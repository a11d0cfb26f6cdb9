"""--shuffle-markers 0 behavior and the extract-nonzero-beta tool."""

import io

import numpy as np

from gmrm_tpu.config import Options
from gmrm_tpu.runner import run_training
from gmrm_tpu.tools import extract_nonzero_beta, main as tools_main


def _opts(sim, out_dir, **kw):
    base = dict(
        bed_file=sim.bed, dim_file=sim.dim, phen_files=sim.phens,
        group_index_file=sim.gri, group_mixture_file=sim.grm,
        iterations=12, seed=7, out_dir=out_dir, block_size=16,
        output_thin_rate=3,
    )
    base.update(kw)
    return Options(**base)


def test_shuffle_off_is_deterministic_and_differs(sim_small, tmp_path):
    o1 = _opts(sim_small, str(tmp_path / "a"), shuffle_markers=False)
    r1 = run_training(o1, verbose=False)
    o2 = _opts(sim_small, str(tmp_path / "b"), shuffle_markers=False)
    r2 = run_training(o2, verbose=False)
    # Same seed, no shuffle -> bit-identical chains.
    np.testing.assert_array_equal(
        np.asarray(r1.state.betas), np.asarray(r2.state.betas))
    np.testing.assert_array_equal(
        np.asarray(r1.state.sigmae), np.asarray(r2.state.sigmae))

    # Shuffled chain with the same seed takes a different trajectory
    # (processing order matters in a Gibbs sweep).
    o3 = _opts(sim_small, str(tmp_path / "c"), shuffle_markers=True)
    r3 = run_training(o3, verbose=False)
    assert not np.array_equal(
        np.asarray(r1.state.betas), np.asarray(r3.state.betas))


def test_extract_nonzero_beta(sim_small, tmp_path):
    out = str(tmp_path / "out")
    run_training(_opts(sim_small, out), verbose=False)
    import os
    bet = [os.path.join(out, f) for f in os.listdir(out)
           if f.endswith(".bet")][0]

    buf = io.StringIO()
    rows = extract_nonzero_beta(bet, 1, 12, out=buf)
    assert rows, "expected some non-zero betas"
    lines = buf.getvalue().splitlines()
    assert len(lines) == len(rows)
    # Reference format: "%7d %7d %20.12f" per row.
    it, j, b = lines[0][:7], lines[0][8:15], lines[0][16:]
    assert int(it) >= 1 and 0 <= int(j)
    assert abs(float(b) - rows[0][2]) < 1e-12
    # Iteration filter respected.
    some_it = rows[0][0]
    only = extract_nonzero_beta(bet, some_it, some_it)
    assert all(r[0] == some_it for r in only)


def test_tools_cli(sim_small, tmp_path, capsys):
    out = str(tmp_path / "out")
    run_training(_opts(sim_small, out), verbose=False)
    import os
    bet = [os.path.join(out, f) for f in os.listdir(out)
           if f.endswith(".bet")][0]
    assert tools_main(["extract-nonzero-beta", bet, "1", "12"]) == 0
    assert capsys.readouterr().out.strip()


def _on_accelerator(monkeypatch):
    """Make resolve_compute_plan see an accelerator backend (the tests
    themselves run on the CPU)."""
    import jax
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")


def test_compute_plan_auto_selection(monkeypatch):
    """The CLI default config auto-selects the validated production plan:
    wave 32 on an accelerator, exact-serial (1) on CPU, largest dividing
    wave otherwise."""
    from gmrm_tpu.cli import build_parser, options_from_args

    args = build_parser().parse_args([])
    opt = options_from_args(args)
    assert opt.block_size == 128 and opt.wave_size is None

    o = Options(block_size=128)          # CPU backend under the conftest
    o.resolve_compute_plan()
    assert o.wave_size == 1

    _on_accelerator(monkeypatch)
    o = Options(block_size=128)
    o.resolve_compute_plan()
    assert o.wave_size == 32

    o = Options(block_size=48)
    o.resolve_compute_plan()
    assert o.wave_size == 16

    # Explicit-but-indivisible wave downgrades to the exact-serial mode.
    o = Options(block_size=100, wave_size=32)
    o.resolve_compute_plan()
    assert o.wave_size == 1

    # Idempotent: resolving twice keeps the explicit choice.
    o = Options(block_size=128, wave_size=16)
    o.resolve_compute_plan()
    o.resolve_compute_plan()
    assert o.wave_size == 16


def test_compute_knob_validation(sim_small, tmp_path):
    """--wave-size 0 must fail as OptionsError at validate() time, not as
    ZeroDivisionError later; an explicit wave runs on
    any backend, and block sizes above 512 validate and run."""
    import pytest
    from gmrm_tpu.config import Options, OptionsError

    def opts(**kw):
        return Options(bed_file=sim_small.bed, dim_file=sim_small.dim,
                       phen_files=[sim_small.phens[0]],
                       group_index_file=sim_small.gri,
                       group_mixture_file=sim_small.grm, **kw)

    with pytest.raises(OptionsError, match="wave-size"):
        opts(wave_size=0).validate()
    o = opts(block_size=2048, wave_size=1)
    o.validate()
    o.resolve_compute_plan()
    assert o.wave_size == 1
    # B=1024 with the production wave: no ceiling, and the chain runs.
    o = opts(block_size=1024, wave_size=32, iterations=2, out_dir="")
    o.validate()
    o.resolve_compute_plan()
    assert o.wave_size == 32
    res = run_training(o, verbose=False)
    assert res.state.betas.shape[1] == 1024
    assert np.isfinite(np.asarray(res.state.sigmae)).all()


def test_wave_guard_auto_downgrade(monkeypatch):
    """An AUTO-selected wave must fall back to exact-serial W=1 on
    panels with too few Gram blocks (the LD_VALIDATION.md stress regime
    where W=32 can diverge); an EXPLICIT wave keeps the user's choice
."""
    from gmrm_tpu.config import Options

    _on_accelerator(monkeypatch)
    # auto plan on a small panel: downgraded
    o = Options(block_size=128)
    o.resolve_compute_plan()
    assert o.wave_size == 32 and o.wave_auto
    nb = o.guard_wave_blocks(2048, verbose=False)    # 16 blocks
    assert nb == 16 and o.wave_size == 1

    # auto plan on a production-size panel: untouched
    o = Options(block_size=128)
    o.resolve_compute_plan()
    o.guard_wave_blocks(20000, verbose=False)        # 157 blocks
    assert o.wave_size == 32

    # explicit wave on a small panel: kept (warned, and the divergence
    # guard still protects the chain)
    o = Options(block_size=128, wave_size=32)
    o.resolve_compute_plan()
    o.guard_wave_blocks(2048, verbose=False)
    assert o.wave_size == 32


def test_divergence_guard_raises():
    """Non-finite sigmaG/sigmaE fails loudly with remediation advice
    instead of writing NaN chains."""
    import numpy as np
    import pytest
    from gmrm_tpu.runner import check_finite_chain

    check_finite_chain(np.ones((2, 3)), np.ones(2), 5)   # fine
    with pytest.raises(FloatingPointError, match="wave-size 1"):
        check_finite_chain(np.array([[np.nan, 1.0]]), np.ones(1), 5)
    with pytest.raises(FloatingPointError, match="diverged"):
        check_finite_chain(np.ones((1, 2)), np.array([np.inf]), 5)


def test_ld_stress_defaults_safe(tmp_path, monkeypatch):
    """The LD_VALIDATION.md stress case (rho=0.99, M=2048 -> 16 Gram
    blocks, where W=32 diverges) under PURE DEFAULTS on an accelerator:
    the auto plan downgrades to W=1 and the chain completes finite; an
    explicit --wave-size 32 fails loudly via the divergence guard instead
    of writing garbage."""
    import numpy as np
    import pytest
    from gmrm_tpu.config import Options
    from gmrm_tpu.io.sim import simulate
    from gmrm_tpu.runner import run_training

    sim = simulate(str(tmp_path / "ldstress"), n=1500, m=2048, n_traits=1,
                   n_causal=256, h2=0.6, n_groups=2, na_rate=0.0, seed=99,
                   ld_rho=0.99)

    def opts(iters, **kw):
        return Options(bed_file=sim.bed, dim_file=sim.dim,
                       phen_files=sim.phens, group_index_file=sim.gri,
                       group_mixture_file=sim.grm, iterations=iters,
                       seed=7, out_dir="", **kw)

    _on_accelerator(monkeypatch)
    o = opts(30)                      # wave unset = accelerator default
    res = run_training(o, verbose=False)
    assert o.wave_size == 1           # guard downgraded before the chain
    se = np.asarray(res.state.sigmae)
    assert np.isfinite(se).all() and se.max() < 10

    with pytest.raises(FloatingPointError, match="diverged"):
        run_training(opts(80, wave_size=32, block_size=128),
                     verbose=False)


def test_many_groups_run_on_wave_path(sim_small, tmp_path):
    """More than 256 annotation groups (once a bf16 group-id carry limit)
    run through the wave path: a 300-group .grm with markers spread over
    them gives a finite chain whose empty groups stay at sigmaG = 0."""
    grm = tmp_path / "many.grm"
    grm.write_text("0.0 0.001 0.01 0.05\n" * 300)
    gri = tmp_path / "many.gri"
    gri.write_text("".join(f"{j} {3 * j}\n" for j in range(sim_small.m)))
    o = Options(bed_file=sim_small.bed, dim_file=sim_small.dim,
                phen_files=sim_small.phens, group_index_file=str(gri),
                group_mixture_file=str(grm), iterations=3, seed=7,
                block_size=16, wave_size=4)
    res = run_training(o, verbose=False)
    assert o.n_groups == 300
    sg = np.asarray(res.state.sigmag)
    assert sg.shape == (len(sim_small.phens), 300)
    assert np.isfinite(sg).all()
    used = np.zeros(300, bool)
    used[3 * np.arange(sim_small.m)] = True
    assert (sg[:, ~used] == 0.0).all()


def test_float64_wave_run(sim_small):
    """--dtype float64 runs the wave path too: the Gram cache (exact
    integer counts) casts to float64 and the block ops take their
    HIGHEST-precision form."""
    import jax
    with jax.enable_x64(True):
        o = _opts(sim_small, "", iterations=3, block_size=32, wave_size=8,
                  dtype="float64")
        res = run_training(o, verbose=False)
        assert res.state.betas.dtype == np.float64
        assert np.isfinite(np.asarray(res.state.sigmae)).all()
