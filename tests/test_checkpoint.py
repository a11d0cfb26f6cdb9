"""Checkpoint/resume: a resumed chain must be bit-identical to an
uninterrupted one (keys derive from (seed, iteration), so no RNG state
needs persisting)."""

import os

import numpy as np

from gmrm_tpu.config import Options
from gmrm_tpu.io.writers import read_history
from gmrm_tpu.runner import run_training


def _opts(sim, out_dir, iterations, **kw):
    base = dict(
        bed_file=sim.bed, dim_file=sim.dim, phen_files=[sim.phens[0]],
        group_index_file=sim.gri, group_mixture_file=sim.grm,
        iterations=iterations, seed=7, out_dir=out_dir, block_size=16,
        output_thin_rate=2,
    )
    base.update(kw)
    return Options(**base)


def test_resume_bit_identical(sim_small, tmp_path):
    full_dir = str(tmp_path / "full")
    res_full = run_training(_opts(sim_small, full_dir, 12), verbose=False)

    part_dir = str(tmp_path / "part")
    run_training(_opts(sim_small, part_dir, 6, checkpoint_every=3),
                 verbose=False)
    assert os.path.exists(os.path.join(part_dir, "checkpoint.npz"))
    res_resumed = run_training(
        _opts(sim_small, part_dir, 12, checkpoint_every=3, resume=True),
        verbose=False)

    np.testing.assert_array_equal(
        np.asarray(res_full.state.betas), np.asarray(res_resumed.state.betas))
    np.testing.assert_array_equal(
        np.asarray(res_full.state.sigmag),
        np.asarray(res_resumed.state.sigmag))
    np.testing.assert_array_equal(
        np.asarray(res_full.state.eps), np.asarray(res_resumed.state.eps))

    # The .bet history must contain all 6 thinned records, matching the
    # uninterrupted run byte-for-byte.
    i_full, d_full = read_history(os.path.join(full_dir, "test1.bet"), "f8")
    i_res, d_res = read_history(os.path.join(part_dir, "test1.bet"), "f8")
    np.testing.assert_array_equal(i_full, i_res)
    np.testing.assert_array_equal(d_full, d_res)


def test_resume_without_checkpoint_starts_fresh(sim_small, tmp_path):
    out = str(tmp_path / "fresh")
    res = run_training(_opts(sim_small, out, 4, resume=True), verbose=False)
    assert len(res.iter_seconds) == 4


def test_sharded_resume_truncates_stale_rows(sim_small, tmp_path):
    """Resuming a SHARDED run from a checkpoint OLDER than the output
    files must truncate rows past the checkpoint:
    final artifacts match an uninterrupted run byte-for-byte."""
    import jax
    import pytest
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    from gmrm_tpu.parallel.runner import run_training_sharded

    full_dir = str(tmp_path / "sfull")
    run_training_sharded(_opts(sim_small, full_dir, 10), verbose=False)

    # Crash scenario: the chain ran to 14 (rows for it=10..14 on disk)
    # but the last checkpoint is from it=8; the resumed 10-iteration run
    # must drop the stale tail before re-writing.
    part_dir = str(tmp_path / "spart")
    run_training_sharded(_opts(sim_small, part_dir, 14, checkpoint_every=8),
                         verbose=False)
    run_training_sharded(
        _opts(sim_small, part_dir, 10, checkpoint_every=8, resume=True),
        verbose=False)

    for suf in (".bet", ".cpn", ".csv"):
        a = open(os.path.join(full_dir, "test1" + suf), "rb").read()
        b = open(os.path.join(part_dir, "test1" + suf), "rb").read()
        assert a == b, f"{suf}: resumed artifact differs / stale rows"


def test_resume_bit_identical_wave_mode(sim_small, tmp_path):
    """Resume under the production wave mode: interleaved marker storage
    (runner.interleave_order) must reproduce identically across the
    checkpoint boundary — artifacts byte-identical to an uninterrupted
    run."""
    kw = dict(wave_size=4, block_size=16)
    full_dir = str(tmp_path / "wfull")
    run_training(_opts(sim_small, full_dir, 12, **kw), verbose=False)

    part_dir = str(tmp_path / "wpart")
    run_training(_opts(sim_small, part_dir, 6, checkpoint_every=3, **kw),
                 verbose=False)
    run_training(
        _opts(sim_small, part_dir, 12, checkpoint_every=3, resume=True,
              **kw),
        verbose=False)

    for suf in (".bet", ".cpn", ".csv"):
        a = open(os.path.join(full_dir, "test1" + suf), "rb").read()
        b = open(os.path.join(part_dir, "test1" + suf), "rb").read()
        assert a == b, f"{suf}: wave-mode resume differs"


def test_single_device_resume_truncates_stale_rows(sim_small, tmp_path):
    """The SINGLE-device analog of the sharded stale-row test: checkpoint at it=8, crash after it=14, resume to it=10 —
    rows past the checkpoint must not survive; artifacts byte-identical
    to an uninterrupted 10-iteration run."""
    full_dir = str(tmp_path / "ofull")
    run_training(_opts(sim_small, full_dir, 10), verbose=False)

    part_dir = str(tmp_path / "opart")
    run_training(_opts(sim_small, part_dir, 14, checkpoint_every=8),
                 verbose=False)
    run_training(
        _opts(sim_small, part_dir, 10, checkpoint_every=8, resume=True),
        verbose=False)

    for suf in (".bet", ".cpn", ".csv"):
        a = open(os.path.join(full_dir, "test1" + suf), "rb").read()
        b = open(os.path.join(part_dir, "test1" + suf), "rb").read()
        assert a == b, f"{suf}: resumed artifact differs / stale rows"


def test_resume_layout_mismatch_fails_loudly(sim_small, tmp_path):
    """Checkpoints stamp the marker-STORAGE layout (block_size /
    wave_size / interleave); resuming under a different layout must fail
    loudly instead of silently misaligning state against the
    re-interleaved bed."""
    import pytest

    out = str(tmp_path / "lay")
    run_training(_opts(sim_small, out, 6, checkpoint_every=3,
                       wave_size=4, block_size=16),
                 verbose=False)
    with pytest.raises(ValueError, match="storage layout"):
        run_training(_opts(sim_small, out, 12, checkpoint_every=3,
                           resume=True, wave_size=1, block_size=16),
                     verbose=False)
    with pytest.raises(ValueError, match="storage layout"):
        run_training(_opts(sim_small, out, 12, checkpoint_every=3,
                           resume=True, wave_size=4,
                           block_size=32),
                     verbose=False)


def test_legacy_checkpoint_without_layout_stamp(sim_small, tmp_path):
    """Unstamped (pre-stamp) checkpoints are refused outright: their
    marker storage order cannot be verified, and resuming misaligned
    state corrupts the chain silently (code-review r5: pre-stamp WAVE
    runs wrote interleaved state, so no assumption is safe)."""
    import pytest
    import numpy as np

    out = str(tmp_path / "legacy")
    run_training(_opts(sim_small, out, 6, checkpoint_every=3, wave_size=1),
                 verbose=False)
    ck = os.path.join(out, "checkpoint.npz")
    with np.load(ck) as z:
        arrays = {k: z[k] for k in z.files if not k.startswith("layout_")}
    np.savez(ck, **arrays)                       # strip the stamp

    for kw in (dict(wave_size=1),
               dict(wave_size=4, block_size=16)):
        with pytest.raises(ValueError, match="predates layout stamping"):
            run_training(_opts(sim_small, out, 8, checkpoint_every=3,
                               resume=True, **kw), verbose=False)


def test_fresh_run_clears_stale_checkpoints(sim_small, tmp_path):
    """A non-resume run removes checkpoint files left by a previous
    chain in the same out_dir — otherwise a later --resume could merge
    state across unrelated chains sharing an iteration number
    (code-review r5)."""
    out = str(tmp_path / "clear")
    run_training(_opts(sim_small, out, 6, checkpoint_every=3),
                 verbose=False)
    assert os.path.exists(os.path.join(out, "checkpoint.npz"))
    run_training(_opts(sim_small, out, 4), verbose=False)   # fresh run
    assert not os.path.exists(os.path.join(out, "checkpoint.npz"))


def test_single_device_refuses_sharded_checkpoint(sim_small, tmp_path):
    """Cross-runner checkpoint formats fail loudly instead of KeyError
    or silent clobbering (code-review r5)."""
    import jax
    import pytest
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    from gmrm_tpu.parallel.runner import run_training_sharded

    out = str(tmp_path / "xfmt")
    run_training_sharded(_opts(sim_small, out, 6, checkpoint_every=3),
                         verbose=False)
    # v2 sharded checkpoint.npz -> clear error from the 1-device runner
    with pytest.raises(ValueError, match="SHARDED checkpoint"):
        run_training(_opts(sim_small, out, 8, checkpoint_every=3,
                           resume=True), verbose=False)
    # only per-process files present -> refuse rather than fresh-start
    ck = os.path.join(out, "checkpoint.npz")
    os.rename(ck, os.path.join(out, "checkpoint.p0.npz"))
    with pytest.raises(ValueError, match="sharded runner"):
        run_training(_opts(sim_small, out, 8, resume=True), verbose=False)


def test_truncate_csv_variable_width(tmp_path):
    """truncate_csv_to must survive rows of DIFFERENT widths (iteration
    crossing %5d, m0_sum crossing %7d)."""
    from gmrm_tpu.io.writers import truncate_csv_to

    p = str(tmp_path / "x.csv")
    rows = [b"    1, short row\n",
            b"100000, wider row because iteration overflowed %5d field\n",
            b"100001, w\n",
            b"100002, stale tail row\n"]
    with open(p, "wb") as fh:
        fh.write(b"".join(rows))
    truncate_csv_to(p, 3)
    assert open(p, "rb").read() == b"".join(rows[:3])
    truncate_csv_to(p, 99)                       # fewer rows than asked: noop
    assert open(p, "rb").read() == b"".join(rows[:3])


def test_startup_cache_reuse(sim_small, tmp_path):
    """--cache-dir persists marker stats + Gram cache across runs of
    the same dataset: the second run warm-loads
    the npz and produces byte-identical artifacts; a changed geometry
    (block size) keys a different entry."""
    cache = str(tmp_path / "cache")
    kw = dict(wave_size=4, block_size=16,
              cache_dir=cache)

    cold_dir = str(tmp_path / "cold")
    run_training(_opts(sim_small, cold_dir, 8, **kw), verbose=False)
    entries = os.listdir(cache)
    assert len(entries) == 1 and entries[0].startswith("startup_")
    with np.load(os.path.join(cache, entries[0])) as z:
        assert {"mave", "msig", "gram"} <= set(z.files)

    warm_dir = str(tmp_path / "warm")
    run_training(_opts(sim_small, warm_dir, 8, **kw), verbose=False)
    assert len(os.listdir(cache)) == 1           # reused, not rebuilt
    for suf in (".bet", ".cpn", ".csv"):
        a = open(os.path.join(cold_dir, "test1" + suf), "rb").read()
        b = open(os.path.join(warm_dir, "test1" + suf), "rb").read()
        assert a == b, f"{suf}: warm-start run differs"

    # different geometry -> different key -> second entry
    kw2 = dict(kw, block_size=32, wave_size=4)
    run_training(_opts(sim_small, str(tmp_path / "g2"), 8, **kw2),
                 verbose=False)
    assert len(os.listdir(cache)) == 2


def test_sharded_startup_cache_reuse(sim_small, tmp_path):
    """The sharded runner's --cache-dir: each process persists its own
    shards' stats + Gram quadrants and a warm start produces
    byte-identical artifacts; a topology change just misses the key."""
    import jax
    import pytest
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    from gmrm_tpu.parallel.runner import run_training_sharded

    cache = str(tmp_path / "scache")
    kw = dict(wave_size=4, block_size=16,
              cache_dir=cache)

    cold_dir = str(tmp_path / "scold")
    run_training_sharded(_opts(sim_small, cold_dir, 8, **kw),
                         verbose=False)
    entries = os.listdir(cache)
    assert len(entries) == 1 and entries[0].startswith("startup_shard_p0_")
    with np.load(os.path.join(cache, entries[0])) as z:
        assert {"mave", "msig", "gram"} <= set(z.files)

    warm_dir = str(tmp_path / "swarm")
    run_training_sharded(_opts(sim_small, warm_dir, 8, **kw),
                         verbose=False)
    assert len(os.listdir(cache)) == 1           # reused, not rebuilt
    for suf in (".bet", ".cpn", ".csv"):
        a = open(os.path.join(cold_dir, "test1" + suf), "rb").read()
        b = open(os.path.join(warm_dir, "test1" + suf), "rb").read()
        assert a == b, f"{suf}: sharded warm-start run differs"

    # different shard topology -> different key -> second entry
    run_training_sharded(_opts(sim_small, str(tmp_path / "s4"), 8, **kw),
                         n_devices=4, verbose=False)
    assert len(os.listdir(cache)) == 2


def test_sharded_checkpoint_era_fallback(sim_small, tmp_path):
    """A crash mid-checkpoint can leave the newest save era incomplete
    (some processes ahead of others); the loader must fall back to the
    newest COMPLETE era — the previous saves kept as *.prev.npz
    (code-review r5)."""
    import jax
    import pytest
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    from gmrm_tpu.parallel.runner import run_training_sharded

    out = str(tmp_path / "era")
    run_training_sharded(_opts(sim_small, out, 6, checkpoint_every=3),
                         verbose=False)
    ck = os.path.join(out, "checkpoint.npz")
    prev = os.path.join(out, "checkpoint.prev.npz")
    assert os.path.exists(ck) and os.path.exists(prev)   # it=6 and it=3

    # Sabotage the newest era: drop one shard's slices + its range from
    # `starts`, so it=6 no longer covers all markers.
    with np.load(ck) as z:
        arrays = {k: z[k] for k in z.files}
    last = arrays["starts"].shape[0] - 1
    for f in ("betas", "comp", "acum"):
        del arrays[f"{f}_{last}"]
    # re-key the remaining shards' names are 0..last-1 already; trim starts
    arrays["starts"] = arrays["starts"][:last]
    np.savez(ck, **arrays)

    res = run_training_sharded(
        _opts(sim_small, out, 8, checkpoint_every=3, resume=True),
        verbose=False)
    # Fell back to the complete it=3 era: 8 - 3 = 5 iterations run.
    assert res.iters_run == 5


def test_resume_without_checkpoint_guards_existing_outputs(sim_small,
                                                           tmp_path):
    """--resume with no checkpoint must not silently destroy a previous
    chain's outputs (code-review r5); in an EMPTY out_dir it still
    starts fresh (test_resume_without_checkpoint_starts_fresh)."""
    import pytest

    out = str(tmp_path / "guard")
    run_training(_opts(sim_small, out, 6), verbose=False)   # no checkpoint
    with pytest.raises(ValueError, match="destroy"):
        run_training(_opts(sim_small, out, 8, resume=True), verbose=False)


def test_resume_with_missing_bet_fails(sim_small, tmp_path):
    """A checkpoint that records thinned rows whose .bet file is gone
    must raise, not create a zero-filled history (code-review r5)."""
    import pytest

    out = str(tmp_path / "gone")
    run_training(_opts(sim_small, out, 8, checkpoint_every=4),
                 verbose=False)
    os.remove(os.path.join(out, "test1.bet"))
    with pytest.raises(IOError, match="missing"):
        run_training(_opts(sim_small, out, 12, checkpoint_every=4,
                           resume=True), verbose=False)


def test_resume_trunc_markers_mismatch_fails(sim_small, tmp_path):
    """A changed --trunc-markers between save and resume keeps padded
    shapes but changes the interleave permutation AND the .bet record
    stride — the m_total layout stamp must catch it (code-review r5)."""
    import pytest

    out = str(tmp_path / "trunc")
    run_training(_opts(sim_small, out, 6, checkpoint_every=3,
                       wave_size=4, block_size=16),
                 verbose=False)
    with pytest.raises(ValueError, match="storage layout"):
        run_training(_opts(sim_small, out, 10, checkpoint_every=3,
                           resume=True, wave_size=4,
                           block_size=16,
                           trunc_markers=sim_small.m - 16),
                     verbose=False)
