#!/usr/bin/env python3
"""Smoke test of the Gibbs sampler on an NVIDIA GPU, through the entry
points a user calls.  Exits non-zero without a GPU.

    python chip_smoke.py           # one card
    python chip_smoke.py --four    # the sharded path on four cards only

One card, one process, phases in order:

0. the ``gpu``-marked tests (tests/test_gpu.py), run by pytest in this
   process;
1. kernel gates at real widths on a few blocks of both datasets below:
   x^T eps and the residual update (the fused Triton kernels and the plain
   XLA versions) vs a float64 decode, the Gram cache vs
   float64 integer counts (bit-identical), the wave scan (B=128, W=32,
   T=4) on real c/gs vs the float64 wave reference;
2. the anchor chain through ``cli.main``: N=10,000 x Mt=20,000, T=4,
   2 groups, 1% NAs (the compiled-reference equivalence dataset,
   benchmarking/EQUIVALENCE.md), 400 iterations, thin 2, default block
   and wave; per-trait mean h2 after 40% burn-in within 0.03 of the
   compiled reference's pooled value; then ``--predict`` on that chain;
3. a panel larger than the card's L2: N=100,000 x Mt=32,000, T=4, 1% NAs
   (800 MB of packed bed), 20 iterations through ``run_training``.

``--four`` runs only what exists across cards: one sharded sweep with
injected randomness vs ``oracle.sweep_replay_sharded`` on the 100k-wide
panel cut to 1,024 markers (the fused kernels under shard_map), and the
anchor chain through ``cli.main`` on four cards (``run_training_sharded``,
plain block ops at that width) with the same h2 gate.

Each phase prints its seconds, compile seconds, warm ms/iteration where it
runs the step, ``compiled.memory_analysis()`` and peak device memory.  The
line before the last names the card and its power limit; the last line is
one JSON object.  Data is generated from fixed seeds into ``.smoke/``
(removed at exit).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))

# Compiled reference's pooled per-trait h2 at the anchor
# (benchmarking/EQUIVALENCE.md, "Anchor-scale (multi-seed)").
ANCHOR_REF_H2 = (0.4110, 0.4853, 0.4644, 0.4869)
H2_TOL = 0.03
ANCHOR = dict(n=10_000, m=20_000, n_traits=4, n_groups=2, na_rate=0.01,
              seed=20260819)
BIG = dict(n=100_000, m=32_000, n_traits=4, n_groups=2, na_rate=0.01,
           seed=20261016)
# The big panel's width cut to 1,024 markers: the four-card replay gate.
WIDE = dict(BIG, m=1_024)
MIXTURES = (0.0, 0.0001, 0.001, 0.01)
ANCHOR_ITERS, ANCHOR_THIN, BURN = 400, 2, 0.4
BIG_ITERS = 20
TIMED_ITERS = 20


def card_line() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"
    return "; ".join(ln.strip() for ln in out.splitlines() if ln.strip())


def log(msg: str) -> None:
    print(msg, flush=True)


def simulate_dataset(root, name, spec):
    import numpy as np
    from gmrm_tpu.io.sim import simulate
    t0 = time.perf_counter()
    sim = simulate(os.path.join(root, name), n=spec["n"], m=spec["m"],
                   n_traits=spec["n_traits"], n_causal=spec["m"] // 4,
                   h2=0.5, n_groups=spec["n_groups"],
                   na_rate=spec["na_rate"], seed=spec["seed"],
                   mixtures=np.array(MIXTURES))
    log(f"#   simulate {name}: N={spec['n']} Mt={spec['m']} "
        f"T={spec['n_traits']}: {time.perf_counter() - t0:.1f} s")
    return sim


def options(sim, **kw):
    from gmrm_tpu.config import Options
    opt = Options(bed_file=sim.bed, dim_file=sim.dim, phen_files=sim.phens,
                  group_index_file=sim.gri, group_mixture_file=sim.grm,
                  seed=42, **kw)
    opt.validate()
    opt.load_group_mixtures()
    return opt


def peak_bytes(devices=None) -> str:
    import jax
    devs = devices or jax.devices()[:1]
    return ", ".join(
        f"{d.id}: {(d.memory_stats() or {}).get('peak_bytes_in_use', 0) / 2**30:.3f}"
        for d in devs) + " GiB peak"


def load_static(opt):
    """runner's load + stats + Gram cache, with the production layout."""
    import jax
    import jax.numpy as jnp
    from gmrm_tpu.io.grouping import read_dim
    from gmrm_tpu.runner import build_static, load_data
    opt.resolve_compute_plan()
    opt.guard_wave_blocks(read_dim(opt.dim_file)[1], verbose=False)
    t0 = time.perf_counter()
    data = load_data(opt, interleave=opt.wave_size > 1)
    t1 = time.perf_counter()
    static = build_static(data, opt, jnp.float32)
    jax.block_until_ready(static)
    t2 = time.perf_counter()
    log(f"#   load {t1 - t0:.2f} s; marker stats + Gram cache "
        f"{t2 - t1:.2f} s (block {opt.block_size}, wave {opt.wave_size})")
    return data, static


def time_step(opt, data, static):
    """Compile the production step once (timed, with its memory
    analysis), then time TIMED_ITERS warm iterations."""
    import jax
    import jax.numpy as jnp
    from gmrm_tpu.runner import init_sampler_state
    from gmrm_tpu.sampler.gibbs import make_gibbs_step
    state = init_sampler_state(data, opt, jnp.float32)
    shared_na = all(ph.nas == 0 for ph in data.phens)
    step = make_gibbs_step(block_size=opt.block_size, donate=True,
                           shared_na=shared_na, wave_size=opt.wave_size)
    it = jnp.asarray(1, jnp.int32)
    t0 = time.perf_counter()
    compiled = step.lower(state, static, it).compile()
    log(f"#   compile {time.perf_counter() - t0:.2f} s; memory_analysis: "
        f"{compiled.memory_analysis()}")
    for k in range(1, 4):
        state, _ = compiled(state, static, jnp.asarray(k, jnp.int32))
    jax.block_until_ready(state)
    t0 = time.perf_counter()
    for k in range(4, 4 + TIMED_ITERS):
        state, _ = compiled(state, static, jnp.asarray(k, jnp.int32))
    jax.block_until_ready(state)
    ms = (time.perf_counter() - t0) / TIMED_ITERS * 1e3
    log(f"#   {ms:.3f} ms/iteration warm ({TIMED_ITERS} iterations, "
        f"block_until_ready); {peak_bytes()}")
    return ms


def chain_h2(out_dir, n_traits, n_groups):
    """Per-trait mean h2 after burn-in, read as equivalence_ref reads it."""
    spec = importlib.util.spec_from_file_location(
        "equivalence_ref",
        os.path.join(HERE, "benchmarking", "equivalence_ref.py"))
    eq = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(eq)
    return [eq.summarize("ours", eq.parse_csv_chain(
        os.path.join(out_dir, f"test{t + 1}.csv"), n_groups),
        BURN)["h2_mean"] for t in range(n_traits)]


def gate_h2(h2s):
    ok = True
    for t, (got, ref) in enumerate(zip(h2s, ANCHOR_REF_H2)):
        good = abs(got - ref) <= H2_TOL
        ok &= good
        log(f"#   trait {t}: h2 {got:.4f} vs reference {ref:.4f} "
            f"(|diff| {abs(got - ref):.4f} <= {H2_TOL}: "
            f"{'PASS' if good else 'FAIL'})")
    if not ok:
        raise AssertionError("anchor chain h2 outside the gate")


def anchor_argv(sim, out_dir, *extra):
    return ["--bed-file", sim.bed, "--dim-file", sim.dim,
            "--phen-files", ",".join(sim.phens),
            "--group-index-file", sim.gri, "--group-mixture-file", sim.grm,
            "--iterations", str(ANCHOR_ITERS), "--seed", "42",
            "--output-thin-rate", str(ANCHOR_THIN), "--out-dir", out_dir,
            "--verbosity", "-1", *extra]


# --------------------------------------------------------------------------
# Phases
# --------------------------------------------------------------------------

def phase_gpu_tests(ctx):
    import pytest
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      "-p", "no:randomly",
                      os.path.join(HERE, "tests", "test_gpu.py")])
    if rc != 0:
        raise AssertionError(f"gpu tests failed (pytest exit {rc})")


def gate_blocks(name, opt, data, static, wave=32, seed=0):
    """Kernel gates on a few blocks of one dataset (see module doc)."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from gmrm_tpu import oracle
    from gmrm_tpu.io.bed import decode_planes, unpack_codes
    from gmrm_tpu.ops.blockops import (
        block_cdot, block_eps_update, gram_from_quadrants,
    )
    from gmrm_tpu.ops.decode import from_phase_planes, to_phase_planes
    from gmrm_tpu.ops.triton_kernels import (
        block_cdot_fused, block_eps_update_fused,
    )
    from gmrm_tpu.runner import init_sampler_state
    from gmrm_tpu.sampler.scan import block_scan_wave

    rng = np.random.default_rng(seed)
    B = static.gram_cache.shape[2] // 2
    nblocks = static.gram_cache.shape[0]
    mb = static.bed.shape[1]
    T = static.na.shape[0]
    cdot = {"plain": jax.jit(lambda bed, rows, e, m: block_cdot(
                 jnp.take(bed, rows, axis=0), e, m)),
            "fused": block_cdot_fused}
    upd = {"plain": jax.jit(lambda bed, rows, d, na, m: block_eps_update(
                jnp.take(bed, rows, axis=0), d, na, m)),
           "fused": block_eps_update_fused}
    scan = jax.jit(lambda *a: block_scan_wave(*a, wave=wave))
    gsc = jax.jit(lambda g, m, s: (s[:, :, None] * s[:, None, :])
                  * gram_from_quadrants(g, m))

    eps = jnp.asarray(data.eps0, jnp.float32)
    eps_i = from_phase_planes(data.eps0)                     # (T, 4mb)
    na_i = from_phase_planes(data.na)
    state = init_sampler_state(data, opt, jnp.float32)
    nonas = np.asarray(static.nonas)
    sigmae = 0.5 * (eps_i ** 2).sum(axis=1) / nonas          # iteration 1
    worst = {"c plain": 0.0, "c fused": 0.0, "deps plain": 0.0,
             "deps fused": 0.0, "beta": 0.0}
    for k in sorted({0, nblocks // 2, nblocks - 1}):
        rows = slice(k * B, (k + 1) * B)
        ridx = jnp.arange(k * B, (k + 1) * B, dtype=jnp.int32)
        bed_blk = static.bed[rows]
        mave = static.mave[:, rows]
        msig = static.msig[:, rows]
        a, b = decode_planes(unpack_codes(np.asarray(bed_blk), 4 * mb))
        a, b = a.astype(np.float64), b.astype(np.float64)
        m64 = np.asarray(mave, np.float64)

        c_ref = a @ eps_i.T - (b @ eps_i.T) * m64.T          # (B, T)
        d = (rng.normal(size=(T, B)) * 0.01).astype(np.float32)
        deps_ref = to_phase_planes(
            (d @ a - (d * m64) @ b) * na_i)                  # (T, 4, mb)
        for how in ("plain", "fused"):
            c = np.asarray(cdot[how](static.bed, ridx, eps, mave), np.float64)
            err = np.abs(c - c_ref.T).max() / np.abs(c_ref).max()
            worst["c " + how] = max(worst["c " + how], err)
            deps = np.asarray(upd[how](static.bed, ridx, jnp.asarray(d),
                                       static.na, mave))
            err = np.abs(deps - deps_ref).max() / np.abs(deps_ref).max()
            worst["deps " + how] = max(worst["deps " + how], err)

        ab = np.concatenate([a, b])
        gram = np.asarray(static.gram_cache[k], np.float64)
        for t in range(gram.shape[0]):
            if not np.array_equal(gram[t], (ab * na_i[t]) @ ab.T):
                raise AssertionError(f"{name} block {k}: Gram cache is not "
                                     f"the float64 count (trait mask {t})")

        cs = msig * jnp.asarray(c, jnp.float32)            # fused c
        gs = gsc(static.gram_cache[k], mave, msig)
        valid = jnp.arange(k * B, (k + 1) * B) < data.m_local
        args = (cs, gs,
                jnp.asarray(rng.normal(size=(T, B)) * 0.01
                            * (rng.uniform(size=(T, B)) < 0.5), jnp.float32),
                jnp.zeros((T, B), jnp.int32), jnp.zeros((T, B), jnp.float32),
                static.group_of[rows], valid,
                jnp.asarray(rng.uniform(size=(T, B)), jnp.float32),
                jnp.asarray(rng.normal(size=(T, B)), jnp.float32),
                state.sigmag, jnp.asarray(sigmae, jnp.float32), state.pi_est,
                static.cva, static.cvai, static.nonas, static.n_total)
        out = jax.device_get(scan(*args))
        ref = oracle.wave_scan(*(np.asarray(x) for x in args), wave=wave)
        if not (np.array_equal(out.comp_new, ref[2])
                and np.array_equal(out.cass_inc, ref[4])):
            raise AssertionError(f"{name} block {k}: wave scan components "
                                 f"differ from the float64 reference")
        np.testing.assert_allclose(out.beta_new, ref[1], rtol=1e-4,
                                   atol=1e-6, err_msg=f"{name} block {k}")
        worst["beta"] = max(worst["beta"],
                            float(np.abs(out.beta_new - ref[1]).max()))
    log(f"#   {name} gates: max |x - ref| / max|ref| (<= 1e-5): "
        + ", ".join(f"{key} {worst[key]:.3e}" for key in worst
                    if key != "beta")
        + f"; Gram cache bit-identical; wave scan B={B} W={wave} T={T}: "
        f"components identical, max |beta - ref| = {worst['beta']:.3e}")
    for key, err in worst.items():
        if key != "beta" and err > 1e-5:
            raise AssertionError(f"{name}: {key} error {err:.3e}")


def phase_kernels(ctx):
    for name in ("anchor", "big"):
        opt = options(ctx[name], block_size=128, wave_size=32)
        data, static = load_static(opt)
        gate_blocks(name, opt, data, static)
        del data, static


def phase_anchor_chain(ctx):
    import numpy as np
    from gmrm_tpu import cli
    sim = ctx["anchor"]
    opt = options(sim)
    data, static = load_static(opt)
    time_step(opt, data, static)
    del data, static
    out = os.path.join(ctx["root"], "anchor_out")
    t0 = time.perf_counter()
    rc = cli.main(anchor_argv(sim, out, "--devices", "1"))
    log(f"#   cli.main train: rc {rc}, {time.perf_counter() - t0:.2f} s "
        f"({ANCHOR_ITERS} iterations, thin {ANCHOR_THIN}, output included)")
    if rc != 0:
        raise AssertionError(f"cli.main returned {rc}")
    gate_h2(chain_h2(out, len(sim.phens), ANCHOR["n_groups"]))
    t0 = time.perf_counter()
    rc = cli.main(["--predict", "--bed-file", sim.bed, "--dim-file", sim.dim,
                   "--phen-files", ",".join(sim.phens), "--bim-file",
                   sim.bim, "--ref-bim-file", sim.bim, "--out-dir", out,
                   "--verbosity", "-1"])
    log(f"#   cli.main --predict: rc {rc}, {time.perf_counter() - t0:.2f} s")
    if rc != 0:
        raise AssertionError(f"predict returned {rc}")
    for t in range(len(sim.phens)):
        with open(os.path.join(out, f"test{t + 1}.mlma")) as fh:
            rows = [ln.split() for ln in fh]
        vals = np.array([[float(x) for x in r[1:]] for r in rows])
        if len(rows) != sim.m or not np.isfinite(vals).all():
            raise AssertionError(f"test{t + 1}.mlma: {len(rows)} lines "
                                 f"(want {sim.m}), finite "
                                 f"{np.isfinite(vals).all()}")
    log(f"#   .mlma: {sim.m} lines per trait, all values finite; "
        f"{peak_bytes()}")


def phase_big(ctx):
    import numpy as np
    from gmrm_tpu.runner import run_training
    sim = ctx["big"]
    opt = options(sim)
    data, static = load_static(opt)
    time_step(opt, data, static)
    del data, static
    opt = options(sim, iterations=BIG_ITERS, output_thin_rate=10,
                  out_dir=os.path.join(ctx["root"], "big_out"))
    t0 = time.perf_counter()
    res = run_training(opt, verbose=False)
    sg = np.asarray(res.state.sigmag)
    se = np.asarray(res.state.sigmae)
    log(f"#   run_training: {BIG_ITERS} iterations in "
        f"{time.perf_counter() - t0:.2f} s (load, stats, Gram cache and "
        f"compile included); chain {res.chain_seconds:.2f} s; "
        f"h2 {np.round(sg.sum(1) / (sg.sum(1) + se), 4).tolist()}; "
        f"{peak_bytes()}")
    if not (np.isfinite(sg).all() and np.isfinite(se).all()
            and np.isfinite(np.asarray(res.state.betas)).all()):
        raise AssertionError("100k x 32k chain is not finite")


def phase_sharded_replay(ctx, n_dev=4, block=128, wave=32):
    """One sharded sweep with injected randomness vs the float64 D-rank
    wave replay, on the 100k-wide panel cut to 1,024 markers (N, T, NA
    masks at full width; rows wide enough for the fused kernels)."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import PartitionSpec as P
    from gmrm_tpu import oracle
    from gmrm_tpu.io.bed import decode_planes, unpack_codes
    from gmrm_tpu.ops.decode import from_phase_planes
    from gmrm_tpu.parallel.mesh import MARKER_AXIS, make_marker_mesh
    from gmrm_tpu.parallel.runner import (
        _static_specs, load_data_process, make_global,
    )
    from gmrm_tpu.ops.blockops import build_gram_cache, marker_stats_jax
    from gmrm_tpu.sampler.gibbs import marker_sweep
    from gmrm_tpu.sampler.state import StaticInputs, pi_prior_from_cva

    sim = ctx["wide"]
    mesh = make_marker_mesh(n_dev)
    devs = list(mesh.devices.flat)
    m = sim.m
    opt = options(sim, block_size=block, wave_size=wave)
    data = load_data_process(opt, n_dev, interleave=False)
    mps = data.layout.m_pad_shard
    assert (data.m_local_arr == mps).all()       # no pad rows to mask
    nblocks = mps // block
    T = len(data.phens)
    sh1, sh2, rep = P(MARKER_AXIS), P(None, MARKER_AXIS), P()
    bed = make_global(mesh, sh1, data.bed_local)
    na = make_global(mesh, rep, data.na, np.float32)
    nonas = make_global(mesh, rep, data.nonas, np.float32)
    stats = jax.jit(jax.shard_map(
        lambda b, n, o: marker_stats_jax(b, n, o, axis_name=MARKER_AXIS),
        mesh=mesh, in_specs=(sh1, rep, rep), out_specs=sh2))
    mave, msig = stats(bed, na, nonas)
    cache = jax.jit(jax.shard_map(
        lambda b, n: build_gram_cache(b, n, block_size=block,
                                      shared_na=False),
        mesh=mesh, in_specs=(sh1, rep), out_specs=sh1))(bed, na)
    G, K = opt.cva.shape
    static = StaticInputs(
        bed=bed, na=na, mave=mave, msig=msig,
        group_of=make_global(mesh, sh1, data.group_local),
        mtotgrp=make_global(mesh, rep, data.mtotgrp),
        nonas=nonas, cva=make_global(mesh, rep, opt.cva, np.float32),
        cvai=make_global(mesh, rep, opt.cvai, np.float32),
        n_total=make_global(mesh, rep, np.asarray(float(data.n)),
                            np.float32),
        m_local=make_global(mesh, sh1, data.m_local_arr),
        gram_cache=cache)

    rng = np.random.default_rng(4711)
    perms = [(rng.permutation(nblocks)[:, None] * block
              + np.stack([rng.permutation(block) for _ in range(nblocks)])
              ).reshape(-1) for _ in range(n_dev)]
    u = rng.uniform(size=(n_dev, nblocks, T, block))
    z = rng.normal(size=(n_dev, nblocks, T, block))
    sigmag0 = rng.uniform(0.05, 0.5, size=(T, G))
    eps_i = from_phase_planes(data.eps0)
    sigmae0 = 0.5 * (eps_i ** 2).sum(axis=1) / data.nonas

    def sweep(eps, betas, comp, acum, sigmag, sigmae, pi_est, st, blocks,
              u_all, z_all):
        eps, betas, comp, acum, cass = marker_sweep(
            eps, betas, comp, acum, sigmag, sigmae, pi_est, st, blocks,
            u_all, z_all, axis_name=MARKER_AXIS, wave_size=wave)
        return eps, betas, comp, acum, jax.lax.psum(cass, MARKER_AXIS)

    fn = jax.jit(jax.shard_map(
        sweep, mesh=mesh,
        in_specs=(rep, sh2, sh2, sh2, rep, rep, rep, _static_specs(True),
                  sh1, sh1, sh1),
        out_specs=(rep, sh2, sh2, sh2, rep)))
    zeros = np.zeros((T, n_dev * mps), np.float32)
    args = (make_global(mesh, rep, data.eps0, np.float32),
            make_global(mesh, sh2, zeros),
            make_global(mesh, sh2, zeros.astype(np.int32)),
            make_global(mesh, sh2, zeros),
            make_global(mesh, rep, sigmag0, np.float32),
            make_global(mesh, rep, sigmae0, np.float32),
            make_global(mesh, rep, np.broadcast_to(
                pi_prior_from_cva(opt.cva), (T, G, K)), np.float32),
            static,
            make_global(mesh, sh1, np.concatenate(
                [p.reshape(nblocks, block) for p in perms]).astype(np.int32)),
            make_global(mesh, sh1, u.reshape(n_dev * nblocks, T, block),
                        np.float32),
            make_global(mesh, sh1, z.reshape(n_dev * nblocks, T, block),
                        np.float32))
    t0 = time.perf_counter()
    compiled = fn.lower(*args).compile()
    log(f"#   sharded sweep compile {time.perf_counter() - t0:.2f} s; "
        f"memory_analysis: {compiled.memory_analysis()}")
    out = jax.device_get(compiled(*args))
    log(f"#   per-device {peak_bytes(devs)}")
    in_use = [(d.memory_stats() or {}).get("bytes_in_use", 0) for d in devs]
    log(f"#   per-device bytes_in_use: {in_use}")
    if min(in_use) < 0.5 * max(in_use):
        raise AssertionError(f"shards unevenly placed: {in_use}")

    bed_np = np.asarray(data.bed_local)
    a0, b0 = decode_planes(unpack_codes(bed_np, 4 * bed_np.shape[1]))
    na_i = from_phase_planes(data.na)
    mave_np, msig_np = np.asarray(mave, np.float64), np.asarray(msig,
                                                                np.float64)
    gid = data.group_local
    shards = [(i * mps, int(data.m_local_arr[i])) for i in range(n_dev)]
    worst = 0.0
    for t in range(T):
        st = oracle.OracleState(
            eps=eps_i[t].copy(), betas=np.zeros(n_dev * mps),
            comp=np.zeros(n_dev * mps, np.int64),
            acum=np.zeros(n_dev * mps), cass=np.zeros((G, K), np.int64),
            sigmag=sigmag0[t].copy(), sigmae=float(sigmae0[t]),
            pi_est=pi_prior_from_cva(opt.cva).copy(), mu=0.0,
            nonas=float(data.nonas[t]))
        oracle.sweep_replay_sharded(
            st, a0 * na_i[t], b0 * na_i[t], na_i[t], mave_np[t], msig_np[t],
            gid, opt.cva, opt.cvai, shards, perms,
            [u[d, :, t].reshape(-1) for d in range(n_dev)],
            [z[d, :, t].reshape(-1) for d in range(n_dev)],
            block, data.n, wave=wave)
        live = np.concatenate([np.arange(s, s + ln) for s, ln in shards])
        if not (np.array_equal(out[2][t, live], st.comp[live])
                and np.array_equal(out[4][t], st.cass)):
            raise AssertionError(f"trait {t}: sharded components differ "
                                 f"from the replay oracle")
        np.testing.assert_allclose(out[1][t, live], st.betas[live],
                                   rtol=2e-3, atol=2e-4)
        np.testing.assert_allclose(from_phase_planes(out[0])[t], st.eps,
                                   rtol=5e-3, atol=2e-3)
        worst = max(worst, float(np.abs(out[1][t, live]
                                        - st.betas[live]).max()))
    log(f"#   sharded sweep ({n_dev} devices, {m} markers, N={data.n}, "
        f"T={T}, B={block}, W={wave}) vs replay oracle: components "
        f"identical, max |beta - ref| = {worst:.3e}")


def phase_four_chain(ctx):
    import jax
    from gmrm_tpu import cli
    sim = ctx["anchor"]
    out = os.path.join(ctx["root"], "anchor4_out")
    t0 = time.perf_counter()
    # 5,000 markers per card is 40 blocks, below the auto plan's 64-block
    # margin, so the production wave is asked for explicitly.
    rc = cli.main(anchor_argv(sim, out, "--devices", "4",
                              "--wave-size", "32"))
    log(f"#   cli.main train on 4 devices: rc {rc}, "
        f"{time.perf_counter() - t0:.2f} s ({ANCHOR_ITERS} iterations, "
        f"thin {ANCHOR_THIN}, compile and output included); "
        f"{peak_bytes(jax.devices()[:4])}")
    if rc != 0:
        raise AssertionError(f"cli.main returned {rc}")
    gate_h2(chain_h2(out, len(sim.phens), ANCHOR["n_groups"]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card sharded phases")
    args = ap.parse_args(argv)
    if not os.path.isdir(os.path.join(HERE, "gmrm_tpu")):
        print("FATAL  : chip_smoke.py must sit in the repository checkout",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from gmrm_tpu import compile_cache
    compile_cache.enable()
    import jax
    if jax.default_backend() != "gpu":
        print(f"FATAL  : no GPU (JAX backend {jax.default_backend()!r})",
              file=sys.stderr)
        return 2
    n_need = 4 if args.four else 1
    if len(jax.devices()) < n_need:
        print(f"FATAL  : {n_need} GPUs needed, {len(jax.devices())} found",
              file=sys.stderr)
        return 2
    card = card_line()
    dev = jax.devices()[0]
    log(f"# device: {dev.platform} {dev.device_kind} x{len(jax.devices())}; "
        f"card: {card}; jax {jax.__version__}")

    os.makedirs(os.path.join(HERE, ".smoke"), exist_ok=True)
    root = tempfile.mkdtemp(dir=os.path.join(HERE, ".smoke"))
    ctx = {"root": root}
    failed = []
    t_all = time.perf_counter()
    try:
        t0 = time.perf_counter()
        ctx["anchor"] = simulate_dataset(root, "anchor", ANCHOR)
        if args.four:
            ctx["wide"] = simulate_dataset(root, "wide", WIDE)
            phases = [("sharded sweep vs replay oracle", phase_sharded_replay),
                      ("anchor chain on 4 cards", phase_four_chain)]
        else:
            ctx["big"] = simulate_dataset(root, "big", BIG)
            phases = [("gpu tests", phase_gpu_tests),
                      ("kernel gates", phase_kernels),
                      ("anchor chain + predict", phase_anchor_chain),
                      ("100k x 32k chain", phase_big)]
        log(f"# data ready: {time.perf_counter() - t0:.1f} s")
        for name, fn in phases:
            log(f"# phase: {name}")
            t0 = time.perf_counter()
            try:
                fn(ctx)
                log(f"# phase {name}: PASS, {time.perf_counter() - t0:.1f} s")
            except Exception:                  # report, then fail the run
                traceback.print_exc()
                failed.append(name)
                log(f"# phase {name}: FAIL, {time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"# total {time.perf_counter() - t_all:.1f} s; failed phases: "
        f"{failed or 'none'}")
    log(f"# card: {card}")
    if failed:
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": n_need}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
