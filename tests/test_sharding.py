"""Multi-device semantics on the 8-device virtual CPU mesh.

The reference's multi-rank behavior (different rank counts give different
but statistically equivalent chains; artifacts identical in layout) is the
contract checked here, plus graft-entry dry runs.
"""

import os

import numpy as np
import pytest
import jax

from gmrm_tpu.config import Options
from gmrm_tpu.io.writers import read_history


needs_8 = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices"
)


def _opts(sim, out_dir, **kw):
    base = dict(
        bed_file=sim.bed, dim_file=sim.dim, phen_files=sim.phens,
        group_index_file=sim.gri, group_mixture_file=sim.grm,
        iterations=20, seed=42, out_dir=out_dir, block_size=16,
        output_thin_rate=4,
    )
    base.update(kw)
    return Options(**base)


@needs_8
def test_sharded_run_matches_single_device_statistically(sim_medium, tmp_path):
    sim_small = sim_medium
    from gmrm_tpu.runner import run_training
    from gmrm_tpu.parallel.runner import run_training_sharded

    opt1 = _opts(sim_small, str(tmp_path / "out1"), iterations=30)
    res1 = run_training(opt1, verbose=False)

    opt8 = _opts(sim_small, str(tmp_path / "out8"), iterations=30)
    res8 = run_training_sharded(opt8, verbose=False)

    sg1 = np.asarray(res1.state.sigmag).sum(axis=1)
    sg8 = np.asarray(res8.state.sigmag).sum(axis=1)
    se1 = np.asarray(res1.state.sigmae)
    se8 = np.asarray(res8.state.sigmae)
    # Different RNG streams (like different MPI rank counts in the
    # reference) -> same laws, loose agreement after 20 iterations.
    h1 = sg1 / (sg1 + se1)
    h8 = sg8 / (sg8 + se8)
    np.testing.assert_allclose(h8, h1, atol=0.25)

    # Posterior means from both layouts correlate with the truth and with
    # each other.
    for t in range(res1.beta_mean.shape[0]):
        b1 = res1.beta_mean[t][: sim_small.m]
        b8 = res8.beta_mean[t]
        assert np.corrcoef(b1, b8)[0, 1] > 0.8

    # Artifact layouts identical between layouts.
    i1, d1 = read_history(str(tmp_path / "out1" / "test1.bet"), "f8")
    i8, d8 = read_history(str(tmp_path / "out8" / "test1.bet"), "f8")
    np.testing.assert_array_equal(i1, i8)
    assert d1.shape == d8.shape


@needs_8
@pytest.mark.parametrize("block_size,wave", [(1, 1), (4, 1), (8, 4)])
def test_sharded_sweep_matches_replay_oracle(sim_small, block_size, wave):
    """The sharded blocked sweep vs the NumPy D-rank replay oracle at exact
    cadence with injected randomness: B=1 reproduces
    the reference's per-marker Allgatherv protocol (bayes.cpp:500-553),
    B=4 the blocked throughput mode.  Discrete choices must match exactly.

    wave > 1 runs the production wave path under shard_map: a
    block-preserving shuffle and the per-shard Gram cache, against the
    oracle's wave replay.
    """
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from gmrm_tpu.io.bed import read_bed, unpack_codes, decode_planes
    from gmrm_tpu.io.grouping import read_dim, read_group_index
    from gmrm_tpu.io.phen import read_phen
    from gmrm_tpu.ops.decode import to_phase_planes, from_phase_planes
    from gmrm_tpu.parallel.mesh import (
        MARKER_AXIS, make_marker_mesh, marker_blocks,
    )
    from gmrm_tpu.ops.blockops import build_gram_cache
    from gmrm_tpu.parallel.runner import _static_specs
    from gmrm_tpu.sampler.gibbs import marker_sweep
    from gmrm_tpu.sampler.state import StaticInputs, pad_bed, pi_prior_from_cva
    from gmrm_tpu.config import Options
    from gmrm_tpu import oracle

    D = 8
    B = block_size
    n, m = read_dim(sim_small.dim)
    bed = read_bed(sim_small.bed, n, m)
    mb = bed.shape[1]
    ph = read_phen(sim_small.phens[0], n)
    napad = ph.na_vector_padded()
    codes = unpack_codes(bed, 4 * mb)
    a, b = decode_planes(codes)
    a, b = a * napad, b * napad
    mave, msig = oracle.marker_stats(a, b, napad, ph.nonas)

    opt = Options(group_mixture_file=sim_small.grm)
    opt.load_group_mixtures()
    cva, cvai = opt.cva, opt.cvai
    G, K = cva.shape
    gidx = read_group_index(sim_small.gri, G)
    mtotgrp = np.bincount(gidx, minlength=G)

    blocks_glob = marker_blocks(m, D)
    mm = max(ln for _, ln in blocks_glob)
    mps = -(-mm // B) * B                       # m_pad_shard
    nblocks = mps // B

    rng = np.random.default_rng(4711)
    sigmag0 = rng.uniform(0.05, 0.5, size=G)
    ost = oracle.OracleState(
        eps=ph.epsilon_padded().copy(),
        betas=np.zeros(m), comp=np.zeros(m, np.int64), acum=np.zeros(m),
        cass=np.zeros((G, K), np.int64), sigmag=sigmag0.copy(),
        sigmae=0.6, pi_est=pi_prior_from_cva(cva).copy(), mu=0.0,
        nonas=ph.nonas,
    )

    if wave > 1:                     # block-preserving, as the sampler
        perms = [(rng.permutation(nblocks)[:, None] * B
                  + np.stack([rng.permutation(B) for _ in range(nblocks)])
                  ).reshape(-1) for _ in range(D)]
    else:
        perms = [rng.permutation(mps) for _ in range(D)]
    us = [rng.uniform(size=mps) for _ in range(D)]
    zs = [rng.normal(size=mps) for _ in range(D)]

    oracle.sweep_replay_sharded(
        ost, a, b, napad, mave, msig, gidx, cva, cvai,
        blocks_glob, perms, us, zs, B, n, wave=wave,
    )

    # --- device side: same inputs laid out as D padded shards ------------
    mesh = make_marker_mesh(D)
    bed_sh = np.concatenate(
        [pad_bed(bed[s:s + ln], mps) for s, ln in blocks_glob], axis=0)
    def shardpad(x, fill=0.0):
        out = np.full(D * mps, fill, dtype=np.float64)
        for i, (s, ln) in enumerate(blocks_glob):
            out[i * mps:i * mps + ln] = x[s:s + ln]
        return out

    f32 = jnp.float32
    static = StaticInputs(
        bed=jnp.asarray(bed_sh),
        na=jnp.asarray(to_phase_planes(napad)[None], f32),
        mave=jnp.asarray(shardpad(mave)[None], f32),
        msig=jnp.asarray(shardpad(msig)[None], f32),
        group_of=jnp.asarray(shardpad(gidx).astype(np.int32)),
        mtotgrp=jnp.asarray(mtotgrp.astype(np.int32)),
        nonas=jnp.asarray([ph.nonas], f32),
        cva=jnp.asarray(cva, f32), cvai=jnp.asarray(cvai, f32),
        n_total=jnp.asarray(float(n), f32),
        m_local=jnp.asarray([ln for _, ln in blocks_glob], np.int32),
    )
    if wave > 1:
        cache_fn = jax.jit(jax.shard_map(
            lambda bb, nn: build_gram_cache(bb, nn, block_size=B,
                                            shared_na=True),
            mesh=mesh, in_specs=(P(MARKER_AXIS), P()),
            out_specs=P(MARKER_AXIS)))
        static = static.replace(gram_cache=cache_fn(static.bed, static.na))

    blocks_dev = jnp.asarray(
        np.stack([p.reshape(nblocks, B) for p in perms])
        .reshape(D * nblocks, B).astype(np.int32))
    u_dev = jnp.asarray(
        np.stack([u.reshape(nblocks, 1, B) for u in us])
        .reshape(D * nblocks, 1, B), f32)
    z_dev = jnp.asarray(
        np.stack([z.reshape(nblocks, 1, B) for z in zs])
        .reshape(D * nblocks, 1, B), f32)

    def sweep(eps, betas, comp, acum, sigmag, sigmae, pi_est, static,
              blocks, u_all, z_all):
        eps, betas, comp, acum, cass_local = marker_sweep(
            eps, betas, comp, acum, sigmag, sigmae, pi_est,
            static, blocks, u_all, z_all, axis_name=MARKER_AXIS,
            shared_na=True, wave_size=wave)
        return eps, betas, comp, acum, jax.lax.psum(cass_local, MARKER_AXIS)

    sh = P(MARKER_AXIS)
    sh2 = P(None, MARKER_AXIS)
    rep = P()
    sweep_sh = jax.jit(jax.shard_map(
        sweep, mesh=mesh,
        in_specs=(rep, sh2, sh2, sh2, rep, rep, rep,
                  _static_specs(wave > 1), sh, sh, sh),
        out_specs=(rep, sh2, sh2, sh2, rep),
    ))
    eps_j, betas_j, comp_j, acum_j, cass_j = sweep_sh(
        jnp.asarray(to_phase_planes(ost.eps * 0 + ph.epsilon_padded())[None],
                    f32),
        jnp.zeros((1, D * mps), f32), jnp.zeros((1, D * mps), jnp.int32),
        jnp.zeros((1, D * mps), f32),
        jnp.asarray(sigmag0[None], f32), jnp.asarray([0.6], f32),
        jnp.asarray(pi_prior_from_cva(cva)[None], f32),
        static, blocks_dev, u_dev, z_dev,
    )

    def gather(x):
        x = np.asarray(x)[0]
        return np.concatenate([x[i * mps:i * mps + ln]
                               for i, (s, ln) in enumerate(blocks_glob)])

    np.testing.assert_array_equal(gather(comp_j), ost.comp,
                                  err_msg="component choices diverged")
    np.testing.assert_array_equal(np.asarray(cass_j)[0], ost.cass)
    np.testing.assert_allclose(gather(betas_j), ost.betas,
                               rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(gather(acum_j), ost.acum,
                               rtol=5e-3, atol=5e-4)
    eps_std = from_phase_planes(np.asarray(eps_j))[0]
    np.testing.assert_allclose(eps_std, ost.eps, rtol=5e-3, atol=2e-3)


@needs_8
def test_sharded_wave_full_run(sim_medium, tmp_path):
    """Full sharded training through the production configuration — wave
    size > 1 with the per-shard Gram cache under shard_map.  Checks the
    combination compiles, executes, and produces a statistically sane
    short chain vs the exact-serial sharded path."""
    from gmrm_tpu.parallel.runner import run_training_sharded

    opt_p = _opts(sim_medium, str(tmp_path / "outp"), iterations=15,
                  wave_size=4)
    res_p = run_training_sharded(opt_p, verbose=False)

    opt_x = _opts(sim_medium, str(tmp_path / "outx"), iterations=15)
    res_x = run_training_sharded(opt_x, verbose=False)

    sg_p = np.asarray(res_p.state.sigmag).sum(axis=1)
    se_p = np.asarray(res_p.state.sigmae)
    sg_x = np.asarray(res_x.state.sigmag).sum(axis=1)
    se_x = np.asarray(res_x.state.sigmae)
    assert np.all(np.isfinite(sg_p)) and np.all(np.isfinite(se_p))
    h_p = sg_p / (sg_p + se_p)
    h_x = sg_x / (sg_x + se_x)
    # Different within-block cadence (wave relaxation) -> same laws; loose
    # agreement after a short chain, exactly like the rank-count contract.
    np.testing.assert_allclose(h_p, h_x, atol=0.3)


@needs_8
def test_dryrun_multichip():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "graft_entry",
        os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "__graft_entry__.py"),
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.dryrun_multichip(8)


def test_entry_compiles():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "graft_entry2",
        os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "__graft_entry__.py"),
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    fn, args = mod.entry()
    out = jax.jit(fn)(*args)
    jax.block_until_ready(out)


@needs_8
def test_verbosity_gates_detail_and_sync_split(sim_tiny, tmp_path, capsys):
    """--verbosity wiring: level 0 suppresses the
    per-iteration timing + NA detail; level >= 1 restores the iteration
    print with the reference's "with sync time" split
    (bayes.cpp:653-655); level >= 2 restores per-phen NA counts
    (phenotype.cpp:610-627)."""
    from gmrm_tpu.runner import run_training
    from gmrm_tpu.parallel.runner import run_training_sharded

    o0 = _opts(sim_tiny, str(tmp_path / "v0"), iterations=2, block_size=8,
               verbosity=0, output_thin_rate=1)
    run_training(o0, verbose=True)
    out0 = capsys.readouterr().out
    assert "total proc time" not in out0
    assert "NAs" not in out0
    assert "RESULT" in out0          # thin-boundary chain lines stay

    o2 = _opts(sim_tiny, str(tmp_path / "v2"), iterations=2, block_size=8,
               verbosity=2, output_thin_rate=1)
    run_training(o2, verbose=True)
    out2 = capsys.readouterr().out
    assert "total proc time" in out2
    assert "non-NAs" in out2

    os1 = _opts(sim_tiny, str(tmp_path / "vs1"), iterations=2, block_size=8,
                verbosity=1)
    run_training_sharded(os1, verbose=True)
    outs = capsys.readouterr().out
    assert "with sync time =" in outs
    assert "measured collective sync cost" in outs


def test_sync_split_in_step_differential(sim_tiny, tmp_path, capsys):
    """verbosity >= 2 on the sharded runner measures the sync split
    differentially IN-STEP: the real jitted step
    vs an identically-gated compile with the collectives elided, on
    cloned state.  The measurement must not perturb the chain."""
    from gmrm_tpu.parallel.runner import run_training_sharded

    o1 = _opts(sim_tiny, str(tmp_path / "sd1"), iterations=3, block_size=8,
               verbosity=2, output_thin_rate=1)
    r1 = run_training_sharded(o1, verbose=True)
    outs = capsys.readouterr().out
    assert "measured in-step sync cost" in outs
    assert "in-step differential" in outs

    o2 = _opts(sim_tiny, str(tmp_path / "sd2"), iterations=3, block_size=8,
               verbosity=0, output_thin_rate=1)
    r2 = run_training_sharded(o2, verbose=False)
    np.testing.assert_array_equal(
        np.asarray(jax.device_get(r1.state.sigmag)),
        np.asarray(jax.device_get(r2.state.sigmag)))


@needs_8
def test_sharded_cached_gram_matches_recompute(sim_small):
    """The per-shard Gram cache under shard_map: the
    cached-Gram sharded sweep must reproduce the recompute sharded sweep
    exactly (same block-preserving shuffle, same per-block psum cadence)
    — discrete choices equal, continuous state to f32 tolerance."""
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from gmrm_tpu.io.bed import read_bed
    from gmrm_tpu.io.grouping import read_dim, read_group_index
    from gmrm_tpu.io.phen import read_phen
    from gmrm_tpu.ops.decode import to_phase_planes
    from gmrm_tpu.ops.blockops import build_gram_cache
    from gmrm_tpu.parallel.mesh import (
        MARKER_AXIS, make_marker_mesh, marker_blocks,
    )
    from gmrm_tpu.parallel.runner import _static_specs
    from gmrm_tpu.sampler.gibbs import marker_sweep
    from gmrm_tpu.sampler.state import StaticInputs, pad_bed, pi_prior_from_cva

    D, B, W = 8, 8, 4
    n, m = read_dim(sim_small.dim)
    bed = read_bed(sim_small.bed, n, m)
    ph = read_phen(sim_small.phens[0], n)
    napad = ph.na_vector_padded()

    opt = Options(group_mixture_file=sim_small.grm)
    opt.load_group_mixtures()
    cva, cvai = opt.cva, opt.cvai
    G, K = cva.shape
    gidx = read_group_index(sim_small.gri, G)
    mtotgrp = np.bincount(gidx, minlength=G)

    blocks_glob = marker_blocks(m, D)
    mm = max(ln for _, ln in blocks_glob)
    mps = -(-mm // B) * B
    nblocks = mps // B

    mesh = make_marker_mesh(D)
    mb, mb_pad = bed.shape[1], 512              # runner lane_pad layout
    bed_sh = np.concatenate(
        [pad_bed(bed[s:s + ln], mps, mb_pad) for s, ln in blocks_glob],
        axis=0)

    def shardpad(x, fill=0.0):
        out = np.full(D * mps, fill, dtype=np.float64)
        for i, (s, ln) in enumerate(blocks_glob):
            out[i * mps:i * mps + ln] = x[s:s + ln]
        return out

    def planes(vec):
        out = np.zeros((1, 4, mb_pad))
        out[0, :, :mb] = to_phase_planes(vec)
        return jnp.asarray(out, jnp.float32)

    f32 = jnp.float32
    na_dev = planes(napad)
    bed_dev = jnp.asarray(bed_sh)

    # marker stats from the oracle (exactness is not the point here; the
    # SAME stats feed both variants)
    from gmrm_tpu.io.bed import unpack_codes, decode_planes
    from gmrm_tpu import oracle
    codes = unpack_codes(bed, 4 * bed.shape[1])
    a, b = decode_planes(codes)
    a, b = a * napad, b * napad
    mave, msig = oracle.marker_stats(a, b, napad, ph.nonas)

    # per-shard gram cache via the production shard_map plumbing
    cache_fn = jax.jit(jax.shard_map(
        lambda bb, nn: build_gram_cache(bb, nn, block_size=B,
                                        shared_na=True),
        mesh=mesh, in_specs=(P(MARKER_AXIS), P()),
        out_specs=P(MARKER_AXIS)))
    gram_cache = cache_fn(bed_dev, na_dev)

    def make_static(cache):
        return StaticInputs(
            gram_cache=cache,
            bed=bed_dev, na=na_dev,
            mave=jnp.asarray(shardpad(mave)[None], f32),
            msig=jnp.asarray(shardpad(msig)[None], f32),
            group_of=jnp.asarray(shardpad(gidx).astype(np.int32)),
            mtotgrp=jnp.asarray(mtotgrp.astype(np.int32)),
            nonas=jnp.asarray([ph.nonas], f32),
            cva=jnp.asarray(cva, f32), cvai=jnp.asarray(cvai, f32),
            n_total=jnp.asarray(float(n), f32),
            m_local=jnp.asarray([ln for _, ln in blocks_glob], np.int32),
        )

    rng = np.random.default_rng(99)
    pi_b = np.stack([rng.permutation(nblocks) for _ in range(D)])
    win = np.stack([np.stack([rng.permutation(B) for _ in range(nblocks)])
                    for _ in range(D)])
    perm = (pi_b[:, :, None] * B + win).reshape(D * nblocks, B)
    u_dev = jnp.asarray(rng.uniform(size=(D * nblocks, 1, B)), f32)
    z_dev = jnp.asarray(rng.normal(size=(D * nblocks, 1, B)), f32)
    sigmag0 = rng.uniform(0.05, 0.5, size=G)

    def sweep(eps, betas, comp, acum, sigmag, sigmae, pi_est, static,
              blocks, u_all, z_all):
        eps, betas, comp, acum, cass_local = marker_sweep(
            eps, betas, comp, acum, sigmag, sigmae, pi_est,
            static, blocks, u_all, z_all, axis_name=MARKER_AXIS,
            shared_na=True, wave_size=W)
        return (eps, betas, comp, acum,
                jax.lax.psum(cass_local, MARKER_AXIS))

    sh, sh2, rep = P(MARKER_AXIS), P(None, MARKER_AXIS), P()
    outs = {}
    # The recompute and cached-Gram sharded sweeps must agree.
    for name, cache in (("recompute", None), ("cached", gram_cache)):
        sweep_sh = jax.jit(jax.shard_map(
            sweep, mesh=mesh,
            in_specs=(rep, sh2, sh2, sh2, rep, rep, rep,
                      _static_specs(cache is not None), sh, sh, sh),
            out_specs=(rep, sh2, sh2, sh2, rep),
        ))
        outs[name] = jax.device_get(sweep_sh(
            planes(ph.epsilon_padded()),
            jnp.zeros((1, D * mps), f32),
            jnp.zeros((1, D * mps), jnp.int32),
            jnp.zeros((1, D * mps), f32),
            jnp.asarray(sigmag0[None], f32), jnp.asarray([0.6], f32),
            jnp.asarray(pi_prior_from_cva(cva)[None], f32),
            make_static(cache),
            jnp.asarray(perm.astype(np.int32)), u_dev, z_dev,
        ))

    (e_a, b_a, c_a, a_a, k_a) = outs["recompute"]
    (e_b, b_b, c_b, a_b, k_b) = outs["cached"]
    np.testing.assert_array_equal(np.asarray(c_b), np.asarray(c_a))
    np.testing.assert_array_equal(np.asarray(k_b), np.asarray(k_a))
    np.testing.assert_allclose(np.asarray(b_b), np.asarray(b_a),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(e_b), np.asarray(e_a),
                               rtol=1e-4, atol=1e-5)
