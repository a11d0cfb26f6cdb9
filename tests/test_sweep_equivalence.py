"""THE correctness anchor: the blocked-Gram sweep must reproduce the
serial per-marker recursion of the reference *exactly* (same draws ->
same chain), up to float32 tolerance.

Both implementations consume identical injected randomness (perm, u, z), so
any algorithmic divergence — Gram correction terms, overflow guards, adaV
handling, NA masking, padding — shows up as a hard mismatch.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from gmrm_tpu.config import Options
from gmrm_tpu.io.bed import read_bed, unpack_codes, decode_planes
from gmrm_tpu.io.grouping import read_dim, read_group_index
from gmrm_tpu.io.phen import read_phen
from gmrm_tpu.ops.decode import to_phase_planes, from_phase_planes
from gmrm_tpu.sampler.gibbs import marker_sweep
from gmrm_tpu.sampler.state import StaticInputs, pad_bed, pi_prior_from_cva
from gmrm_tpu import oracle


def _setup(sim, block_size, trait=0, sigmag0=None, n_sweeps=1, seed=99):
    n, m = read_dim(sim.dim)
    bed = read_bed(sim.bed, n, m)
    mb = bed.shape[1]
    ph = read_phen(sim.phens[trait], n)
    napad = ph.na_vector_padded()

    codes = unpack_codes(bed, 4 * mb)
    a, b = decode_planes(codes)
    a, b = a * napad, b * napad          # zero the byte-padding tail + NAs
    mave, msig = oracle.marker_stats(a, b, napad, ph.nonas)

    opt = Options(group_mixture_file=sim.grm)
    opt.load_group_mixtures()
    cva, cvai = opt.cva, opt.cvai
    G, K = cva.shape
    gidx = read_group_index(sim.gri, G)
    mtotgrp = np.bincount(gidx, minlength=G)

    rng = np.random.default_rng(seed)
    if sigmag0 is None:
        sigmag0 = rng.uniform(0.05, 0.5, size=G)
    sigmae0 = 0.6
    pi0 = pi_prior_from_cva(cva)

    # Oracle state (float64).
    ost = oracle.OracleState(
        eps=ph.epsilon_padded().copy(),
        betas=np.zeros(m), comp=np.zeros(m, np.int64), acum=np.zeros(m),
        cass=np.zeros((G, K), np.int64), sigmag=sigmag0.copy(),
        sigmae=sigmae0, pi_est=pi0.copy(), mu=0.0, nonas=ph.nonas,
    )

    # Device-side static inputs (mirrors runner.build_static but with the
    # oracle's float64 stats cast in, so both paths share identical stats).
    B = block_size
    m_pad = -(-m // B) * B
    bed_p = pad_bed(bed, m_pad)
    group_p = np.zeros(m_pad, np.int32)
    group_p[:m] = gidx
    static = StaticInputs(
        bed=jnp.asarray(bed_p),
        na=jnp.asarray(to_phase_planes(napad)[None], jnp.float32),
        mave=jnp.asarray(np.pad(mave, (0, m_pad - m))[None], jnp.float32),
        msig=jnp.asarray(np.pad(msig, (0, m_pad - m))[None], jnp.float32),
        group_of=jnp.asarray(group_p),
        mtotgrp=jnp.asarray(mtotgrp.astype(np.int32)),
        nonas=jnp.asarray([ph.nonas], jnp.float32),
        cva=jnp.asarray(cva, jnp.float32),
        cvai=jnp.asarray(cvai, jnp.float32),
        n_total=jnp.asarray(float(n), jnp.float32),
        m_local=jnp.asarray(m, jnp.int32),
    )
    return (n, m, m_pad, B, a, b, napad, mave, msig, gidx, cva, cvai,
            ost, static, rng)


@pytest.mark.parametrize("block_size", [8, 32, 96])
def test_blocked_sweep_matches_serial_oracle(sim_small, block_size):
    (n, m, m_pad, B, a, b, napad, mave, msig, gidx, cva, cvai,
     ost, static, rng) = _setup(sim_small, block_size)

    # Run 2 sweeps to also exercise the beta_old != 0 path.
    eps_j = jnp.asarray(to_phase_planes(ost.eps)[None], jnp.float32)
    betas_j = jnp.zeros((1, m_pad), jnp.float32)
    comp_j = jnp.zeros((1, m_pad), jnp.int32)
    acum_j = jnp.zeros((1, m_pad), jnp.float32)

    for sweep in range(2):
        perm = rng.permutation(m)
        u = rng.uniform(size=m)
        z = rng.normal(size=m)

        oracle.sweep_serial(ost, a, b, napad, mave, msig, gidx, cva, cvai,
                            perm, u, z, n)

        perm_pad = np.concatenate([perm, np.arange(m, m_pad)])
        nblocks = m_pad // B
        blocks = jnp.asarray(perm_pad.reshape(nblocks, B))
        u_pad = np.zeros(m_pad); u_pad[:m] = u
        z_pad = np.zeros(m_pad); z_pad[:m] = z
        u_all = jnp.asarray(u_pad.reshape(nblocks, 1, B), jnp.float32)
        z_all = jnp.asarray(z_pad.reshape(nblocks, 1, B), jnp.float32)

        eps_j, betas_j, comp_j, acum_j, cass_j = marker_sweep(
            eps_j, betas_j, comp_j, acum_j,
            jnp.asarray(ost.sigmag[None], jnp.float32),
            jnp.asarray([ost.sigmae], jnp.float32),
            jnp.asarray(ost.pi_est[None], jnp.float32),
            static, blocks, u_all, z_all,
        )

        # Component choices must agree EXACTLY (they're discrete; a float
        # wobble at a decision boundary would flip them — tolerances on the
        # continuous quantities below would catch systematic issues anyway).
        np.testing.assert_array_equal(
            np.asarray(comp_j)[0, :m], ost.comp,
            err_msg=f"sweep {sweep}: component assignments diverged",
        )
        np.testing.assert_allclose(
            np.asarray(betas_j)[0, :m], ost.betas, rtol=2e-3, atol=2e-4,
            err_msg=f"sweep {sweep}: betas diverged",
        )
        np.testing.assert_allclose(
            np.asarray(acum_j)[0, :m], ost.acum, rtol=5e-3, atol=5e-4,
        )
        np.testing.assert_array_equal(np.asarray(cass_j)[0], ost.cass)
        eps_std = from_phase_planes(np.asarray(eps_j))[0]
        np.testing.assert_allclose(eps_std, ost.eps, rtol=5e-3, atol=2e-3)
        # cass resets every sweep in the real iteration; mirror that.
        ost.cass[:] = 0


def test_adav_group_skipped(sim_small):
    """A group with sigmag == 0 must zero betas without touching eps/cass
    (reference bayes.cpp:396-400)."""
    (n, m, m_pad, B, a, b, napad, mave, msig, gidx, cva, cvai,
     ost, static, rng) = _setup(sim_small, 32, sigmag0=np.array([0.0, 0.3]))

    perm = rng.permutation(m)
    u = rng.uniform(size=m)
    z = rng.normal(size=m)
    oracle.sweep_serial(ost, a, b, napad, mave, msig, gidx, cva, cvai,
                        perm, u, z, n)

    perm_pad = np.concatenate([perm, np.arange(m, m_pad)])
    nblocks = m_pad // B
    u_pad = np.zeros(m_pad); u_pad[:m] = u
    z_pad = np.zeros(m_pad); z_pad[:m] = z
    eps0 = _initial_eps(sim_small)
    eps_j, betas_j, comp_j, acum_j, cass_j = marker_sweep(
        jnp.asarray(to_phase_planes(eps0)[None], jnp.float32),
        jnp.zeros((1, m_pad), jnp.float32),
        jnp.zeros((1, m_pad), jnp.int32),
        jnp.zeros((1, m_pad), jnp.float32),
        jnp.asarray(ost.sigmag[None], jnp.float32),
        jnp.asarray([0.6], jnp.float32),
        jnp.asarray(ost.pi_est[None], jnp.float32),
        static, jnp.asarray(perm_pad.reshape(nblocks, B)),
        jnp.asarray(u_pad.reshape(nblocks, 1, B), jnp.float32),
        jnp.asarray(z_pad.reshape(nblocks, 1, B), jnp.float32),
    )
    g0 = gidx == 0
    np.testing.assert_array_equal(np.asarray(betas_j)[0, :m][g0], 0.0)
    np.testing.assert_allclose(np.asarray(acum_j)[0, :m][g0], 1.0)
    assert np.asarray(cass_j)[0, 0].sum() == 0          # group 0 untouched
    np.testing.assert_array_equal(np.asarray(comp_j)[0, :m], ost.comp)


def _initial_eps(sim):
    n, _ = read_dim(sim.dim)
    return read_phen(sim.phens[0], n).epsilon_padded()


@pytest.fixture(scope="module", params=["shared_na", "per_trait_na"])
def sim_wave(request, tmp_path_factory):
    from gmrm_tpu.io.sim import simulate
    out = tmp_path_factory.mktemp(f"sim_wave_{request.param}")
    return request.param, simulate(
        str(out), n=400, m=250, n_traits=4, n_causal=60, h2=0.5,
        n_groups=2, na_rate=0.0 if request.param == "shared_na" else 0.03,
        seed=20261016, mixtures=np.array([0.0, 0.001, 0.01, 0.05]))


@pytest.mark.parametrize("T", [1, 4])
def test_wave_sweep_matches_wave_oracle(sim_wave, T):
    """The production sweep (B=128, W=32, block-preserving shuffle,
    cached Gram) vs the float64 wave replay oracle, trait by trait, with
    identical injected randomness — over shared and per-trait NA masks."""
    from gmrm_tpu.ops.blockops import build_gram_cache
    kind, sim = sim_wave
    B, W = 128, 32
    n, m = read_dim(sim.dim)
    bed = read_bed(sim.bed, n, m)
    a0, b0 = decode_planes(unpack_codes(bed, 4 * bed.shape[1]))
    opt = Options(group_mixture_file=sim.grm)
    opt.load_group_mixtures()
    cva, cvai = opt.cva, opt.cvai
    G, K = cva.shape
    gidx = read_group_index(sim.gri, G)
    m_pad = -(-m // B) * B
    nblocks = m_pad // B
    rng = np.random.default_rng(5)

    osts, planes = [], []
    for t in range(T):
        ph = read_phen(sim.phens[t], n)
        napad = ph.na_vector_padded()
        a, b = a0 * napad, b0 * napad
        mave, msig = oracle.marker_stats(a, b, napad, ph.nonas)
        osts.append(oracle.OracleState(
            eps=ph.epsilon_padded().copy(), betas=np.zeros(m),
            comp=np.zeros(m, np.int64), acum=np.zeros(m),
            cass=np.zeros((G, K), np.int64),
            sigmag=rng.uniform(0.05, 0.5, size=G), sigmae=0.6,
            pi_est=pi_prior_from_cva(cva).copy(), mu=0.0, nonas=ph.nonas))
        planes.append((a, b, napad, mave, msig))

    shared_na = kind == "shared_na"
    f32 = jnp.float32
    na = jnp.asarray(np.stack([to_phase_planes(p[2]) for p in planes]), f32)
    bed_p = jnp.asarray(pad_bed(bed, m_pad))
    static = StaticInputs(
        bed=bed_p, na=na,
        mave=jnp.asarray(np.stack([np.pad(p[3], (0, m_pad - m))
                                   for p in planes]), f32),
        msig=jnp.asarray(np.stack([np.pad(p[4], (0, m_pad - m))
                                   for p in planes]), f32),
        group_of=jnp.asarray(np.pad(gidx, (0, m_pad - m)).astype(np.int32)),
        mtotgrp=jnp.asarray(np.bincount(gidx, minlength=G).astype(np.int32)),
        nonas=jnp.asarray([o.nonas for o in osts], f32),
        cva=jnp.asarray(cva, f32), cvai=jnp.asarray(cvai, f32),
        n_total=jnp.asarray(float(n), f32),
        m_local=jnp.asarray(m, jnp.int32),
        gram_cache=build_gram_cache(bed_p, na, block_size=B,
                                    shared_na=shared_na),
    )
    eps_j = jnp.asarray(np.stack([to_phase_planes(o.eps) for o in osts]),
                        f32)
    betas_j = jnp.zeros((T, m_pad), f32)
    comp_j = jnp.zeros((T, m_pad), jnp.int32)
    acum_j = jnp.zeros((T, m_pad), f32)

    for sweep in range(2):                # the 2nd sweep has beta_old != 0
        perm = (rng.permutation(nblocks)[:, None] * B
                + np.stack([rng.permutation(B) for _ in range(nblocks)]))
        u = rng.uniform(size=(nblocks, T, B))
        z = rng.normal(size=(nblocks, T, B))
        for t, (o, (a, b, napad, mave, msig)) in enumerate(zip(osts,
                                                               planes)):
            o.cass[:] = 0
            oracle.sweep_replay_sharded(
                o, a, b, napad, mave, msig, gidx, cva, cvai, [(0, m)],
                [perm.reshape(-1)], [u[:, t].reshape(-1)],
                [z[:, t].reshape(-1)], B, n, wave=W)

        eps_j, betas_j, comp_j, acum_j, cass_j = marker_sweep(
            eps_j, betas_j, comp_j, acum_j,
            jnp.asarray(np.stack([o.sigmag for o in osts]), f32),
            jnp.asarray([o.sigmae for o in osts], f32),
            jnp.asarray(np.stack([o.pi_est for o in osts]), f32),
            static, jnp.asarray(perm.astype(np.int32)),
            jnp.asarray(u, f32), jnp.asarray(z, f32),
            shared_na=shared_na, wave_size=W)

        for t, o in enumerate(osts):
            msg = f"{kind} T={T} trait {t} sweep {sweep}"
            np.testing.assert_array_equal(np.asarray(comp_j)[t, :m], o.comp,
                                          err_msg=msg)
            np.testing.assert_array_equal(np.asarray(cass_j)[t], o.cass,
                                          err_msg=msg)
            np.testing.assert_allclose(np.asarray(betas_j)[t, :m], o.betas,
                                       rtol=2e-3, atol=2e-4, err_msg=msg)
            np.testing.assert_allclose(np.asarray(acum_j)[t, :m], o.acum,
                                       rtol=5e-3, atol=5e-4, err_msg=msg)
            np.testing.assert_allclose(
                from_phase_planes(np.asarray(eps_j))[t], o.eps,
                rtol=5e-3, atol=2e-3, err_msg=msg)
