"""NumPy port-of-record of the reference sampler math (float64, serial).

This is the correctness anchor: a direct, unoptimized transcription of the
marker sweep of ``/root/reference/src/bayes.cpp:375-553`` (dot product at
``bayes.cpp:709-770``, rank-1 residual update at ``src/phenotype.cpp:326-393``,
mixture-component walk incl. the |dlogl| > 700 overflow guards at
``bayes.cpp:413-477``) and the hyperparameter block (``bayes.cpp:562-651``).

All randomness is *injected* (pre-drawn arrays), so the device's
blocked-Gram sweep can be compared against this serial recursion
bit-for-bit up to float tolerance.  Used by tests, by ``chip_smoke.py``'s
gates and as the CPU throughput baseline proxy.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from gmrm_tpu.config import V0E, S02E, V0G, S02G


def marker_stats(a: np.ndarray, b: np.ndarray, na: np.ndarray, nonas: int):
    """Per-marker mean/inverse-sd over observed entries.

    Reference compute_markers_statistics (src/phenotype.cpp:466-556):
    mave = sum(a*na)/sum(b*na); msig = 1/sqrt(sum(((a-mave)*b*na)^2)/(nonas-1)).
    a, b: (M, Np) decoded planes; na: (Np,) 0/1 phenotype mask.
    """
    suma = (a * na).sum(axis=1)
    sumb = (b * na).sum(axis=1)
    mave = suma / sumb
    xc = (a - mave[:, None]) * b * na
    msig = 1.0 / np.sqrt((xc ** 2).sum(axis=1) / (nonas - 1.0))
    return mave, msig


@dataclass
class OracleState:
    """Mutable per-trait sampler state (the reference Phenotype's fields)."""
    eps: np.ndarray            # (Np,) residual, 0 at NAs
    betas: np.ndarray          # (M,)
    comp: np.ndarray           # (M,) int
    acum: np.ndarray           # (M,)
    cass: np.ndarray           # (G, K) int
    sigmag: np.ndarray         # (G,)
    sigmae: float
    pi_est: np.ndarray         # (G, K)
    mu: float
    nonas: int
    epssum: float = 0.0        # reference quirk: never updated (phenotype.hpp:52)


def draw_marker(num, g, sigmag, sigmae, pi_est, cva, cvai, nonas, n_total,
                p, zz):
    """Component walk and effect draw for one marker of a live group
    (bayes.cpp:413-477).  ``num`` = x_j^T eps + beta_old*(nonas-1)
    (bayes.cpp:418-421), ``p`` the uniform, ``zz`` the std normal.
    Returns (beta, comp, acum)."""
    K = pi_est.shape[1]
    sige_g = sigmae / sigmag[g]
    sigg_e = 1.0 / sige_g
    inv2sige = 1.0 / (2.0 * sigmae)
    denom = (n_total - 1.0) + sige_g * cvai[g, 1:K]        # (K-1,)
    muk = np.zeros(K)
    muk[1:] = num / denom
    logl = np.log(pi_est[g]).copy()
    logl[1:] += (
        -0.5 * np.log(sigg_e * (nonas - 1.0) * cva[g, 1:K] + 1.0)
        + muk[1:] * num * inv2sige
    )
    if np.any(np.abs(logl - logl[0]) > 700.0):
        acum = 0.0
    else:
        acum = 1.0 / np.exp(logl - logl[0]).sum()
    for i in range(K):
        if p <= acum or i == K - 1:
            if i == 0:
                return 0.0, 0, acum
            return muk[i] + np.sqrt(sigmae / denom[i - 1]) * zz, i, acum
        zero_inc = np.any(np.abs(logl[i + 1:] - logl[i + 1]) > 700.0)
        if not zero_inc:
            acum += 1.0 / np.exp(logl - logl[i + 1]).sum()


def sweep_serial(
    state: OracleState,
    a: np.ndarray,             # (M, Np) dosage plane
    b: np.ndarray,             # (M, Np) present plane
    na: np.ndarray,            # (Np,) phenotype mask
    mave: np.ndarray,
    msig: np.ndarray,
    group_of: np.ndarray,      # (M,) group id per local marker
    cva: np.ndarray,           # (G, K)
    cvai: np.ndarray,          # (G, K)
    perm: np.ndarray,          # (M,) processing order (shuffled local indices)
    u: np.ndarray,             # (M,) uniforms, indexed by processing slot
    z: np.ndarray,             # (M,) std normals, indexed by processing slot
    n_total: int,              # N (the reference's dims N, not nonas)
) -> None:
    """One full marker sweep, updating state in place.

    Mirrors the per-marker loop bayes.cpp:375-553 for a single rank (the
    multi-rank replay protocol collapses to in-place updates).
    """
    sweep_replay_sharded(state, a, b, na, mave, msig, group_of, cva, cvai,
                         [(0, perm.shape[0])], [perm], [u], [z],
                         perm.shape[0], n_total)


def sweep_replay_sharded(
    state: OracleState,
    a: np.ndarray,             # (M, Np) dosage plane (global)
    b: np.ndarray,             # (M, Np) present plane
    na: np.ndarray,            # (Np,) phenotype mask
    mave: np.ndarray,          # (M,)
    msig: np.ndarray,          # (M,)
    group_of: np.ndarray,      # (M,) global
    cva: np.ndarray,
    cvai: np.ndarray,
    shard_blocks,              # [(start, len)] global marker block per shard
    perms,                     # per shard: (m_pad_shard,) local slot order
    us, zs,                    # per shard: (m_pad_shard,) slot-indexed draws
    block_size: int,
    n_total: int,
    wave: int = 1,
) -> None:
    """D-rank replay of the blocked sharded sweep, updating state in place.

    The sharded sampler's protocol (gmrm_tpu.parallel.runner /
    sampler.gibbs): at each block step every shard runs its next
    ``block_size`` markers against the residual as of the block start
    (its own within-block moves visible through a local copy), then all
    shards' residual deltas merge — the psum that replaces the reference's
    per-marker MPI_Allgatherv replay (bayes.cpp:500-553).  block_size = 1
    reproduces the reference's per-marker cadence exactly.

    Within a block, markers run in waves of ``wave`` slots: each draws
    against the shard's residual as of its wave start, blind to the
    wave's other moves (sampler.scan.block_scan_wave); ``wave`` = 1 is the
    exact serial recursion.

    Slots >= the shard's real marker count are idle pads (the reference's
    Mm idle steps, bayes.cpp:375-382).
    """
    m_pad_shard = perms[0].shape[0]
    assert m_pad_shard % block_size == 0 and block_size % wave == 0

    for k in range(m_pad_shard // block_size):
        deps_total = np.zeros_like(state.eps)
        for d, (start, ln) in enumerate(shard_blocks):
            eps_d = state.eps.copy()
            for slot in range(k * block_size, (k + 1) * block_size):
                if slot % wave == 0:
                    # W = 1 reads the live residual (in-place updates).
                    eps_w = eps_d if wave == 1 else eps_d.copy()
                jl = int(perms[d][slot])
                if jl >= ln:
                    continue                      # pad slot: idle step
                j = start + jl
                g = int(group_of[j])
                if state.sigmag[g] == 0.0:
                    # adaV: group variance pinned to zero -> zero the marker
                    # silently (bayes.cpp:396-400; epsilon is NOT updated and
                    # cass/comp are NOT touched).
                    state.acum[j] = 1.0
                    state.betas[j] = 0.0
                    continue
                beta_old = state.betas[j]
                # num = x_j^T eps; x_j = msig*(a - mave*b), eps already 0 at
                # NAs (bayes.cpp:709-770).
                num = msig[j] * (a[j] @ eps_w - mave[j] * (b[j] @ eps_w))
                num += beta_old * (state.nonas - 1.0)
                beta, comp, acum = draw_marker(
                    num, g, state.sigmag, state.sigmae, state.pi_est, cva,
                    cvai, state.nonas, n_total, us[d][slot], zs[d][slot])
                state.betas[j], state.comp[j], state.acum[j] = beta, comp, acum
                state.cass[g, comp] += 1
                dbeta = beta_old - beta
                if dbeta != 0.0:
                    # eps += dbeta * msig * (a - mave*b) * na
                    # (phenotype.cpp:326-393)
                    eps_d += dbeta * msig[j] * (a[j] - mave[j] * b[j]) * na
            deps_total += eps_d - state.eps
        state.eps += deps_total


def wave_scan(c, gs, beta_old, comp_old, acum_old, grp, valid, u, z,
              sigmag, sigmae, pi_est, cva, cvai, nonas, n_total, wave):
    """Float64 reference of sampler.scan.block_scan_wave on one block.

    c (T, B) msig-scaled x^T eps at block start; gs (T, B, B) scaled Gram;
    the other arguments as block_scan's.  Markers run in waves of
    ``wave``: each sees the Gram corrections of all earlier waves, none
    of its own wave's (``wave`` = 1: the exact serial recursion).
    Returns (dbeta, beta, comp, acum, cass_inc) as float64 / int64 arrays.
    """
    c, gs = np.asarray(c, np.float64), np.asarray(gs, np.float64)
    beta = np.array(beta_old, np.float64)
    comp = np.array(comp_old, np.int64)
    acum = np.array(acum_old, np.float64)
    grp, valid = np.asarray(grp), np.asarray(valid)
    u, z = np.asarray(u, np.float64), np.asarray(z, np.float64)
    sigmag = np.asarray(sigmag, np.float64)
    sigmae = np.asarray(sigmae, np.float64)
    pi_est = np.asarray(pi_est, np.float64)
    cva, cvai = np.asarray(cva, np.float64), np.asarray(cvai, np.float64)
    nonas = np.asarray(nonas, np.float64)
    n_total = float(n_total)
    T, B = c.shape
    dbeta = np.zeros((T, B))
    cass = np.zeros((T,) + cva.shape, np.int64)
    corr = np.zeros((T, B))
    for w0 in range(0, B, wave):
        for t in range(T):
            for j in range(w0, w0 + wave):
                g = int(grp[j])
                if not valid[j]:
                    continue
                if sigmag[t, g] == 0.0:
                    beta[t, j], acum[t, j] = 0.0, 1.0
                    continue
                num = c[t, j] + corr[t, j] + beta[t, j] * (nonas[t] - 1.0)
                b_new, k, a_new = draw_marker(
                    num, g, sigmag[t], sigmae[t], pi_est[t], cva, cvai,
                    nonas[t], n_total, u[t, j], z[t, j])
                dbeta[t, j] = beta[t, j] - b_new
                beta[t, j], comp[t, j], acum[t, j] = b_new, k, a_new
                cass[t, g, k] += 1
        s = slice(w0, w0 + wave)
        corr += np.einsum("tw,twb->tb", dbeta[:, s], gs[:, s, :])
    return dbeta, beta, comp, acum, cass


def hyper_block(
    state: OracleState,
    group_of: np.ndarray,
    mtotgrp: np.ndarray,       # (G,) total markers per group (global)
    n_total: int,
    draw_inv_chisq,            # callable(a, b) -> float
    draw_gamma,                # callable(shape) -> float (scale 1)
) -> None:
    """Post-sweep hyperparameter updates (bayes.cpp:562-651)."""
    G, K = state.pi_est.shape
    beta_sqn = np.zeros(G)
    np.add.at(beta_sqn, group_of, state.betas ** 2)

    for g in range(G):
        if mtotgrp[g] == 0:
            continue
        m0 = mtotgrp[g] - state.cass[g, 0]
        if m0 == 0 or state.cass[g].sum() == 0:
            state.sigmag[g] = 0.0
            continue
        state.sigmag[g] = draw_inv_chisq(
            V0G + m0, (beta_sqn[g] * m0 + V0G * S02G) / (V0G + m0)
        )
        # Dirichlet via normalized gammas (phenotype.cpp:227-237; dirich=1).
        gs = np.array([draw_gamma(state.cass[g, i] + 1.0) for i in range(K)])
        state.pi_est[g] = gs / gs.sum()

    e_sqn = float(state.eps @ state.eps)
    state.sigmae = draw_inv_chisq(
        V0E + n_total, (e_sqn + V0E * S02E) / (V0E + n_total)
    )


def m0_of(state: OracleState, mtotgrp: np.ndarray) -> np.ndarray:
    return mtotgrp - state.cass[:, 0]
