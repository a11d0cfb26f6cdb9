"""The within-block Gibbs scans.

Given the block's precomputed dot products ``c`` and scaled Gram matrix
``gs`` (see gmrm_tpu.ops.blockops), ``block_scan`` reproduces the
reference's exact per-marker recursion (``src/bayes.cpp:391-492``) —
mixture likelihoods, the sequential CDF walk with |dlogl| > 700 overflow
guards, component selection, and effect draw — for B markers and T traits,
with the residual interaction reduced to
``num_j = c_j + sum_{i<j} gs[j,i] * dbeta_i``.

``block_scan_wave`` relaxes the recursion to waves of W markers: markers
within a wave draw against the residual as of the wave start (blind to
each other's same-wave moves), and the wave's rank-W Gram correction is
folded before the next wave.  This is exactly the relaxation the
reference's own multi-rank protocol makes — D MPI ranks process D markers
simultaneously, each blind to the others' same-step moves, merging
afterwards (bayes.cpp:375-553) — except strictly closer to the serial
sampler (waves DO see all earlier waves of the block).  W=1 is the exact
serial recursion; W>1 is the throughput mode, validated statistically
against the compiled reference (benchmarking/EQUIVALENCE.md).

All randomness is injected (u uniforms, z standard normals per marker slot
and trait), so both functions are pure deterministic maps and can be
checked against the float64 NumPy oracle up to float tolerance.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

# f32 contractions must not drop to reduced-precision (TF32) passes.
_PREC = jax.lax.Precision.HIGHEST


class BlockScanResult(NamedTuple):
    dbeta_eff: jnp.ndarray   # (T, B) standardized-scale beta_old - beta_new,
                             # zeroed where the reference does not share the
                             # update (adaV zeroing / padding)
    beta_new: jnp.ndarray    # (T, B)
    comp_new: jnp.ndarray    # (T, B) int32
    acum_new: jnp.ndarray    # (T, B)
    cass_inc: jnp.ndarray    # (T, G, K) int32


def block_scan(
    c,            # (T, B) msig-scaled x^T eps at block start
    gs,           # (T, B, B) scaled Gram: msig_j*msig_i*graw
    beta_old,     # (T, B)
    comp_old,     # (T, B) int32
    acum_old,     # (T, B)
    grp,          # (B,) int32 group ids
    valid,        # (B,) bool: real (non-pad) marker
    u,            # (T, B) uniforms
    z,            # (T, B) std normals
    sigmag,       # (T, G)
    sigmae,       # (T,)
    pi_est,       # (T, G, K)
    cva,          # (G, K)
    cvai,         # (G, K)
    nonas,        # (T,)
    n_total,      # () float
    axis_name=None,  # mesh axis when running under shard_map (vma tracking)
) -> BlockScanResult:
    T, B = c.shape
    G, K = cva.shape
    dtype = c.dtype
    t_idx = jnp.arange(T)

    inv2sige = 1.0 / (2.0 * sigmae)                     # (T,)

    def step(carry, xs):
        dbeta_vec, cass_inc = carry
        (c_j, g_row, beta_old_j, comp_old_j, acum_old_j,
         grp_j, valid_j, u_j, z_j) = xs

        sg = sigmag[:, grp_j]                           # (T,)
        adav = sg == 0.0
        sg_safe = jnp.where(adav, jnp.asarray(1.0, dtype), sg)
        sige_g = sigmae / sg_safe
        sigg_e = sg_safe / sigmae

        # num = x_j^T eps_current + beta_old*(nonas-1)   (bayes.cpp:418-421)
        num = (
            c_j
            + jnp.einsum("tb,tb->t", g_row, dbeta_vec, precision=_PREC)
            + beta_old_j * (nonas - 1.0)
        )

        denom = (n_total - 1.0) + sige_g[:, None] * cvai[grp_j, 1:]  # (T, K-1)
        muk = jnp.concatenate(
            [jnp.zeros((T, 1), dtype), num[:, None] / denom], axis=1
        )                                                # (T, K)

        logl = jnp.log(pi_est[:, grp_j, :])              # (T, K)
        tail = (
            -0.5 * jnp.log(sigg_e[:, None] * (nonas[:, None] - 1.0)
                           * cva[grp_j, 1:] + 1.0)
            + muk[:, 1:] * num[:, None] * inv2sige[:, None]
        )
        logl = logl.at[:, 1:].add(tail)

        # Sequential CDF walk with overflow guards (bayes.cpp:435-477).
        over0 = jnp.any(jnp.abs(logl - logl[:, :1]) > 700.0, axis=1)
        acum = jnp.where(
            over0,
            jnp.asarray(0.0, dtype),
            1.0 / jnp.sum(jnp.exp(logl - logl[:, :1]), axis=1),
        )
        comp = jnp.full((T,), K - 1, jnp.int32)
        chosen = jnp.zeros((T,), bool)
        for i in range(K):
            sel = (~chosen) & ((u_j <= acum) | (i == K - 1))
            comp = jnp.where(sel, i, comp)
            chosen = chosen | sel
            if i < K - 1:
                ref = logl[:, i + 1]
                zero_inc = jnp.any(
                    jnp.abs(logl[:, i + 1:] - ref[:, None]) > 700.0, axis=1
                )
                esum = jnp.sum(jnp.exp(logl - ref[:, None]), axis=1)
                inc = jnp.where(zero_inc, jnp.asarray(0.0, dtype), 1.0 / esum)
                acum = jnp.where(chosen, acum, acum + inc)

        # Effect draw for the selected slab (bayes.cpp:450-459).
        denom_sel = denom[t_idx, jnp.clip(comp - 1, 0, K - 2)]
        beta_drawn = muk[t_idx, comp] + jnp.sqrt(sigmae / denom_sel) * z_j
        beta_sampled = jnp.where(comp == 0, jnp.asarray(0.0, dtype), beta_drawn)

        # adaV short-circuit (bayes.cpp:396-400): beta zeroed, acum = 1,
        # comp/cass untouched, no residual update shared.
        live = valid_j & (~adav)                         # (T,)
        beta_new = jnp.where(
            valid_j,
            jnp.where(adav, jnp.asarray(0.0, dtype), beta_sampled),
            beta_old_j,
        )
        comp_new = jnp.where(live, comp, comp_old_j)
        acum_new = jnp.where(
            valid_j,
            jnp.where(adav, jnp.asarray(1.0, dtype), acum),
            acum_old_j,
        )

        onehot = jax.nn.one_hot(comp, K, dtype=jnp.int32)      # (T, K)
        cass_inc = cass_inc.at[:, grp_j, :].add(
            onehot * live[:, None].astype(jnp.int32)
        )

        dbeta_j = jnp.where(live, beta_old_j - beta_sampled,
                            jnp.asarray(0.0, dtype))
        return (dbeta_vec, cass_inc), (beta_new, comp_new, acum_new, dbeta_j)

    # The step index is threaded through xs so dbeta_j lands in the carry
    # slot that later markers' Gram corrections read.
    def step_indexed(carry, xs):
        j = xs[0]
        (dbeta_vec, cass_inc), (beta_new, comp_new, acum_new, dbeta_j) = step(
            carry, xs[1:]
        )
        dbeta_vec = dbeta_vec.at[:, j].set(dbeta_j)
        return (dbeta_vec, cass_inc), (beta_new, comp_new, acum_new)

    xs = (
        jnp.arange(B),
        jnp.moveaxis(c, 1, 0),             # (B, T)
        jnp.moveaxis(gs, 1, 0),            # (B, T, B)
        jnp.moveaxis(beta_old, 1, 0),
        jnp.moveaxis(comp_old, 1, 0),
        jnp.moveaxis(acum_old, 1, 0),
        grp,
        valid,
        jnp.moveaxis(u, 1, 0),
        jnp.moveaxis(z, 1, 0),
    )
    init = (
        jnp.zeros((T, B), dtype),
        jnp.zeros((T,) + cva.shape, jnp.int32),
    )
    if axis_name is not None:
        # Under shard_map the carries become device-varying (they absorb
        # per-shard draws); mark the fresh zeros accordingly.
        init = jax.tree.map(lambda x: jax.lax.pcast(x, (axis_name,), to='varying'), init)
    (dbeta_vec, cass_inc), (beta_new, comp_new, acum_new) = jax.lax.scan(
        step_indexed, init, xs
    )
    return BlockScanResult(
        dbeta_eff=dbeta_vec,
        beta_new=jnp.moveaxis(beta_new, 0, 1),
        comp_new=jnp.moveaxis(comp_new, 0, 1),
        acum_new=jnp.moveaxis(acum_new, 0, 1),
        cass_inc=cass_inc,
    )


def wave_tables(grp, sigmag, sigmae, pi_est, cva, cvai, nonas, n_total):
    """Per-marker mixture tables (T, B, K) for the wave scan.

    logl is affine in q = num^2 / (2 sigmaE) for each component
    (bayes.cpp:425-433): logl_k = lc_k + q * rd_k with rd_k = 1/denom_k
    (rd_0 = 0), and the slab draw is num * rd_k + sqb_k * z with
    sqb_k = sqrt(sigmaE / denom_k).  These depend on a marker only
    through its group, so they are built once per block.
    """
    dtype = sigmag.dtype
    sigmae_c = sigmae[:, None]                             # (T, 1)
    sg = jnp.take_along_axis(sigmag, grp[None, :], axis=1)  # (T, B)
    sg_safe = jnp.where(sg == 0.0, jnp.asarray(1.0, dtype), sg)
    sige_g = sigmae_c / sg_safe
    sigg_e = sg_safe / sigmae_c
    denom = ((n_total - 1.0)
             + sige_g[:, :, None] * cvai[grp, 1:][None])   # (T, B, K-1)
    zeros0 = jnp.zeros(denom.shape[:2] + (1,), dtype)
    rd = jnp.concatenate([zeros0, 1.0 / denom], axis=2)    # (T, B, K)
    sqb = jnp.concatenate(
        [zeros0, jnp.sqrt(sigmae_c[:, :, None] / denom)], axis=2)
    tail = -0.5 * jnp.log(sigg_e[:, :, None] * (nonas[:, None, None] - 1.0)
                          * cva[grp, 1:][None] + 1.0)
    lc = jnp.log(pi_est)[:, grp, :].at[:, :, 1:].add(tail)
    return lc, rd, sqb, sg == 0.0


def _wave_draw(num, u, z, lc, rd, sqb, inv2sige):
    """Component selection and effect draw for one wave of markers.

    num/u/z: (T, W); lc/rd/sqb: (T, W, K).  The reference's CDF walk
    (bayes.cpp:435-477) sums K*K pairwise terms 1/sum_k2 exp(L_k2 - L_i);
    with E_k = exp(L_k - Lmax) and S = sum_k E_k each term is E_i / S — K
    overflow-free exponentials — and the |dlogl| > 700 guard over pairs
    k2 >= i becomes a suffix max/min test.  Returns (comp, acum, beta).
    """
    K = lc.shape[-1]
    q = (num * num * inv2sige)[..., None]
    L = lc + q * rd                                        # (T, W, K)
    e = jnp.exp(L - jnp.max(L, axis=-1, keepdims=True))
    sufmax = jax.lax.cummax(L, axis=L.ndim - 1, reverse=True)
    sufmin = jax.lax.cummin(L, axis=L.ndim - 1, reverse=True)
    over = (sufmax - L > 700.0) | (L - sufmin > 700.0)
    share = jnp.where(over, jnp.asarray(0.0, L.dtype),
                      e / jnp.sum(e, axis=-1, keepdims=True))
    cdf = jnp.cumsum(share, axis=-1)
    # First component whose running CDF reaches u; the last one otherwise.
    comp = jnp.minimum(jnp.sum(u[..., None] > cdf, axis=-1), K - 1)
    pick = comp[..., None]
    acum = jnp.take_along_axis(cdf, pick, axis=-1)[..., 0]
    rd_s = jnp.take_along_axis(rd, pick, axis=-1)[..., 0]
    sqb_s = jnp.take_along_axis(sqb, pick, axis=-1)[..., 0]
    beta = jnp.where(comp == 0, jnp.asarray(0.0, num.dtype),
                     num * rd_s + sqb_s * z)
    return comp.astype(jnp.int32), acum, beta


def block_scan_wave(
    c, gs, beta_old, comp_old, acum_old, grp, valid, u, z,
    sigmag, sigmae, pi_est, cva, cvai, nonas, n_total,
    axis_name=None, *, wave: int,
) -> BlockScanResult:
    """``block_scan`` relaxed to waves of ``wave`` markers (module
    docstring); same arguments and result.  The B/wave waves are unrolled
    so that XLA sees one graph per block."""
    T, B = c.shape
    G, K = cva.shape
    W = wave
    if B % W:
        raise ValueError(f"wave {W} does not divide block size {B}")
    lc, rd, sqb, adav = wave_tables(grp, sigmag, sigmae, pi_est, cva, cvai,
                                    nonas, n_total)
    inv2sige = (1.0 / (2.0 * sigmae))[:, None]             # (T, 1)
    live = valid[None, :] & ~adav                          # (T, B)
    zerob = valid[None, :] & adav
    base = c + beta_old * (nonas[:, None] - 1.0)           # (T, B)

    corr = jnp.zeros((T, B), c.dtype)
    dbeta, beta_new, comp_new, acum_new = [], [], [], []
    for w0 in range(0, B, W):
        s = slice(w0, w0 + W)
        comp, acum, beta = _wave_draw(
            base[:, s] + corr[:, s], u[:, s], z[:, s],
            lc[:, s], rd[:, s], sqb[:, s], inv2sige)
        lv, zb, b_old = live[:, s], zerob[:, s], beta_old[:, s]
        db = jnp.where(lv, b_old - beta, jnp.asarray(0.0, c.dtype))
        dbeta.append(db)
        beta_new.append(jnp.where(lv, beta,
                                  jnp.where(zb, jnp.asarray(0.0, c.dtype),
                                            b_old)))
        comp_new.append(jnp.where(lv, comp, comp_old[:, s]))
        acum_new.append(jnp.where(lv, acum,
                                  jnp.where(zb, jnp.asarray(1.0, c.dtype),
                                            acum_old[:, s])))
        if w0 + W < B:
            # The wave's rank-W correction for all traits in one product.
            corr = corr + jnp.einsum("tw,twb->tb", db, gs[:, s, :],
                                     precision=_PREC)
    comp_new = jnp.concatenate(comp_new, axis=1)
    onehot_k = jax.nn.one_hot(comp_new, K, dtype=jnp.int32)
    onehot_g = jax.nn.one_hot(grp, G, dtype=jnp.int32)
    cass_inc = jnp.einsum("tbk,bg->tgk",
                          onehot_k * live[:, :, None].astype(jnp.int32),
                          onehot_g)
    return BlockScanResult(
        dbeta_eff=jnp.concatenate(dbeta, axis=1),
        beta_new=jnp.concatenate(beta_new, axis=1),
        comp_new=comp_new,
        acum_new=jnp.concatenate(acum_new, axis=1),
        cass_inc=cass_inc,
    )
