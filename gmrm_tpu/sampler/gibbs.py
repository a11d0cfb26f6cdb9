"""One full Gibbs iteration, jitted, SPMD-ready.

Structure mirrors the reference outer loop (``src/bayes.cpp:340-671``):

1. intercept step (offset epsilon by old mu, first-iteration sigmaE init,
   draw new mu, offset back — ``bayes.cpp:348-368``; the mu draw has mean 0
   because the reference never updates ``epssum``, phenotype.cpp:279-282),
2. per-device marker permutation (``phenotype.cpp:314-323``),
3. the marker sweep as a ``lax.scan`` over Gram blocks (exact restructuring
   of the per-marker loop ``bayes.cpp:375-553``; the cross-rank Allgatherv
   replay protocol becomes a psum of the block residual delta),
4. hyperparameter block (``bayes.cpp:562-651``): psum of per-group beta^2
   and cass, scaled-inverse-chi-squared sigmaG/sigmaE draws, Dirichlet pi,
   with replicated keys reproducing the reference's rank-0 broadcast.

The iteration index ``it`` is a traced scalar so one compilation serves the
whole chain.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import jax.random as jr

from gmrm_tpu.config import V0E, S02E, V0G, S02G
from gmrm_tpu.ops.blockops import (
    block_eps_update, block_gram, gram_from_quadrants,
)
from gmrm_tpu.ops.triton_kernels import (
    block_cdot_rows, block_eps_update_rows,
)
from gmrm_tpu.sampler.dists import inv_scaled_chisq
from gmrm_tpu.sampler.scan import block_scan, block_scan_wave
from gmrm_tpu.sampler.state import SamplerState, StaticInputs


class IterAux(NamedTuple):
    """Per-iteration observables (the .csv row ingredients, xfiles.cpp:17-43)."""
    m0: jnp.ndarray          # (T, G)
    e_sqn: jnp.ndarray       # (T,)


def _psum(x, axis_name):
    return jax.lax.psum(x, axis_name) if axis_name else x


def marker_sweep(
    eps, betas, comp, acum,
    sigmag, sigmae, pi_est,
    static: StaticInputs,
    blocks,                 # (nblocks, B) processing order (local indices)
    u_all,                  # (nblocks, T, B) uniforms
    z_all,                  # (nblocks, T, B) std normals
    *,
    axis_name: Optional[str] = None,
    shared_na: bool = False,
    wave_size: int = 1,
    elide_collectives: bool = False,
):
    """The full marker sweep (reference loop bayes.cpp:375-553) over Gram
    blocks, with all randomness injected — directly comparable to the NumPy
    serial oracle.  Returns (eps, betas, comp, acum, cass_local).

    Two paths, chosen by ``wave_size``:

    - W = 1, exact serial: ``blocks`` is any permutation of [0, m_pad).
      Every marker-indexed operand, the bed included, is permuted once and
      each block's Gram is recomputed from the bed (blockops.block_gram).
    - W > 1, wave relaxation (sampler.scan.block_scan_wave): ``blocks``
      must be block-preserving — row b holds natural block pi_b's markers
      in a shuffled order ``win`` (gibbs_iteration draws it so).  The bed
      never moves: each block is sliced in place, and its Gram comes from
      ``static.gram_cache`` (built once — X never changes and block
      membership is fixed), permuted by ``win`` and scaled.  Without a
      cache the Gram is recomputed as on the serial path.

    Per block, only the x^T eps dot products and the residual update
    stream over the bed — on a CUDA device in float32 through the fused
    decode kernels of ops/triton_kernels.py, which read the block's rows
    in place.  Under ``axis_name`` the block's residual delta is psum'd
    across shards (the reference's Allgatherv replay).

    ``elide_collectives`` skips the psums: a TIMING-ONLY variant whose
    results are wrong across shards (each device sweeps on its local
    deltas alone), used by ``parallel.runner.measure_sync_seconds``.

    ``shared_na`` is a static hint that all traits share one NA mask (no
    phenotype NAs) — it collapses the per-trait Gram to a single one.
    """
    na = static.na
    nonas = static.nonas.astype(eps.dtype)
    n_total = static.n_total.astype(eps.dtype)
    dtype = eps.dtype
    sync_axis = None if elide_collectives else axis_name
    nblocks, B = blocks.shape
    T = betas.shape[0]
    m_pad = nblocks * B
    wave = wave_size > 1
    if wave:
        scan_fn = functools.partial(block_scan_wave, wave=wave_size)
    else:
        scan_fn = block_scan

    # Permute every marker-indexed operand ONCE, stream contiguous slices
    # through the scan as xs, and invert the permutation once at the end
    # (instead of per-block gathers and scatters).
    perm = blocks.reshape(-1)

    def permuted_blocks(x, axis):
        """take along ``axis`` then split the marker axis into (nblocks, B),
        moved to the front for lax.scan xs."""
        xp = jnp.take(x, perm, axis=axis)
        if axis == 0:
            return xp.reshape((nblocks, B) + x.shape[1:])
        # axis == 1, trait-leading (T, m_pad) -> (nblocks, T, B)
        xp = xp.reshape(x.shape[0], nblocks, B)
        return jnp.moveaxis(xp, 1, 0)

    if wave:
        bidx_all = blocks[:, 0] // B                       # natural block
        win_all = blocks - bidx_all[:, None] * B           # row order
        lead = (bidx_all, win_all)
    else:
        lead = (permuted_blocks(static.bed, 0),)           # (nb, B, mb)
    xs = lead + (
        permuted_blocks(static.mave, 1),                   # (nblocks, T, B)
        permuted_blocks(static.msig, 1),
        permuted_blocks(static.group_of, 0),               # (nblocks, B)
        (perm < static.m_local).reshape(nblocks, B),
        permuted_blocks(betas, 1),
        permuted_blocks(comp, 1),
        permuted_blocks(acum, 1),
        u_all, z_all,
    )
    use_cache = wave and static.gram_cache is not None

    def cached_gram_scaled(bidx, win_blk, mave_blk, msig_blk):
        gf = static.gram_cache[bidx].astype(dtype)         # (NT, 2B, 2B)
        # Natural -> processing order: one exact row + column gather.
        win2 = jnp.concatenate([win_blk, win_blk + B])
        gf = jnp.take(jnp.take(gf, win2, axis=1), win2, axis=2)
        graw = gram_from_quadrants(gf, mave_blk)           # NT=1 broadcasts
        return (msig_blk[:, :, None] * msig_blk[:, None, :]) * graw

    def block_body(carry, xs):
        eps, cass = carry
        (mave_blk, msig_blk, grp_blk, valid_blk,
         beta_old, comp_old, acum_old, u_blk, z_blk) = xs[len(lead):]
        if use_cache:
            bidx, win_blk = xs[:2]
            rows = bidx * B + win_blk                      # bed rows
            c = msig_blk * block_cdot_rows(static.bed, rows, eps, mave_blk,
                                           axis_name=axis_name)
            gs = cached_gram_scaled(bidx, win_blk, mave_blk, msig_blk)

            def update(d):
                return block_eps_update_rows(static.bed, rows, d, na,
                                             mave_blk, axis_name=axis_name)
        else:
            bed_blk = (jnp.take(static.bed, xs[0] * B + xs[1], axis=0)
                       if wave else xs[0])
            craw, graw = block_gram(bed_blk, eps, na, mave_blk, dtype=dtype,
                                    shared_na=shared_na)
            c = msig_blk * craw
            gs = msig_blk[:, :, None] * msig_blk[:, None, :] * graw

            def update(d):
                return block_eps_update(bed_blk, d, na, mave_blk, dtype=dtype)

        res = scan_fn(
            c, gs, beta_old, comp_old, acum_old, grp_blk, valid_blk,
            u_blk, z_blk, sigmag, sigmae, pi_est,
            static.cva, static.cvai, nonas, n_total,
            axis_name=axis_name,
        )

        eps = eps + _psum(update(msig_blk * res.dbeta_eff), sync_axis)
        cass = cass + res.cass_inc
        return (eps, cass), (res.beta_new, res.comp_new, res.acum_new)

    cass0 = jnp.zeros((T,) + static.cva.shape, jnp.int32)
    if axis_name is not None:
        cass0 = jax.lax.pcast(cass0, (axis_name,), to='varying')
    (eps, cass_local), (beta_new_p, comp_new_p, acum_new_p) = jax.lax.scan(
        block_body, (eps, cass0), xs,
    )

    return _finish_sweep(
        eps, beta_new_p, comp_new_p, acum_new_p, cass_local, perm, m_pad, T)


def _finish_sweep(eps, beta_new_p, comp_new_p, acum_new_p, cass_local,
                  perm, m_pad, T):
    # Invert the permutation: position k of the processed stream is marker
    # perm[k], so marker j lives at inv[j] with inv[perm[k]] = k.
    inv = jnp.zeros((m_pad,), jnp.int32).at[perm].set(
        jnp.arange(m_pad, dtype=jnp.int32))

    def unpermute(y):                                  # (nblocks, T, B) ->
        yp = jnp.moveaxis(y, 0, 1).reshape(T, m_pad)   # (T, m_pad) permuted
        return jnp.take(yp, inv, axis=1)

    betas = unpermute(beta_new_p)
    comp = unpermute(comp_new_p)
    acum = unpermute(acum_new_p)
    return eps, betas, comp, acum, cass_local


def gibbs_iteration(
    state: SamplerState,
    static: StaticInputs,
    it: jnp.ndarray,
    *,
    block_size: int,
    axis_name: Optional[str] = None,
    shuffle: bool = True,
    shared_na: bool = False,
    wave_size: int = 1,
    elide_collectives: bool = False,
):
    T, _, mb = state.eps.shape
    m_pad = state.betas.shape[1]
    G, K = static.cva.shape
    dtype = state.eps.dtype
    B = block_size
    assert m_pad % B == 0, "pad local markers to a multiple of block_size"
    nblocks = m_pad // B

    it_key = jr.fold_in(state.key, it)
    k_mu, k_perm, k_u, k_z, k_sg, k_pi, k_se = jr.split(it_key, 7)
    if axis_name:
        didx = jax.lax.axis_index(axis_name)
        k_perm = jr.fold_in(k_perm, didx)
        k_u = jr.fold_in(k_u, didx)
        k_z = jr.fold_in(k_z, didx)

    na = static.na
    nonas = static.nonas.astype(dtype)
    n_total = static.n_total.astype(dtype)

    # --- 1. intercept step ------------------------------------------------
    eps = state.eps + state.mu[:, None, None] * na
    e_sqn0 = jnp.sum(eps * eps, axis=(1, 2))
    sigmae = jnp.where(it == 1, 0.5 * e_sqn0 / nonas, state.sigmae)
    z_mu = jr.normal(k_mu, (T,), dtype)
    mu_new = state.epssum / nonas + jnp.sqrt(sigmae / nonas) * z_mu
    eps = eps - mu_new[:, None, None] * na

    # --- 2. shuffled processing order ------------------------------------
    # Two schemes, one per sweep path (marker_sweep):
    # (a) W = 1: uniform shuffle of the real markers with pad slots pinned
    #     to the end (supports per-device remainder markers under a common
    #     nblocks, the reference's Mm idle-step scheme, bayes.cpp:375-382);
    # (b) W > 1: block-preserving shuffle — random block order x random
    #     within-block row order — so natural-block membership never
    #     changes and the Gram cache holds.  The reference itself shuffles
    #     only within each rank's FIXED marker block (phenotype.cpp:314-323,
    #     per-rank midx), so (b) is at least as random as the reference's
    #     own multi-rank semantics; the wave relaxation's within-wave
    #     pairings re-randomize every iteration.  Under shard_map each
    #     device draws its own order (k_perm is device-folded above).
    block_mode = wave_size > 1
    if shuffle and not block_mode:
        r = jr.uniform(k_perm, (m_pad,))
        r = jnp.where(jnp.arange(m_pad) < static.m_local, r, 2.0)
        perm = jnp.argsort(r)
    elif shuffle:
        k_pb, k_pw = jr.split(k_perm)
        pi_b = jr.permutation(k_pb, jnp.arange(nblocks, dtype=jnp.int32))
        win = jnp.argsort(jr.uniform(k_pw, (nblocks, B)),
                          axis=1).astype(jnp.int32)
        perm = (pi_b[:, None] * B + win).reshape(-1)
    else:
        # --shuffle-markers 0: natural order (options.cpp:64-68; pad slots
        # already sit at the end of the local range).
        perm = jnp.arange(m_pad, dtype=jnp.int32)
    blocks = perm.reshape(nblocks, B)

    u_all = jr.uniform(k_u, (nblocks, T, B), dtype)
    z_all = jr.normal(k_z, (nblocks, T, B), dtype)

    # --- 3. marker sweep over Gram blocks --------------------------------
    eps, betas, comp, acum, cass_local = marker_sweep(
        eps, state.betas, state.comp, state.acum,
        state.sigmag, sigmae, state.pi_est,
        static, blocks, u_all, z_all,
        axis_name=axis_name, shared_na=shared_na, wave_size=wave_size,
        elide_collectives=elide_collectives,
    )

    # --- 4. hyperparameter block -----------------------------------------
    beta_sqn_local = jax.ops.segment_sum(
        (betas * betas).T, static.group_of, num_segments=G
    ).T                                                    # (T, G)
    sync_axis = None if elide_collectives else axis_name
    beta_sqn = _psum(beta_sqn_local, sync_axis)
    cass = _psum(cass_local, sync_axis)

    mtotgrp = static.mtotgrp.astype(dtype)                 # (G,)
    m0 = jnp.where(static.mtotgrp > 0,
                   static.mtotgrp - cass[:, :, 0], 0)      # (T, G) int
    m0f = m0.astype(dtype)
    cass_sum = jnp.sum(cass, axis=2)                       # (T, G)
    active = (static.mtotgrp[None, :] > 0) & (m0 > 0) & (cass_sum > 0)

    a_g = V0G + m0f
    b_g = (beta_sqn * m0f + V0G * S02G) / jnp.maximum(a_g, 1e-30)
    sg_draw = inv_scaled_chisq(k_sg, a_g, jnp.maximum(b_g, 1e-30), dtype=dtype)
    sigmag_new = jnp.where(
        static.mtotgrp[None, :] > 0,
        jnp.where(active, sg_draw, jnp.asarray(0.0, dtype)),
        state.sigmag,
    )

    alpha = cass.astype(dtype) + 1.0                       # dirich = 1
    g_draw = jr.gamma(k_pi, alpha, dtype=dtype)            # (T, G, K)
    pi_draw = g_draw / jnp.sum(g_draw, axis=-1, keepdims=True)
    pi_new = jnp.where(active[:, :, None], pi_draw, state.pi_est)

    e_sqn = jnp.sum(eps * eps, axis=(1, 2))
    sigmae_new = inv_scaled_chisq(
        k_se, V0E + n_total, (e_sqn + V0E * S02E) / (V0E + n_total),
        dtype=dtype,
    )

    new_state = state.replace(
        eps=eps, betas=betas, comp=comp, acum=acum, cass=cass,
        sigmag=sigmag_new, sigmae=sigmae_new, pi_est=pi_new, mu=mu_new,
    )
    return new_state, IterAux(m0=m0, e_sqn=e_sqn)


def make_gibbs_step(*, block_size: int, axis_name: Optional[str] = None,
                    donate: bool = True, shuffle: bool = True,
                    shared_na: bool = False, wave_size: int = 1):
    """Jitted single-iteration step (state, static, it) -> (state, aux).

    ``static`` is a regular argument (not a closure constant) so the bed
    matrix stays a device-resident input rather than a baked-in literal.
    """
    fn = functools.partial(
        gibbs_iteration, block_size=block_size, axis_name=axis_name,
        shuffle=shuffle, shared_na=shared_na, wave_size=wave_size,
    )
    return jax.jit(fn, donate_argnums=(0,) if donate else ())
