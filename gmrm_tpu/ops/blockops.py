"""Fused block operations: the matrix-product path of the sampler.

These ops carry all the O(N) work of the Gibbs sweep (the reference's hot
loops: dot product ``src/bayes.cpp:709-770``, rank-1 residual update
``src/phenotype.cpp:326-393``, marker statistics
``src/phenotype.cpp:466-556``), restructured as block matrix products:

- ``block_cdot``: for a block of B markers, ``c = Xc @ eps`` with the 2-bit
  decode fused in (the x^T eps stream).
- ``block_gram``: ``c`` plus the NA-masked Gram ``G = (Xc*na) @ Xc^T``.
  Together they make the within-block serial scan O(B) per marker
  instead of O(N).
- ``build_gram_cache``: the raw Gram quadrants of every natural block,
  built once (X never changes), which the wave sweep permutes and scales
  instead of recomputing ``block_gram`` each iteration.
- ``block_eps_update``: apply the accumulated rank-1 updates of a block as
  one matvec ``eps += Xc^T @ (msig*dbeta) * na``.
- ``marker_stats_jax``: one fused pass for per-marker mean / inverse-sd.

Exactness strategy (float32 path): the decoded planes are exact small
integers (a in {0,1,2}, b in {0,1}, na in {0,1}), so every product of two
decoded planes is exact in bfloat16 with float32 accumulation — integer
sums stay below 2^24.  The centered Gram

    G[j,i] = sum_n na * (a_j - m_j b_j)(a_i - m_i b_i)

is therefore expanded into three *exact* bf16 products (A·A^T, B·A^T,
B·B^T with the na mask folded into the left operand) and recombined with
the means elementwise — one bf16 tensor-core pass each instead of a
multi-pass ``Precision.HIGHEST`` f32 einsum.  Continuous operands (eps,
dbeta) are split into bf16 hi+lo pairs (Dekker split across formats: hi =
bf16(x) and x - hi is exact in f32, so two bf16 passes reconstruct x to
~2^-17 relative), keeping those products on the bf16 path too.

The float64 path keeps plain HIGHEST-precision einsums (it exists for
oracle-grade runs, not for throughput).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# f32/f64 contractions must not drop to reduced-precision passes (TF32 on
# GPUs); the float64 path needs true wide accumulation.
_PREC = jax.lax.Precision.HIGHEST

from gmrm_tpu.ops.decode import decode_planes_jax

_BF16 = jnp.bfloat16
_F32 = jnp.float32


def split_hi_lo(x):
    """Dekker split of an f32 array into two bf16 arrays with
    hi + lo ~= x to ~2^-17 relative.

    hi is x rounded to bf16 (nearest, ties to even) in integer arithmetic
    on the bit pattern: XLA may drop an f32 -> bf16 -> f32 round trip as
    excess precision (GPU backends do), which would zero lo."""
    bits = jax.lax.bitcast_convert_type(x, jnp.uint32)
    bits = (bits + jnp.uint32(0x7FFF) + ((bits >> 16) & 1)) \
        & jnp.uint32(0xFFFF0000)
    hi = jax.lax.bitcast_convert_type(bits, _F32)
    return hi.astype(_BF16), (x - hi).astype(_BF16)


def _mm(x, y, sub):
    """einsum of bf16 operands with f32 accumulation (one bf16 pass)."""
    return jnp.einsum(sub, x, y, preferred_element_type=_F32)


def _xc(bed_block, mave, dtype):
    """Decode a marker block and center: xc = a - mave*b, phase layout.

    bed_block: (B, mb) uint8; mave: (T, B) -> returns (T, B, 4, mb).
    """
    a, b = decode_planes_jax(bed_block, dtype=dtype)       # (B, 4, mb)
    return a[None] - mave[:, :, None, None] * b[None]      # (T, B, 4, mb)


def block_cdot(bed_block, eps, mave, *, dtype=jnp.float32):
    """Raw dot products x^T eps for one marker block.

    Args:
      bed_block: (B, mb) uint8 packed genotypes.
      eps: (T, 4, mb) residual phase planes (zeros at NAs and padding).
      mave: (T, B) per-trait marker means for the block.

    Returns craw (T, B) = sum_i xc[t,j,i] * eps[t,i] (the un-scaled
    x^T eps; the NA mask is implicit because eps is 0 there — matching the
    reference dot product which also omits it, bayes.cpp:709-770).
    """
    if dtype != jnp.float32:
        xc = _xc(bed_block, mave, dtype)                   # (T, B, 4, mb)
        return jnp.einsum("tbkm,tkm->tb", xc, eps,
                          preferred_element_type=dtype, precision=_PREC)
    B = bed_block.shape[0]
    T = eps.shape[0]
    a, b = decode_planes_jax(bed_block, dtype=_BF16)       # exact integers
    ab = jnp.concatenate([a, b], axis=0)                   # (2B, 4, mb)
    eps_hi, eps_lo = split_hi_lo(eps.astype(_F32))
    # craw = A·eps - mave ⊙ (B·eps), eps reconstructed from its bf16 split —
    # ONE product over [A;B] with hi/lo stacked on the rhs: the sweep is
    # bound by passes over the bed.
    cab = _mm(ab, jnp.concatenate([eps_hi, eps_lo], axis=0),
              "bkm,skm->bs")                               # (2B, 2T)
    ca = cab[:B, :T] + cab[:B, T:]                         # (B, T)
    cb = cab[B:, :T] + cab[B:, T:]
    return (ca - cb * mave.T).T                            # (T, B)


def block_gram(bed_block, eps, na, mave, *, dtype=jnp.float32,
               shared_na: bool = False):
    """Raw dot products and Gram matrix for one marker block.

    Args as :func:`block_cdot`, plus na (T, 4, mb) 0/1 phenotype-observed
    masks; ``shared_na`` is a static hint that every trait's na mask is
    identical (no phenotype NAs) — the Gram then collapses to one trait's
    worth of products.

    Returns:
      craw: (T, B), as :func:`block_cdot`.
      graw: (T, B, B) = sum_i na[t,i] * xc[t,j,i] * xc[t,j',i].
    """
    if dtype != jnp.float32:
        return _block_gram_wide(bed_block, eps, na, mave, dtype=dtype)

    B = bed_block.shape[0]
    craw = block_cdot(bed_block, eps, mave, dtype=dtype)
    a, b = decode_planes_jax(bed_block, dtype=_BF16)       # exact integers
    ab = jnp.concatenate([a, b], axis=0)                   # (2B, 4, mb)

    # Gram pieces: G1 = Σ na a_j a_i, G2 = Σ na b_j a_i, G3 = Σ na b_j b_i;
    # G[t,j,i] = G1 - m_ti G2[i,j] - m_tj G2[j,i] + m_tj m_ti G3[j,i].
    # All three come out of ONE [A;B]·[A;B]^T pass (quadrants of Gfull).
    if shared_na:
        na0 = na[0].astype(_BF16)                          # (4, mb), 0/1
        gfull = _mm(ab * na0, ab, "bkm,ckm->bc")[None]     # (1, 2B, 2B)
    else:
        nab = na.astype(_BF16)
        ln = ab[None] * nab[:, None]                       # (T, 2B, 4, mb)
        gfull = _mm(ln, ab, "tbkm,ckm->tbc")               # (T, 2B, 2B)
    return craw, gram_from_quadrants(gfull, mave).astype(dtype)


def gram_from_quadrants(gfull, mave):
    """Centered Gram (T, B, B) from raw [A;B]·[A;B]^T quadrants
    ``gfull`` (NT, 2B, 2B), NT in {1, T}: elementwise, so exact to f32
    rounding of the recombination."""
    B = mave.shape[1]
    g1 = gfull[:, :B, :B]
    g2 = gfull[:, B:, :B]
    g2t = gfull[:, :B, B:]
    g3 = gfull[:, B:, B:]
    mj = mave[:, :, None]
    mi = mave[:, None, :]
    return g1 - mi * g2t - mj * g2 + (mj * mi) * g3


def build_gram_cache(bed, na, *, block_size, shared_na):
    """Precompute raw Gram quadrants for every natural block.

    bed (m_pad, mb) u8 natural order; na (T, 4, mb).  Returns
    (nblocks, NT, 2B, 2B) f32 with NT = 1 under ``shared_na`` else T.
    O(M N B) once, as bf16 tensor-core products; the sweep then pays only
    an O(M B^2) load + permute per iteration.

    Every entry is an exact non-negative integer count < 2^24 (codes <= 2
    and na in {0,1} are exact in bf16, so every product is, and f32
    accumulation of such integers is order-independent), so the cache is
    bit-identical to a float64 count whatever order the reduction takes.
    """
    m_pad, mb = bed.shape
    B = block_size
    if m_pad % B:
        raise ValueError(f"marker rows {m_pad} not a multiple of block "
                         f"size {B}")
    na_b = (na[:1] if shared_na else na).astype(_BF16)

    def per_block(bed_blk):                       # (B, mb) u8
        a, b = decode_planes_jax(bed_blk, dtype=_BF16)
        ab = jnp.concatenate([a, b], axis=0)      # (2B, 4, mb) bf16
        return _mm(ab[None] * na_b[:, None], ab, "tbkm,ckm->tbc")

    return jax.lax.map(per_block, bed.reshape(m_pad // B, B, mb))


def _block_gram_wide(bed_block, eps, na, mave, *, dtype):
    xc = _xc(bed_block, mave, dtype)                       # (T, B, 4, mb)
    craw = jnp.einsum("tbkm,tkm->tb", xc, eps,
                      preferred_element_type=dtype, precision=_PREC)
    xcn = xc * na[:, None, :, :]
    graw = jnp.einsum("tbkm,tckm->tbc", xcn, xc,
                      preferred_element_type=dtype, precision=_PREC)
    return craw, graw


def block_eps_update(bed_block, dbeta_scaled, na, mave, *, dtype=jnp.float32):
    """Residual delta from a block's accepted moves.

    dbeta_scaled: (T, B) = msig * (beta_old - beta_new) per marker.
    Returns deps (T, 4, mb) = na * sum_j dbeta_scaled[t,j] * xc[t,j],
    the batched form of the reference rank-1 update
    ``eps += dbeta*msig*(a - mave*b)*na`` (phenotype.cpp:326-393).
    """
    if dtype != jnp.float32:
        xc = _xc(bed_block, mave, dtype)                   # (T, B, 4, mb)
        deps = jnp.einsum("tb,tbkm->tkm", dbeta_scaled, xc,
                          preferred_element_type=dtype, precision=_PREC)
        return deps * na

    T = dbeta_scaled.shape[0]
    a, b = decode_planes_jax(bed_block, dtype=_BF16)
    ab = jnp.concatenate([a, b], axis=0)                   # (2B, 4, mb)
    d = dbeta_scaled.astype(_F32)
    md = mave * d
    d_hi, d_lo = split_hi_lo(d)
    md_hi, md_lo = split_hi_lo(md)
    # deps = A^T d - B^T (mave ⊙ d) = [d, -md]·[A;B], hi/lo rows stacked —
    # one matmul pass over [A;B].
    lhs = jnp.concatenate([
        jnp.concatenate([d_hi, -md_hi], axis=1),           # (T, 2B)
        jnp.concatenate([d_lo, -md_lo], axis=1),
    ], axis=0)                                             # (2T, 2B)
    out = _mm(lhs, ab, "sb,bkm->skm")                      # (2T, 4, mb)
    return (out[:T] + out[T:]) * na


def marker_stats_jax(bed, na, nonas, *, dtype=jnp.float32, chunk=512,
                     axis_name=None):
    """Per-marker mean and inverse-sd for all traits, fused single pass.

    bed: (M, mb) uint8; na: (T, 4, mb); nonas: (T,).
    Returns (mave, msig) each (T, M):
      mave = sum(a*na)/sum(b*na)
      msig = 1/sqrt((sum(a^2*na) - 2*mave*sum(a*na) + mave^2*sum(b*na))
                    / (nonas-1))
    which equals the reference two-pass formula (phenotype.cpp:466-556)
    because a*b == a and b*b == b for this decode.

    The three reductions are integer sums below 2^24, so the bf16 matmuls
    are exact for float32 runs.
    """
    m = bed.shape[0]
    # Never copy or pad the bed (at UKB scale it is most of HBM — even a
    # device-side slice is a full copy): scan over chunk starts with
    # dynamic_slice, so only one (chunk, mb) tile materializes at a time.
    # The last start is clamped to m - chunk; overlapping rows are simply
    # recomputed and overwritten at the same output positions.
    chunk = min(chunk, m)
    n_steps = -(-m // chunk)

    fast = dtype == jnp.float32
    mm_dtype = _BF16 if fast else dtype

    def one_chunk(bc):
        a, b = decode_planes_jax(bc, dtype=mm_dtype)       # (chunk, 4, mb)
        nab = na.astype(mm_dtype)
        if fast:
            sa = _mm(a, nab, "bkm,tkm->tb")
            sb = _mm(b, nab, "bkm,tkm->tb")
            saa = _mm(a * a, nab, "bkm,tkm->tb")
        else:
            sa = jnp.einsum("bkm,tkm->tb", a, nab,
                            preferred_element_type=dtype, precision=_PREC)
            sb = jnp.einsum("bkm,tkm->tb", b, nab,
                            preferred_element_type=dtype, precision=_PREC)
            saa = jnp.einsum("bkm,tkm->tb", a * a, nab,
                             preferred_element_type=dtype, precision=_PREC)
        return sa, sb, saa

    t = na.shape[0]

    def body(carry, i):
        sa_f, sb_f, saa_f = carry
        start = jnp.minimum(i * chunk, m - chunk)
        bc = jax.lax.dynamic_slice(bed, (start, 0), (chunk, bed.shape[1]))
        sa, sb, saa = one_chunk(bc)                        # (T, chunk)
        sa_f = jax.lax.dynamic_update_slice(sa_f, sa.astype(sa_f.dtype),
                                            (0, start))
        sb_f = jax.lax.dynamic_update_slice(sb_f, sb.astype(sb_f.dtype),
                                            (0, start))
        saa_f = jax.lax.dynamic_update_slice(saa_f, saa.astype(saa_f.dtype),
                                             (0, start))
        return (sa_f, sb_f, saa_f), None

    zeros = jnp.zeros((t, m), _F32 if fast else dtype)
    if axis_name is not None:
        # Under shard_map the carry absorbs shard-varying chunk sums.
        zeros = jax.lax.pcast(zeros, (axis_name,), to='varying')
    (sa, sb, saa), _ = jax.lax.scan(
        body, (zeros, zeros, zeros), jnp.arange(n_steps))
    sa = sa.astype(dtype)
    sb = sb.astype(dtype)
    saa = saa.astype(dtype)

    mave = sa / sb
    ssq = saa - 2.0 * mave * sa + mave * mave * sb
    msig = 1.0 / jnp.sqrt(ssq / (nonas[:, None].astype(dtype) - 1.0))
    return mave, msig
