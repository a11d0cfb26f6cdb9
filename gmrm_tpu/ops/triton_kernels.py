"""Fused decode + product kernels for the wave sweep on NVIDIA GPUs
(Pallas, Triton route).

They compute what ``blockops.block_cdot`` and ``blockops.block_eps_update``
compute for one block, but read the packed bed rows of the block straight
from the natural-order bed (the block's row indices are an input) and
decode the 2-bit codes in registers: XLA's plain version materialises the
decoded bf16 planes in device memory, 16x the packed bytes.

Numerics are those of the plain version: decoded planes are exact small
integers in bf16, the continuous operand is split hi/lo into two bf16
halves (``blockops.split_hi_lo``, in integer arithmetic), products
accumulate in f32.

- ``block_cdot_fused``: c partials over column chunks, one chunk range per
  program, then a deterministic XLA sum over programs (no atomics: an
  MCMC chain must not vary from run to run).
- ``block_eps_update_fused``: every program owns its own columns of the
  residual delta; nothing is reduced across programs.

``block_cdot_rows`` / ``block_eps_update_rows`` choose between these and
the plain versions by the lowering platform.

Trait rows are padded to a power of two of at least 16, Triton's minimum
dot width.  Neither wrapper picks interpret mode by itself.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from gmrm_tpu.io.bed import MISSING_BYTE
from gmrm_tpu.ops.blockops import block_cdot, block_eps_update, split_hi_lo

_BF16 = jnp.bfloat16
_F32 = jnp.float32
# Tile sizes, from device time per block on an H100 at N = 10k and 100k
# (benchmarking/kernel_ab.py, PERF.md): x^T eps in (64 rows x 128 bytes)
# tiles over at most 128 column ranges; the update in 32-byte columns.
_CDOT_CHUNK = 128      # packed bytes per step: 512 individuals
_CDOT_ROWS = 64        # bed rows per program
_MAX_PROGRAMS = 128    # column ranges (each writes a partial sum)
_UPDATE_CHUNK = 32
_PARAMS = plgpu.CompilerParams(num_warps=4, num_stages=2)


def _trait_rows(n_traits: int) -> int:
    return max(16, pl.next_power_of_2(n_traits))


def _planes(codes, k):
    """Plane k of int32 byte values -> (a, b) bf16: a = dosage, b =
    present (code map of ops/decode.py: 00->2, 01->missing, 10->1,
    11->0)."""
    ck = (codes >> (2 * k)) & 3
    b = (ck != 1).astype(jnp.int32)
    a = ((4 - ck) >> 1) * b
    return a.astype(_BF16), b.astype(_BF16)


def _dot(x, y, contract):
    return jax.lax.dot_general(x, y, (contract, ((), ())),
                               preferred_element_type=_F32)


def _columns(j, steps, s, chunk, mb):
    col = (j * steps + s) * chunk + jnp.arange(chunk)
    return col, col < mb


def _load_codes(rows, bed_ref, col, cmask):
    return plgpu.load(bed_ref.at[rows[:, None], col[None, :]],
                      mask=cmask[None, :],
                      other=MISSING_BYTE).astype(jnp.int32)


def _cdot_kernel(rows_ref, bed_ref, eps_ref, mave_ref, out_ref, *,
                 n_traits, steps, row_block):
    r = pl.program_id(0)
    j = pl.program_id(1)
    B = rows_ref.shape[0]
    mb = bed_ref.shape[1]
    tp = _trait_rows(n_traits)
    bi = r * row_block + jnp.arange(row_block)        # slots of this tile
    rows = plgpu.load(rows_ref.at[bi])
    t = jnp.arange(tp)
    tmask = t < n_traits

    def step(s, acc):
        acc_a, acc_b = acc
        col, cmask = _columns(j, steps, s, _CDOT_CHUNK, mb)
        codes = _load_codes(rows, bed_ref, col, cmask)      # (RB, CHUNK)
        for k in range(4):
            e = plgpu.load(eps_ref.at[(t * 4 + k)[:, None], col[None, :]],
                           mask=tmask[:, None] & cmask[None, :], other=0.0)
            hi, lo = split_hi_lo(e)                         # (tp, CHUNK)
            a, b = _planes(codes, k)
            acc_a = acc_a + _dot(a, hi, ((1,), (1,))) + _dot(a, lo, ((1,), (1,)))
            acc_b = acc_b + _dot(b, hi, ((1,), (1,))) + _dot(b, lo, ((1,), (1,)))
        return acc_a, acc_b

    zeros = jnp.zeros((row_block, tp), _F32)
    acc_a, acc_b = jax.lax.fori_loop(0, steps, step, (zeros, zeros))
    m = plgpu.load(mave_ref.at[t[None, :], bi[:, None]],
                   mask=tmask[None, :], other=0.0)          # (RB, tp)
    plgpu.store(out_ref.at[(j * B + bi)[:, None], t[None, :]],
                acc_a - m * acc_b, mask=tmask[None, :])


def _update_kernel(rows_ref, bed_ref, lhs_ref, na_ref, out_ref, *,
                   n_traits):
    j = pl.program_id(0)
    B = rows_ref.shape[0]
    mb = bed_ref.shape[1]
    tp = _trait_rows(n_traits)
    rows = rows_ref[...]
    t = jnp.arange(tp)
    tmask = t < n_traits
    bi = jnp.arange(B)
    # rows [d_hi; d_lo; -md_hi; -md_lo], each (tp, B)
    lhs = [plgpu.load(lhs_ref.at[(q * tp + t)[:, None], bi[None, :]])
           for q in range(4)]
    col, cmask = _columns(j, 1, 0, _UPDATE_CHUNK, mb)
    codes = _load_codes(rows, bed_ref, col, cmask)
    mask = tmask[:, None] & cmask[None, :]
    for k in range(4):
        a, b = _planes(codes, k)
        out = (_dot(lhs[0], a, ((1,), (0,))) + _dot(lhs[1], a, ((1,), (0,)))
               + _dot(lhs[2], b, ((1,), (0,))) + _dot(lhs[3], b, ((1,), (0,))))
        idx = ((t * 4 + k)[:, None], col[None, :])
        na = plgpu.load(na_ref.at[idx], mask=mask, other=0.0)
        plgpu.store(out_ref.at[idx], out * na, mask=mask)


def _vma(axis_name):
    return frozenset() if axis_name is None else frozenset((axis_name,))


def _varying(axis_name, xs):
    """Under shard_map every kernel operand must vary over the mesh axis."""
    if axis_name is None:
        return xs
    return [x if axis_name in jax.typeof(x).vma
            else jax.lax.pcast(x, (axis_name,), to="varying") for x in xs]


def _programs(mb: int, chunk: int, cap: int):
    chunks = -(-mb // chunk)
    programs = min(chunks, cap)
    return programs, -(-chunks // programs)


@functools.partial(jax.jit, static_argnames=("axis_name", "interpret"))
def block_cdot_fused(bed, rows, eps, mave, *, axis_name=None,
                     interpret=False):
    """craw (T, B) = x^T eps of the bed rows ``rows`` (B,) int32 (one
    block in processing order), as ``blockops.block_cdot`` of
    ``bed[rows]``.  bed (M, mb) u8; eps (T, 4, mb) f32; mave (T, B)."""
    T = eps.shape[0]
    B = rows.shape[0]
    mb = bed.shape[1]
    programs, steps = _programs(mb, _CDOT_CHUNK, _MAX_PROGRAMS)
    row_block = min(_CDOT_ROWS, B)
    call = pl.pallas_call(
        functools.partial(_cdot_kernel, n_traits=T, steps=steps,
                          row_block=row_block),
        out_shape=jax.ShapeDtypeStruct((programs * B, T), _F32,
                                       vma=_vma(axis_name)),
        grid=(B // row_block, programs), backend="triton",
        compiler_params=_PARAMS, interpret=interpret, name="gmrm_cdot")
    part = call(*_varying(axis_name, [
        rows.astype(jnp.int32), bed, eps.astype(_F32).reshape(T * 4, mb),
        mave.astype(_F32)]))
    return part.reshape(programs, B, T).sum(axis=0).T


@functools.partial(jax.jit, static_argnames=("axis_name", "interpret"))
def block_eps_update_fused(bed, rows, dbeta_scaled, na, mave, *,
                           axis_name=None, interpret=False):
    """deps (T, 4, mb) as ``blockops.block_eps_update`` of ``bed[rows]``:
    na * sum_j dbeta_scaled[t, j] * (a_j - mave[t, j] b_j)."""
    T, B = dbeta_scaled.shape
    mb = bed.shape[1]
    tp = _trait_rows(T)
    d = dbeta_scaled.astype(_F32)
    parts = (*split_hi_lo(d), *split_hi_lo(-(mave.astype(_F32) * d)))
    lhs = jnp.zeros((4, tp, B), _BF16).at[:, :T].set(jnp.stack(parts))
    programs = -(-mb // _UPDATE_CHUNK)
    call = pl.pallas_call(
        functools.partial(_update_kernel, n_traits=T),
        out_shape=jax.ShapeDtypeStruct((T * 4, mb), _F32,
                                       vma=_vma(axis_name)),
        grid=(programs,), backend="triton", compiler_params=_PARAMS,
        interpret=interpret, name="gmrm_eps_update")
    out = call(*_varying(axis_name, [
        rows.astype(jnp.int32), bed, lhs.reshape(4 * tp, B),
        na.astype(_F32).reshape(T * 4, mb)]))
    return out.reshape(T, 4, mb)


def block_cdot_rows(bed, rows, eps, mave, *, axis_name=None):
    """x^T eps of the bed rows ``rows``: the fused kernel where a float32
    computation is lowered for CUDA, ``blockops.block_cdot`` elsewhere."""
    def plain(bed, rows, eps, mave):
        return block_cdot(jnp.take(bed, rows, axis=0), eps, mave,
                          dtype=eps.dtype)
    if eps.dtype != _F32:
        return plain(bed, rows, eps, mave)
    return jax.lax.platform_dependent(
        bed, rows, eps, mave, default=plain,
        cuda=functools.partial(block_cdot_fused, axis_name=axis_name))


def block_eps_update_rows(bed, rows, dbeta_scaled, na, mave, *,
                          axis_name=None):
    """The residual delta of the bed rows ``rows``: the fused kernel
    where a float32 computation is lowered for CUDA,
    ``blockops.block_eps_update`` elsewhere."""
    def plain(bed, rows, d, na, mave):
        return block_eps_update(jnp.take(bed, rows, axis=0), d, na, mave,
                                dtype=d.dtype)
    if dbeta_scaled.dtype != _F32:
        return plain(bed, rows, dbeta_scaled, na, mave)
    return jax.lax.platform_dependent(
        bed, rows, dbeta_scaled, na, mave, default=plain,
        cuda=functools.partial(block_eps_update_fused, axis_name=axis_name))
