"""The bf16 block operations (ops/blockops.py) vs a float64 NumPy decode.

The float32 path runs every product on decoded integer planes in bf16 with
f32 accumulation (exact) and Dekker-splits the continuous operand into bf16
hi+lo, so it must agree with float64 ground truth to the split's ~2^-17
relative error; the Gram cache builder must be bit-identical to float64
integer counts.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from gmrm_tpu.io.bed import decode_planes, unpack_codes
from gmrm_tpu.ops.blockops import (
    block_cdot, block_eps_update, block_gram, build_gram_cache,
)
from gmrm_tpu.ops.decode import from_phase_planes, to_phase_planes


def _case(rng, T, B, mb, *, with_nas):
    bed = rng.integers(0, 256, size=(B, mb), dtype=np.uint8)
    na = np.ones((T, 4, mb), np.float32)
    if with_nas:
        na *= (rng.uniform(size=(T, 4, mb)) > 0.03)
    eps = rng.normal(size=(T, 4, mb)).astype(np.float32) * na
    # realistic mave/msig ranges
    mave = rng.uniform(0.2, 1.8, size=(T, B)).astype(np.float32)
    msig = rng.uniform(0.5, 2.0, size=(T, B)).astype(np.float32)
    return bed, eps, na, mave, msig


def _planes64(bed):
    """(a, b) float64 decoded planes (B, 4*mb) in individual order."""
    a, b = decode_planes(unpack_codes(bed, 4 * bed.shape[1]))
    return a.astype(np.float64), b.astype(np.float64)


def _reference(bed, eps, na, mave):
    """float64 craw (T, B), graw (T, B, B), and the centered planes."""
    a, b = _planes64(bed)
    eps_i = from_phase_planes(np.asarray(eps, np.float64))   # (T, 4mb)
    na_i = from_phase_planes(np.asarray(na, np.float64))
    m = np.asarray(mave, np.float64)
    xc = a[None] - m[:, :, None] * b[None]                    # (T, B, 4mb)
    craw = np.einsum("tbn,tn->tb", xc, eps_i)
    graw = np.einsum("tbn,tcn->tbc", xc * na_i[:, None], xc)
    return craw, graw, xc, na_i


# mb values: short ragged, long ragged, and 512-aligned rows.
@pytest.mark.parametrize("mb", [300, 700, 512])
@pytest.mark.parametrize("shared_na", [True, False])
def test_gram_kernel_matches_blockops(mb, shared_na):
    rng = np.random.default_rng(mb + int(shared_na))
    T, B = 3, 32
    bed, eps, na, mave, msig = _case(rng, T, B, mb, with_nas=not shared_na)

    craw, graw = block_gram(jnp.asarray(bed), jnp.asarray(eps),
                            jnp.asarray(na), jnp.asarray(mave),
                            dtype=jnp.float32, shared_na=shared_na)
    c_ref, g_ref, _, _ = _reference(bed, eps, na, mave)
    c_scale = np.abs(c_ref).max()
    np.testing.assert_allclose(np.asarray(craw) / c_scale, c_ref / c_scale,
                               rtol=0, atol=1e-5)
    # The Gram is exact integer sums recombined with the means in f32.
    g_scale = np.abs(g_ref).max()
    np.testing.assert_allclose(np.asarray(graw) / g_scale, g_ref / g_scale,
                               rtol=0, atol=1e-6)
    # block_cdot is the c-half of block_gram, bit for bit.
    np.testing.assert_array_equal(
        np.asarray(block_cdot(jnp.asarray(bed), jnp.asarray(eps),
                              jnp.asarray(mave))),
        np.asarray(craw))

    # The cache builder's raw quadrants are exact float64 counts.
    a, b = _planes64(bed)
    ab = np.concatenate([a, b])
    na_i = from_phase_planes(np.asarray(na, np.float64))
    nt = 1 if shared_na else T
    want = np.einsum("tn,bn,cn->tbc", na_i[:nt], ab, ab)
    got = build_gram_cache(jnp.asarray(bed), jnp.asarray(na), block_size=B,
                           shared_na=shared_na)
    assert got.shape == (1, nt, 2 * B, 2 * B)
    np.testing.assert_array_equal(np.asarray(got[0], np.float64), want)


@pytest.mark.parametrize("mb", [300, 700])
def test_eps_update_kernel_matches_blockops(mb):
    rng = np.random.default_rng(mb)
    T, B = 3, 32
    bed, eps, na, mave, msig = _case(rng, T, B, mb, with_nas=True)
    dbeta = (rng.normal(size=(T, B)) *
             (rng.uniform(size=(T, B)) > 0.5)).astype(np.float32)

    deps = block_eps_update(jnp.asarray(bed), jnp.asarray(dbeta),
                            jnp.asarray(na), jnp.asarray(mave),
                            dtype=jnp.float32)
    _, _, xc, na_i = _reference(bed, eps, na, mave)
    want = np.einsum("tb,tbn->tn", np.asarray(dbeta, np.float64), xc) * na_i
    want = to_phase_planes(want)
    scale = np.abs(want).max()
    np.testing.assert_allclose(np.asarray(deps) / scale, want / scale,
                               rtol=0, atol=1e-5)


def test_gram_kernel_wide_dtype_fallback():
    """float64 takes the plain HIGHEST-precision einsums: they agree with
    the float64 NumPy reference to float64 rounding."""
    rng = np.random.default_rng(0)
    T, B, mb = 2, 8, 64
    bed, eps, na, mave, msig = _case(rng, T, B, mb, with_nas=True)
    c_ref, g_ref, _, _ = _reference(bed, eps, na, mave)
    with jax.enable_x64(True):
        f64 = jnp.float64
        craw, graw = block_gram(jnp.asarray(bed), jnp.asarray(eps, f64),
                                jnp.asarray(na, f64), jnp.asarray(mave, f64),
                                dtype=f64)
        assert craw.dtype == f64 and graw.dtype == f64
        np.testing.assert_allclose(np.asarray(craw), c_ref, rtol=1e-12,
                                   atol=1e-9)
        np.testing.assert_allclose(np.asarray(graw), g_ref, rtol=1e-12,
                                   atol=1e-9)


@pytest.mark.parametrize("T,mb", [(1, 300), (4, 700), (5, 512)])
def test_fused_kernels_match_blockops(T, mb):
    """The Triton-route decode kernels (interpret mode here; compiled on
    the card by tests/test_gpu.py) against the plain versions on the
    gathered rows: ragged column tails, trait counts padded to the dot
    width, rows read in a shuffled order."""
    from gmrm_tpu.ops.triton_kernels import (
        block_cdot_fused, block_eps_update_fused,
    )
    rng = np.random.default_rng(T * 1000 + mb)
    B, M = 32, 96
    bed, eps, na, mave, msig = _case(rng, T, M, mb, with_nas=True)
    rows = rng.permutation(M)[:B].astype(np.int32)
    mave = mave[:, :B]
    d = rng.normal(size=(T, B)).astype(np.float32)
    args = [jnp.asarray(x) for x in (bed, rows, eps, mave)]
    c = block_cdot_fused(*args, interpret=True)
    want = block_cdot(jnp.asarray(bed[rows]), args[2], args[3])
    np.testing.assert_allclose(np.asarray(c), np.asarray(want),
                               rtol=0, atol=1e-5 * np.abs(want).max())
    deps = block_eps_update_fused(args[0], args[1], jnp.asarray(d),
                                  jnp.asarray(na), args[3], interpret=True)
    want = block_eps_update(jnp.asarray(bed[rows]), jnp.asarray(d),
                            jnp.asarray(na), args[3])
    np.testing.assert_allclose(np.asarray(deps), np.asarray(want),
                               rtol=0, atol=1e-5 * np.abs(want).max())


def test_fused_kernels_under_shard_map():
    """The kernels under shard_map with the mesh axis named, as the
    sharded sweep calls them (vma checking off: the interpreter's kernel
    loop cannot type its own constants as varying)."""
    from jax.sharding import PartitionSpec as P
    from gmrm_tpu.ops.triton_kernels import (
        block_cdot_fused, block_eps_update_fused,
    )
    from gmrm_tpu.parallel.mesh import MARKER_AXIS, make_marker_mesh
    D, T, B, mb = 8, 2, 16, 200
    rng = np.random.default_rng(3)
    bed, eps, na, mave, _ = _case(rng, T, D * B, mb, with_nas=True)
    rows = np.concatenate([rng.permutation(B) for _ in range(D)]).astype(
        np.int32)
    d = rng.normal(size=(T, D * B)).astype(np.float32)

    def body(fused, bed, rows, eps, na, mave, d):
        if fused:
            c = block_cdot_fused(bed, rows, eps, mave, axis_name=MARKER_AXIS,
                                 interpret=True)
            u = block_eps_update_fused(bed, rows, d, na, mave,
                                       axis_name=MARKER_AXIS, interpret=True)
        else:
            blk = jnp.take(bed, rows, axis=0)
            c = block_cdot(blk, eps, mave)
            u = block_eps_update(blk, d, na, mave)
        return c, jax.lax.psum(u, MARKER_AXIS)

    sh, sh2, rep = P(MARKER_AXIS), P(None, MARKER_AXIS), P()
    outs = [jax.jit(jax.shard_map(
        functools.partial(body, fused), mesh=make_marker_mesh(D),
        in_specs=(sh, sh, rep, rep, sh2, sh2), out_specs=(sh2, rep),
        check_vma=False))(
            bed, rows, eps, na, mave, d) for fused in (True, False)]
    for got, want in zip(*outs):
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=0, atol=1e-5 * np.abs(want).max())


def _primitives(jaxpr):
    from jax.extend.core import ClosedJaxpr, Jaxpr
    for eqn in jaxpr.eqns:
        yield eqn.primitive.name
        for p in eqn.params.values():
            for sub in (p if isinstance(p, (tuple, list)) else (p,)):
                if isinstance(sub, ClosedJaxpr):
                    yield from _primitives(sub.jaxpr)
                elif isinstance(sub, Jaxpr):
                    yield from _primitives(sub)


@pytest.mark.parametrize("mb", [2560, 25088])
def test_fused_kernel_choice(mb):
    """The sweep's block ops carry the fused kernels as the CUDA branch
    of the lowering; lowered for the CPU, the plain branch runs and gives
    the plain result (to f32 rounding of a differently fused program)."""
    from gmrm_tpu.ops.triton_kernels import (
        block_cdot_rows, block_eps_update_rows,
    )
    rng = np.random.default_rng(mb)
    T, B = 4, 16
    bed, eps, na, mave, _ = _case(rng, T, 2 * B, mb, with_nas=True)
    rows = rng.permutation(2 * B)[:B].astype(np.int32)
    mave = mave[:, :B]
    d = rng.normal(size=(T, B)).astype(np.float32)
    for fn, args, plain in (
            (block_cdot_rows, (bed, rows, eps, mave),
             lambda: block_cdot(jnp.asarray(bed[rows]), eps, mave)),
            (block_eps_update_rows, (bed, rows, d, na, mave),
             lambda: block_eps_update(jnp.asarray(bed[rows]), d, na,
                                      mave))):
        prims = set(_primitives(jax.make_jaxpr(fn)(*args).jaxpr))
        assert "pallas_call" in prims, prims
        got, want = np.asarray(jax.jit(fn)(*args)), np.asarray(plain())
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-6 * np.abs(want).max())
