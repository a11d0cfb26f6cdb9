"""Checks that need the card: compiled for the GPU, compared with the
float64 references and with the same code on the CPU.  Marked ``gpu``;
they skip where JAX has no GPU.  Run them on the card with
``JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/`` (chip_smoke.py
runs them in its own process)."""

import importlib.util
import os

import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest

from gmrm_tpu import oracle
from gmrm_tpu.ops.blockops import block_cdot, block_eps_update, build_gram_cache
from gmrm_tpu.ops.decode import to_phase_planes
from gmrm_tpu.ops.triton_kernels import (
    block_cdot_fused, block_eps_update_fused,
)
from gmrm_tpu.sampler.gibbs import gibbs_iteration
from gmrm_tpu.sampler.scan import block_scan_wave
from test_gram_kernel import _case, _planes64, _reference
from test_scan_kernel import _random_case

pytestmark = pytest.mark.gpu

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _on(device, fn, *args):
    return jax.device_get(jax.jit(fn)(*jax.device_put(args, device)))


def test_rng_matches_cpu(gpu):
    """The sampler's draws (block order, uniforms, normals, gamma for the
    Dirichlet and scaled-inverse-chi-squared) are the CPU's."""
    def draws(key):
        k1, k2, k3, k4 = jr.split(key, 4)
        return (jr.permutation(k1, jnp.arange(157, dtype=jnp.int32)),
                jr.uniform(k2, (4, 128)), jr.normal(k3, (4, 128)),
                jr.gamma(k4, jnp.linspace(0.5, 5000.0, 256)))
    key = jr.PRNGKey(20261016)
    g = _on(gpu, draws, key)
    c = _on(jax.devices("cpu")[0], draws, key)
    np.testing.assert_array_equal(g[0], c[0])
    np.testing.assert_array_equal(g[1], c[1])
    np.testing.assert_allclose(g[2], c[2], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(g[3], c[3], rtol=1e-5)


def test_block_ops_on_card(gpu):
    """x^T eps, the residual update (plain XLA and the fused kernels) and
    the Gram cache at N = 10,000 against float64: the bf16 products run
    exact on the card."""
    rng = np.random.default_rng(1)
    T, B, mb = 4, 128, 2500
    bed, eps, na, mave, msig = _case(rng, T, B, mb, with_nas=True)
    dbeta = rng.normal(size=(T, B)).astype(np.float32)
    c_ref, _, xc, na_i = _reference(bed, eps, na, mave)
    c = _on(gpu, block_cdot, bed, eps, mave)
    assert np.abs(c - c_ref).max() <= 1e-5 * np.abs(c_ref).max()
    deps = _on(gpu, block_eps_update, bed, dbeta, na, mave)
    want = to_phase_planes(
        np.einsum("tb,tbn->tn", dbeta.astype(np.float64), xc) * na_i)
    assert np.abs(deps - want).max() <= 1e-5 * np.abs(want).max()
    # The fused Triton-route kernels, reading the rows in shuffled order.
    rows = np.random.default_rng(2).permutation(B).astype(np.int32)
    c = _on(gpu, block_cdot_fused, bed, rows, eps, mave[:, rows])
    assert np.abs(c - c_ref[:, rows]).max() <= 1e-5 * np.abs(c_ref).max()
    deps = _on(gpu, block_eps_update_fused, bed, rows, dbeta[:, rows], na,
               mave[:, rows])
    assert np.abs(deps - want).max() <= 1e-5 * np.abs(want).max()
    gram = _on(gpu, lambda b, n: build_gram_cache(b, n, block_size=B,
                                                  shared_na=False), bed, na)
    a, b = _planes64(bed)
    ab = np.concatenate([a, b])
    for t in range(T):
        np.testing.assert_array_equal(gram[0, t], (ab * na_i[t]) @ ab.T)


def test_wave_scan_on_card(gpu):
    """The production wave scan (B=128, W=32, T=4) on the card vs the
    float64 wave reference: a TF32 correction product would miss."""
    rng = np.random.default_rng(11)
    args = list(_random_case(rng, 4, 128, 2, 4))
    gs = rng.normal(size=(4, 128, 128)) * 2.0
    args[1] = jnp.asarray((gs + np.swapaxes(gs, 1, 2)) / 2, jnp.float32)
    out = _on(gpu, lambda *a: block_scan_wave(*a, wave=32), *args)
    ref = oracle.wave_scan(*(np.asarray(a) for a in args), wave=32)
    np.testing.assert_array_equal(out.comp_new, ref[2])
    np.testing.assert_array_equal(out.cass_inc, ref[4])
    np.testing.assert_allclose(out.beta_new, ref[1], rtol=1e-4, atol=1e-5)


def test_iteration_on_card_matches_cpu(gpu):
    """One full Gibbs iteration (wave path with Gram cache; integer cass
    contractions included) on the card and on the CPU from the same
    inputs: the same draws and the same components."""
    spec = importlib.util.spec_from_file_location(
        "graft_entry_gpu", os.path.join(REPO, "__graft_entry__.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    state, static, block = mod._tiny_problem(n=2000, m=500, t=4, block=128)
    static = static.replace(gram_cache=build_gram_cache(
        static.bed, static.na, block_size=block, shared_na=False))

    def step(s, st):
        return gibbs_iteration(s, st, jnp.asarray(1, jnp.int32),
                               block_size=block, wave_size=32)
    g, _ = _on(gpu, step, state, static)
    c, _ = _on(jax.devices("cpu")[0], step, state, static)
    np.testing.assert_array_equal(g.comp, c.comp)
    np.testing.assert_array_equal(g.cass, c.cass)
    np.testing.assert_allclose(g.betas, c.betas, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(g.eps, c.eps, rtol=1e-4, atol=1e-5)
