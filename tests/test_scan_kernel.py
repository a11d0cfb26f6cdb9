"""The plain-JAX wave scan (sampler.scan.block_scan_wave) vs its references.

W=1 must reproduce the exact serial ``block_scan``; every W must match the
float64 NumPy wave reference ``oracle.wave_scan``.  Component choices must
match exactly; continuous outputs to float32 tolerance (the wave scan
uses the exponent-sum CDF form where the references walk pairwise terms).
"""

import numpy as np
import jax.numpy as jnp
import pytest

from gmrm_tpu import oracle
from gmrm_tpu.sampler.scan import block_scan, block_scan_wave

WAVES = [1, 4, 8, 32]
CASES = ["plain", "adav", "overflow"]


def _random_case(rng, T, B, G, K, *, adav_group=None, overflow=False,
                 strong_gram=False):
    c = rng.normal(size=(T, B)) * (200.0 if overflow else 5.0)
    if strong_gram:
        # Corrections material enough that within-wave blindness flips
        # draws (a wiring bug would show as component mismatches).
        gs = rng.normal(size=(T, B, B)) * 2.0
        gs = (gs + np.swapaxes(gs, 1, 2)) / 2
    else:
        gs = rng.normal(size=(T, B, B)) * 0.02
    beta_old = rng.normal(size=(T, B)) * 0.01
    comp_old = rng.integers(0, K, size=(T, B))
    acum_old = rng.uniform(size=(T, B))
    grp = rng.integers(0, G, size=B)
    valid = rng.uniform(size=B) > 0.1
    u = rng.uniform(size=(T, B))
    z = rng.normal(size=(T, B))
    sigmag = rng.uniform(0.05, 0.5, size=(T, G))
    if adav_group is not None:
        sigmag[:, adav_group] = 0.0
    sigmae = rng.uniform(0.3, 0.9, size=T)
    pi = rng.dirichlet(np.ones(K), size=(T, G))
    cva = np.sort(rng.uniform(1e-5, 1e-2, size=(G, K)), axis=1)
    cva[:, 0] = 0.0
    cvai = np.zeros_like(cva)
    cvai[:, 1:] = 1.0 / cva[:, 1:]
    nonas = np.full(T, 9900.0)
    n_total = 10000.0
    f32 = jnp.float32
    return (
        jnp.asarray(c, f32), jnp.asarray(gs, f32),
        jnp.asarray(beta_old, f32), jnp.asarray(comp_old, jnp.int32),
        jnp.asarray(acum_old, f32), jnp.asarray(grp, jnp.int32),
        jnp.asarray(valid), jnp.asarray(u, f32), jnp.asarray(z, f32),
        jnp.asarray(sigmag, f32), jnp.asarray(sigmae, f32),
        jnp.asarray(pi, f32), jnp.asarray(cva, f32), jnp.asarray(cvai, f32),
        jnp.asarray(nonas, f32), jnp.asarray(n_total, f32),
    )


def _case(name, T=3, B=64, G=2, K=4, seed=0, strong_gram=True):
    rng = np.random.default_rng(seed + CASES.index(name))
    return _random_case(rng, T, B, G, K,
                        adav_group=0 if name == "adav" else None,
                        overflow=name == "overflow", strong_gram=strong_gram)


@pytest.mark.parametrize("case", CASES)
def test_wave1_scan_matches_block_scan(case):
    """W=1 is the exact serial recursion: block_scan's outputs."""
    args = _case(case, T=3, B=32, strong_gram=False)
    ref = block_scan(*args)
    out = block_scan_wave(*args, wave=1)
    np.testing.assert_array_equal(
        np.asarray(out.comp_new), np.asarray(ref.comp_new),
        err_msg=f"{case}: component choices diverged")
    np.testing.assert_array_equal(np.asarray(out.cass_inc),
                                  np.asarray(ref.cass_inc))
    np.testing.assert_allclose(np.asarray(out.beta_new),
                               np.asarray(ref.beta_new),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(out.dbeta_eff),
                               np.asarray(ref.dbeta_eff),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(out.acum_new),
                               np.asarray(ref.acum_new),
                               rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("W", WAVES)
@pytest.mark.parametrize("case", CASES)
def test_wave_scan_matches_wave_reference(case, W):
    """Every wave width vs the float64 wave reference, with couplings
    strong enough that within-wave blindness matters."""
    args = _case(case, seed=11)
    ref_db, ref_b, ref_c, ref_a, ref_cass = oracle.wave_scan(
        *(np.asarray(a) for a in args), wave=W)
    out = block_scan_wave(*args, wave=W)
    np.testing.assert_array_equal(np.asarray(out.comp_new), ref_c)
    np.testing.assert_array_equal(np.asarray(out.cass_inc), ref_cass)
    np.testing.assert_allclose(np.asarray(out.beta_new), ref_b,
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(out.dbeta_eff), ref_db,
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(out.acum_new), ref_a,
                               rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("W", [1, 4])
def test_wave_scan_serial_dependency(W):
    """The Gram correction must propagate to later waves: a strong first
    marker changes the draw of a correlated marker in a later wave."""
    rng = np.random.default_rng(7)
    T, B, G, K = 1, 8, 1, 4
    args = list(_random_case(rng, T, B, G, K))
    # Marker 0 strongly selected and correlated with marker 5.
    c = np.zeros((T, B)); c[0, 0] = 400.0; c[0, 5] = 30.0
    gs = np.zeros((T, B, B)); gs[0, 0, 5] = gs[0, 5, 0] = 500.0
    args[0] = jnp.asarray(c, jnp.float32)
    args[1] = jnp.asarray(gs, jnp.float32)
    args[6] = jnp.ones(B, bool)
    out = block_scan_wave(*args, wave=W)
    ref = oracle.wave_scan(*(np.asarray(a) for a in args), wave=W)
    np.testing.assert_array_equal(np.asarray(out.comp_new), ref[2])
    np.testing.assert_allclose(np.asarray(out.beta_new), ref[1],
                               rtol=1e-5, atol=1e-6)
    # And the later marker's beta is genuinely affected by the earlier one.
    args[1] = jnp.zeros((T, B, B), jnp.float32)
    out2 = block_scan_wave(*args, wave=W)
    assert not np.allclose(np.asarray(out.beta_new)[0, 5],
                           np.asarray(out2.beta_new)[0, 5])
