"""The cached-Gram wave sweep vs the same sweep recomputing every Gram.

Both run the SAME wave relaxation over the same block-preserving shuffle;
the Gram comes either from ``build_gram_cache`` (exact integer counts,
permuted and scaled per block) or from ``blockops.block_gram`` on each
block.  Outputs must agree: component choices exactly, continuous state
to f32 tolerance.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from gmrm_tpu.config import Options
from gmrm_tpu.io.bed import decode_planes, unpack_codes
from gmrm_tpu.io.sim import simulate
from gmrm_tpu.ops.blockops import build_gram_cache
from gmrm_tpu.ops.decode import from_phase_planes
from gmrm_tpu.runner import load_data, build_static, init_sampler_state
from gmrm_tpu.sampler.gibbs import gibbs_iteration


def _setup(out, *, n, m, n_traits, block_size, wave, na_rate, seed):
    sim = simulate(out, n=n, m=m, n_traits=n_traits, n_causal=m // 4,
                   h2=0.5, n_groups=2, na_rate=na_rate, seed=seed)
    opt = Options(bed_file=sim.bed, dim_file=sim.dim, phen_files=sim.phens,
                  group_index_file=sim.gri, group_mixture_file=sim.grm,
                  iterations=1, seed=3, block_size=block_size,
                  wave_size=wave, output_thin_rate=10 ** 9)
    opt.validate()
    opt.load_group_mixtures()
    data = load_data(opt, interleave=True)
    static = build_static(data, opt, jnp.float32)
    state = init_sampler_state(data, opt, jnp.float32)
    return opt, data, static, state


@pytest.fixture(scope="module")
def small_setup(tmp_path_factory):
    return _setup(str(tmp_path_factory.mktemp("cachedata")), n=600, m=128,
                  n_traits=2, block_size=32, wave=8, na_rate=0.02, seed=7)


def test_cached_gram_matches_recompute(small_setup):
    """The cached-Gram sweep (gram from build_gram_cache, permuted and
    scaled per block) must agree with the recompute sweep: identical
    processing order, identical math restructuring — components exactly,
    continuous state to f32 tolerance."""
    opt, data, static, state = small_setup
    shared_na = all(ph.nas == 0 for ph in data.phens)
    assert static.gram_cache is not None

    outs = {}
    for name, st in (("recompute", static.replace(gram_cache=None)),
                     ("cached", static)):
        s2, _ = gibbs_iteration(
            state, st, jnp.asarray(5, jnp.int32),
            block_size=opt.block_size, shared_na=shared_na,
            wave_size=opt.wave_size)
        outs[name] = jax.device_get(s2)

    a, b = outs["recompute"], outs["cached"]
    np.testing.assert_array_equal(np.asarray(b.comp), np.asarray(a.comp))
    np.testing.assert_array_equal(np.asarray(b.cass), np.asarray(a.cass))
    np.testing.assert_allclose(np.asarray(b.betas), np.asarray(a.betas),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(b.eps), np.asarray(a.eps),
                               rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def b512_setup(tmp_path_factory):
    """Two 512-marker blocks with per-trait NA masks."""
    return _setup(str(tmp_path_factory.mktemp("b512data")), n=300, m=1024,
                  n_traits=2, block_size=512, wave=32, na_rate=0.02, seed=11)


@pytest.mark.parametrize("B", [128, 512])
def test_gram_cache_matches_float64_counts(b512_setup, B):
    """The Gram cache is BITWISE equal to float64 integer counts of the
    decoded planes, per trait mask, for every block."""
    opt, data, static, state = b512_setup
    bed = np.asarray(static.bed)
    na = np.asarray(static.na)
    got = np.asarray(build_gram_cache(static.bed, static.na, block_size=B,
                                      shared_na=False), np.float64)
    assert got.shape == (bed.shape[0] // B, na.shape[0], 2 * B, 2 * B)
    a, b = decode_planes(unpack_codes(bed, 4 * bed.shape[1]))
    na_i = from_phase_planes(na)                      # (T, 4*mb)
    for k in (0, got.shape[0] - 1):
        rows = slice(k * B, (k + 1) * B)
        ab = np.concatenate([a[rows], b[rows]]).astype(np.float64)
        want = np.einsum("tn,bn,cn->tbc", na_i, ab, ab)
        np.testing.assert_array_equal(got[k], want)
