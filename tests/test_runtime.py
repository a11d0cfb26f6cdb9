"""Runtime plumbing: compile-cache placement, the state pytrees, matmul
precision on the sweep path, and the chip smoke script's refusal to run
without a GPU."""

import importlib.util
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.extend.core import ClosedJaxpr, Jaxpr

from gmrm_tpu import compile_cache
from gmrm_tpu.sampler.state import SamplerState, StaticInputs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("env", ["set", "unset"])
def test_compile_cache_placement(env, tmp_path, monkeypatch):
    """JAX_COMPILATION_CACHE_DIR is used as given and nothing else is
    set; without it the cache sits at the fixed <checkout>/.jax_cache."""
    before = jax.config.jax_compilation_cache_dir
    try:
        if env == "set":
            monkeypatch.setenv(compile_cache.ENV_VAR, str(tmp_path))
            jax.config.update("jax_compilation_cache_dir", None)
            assert compile_cache.enable() == str(tmp_path)
            assert jax.config.jax_compilation_cache_dir is None
        else:
            monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
            want = os.path.join(REPO, ".jax_cache")
            assert compile_cache.cache_dir() == want
            assert compile_cache.enable() == want
            assert jax.config.jax_compilation_cache_dir == want
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_state_pytree_roundtrip():
    """The state dataclasses are pytrees (flatten/unflatten, jit, tree
    maps) with a ``replace`` that copies, and are immutable."""
    z = jnp.zeros((2, 3))
    st = SamplerState(eps=z, betas=z, comp=z.astype(jnp.int32), acum=z,
                      cass=z, sigmag=z, sigmae=z[0], pi_est=z, mu=z[0],
                      epssum=z[0], key=jax.random.PRNGKey(0))
    leaves, treedef = jax.tree.flatten(st)
    assert len(leaves) == 11
    back = jax.tree.unflatten(treedef, leaves)
    assert isinstance(back, SamplerState)
    st2 = jax.jit(lambda s: s.replace(mu=s.mu + 1.0))(st)
    np.testing.assert_array_equal(np.asarray(st2.mu), 1.0)
    np.testing.assert_array_equal(np.asarray(st.mu), 0.0)
    with pytest.raises(AttributeError):
        st.mu = z[0]
    # gram_cache None is an empty subtree, not a leaf.
    si = StaticInputs(bed=z, na=z, mave=z, msig=z, group_of=z, mtotgrp=z,
                      nonas=z, cva=z, cvai=z, n_total=z, m_local=z)
    assert len(jax.tree.leaves(si)) == 11
    assert len(jax.tree.leaves(si.replace(gram_cache=z))) == 12


def _graft():
    spec = importlib.util.spec_from_file_location(
        "graft_entry_rt", os.path.join(REPO, "__graft_entry__.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _f32_dots(jaxpr):
    """Yield the precision of every f32 x f32 dot_general, sub-jaxprs
    (jit, scan, shard_map, ...) included."""
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            dts = [v.aval.dtype for v in eqn.invars]
            if all(d == jnp.float32 for d in dts):
                yield eqn.params["precision"]
        for p in eqn.params.values():
            for sub in (p if isinstance(p, (tuple, list)) else (p,)):
                if isinstance(sub, ClosedJaxpr):
                    yield from _f32_dots(sub.jaxpr)
                elif isinstance(sub, Jaxpr):
                    yield from _f32_dots(sub)


@pytest.mark.parametrize("path", ["serial", "wave", "sharded"])
def test_no_f32_dot_below_highest(path):
    """Every f32 x f32 contraction of a Gibbs iteration asks for HIGHEST
    precision, so no GPU runs it in TF32 (bf16 products of decoded integer
    planes and hi/lo splits are exact and are not f32 x f32)."""
    from gmrm_tpu.sampler.gibbs import gibbs_iteration
    g = _graft()
    it = jnp.asarray(1, jnp.int32)
    if path == "sharded":
        from gmrm_tpu.parallel.mesh import make_marker_mesh
        from gmrm_tpu.parallel.runner import make_sharded_step
        state, static, block = g._tiny_problem(m=8 * 16, block=8)
        static = static.replace(
            m_local=jnp.full((8,), 16, jnp.int32),
            gram_cache=jnp.zeros(
                (static.bed.shape[0] // block, 2, 2 * block, 2 * block)))
        step = make_sharded_step(make_marker_mesh(8), block_size=block,
                                 donate=False, wave_size=4, with_cache=True)
        jaxpr = jax.make_jaxpr(step)(state, static, it)
    else:
        state, static, block = g._tiny_problem(m=256, block=128)
        wave = 32 if path == "wave" else 1
        if wave > 1:
            static = static.replace(gram_cache=jnp.zeros(
                (static.bed.shape[0] // block, 2, 2 * block, 2 * block)))
        jaxpr = jax.make_jaxpr(
            lambda s, st, i: gibbs_iteration(s, st, i, block_size=block,
                                             wave_size=wave))(
            state, static, it)
    precs = list(_f32_dots(jaxpr.jaxpr))
    assert precs, "expected f32 contractions on the sweep path"
    highest = jax.lax.Precision.HIGHEST
    assert all(p is not None and all(q == highest for q in p)
               for p in precs), precs


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_fails_without_gpu(where, tmp_path):
    """chip_smoke.py exits non-zero and prints no result line when JAX has
    no GPU, and when it sits in a directory without the repo."""
    script = os.path.join(REPO, "chip_smoke.py")
    cwd = REPO
    if where == "alone":
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script, cwd = str(tmp_path / "chip_smoke.py"), str(tmp_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH="")
    proc = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
