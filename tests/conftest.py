"""Test harness config: an 8-device virtual CPU mesh before JAX loads.

This is the device-mesh analog of testing the reference's multi-rank MPI
semantics without a cluster (SURVEY §4): all sharding tests run on
xla_force_host_platform_device_count=8.  JAX_PLATFORMS defaults to the
CPU; tests marked ``gpu`` need the card and take it through the ``gpu``
fixture, which skips them elsewhere.  Run them on the card with
``JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/``.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "1")
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES", "0")

import subprocess

import numpy as np
import pytest

from gmrm_tpu import compile_cache

compile_cache.enable()

# Build the native IO library if missing so its tests never silently skip
# (the reference's MPI-IO layer analog, _native/io_native.cpp).
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SO = os.path.join(_REPO, "_native", "libgmrm_io.so")
if not os.path.exists(_SO):
    try:
        subprocess.run(["make", "-C", os.path.join(_REPO, "_native")],
                       check=True, capture_output=True, timeout=120)
    except Exception:
        pass  # test_native.py will skip with its usual reason


@pytest.fixture
def gpu():
    """The card, for tests marked ``gpu``; skips where JAX has none."""
    import jax
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (run on the card: "
                    "JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/)")
    return jax.devices()[0]


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(171014)


@pytest.fixture(scope="session")
def sim_small(tmp_path_factory):
    """Small simulated dataset shared across tests.

    Mixture grid is matched to the causal density (top variance ~
    1/n_causal) — with a mismatched grid the BayesR posterior correctly
    collapses sigmaG toward 0, which is faithful but useless for tests.
    """
    from gmrm_tpu.io.sim import simulate

    out = tmp_path_factory.mktemp("sim_small")
    return simulate(
        str(out), n=402, m=96, n_traits=2, n_causal=24, h2=0.5,
        n_groups=2, na_rate=0.03, seed=20260817,
        mixtures=np.array([0.0, 0.001, 0.01, 0.05]),
    )


@pytest.fixture(scope="session")
def sim_medium(tmp_path_factory):
    """Better-conditioned dataset for convergence-sensitive tests."""
    from gmrm_tpu.io.sim import simulate

    out = tmp_path_factory.mktemp("sim_medium")
    return simulate(
        str(out), n=800, m=250, n_traits=2, n_causal=64, h2=0.5,
        n_groups=2, na_rate=0.02, seed=123,
        mixtures=np.array([0.0, 0.001, 0.01, 0.02]),
    )


@pytest.fixture(scope="session")
def sim_tiny(tmp_path_factory):
    from gmrm_tpu.io.sim import simulate

    out = tmp_path_factory.mktemp("sim_tiny")
    return simulate(
        str(out), n=57, m=24, n_traits=1, n_causal=8, h2=0.5,
        n_groups=1, na_rate=0.0, seed=7,
    )
