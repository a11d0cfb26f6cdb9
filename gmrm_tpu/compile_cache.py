"""Where JAX keeps its persistent compilation cache for this program.

``JAX_COMPILATION_CACHE_DIR``, when set, is used as it is and nothing else
is set.  Otherwise the cache lives in ``<checkout>/.jax_cache``: a fixed
path, because the path is part of the cache key and a directory that moves
never hits.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def cache_dir(environ=os.environ) -> str:
    """The cache directory ``enable`` uses under ``environ``."""
    return environ.get(ENV_VAR) or os.path.join(CHECKOUT, ".jax_cache")


def enable() -> str:
    """Point JAX's persistent compilation cache at ``cache_dir()``;
    returns that path."""
    path = cache_dir()
    if not os.environ.get(ENV_VAR):
        import jax
        jax.config.update("jax_compilation_cache_dir", path)
    return path
