"""Where JAX keeps its persistent compilation cache.

The cache key includes the directory, so the path must not move between
runs: ``JAX_COMPILATION_CACHE_DIR`` when it is set (JAX reads it itself,
and nothing here overrides it), else ``.jax_cache/`` at the root of the
checkout.  Entry points call ``setup_compile_cache()`` once at start-up.
"""

from __future__ import annotations

import os
from pathlib import Path

ENV = "JAX_COMPILATION_CACHE_DIR"
CHECKOUT_CACHE = Path(__file__).resolve().parents[2] / ".jax_cache"


def cache_dir(environ=os.environ) -> Path:
    """The cache directory for this environment."""
    env = environ.get(ENV)
    return Path(env) if env else CHECKOUT_CACHE


def setup_compile_cache() -> Path:
    """Point JAX at ``cache_dir()``; returns it."""
    path = cache_dir()
    if ENV not in os.environ:
        import jax

        jax.config.update("jax_compilation_cache_dir", str(path))
    return path
