"""JAX's persistent compilation cache, in one place.

The cache lives in `$JAX_COMPILATION_CACHE_DIR` when that is set, and
otherwise in `<repo>/.jax_cache`. Every benchmark, script and smoke run
calls `enable_compile_cache()` before its first compile, so repeat runs
share compiled programs and no file names another path.
"""

from __future__ import annotations

import os

import jax

REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def cache_dir() -> str:
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        REPO_ROOT, ".jax_cache"
    )


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at `cache_dir()`."""
    path = cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path
