"""Persistent XLA compilation cache.

Every process that compiles the closed loop (bench.py, the CLI,
chip_smoke.py) starts warm when an earlier process left its programs here.
"""

from __future__ import annotations

import os

_REPO_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def enable_persistent_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    ``$JAX_COMPILATION_CACHE_DIR`` wins when it is set (JAX reads it
    itself, and no other directory is set here).  Otherwise the cache is
    ``.jax_cache`` at the repository root: a fixed path, because the path is
    part of the cache key.
    """
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = _REPO_CACHE
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path
