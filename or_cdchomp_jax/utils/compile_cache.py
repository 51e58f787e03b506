"""Persistent XLA compilation cache for this checkout's entry points.

JAX reads ``JAX_COMPILATION_CACHE_DIR`` from the environment itself; a
process started with it set keeps its cache there and nothing here
overrides it.  Otherwise the cache goes to ``<checkout>/.jax_cache``, a
fixed path (the directory is part of the cache key, so a path that
moved between runs would never hit).
"""

from __future__ import annotations

import os

import jax

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(CHECKOUT, ".jax_cache")


def enable_compile_cache() -> str:
    """Turn on the persistent compilation cache; returns its directory."""
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = DEFAULT_DIR
        jax.config.update("jax_compilation_cache_dir", path)
    # cache every executable, not only those above JAX's default
    # compile-time and size thresholds
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    return path
