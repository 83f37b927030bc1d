"""JAX's persistent compilation cache for the command-line entry points.

If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already keeps its cache there
and nothing else is chosen; otherwise the cache is the fixed directory
``<checkout>/.jax_cache`` (listed in ``.gitignore``).  The path is part of
the cache's key, so it never depends on the working directory.
"""

from __future__ import annotations

import os

import jax

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache"
)


def cache_dir() -> str:
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_DIR


def enable_compile_cache() -> str:
    """Point JAX's persistent cache at ``cache_dir()``; returns the path."""
    path = cache_dir()
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return path
