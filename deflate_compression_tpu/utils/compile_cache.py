"""Where JAX keeps compiled programs between processes.

`JAX_COMPILATION_CACHE_DIR`, when set, names the directory and nothing else
is set. Otherwise the cache lives at the fixed path `<checkout>/.jax_cache`:
the path is part of each entry's key, so it must not move between runs.
"""
from __future__ import annotations

import os

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def cache_dir() -> str:
    return (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or os.path.join(CHECKOUT, ".jax_cache"))


def enable() -> str:
    """Point JAX's persistent compilation cache at cache_dir(); returns it."""
    import jax
    path = cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path
