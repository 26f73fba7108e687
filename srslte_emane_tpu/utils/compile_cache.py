"""Where JAX keeps its persistent compile cache.

`JAX_COMPILATION_CACHE_DIR`, when set, is read by JAX itself and nothing
is set here.  Otherwise the cache lives at `<checkout>/.jax_cache`, a
fixed path (the path is part of the cache key, so a moving directory
would never hit); `.gitignore` lists it.
"""

from __future__ import annotations

import os
import pathlib

ENV = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = pathlib.Path(__file__).resolve().parents[2] / ".jax_cache"


def enable() -> str:
    """Turn the persistent cache on; returns the directory in effect."""
    if os.environ.get(ENV):
        return os.environ[ENV]
    import jax

    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_DIR))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return str(DEFAULT_DIR)
