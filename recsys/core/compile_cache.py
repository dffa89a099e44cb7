"""JAX's persistent compilation cache, shared by every entry point.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and nothing
is set here. Otherwise the cache lives in one fixed directory inside the
checkout (git-ignored): the path is part of what a later process looks up,
so a directory named after a pid, a temp name or the time would never hit.
"""

from __future__ import annotations

import os
from pathlib import Path

#: cache directory used when JAX_COMPILATION_CACHE_DIR is not set
DEFAULT_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Turn on the persistent compile cache before the first compile and
    return the directory in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_DIR))
    return str(DEFAULT_DIR)
