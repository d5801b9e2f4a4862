"""Where JAX keeps compiled programs between processes.

A cold flagship run spends much of its start-up compiling (the beam
search, the train step, the VGG forward).  JAX's persistent compilation
cache lets a later process load those executables instead.
"""

from __future__ import annotations

import os
from pathlib import Path

import jax

# A fixed directory, so every process started from this checkout finds
# what an earlier one compiled.
CHECKOUT_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Turn on the persistent compilation cache; return its directory.

    When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and
    nothing is set here.  Otherwise the cache is ``.jax_cache/`` at the
    checkout root (git-ignored).  Call before the first compilation:
    JAX decides once per process whether the cache is in use.
    """
    env_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env_dir:
        return env_dir
    jax.config.update("jax_compilation_cache_dir", str(CHECKOUT_CACHE_DIR))
    return str(CHECKOUT_CACHE_DIR)
