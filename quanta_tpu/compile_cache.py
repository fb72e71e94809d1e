"""JAX's persistent compilation cache for the entry points.

A cold TinyLlama program with 22 layers compiles for minutes, so the CLI,
bench.py and chip_smoke.py keep compiled programs on disk. Where the
cache lives:

  - ``JAX_COMPILATION_CACHE_DIR`` set: JAX reads it itself; nothing else
    is set here;
  - otherwise: ``.jax_cache/`` at the root of the checkout (listed in
    .gitignore). The path is fixed because it is part of the cache key: a
    directory that moves between runs never hits.
"""

from __future__ import annotations

import os
from pathlib import Path

DEFAULT_DIR = Path(__file__).resolve().parent.parent / ".jax_cache"


def enable() -> str:
    """Turn JAX's persistent compilation cache on; return its directory."""
    import jax

    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_DIR))
    return str(DEFAULT_DIR)
