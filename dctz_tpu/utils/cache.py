"""The persistent XLA compilation cache, set up in one place.

Entry points (the CLI, bench.py, chip_smoke.py) call enable_compile_cache()
once before their first compile. The library itself never sets a cache.
"""

from __future__ import annotations

import os
import pathlib

#: the repository root (dctz_tpu/utils/cache.py -> repo)
_REPO = pathlib.Path(__file__).resolve().parents[2]


def compile_cache_dir() -> str:
    """JAX_COMPILATION_CACHE_DIR when set, else <repo>/.jax_cache.

    The path is fixed: it is part of the cache's key, so a directory that
    moved from run to run would never hit."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or str(
        _REPO / ".jax_cache"
    )


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at compile_cache_dir();
    returns the directory."""
    import jax

    path = compile_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    return path
