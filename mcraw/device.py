"""Which device JAX runs on, and where compiled programs are cached.

One rule for every entry point: the program runs on whatever platform JAX
starts with (a GPU when its CUDA plugin is installed, the CPU otherwise) and
never swaps it for another. A platform that fails to start raises.
"""

from __future__ import annotations

import os
from pathlib import Path

# Fixed cache location inside the checkout (listed in .gitignore). The path
# is part of the cache key, so it must not move between runs.
DEFAULT_CACHE_DIR = Path(__file__).resolve().parents[1] / ".jax_cache"


def platform_info() -> tuple[str, str, int]:
    """(platform, device_kind, device count) as JAX reports them."""
    import jax

    devices = jax.devices()
    return devices[0].platform, devices[0].device_kind, len(devices)


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    Where JAX_COMPILATION_CACHE_DIR is set, JAX's own reading of it decides
    and no other directory is set; otherwise the cache lives at
    DEFAULT_CACHE_DIR. Compiles of any duration are cached: a GPU decode
    program compiles in well under JAX's default one-second threshold.
    """
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = str(DEFAULT_CACHE_DIR)
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    return path
