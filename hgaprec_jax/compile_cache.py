"""Where JAX keeps its persistent compilation cache.

The K=100 CAVI programs take tens of seconds to compile; the cache lets a
second process (the CLI again, the benchmark, a test worker) skip that.
Every entry point calls configure_compile_cache() before its first
compilation, so all of them agree on one directory.
"""

from __future__ import annotations

import os

CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_DIR = os.path.join(CHECKOUT, ".jax_cache")


def configure_compile_cache() -> str:
    """Point JAX's persistent cache at this checkout's `.jax_cache`,
    unless JAX_COMPILATION_CACHE_DIR is set: then JAX already reads the
    variable itself and nothing is changed. Returns the directory."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.1)
    # the XLA sub-caches embed host CPU features and warn when a cached
    # entry meets another host; the program cache alone gives the gain
    jax.config.update("jax_persistent_cache_enable_xla_caches", "none")
    return DEFAULT_DIR
