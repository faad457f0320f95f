"""JAX's persistent compilation cache, set in one place.

Every entry point (the CLI, bench.py, chip_smoke.py, benchmarks/) calls
`enable()` before its first compilation.  Where JAX_COMPILATION_CACHE_DIR
is set, JAX reads it itself and nothing here overrides it; otherwise the
cache lives at a fixed path inside the checkout, `<checkout>/.jax_cache`
(listed in .gitignore), so that every process of one checkout finds what
another compiled.
"""

from __future__ import annotations

import os

ENV = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           os.pardir, os.pardir, ".jax_cache")


def cache_dir() -> str:
    """The directory the compilation cache uses."""
    return os.environ.get(ENV) or os.path.normpath(DEFAULT_DIR)


def enable() -> str:
    """Point JAX's compilation cache at cache_dir(); returns it."""
    import jax

    path = cache_dir()
    if not os.environ.get(ENV):
        jax.config.update("jax_compilation_cache_dir", path)
        # cache every executable: the solver programs are many small ones
        jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return path
