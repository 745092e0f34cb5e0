"""Where JAX keeps its persistent compilation cache.

When JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and this module
sets nothing.  Otherwise the cache goes to `.jax_cache` at the root of the
checkout, a fixed path, so later processes find what earlier ones
compiled.  Entry points (the CLI, bench.py, chip_smoke.py, the test
configuration) call `setup()` before their first compile.
"""

from __future__ import annotations

import os

ENV = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache"
)


def cache_dir() -> str:
    """The directory the rule above selects."""
    return os.environ.get(ENV) or DEFAULT_DIR


def setup() -> str:
    """Point JAX at cache_dir() and return it."""
    if not os.environ.get(ENV):
        import jax

        jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return cache_dir()
