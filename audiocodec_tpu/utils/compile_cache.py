"""Where JAX keeps its persistent compilation cache.

Every entry point (the CLI, bench.py, benchmarks/, examples/, the test
hardware lane and chip_smoke.py) calls :func:`enable` so that all of
them share one cache and a warm cache is found again by the next run.
"""

from __future__ import annotations

import os

import jax

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"


def enable() -> str:
    """Turn on the persistent compilation cache; return its directory.

    When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it by itself and
    nothing is set in code. Otherwise the cache goes to
    ``<checkout>/.jax_cache``, a fixed path derived from the package
    location (the path is part of the cache's key, so it must not move).
    """
    from_env = os.environ.get(ENV_VAR)
    if from_env:
        return from_env
    package = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = os.path.join(os.path.dirname(package), ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
