"""Persistent XLA compilation cache for the entry points.

A cold full-pipeline run compiles every stage's programs for every batch
shape; the persistent cache lets the next process on the same checkout
load them instead. JAX reads `JAX_COMPILATION_CACHE_DIR` itself, so where
that is set it is the cache and nothing else is configured. Otherwise the
cache is one fixed directory inside the checkout (listed in .gitignore):
the path is part of what a later run must find again, so it is never built
from a temp name, a PID or the time. That directory keeps every program,
not only those that took JAX's default minimum of one second to compile:
the pipeline compiles hundreds of small per-shape programs, and together
they are a large share of a cold run.
"""

from __future__ import annotations

import os

ENV = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def enable() -> str:
    """Point JAX's persistent compilation cache at its directory and
    return that directory."""
    import jax

    path = os.environ.get(ENV)
    if path:
        return path
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    return DEFAULT_DIR
