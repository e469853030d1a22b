"""Where the persistent XLA compilation cache lives.

One rule for every entry point (the CLI, ``bench.py``, ``chip_smoke.py``):
if ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and nothing
is set here; otherwise the cache is the fixed ``.jax_cache`` directory of
this checkout (gitignored). A fixed path matters: the path is part of the
cache key, so a directory that moves never hits.
"""
from __future__ import annotations

import os

__all__ = ["CHECKOUT_CACHE", "enable"]

ENV = "JAX_COMPILATION_CACHE_DIR"
CHECKOUT_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")


def enable() -> str:
    """Turn the persistent cache on; returns the directory in use."""
    if os.environ.get(ENV):
        return os.environ[ENV]
    import jax

    os.makedirs(CHECKOUT_CACHE, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", CHECKOUT_CACHE)
    return CHECKOUT_CACHE
