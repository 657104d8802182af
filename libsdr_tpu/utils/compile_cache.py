"""Persistent XLA compile cache, one policy for every entry point.

``$JAX_COMPILATION_CACHE_DIR`` wins when it is set: JAX reads it itself and
no other directory is set in code.  Otherwise the cache lives at a fixed
``<checkout>/.jax_cache`` (listed in .gitignore), so repeated runs of the
apps, ``bench.py`` and ``chip_smoke.py`` from one checkout reuse their
compiled programs.
"""

from __future__ import annotations

import os

ENV = "JAX_COMPILATION_CACHE_DIR"


def cache_dir() -> str:
    """The directory the compile cache uses."""
    env = os.environ.get(ENV)
    if env:
        return env
    checkout = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return os.path.join(checkout, ".jax_cache")


def enable_compile_cache() -> str:
    """Turn the persistent compile cache on; returns its directory."""
    import jax

    d = cache_dir()
    if not os.environ.get(ENV):
        jax.config.update("jax_compilation_cache_dir", d)
    return d
