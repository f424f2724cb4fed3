"""JAX's persistent compilation cache at a fixed place.

A compiled XLA program is keyed partly by the cache directory, so a cache
that moves between runs never hits.  ``JAX_COMPILATION_CACHE_DIR``, when
set, is read by JAX itself and wins; otherwise the cache lives in
``.jax_cache`` at the root of the checkout (listed in ``.gitignore``).
"""

from __future__ import annotations

import os

import jax

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def enable_compile_cache() -> str:
    """Turn the persistent cache on; returns the directory in use."""
    if os.environ.get(ENV_VAR):
        return os.environ[ENV_VAR]
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
