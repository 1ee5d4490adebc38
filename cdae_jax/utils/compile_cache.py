"""Persistent XLA compilation cache.

Cold starts at large shapes are compile-dominated (one program per shape
bucket), so every entry point enables this. Where the environment sets
``JAX_COMPILATION_CACHE_DIR``, JAX reads it itself and this module sets no
other directory. Otherwise the cache lives at one fixed directory inside
the checkout, ``<repo>/.jax_cache`` (listed in .gitignore): the path is
part of the cache key, so a directory that moves never hits.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def cache_dir() -> str:
    """The directory the compile cache uses: the env var's, else the
    fixed in-checkout default."""
    return os.environ.get(ENV_VAR) or DEFAULT_DIR


def enable() -> str:
    """Turn on the persistent compile cache; returns its directory. Call
    before the first compilation; safe to call twice."""
    if os.environ.get(ENV_VAR):
        return os.environ[ENV_VAR]
    import jax

    os.makedirs(DEFAULT_DIR, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
