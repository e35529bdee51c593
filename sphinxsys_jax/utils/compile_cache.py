"""Persistent XLA compilation cache shared by the entry points.

A cold 1M-particle step compiles for minutes; the cache lets a second
process (or a second run on the same machine) skip that.  JAX keys cache
entries by the directory too, so the location is fixed: the
`JAX_COMPILATION_CACHE_DIR` environment variable when it is set (JAX
reads it itself, so nothing is configured here), else `.jax_cache` at the
root of the checkout.
"""

from __future__ import annotations

import os

import jax

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its fixed location and
    return that directory."""
    path = os.environ.get(ENV_VAR)
    if path:
        return path
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
