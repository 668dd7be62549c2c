"""Persistent compilation cache placement, shared by every entry point.

JAX reads ``JAX_COMPILATION_CACHE_DIR`` itself; when it is set this
module sets nothing.  Otherwise the cache lives at a fixed
``<repo>/.jax_cache``: a path derived from a temp name, a pid or the time
would never be found again by the next run.
"""

from __future__ import annotations

import os

import jax

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory and
    return that directory."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
