"""Placement of JAX's persistent compilation cache."""

from __future__ import annotations

import os
import pathlib

import jax

#: Cache used when ``JAX_COMPILATION_CACHE_DIR`` is not set. The directory is
#: part of every entry's key, so it is fixed: never derived from a temporary
#: name, a process id or the time.
REPO_CACHE_DIR = pathlib.Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Turn on the persistent compilation cache and return its directory.

    ``JAX_COMPILATION_CACHE_DIR``, when set, is the directory and no other is
    set; otherwise the cache lives in ``<repo>/.jax_cache``. Call before the
    first compilation of the process: JAX opens the cache once.
    """
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR") or str(REPO_CACHE_DIR)
    jax.config.update("jax_compilation_cache_dir", path)
    return path
