"""Persistent XLA compilation cache shared by the entry points.

The CLI, ``bench.py`` and ``chip_smoke.py`` call :func:`configure` before
their first compile.  When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already
uses that directory and nothing is set here; otherwise the cache goes to one
fixed directory inside the checkout (``.jax_cache/``, listed in
``.gitignore``).  The path is part of the cache's identity, so it is never
temporary, per-process or time-stamped.
"""

from __future__ import annotations

import os

import jax

ENV = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def cache_dir() -> str:
    """The directory the cache lives in: the environment's, else the
    checkout's fixed default."""
    return os.environ.get(ENV) or DEFAULT_DIR


def configure() -> str:
    """Point JAX's persistent compilation cache at :func:`cache_dir` and
    return that directory."""
    path = cache_dir()
    if not os.environ.get(ENV):
        jax.config.update("jax_compilation_cache_dir", path)
    return path
