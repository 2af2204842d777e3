"""Persistent XLA compilation cache.

The window programs take minutes to compile; a persistent cache makes that
a one-time cost per cache directory instead of per process.  The directory
is ``JAX_COMPILATION_CACHE_DIR`` when that is set (JAX reads it itself, and
nothing here overrides it); otherwise one fixed directory inside the
checkout, so every process of a checkout finds what the others compiled.
"""
from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def cache_dir(path: str | None = None) -> str:
    """The directory the cache uses: ``path``, else the environment's
    ``JAX_COMPILATION_CACHE_DIR``, else ``DEFAULT_CACHE_DIR``."""
    return os.path.abspath(os.path.expanduser(
        path or os.environ.get(ENV_VAR) or DEFAULT_CACHE_DIR))


def enable_compilation_cache(path: str | None = None) -> str:
    """Point JAX's persistent compilation cache at ``cache_dir(path)``
    (created if missing).  Call before the first jit dispatch; returns the
    directory.  Safe to call multiple times."""
    import jax

    p = cache_dir(path)
    os.makedirs(p, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", p)
    # cache everything that took noticeable compile time; the big pipeline
    # programs are multi-minute, the threshold only filters trivial ops
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    return p


def cache_entries(path: str | None = None) -> int:
    """Number of persisted executables (for tests/telemetry)."""
    p = cache_dir(path)
    if not os.path.isdir(p):
        return 0
    return sum(1 for n in os.listdir(p) if not n.startswith("."))
