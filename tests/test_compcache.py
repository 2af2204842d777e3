"""Persistent XLA compilation cache wiring (utils/compcache.py)."""
import os

import jax

from caelo_tpu.utils.compcache import (DEFAULT_CACHE_DIR, cache_dir,
                                       cache_entries, enable_compilation_cache)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_env_var_places_the_cache(tmp_path, monkeypatch):
    target = tmp_path / "from_env"
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(target))
    prev = jax.config.jax_compilation_cache_dir
    try:
        assert enable_compilation_cache() == str(target)
        assert target.is_dir()
        assert jax.config.jax_compilation_cache_dir == str(target)
    finally:
        jax.config.update("jax_compilation_cache_dir", prev)


def test_default_cache_is_one_fixed_path_in_the_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert cache_dir() == DEFAULT_CACHE_DIR == os.path.join(REPO, ".jax_cache")
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_enable_creates_dir_and_sets_config(tmp_path):
    target = tmp_path / "xla_cache"
    prev = jax.config.jax_compilation_cache_dir
    try:
        p = enable_compilation_cache(str(target))
        assert p == str(target)
        assert target.is_dir()
        assert jax.config.jax_compilation_cache_dir == str(target)
        assert cache_entries(str(target)) == 0
        # entries counts non-hidden files
        (target / "some_executable").write_bytes(b"x")
        (target / ".hidden").write_bytes(b"x")
        assert cache_entries(str(target)) == 1
    finally:
        jax.config.update("jax_compilation_cache_dir", prev)


def test_persists_compiled_executable(tmp_path):
    """With the thresholds floored, even a trivial jit persists an entry."""
    target = tmp_path / "xla_cache2"
    prev = jax.config.jax_compilation_cache_dir
    prev_t = jax.config.jax_persistent_cache_min_compile_time_secs
    try:
        enable_compilation_cache(str(target))
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)

        @jax.jit
        def f(x):
            return x * 2.0 + 1.0

        f(jax.numpy.ones((8,))).block_until_ready()
        assert cache_entries(str(target)) >= 1
    finally:
        jax.config.update("jax_compilation_cache_dir", prev)
        jax.config.update("jax_persistent_cache_min_compile_time_secs",
                          prev_t)
