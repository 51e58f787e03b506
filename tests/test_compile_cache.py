"""The persistent compile cache helper: an environment setting wins,
otherwise a fixed directory in the checkout."""

import os

import jax
import pytest

from or_cdchomp_jax.utils import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_KEYS = ("jax_compilation_cache_dir",
         "jax_persistent_cache_min_compile_time_secs",
         "jax_persistent_cache_min_entry_size_bytes")


@pytest.fixture(autouse=True)
def _restore_config():
    saved = {k: getattr(jax.config, k) for k in _KEYS}
    yield
    for k, v in saved.items():
        jax.config.update(k, v)


def test_env_dir_is_left_alone(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_checkout_dir_when_unset(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compile_cache.enable_compile_cache()
    assert path == os.path.join(REPO, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path
    assert jax.config.jax_persistent_cache_min_compile_time_secs == 0.0


def test_path_is_fixed_and_ignored(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    first = compile_cache.enable_compile_cache()
    assert compile_cache.enable_compile_cache() == first
    assert os.path.isabs(first)
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()
