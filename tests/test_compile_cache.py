"""The persistent compile cache (utils/compile_cache.py): the environment's
directory when JAX_COMPILATION_CACHE_DIR is set, else one fixed directory
inside the checkout."""

import os

import pytest

from particle_simulation_tpu.utils import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture()
def updates(monkeypatch):
    """Record jax.config.update calls instead of applying them."""
    seen = []
    monkeypatch.setattr(compile_cache.jax.config, "update",
                        lambda k, v: seen.append((k, v)))
    return seen


def test_default_dir_is_fixed_in_checkout(monkeypatch):
    monkeypatch.delenv(compile_cache.ENV, raising=False)
    assert compile_cache.cache_dir() == os.path.join(REPO, ".jax_cache")
    assert compile_cache.cache_dir() == compile_cache.cache_dir()


def test_default_dir_is_ignored_by_git():
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_unset_env_configures_default(monkeypatch, updates):
    monkeypatch.delenv(compile_cache.ENV, raising=False)
    assert compile_cache.configure() == compile_cache.DEFAULT_DIR
    assert updates == [("jax_compilation_cache_dir", compile_cache.DEFAULT_DIR)]


def test_set_env_wins_and_sets_nothing(monkeypatch, updates, tmp_path):
    monkeypatch.setenv(compile_cache.ENV, str(tmp_path))
    assert compile_cache.cache_dir() == str(tmp_path)
    assert compile_cache.configure() == str(tmp_path)
    assert updates == []


def test_empty_env_counts_as_unset(monkeypatch, updates):
    monkeypatch.setenv(compile_cache.ENV, "")
    assert compile_cache.configure() == compile_cache.DEFAULT_DIR
    assert updates == [("jax_compilation_cache_dir", compile_cache.DEFAULT_DIR)]
