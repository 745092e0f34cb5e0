"""The compilation-cache rule (ray_tracying.compile_cache)."""

import os

import jax

from ray_tracying import compile_cache


def test_env_var_wins_and_nothing_is_set(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv(compile_cache.ENV, str(tmp_path))
    assert compile_cache.setup() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_default_is_checkout_dot_jax_cache(monkeypatch):
    monkeypatch.delenv(compile_cache.ENV, raising=False)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    want = os.path.join(repo, ".jax_cache")
    assert compile_cache.cache_dir() == want
    assert compile_cache.setup() == want
    assert jax.config.jax_compilation_cache_dir == want
    with open(os.path.join(repo, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()
