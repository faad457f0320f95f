"""The compilation-cache helper every entry point calls."""

import os

import jax

from apf_quadruped.runtime import cache


def test_env_dir_is_used_and_nothing_set(monkeypatch, tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, the helper uses it and sets no
    JAX option of its own."""
    calls = []
    monkeypatch.setenv(cache.ENV, str(tmp_path))
    monkeypatch.setattr(jax.config, "update",
                        lambda *a, **k: calls.append(a))
    assert cache.enable() == str(tmp_path)
    assert calls == []


def test_default_dir_is_in_checkout(monkeypatch):
    """Without the variable, the cache is the fixed .jax_cache of the
    checkout, which .gitignore lists."""
    calls = []
    monkeypatch.delenv(cache.ENV, raising=False)
    monkeypatch.setattr(jax.config, "update",
                        lambda *a, **k: calls.append(a))
    path = cache.enable()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert path == os.path.join(root, ".jax_cache")
    assert ("jax_compilation_cache_dir", path) in calls
    with open(os.path.join(root, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()
