"""compile_cache.configure_compile_cache: one rule for every entry point."""

import os

import jax

from hgaprec_jax import compile_cache


def _spy(monkeypatch):
    calls = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda name, value: calls.__setitem__(name, value))
    return calls


def test_env_var_left_to_jax(monkeypatch, tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, JAX reads it itself and the
    helper sets nothing — no other directory can override it."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    calls = _spy(monkeypatch)
    assert compile_cache.configure_compile_cache() == str(tmp_path)
    assert calls == {}


def test_default_is_checkout_jax_cache(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    calls = _spy(monkeypatch)
    got = compile_cache.configure_compile_cache()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert got == os.path.join(repo, ".jax_cache")
    assert calls["jax_compilation_cache_dir"] == got


def test_entry_points_share_the_helper():
    """No entry point names a cache directory of its own."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    paths = ["bench.py", "chip_smoke.py", "__graft_entry__.py",
             os.path.join("tests", "conftest.py")]
    paths += [os.path.join(d, f) for d in ("hgaprec_jax", "scripts")
              for f in os.listdir(os.path.join(repo, d)) if f.endswith(".py")]
    for p in paths:
        with open(os.path.join(repo, p)) as fh:
            text = fh.read()
        if p.endswith("compile_cache.py"):
            continue
        assert "jax_compilation_cache_dir" not in text, p
