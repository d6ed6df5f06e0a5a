"""Process set-up helpers: the compile-cache location."""

import os

from pigs_tpu.utils import runtime


def test_compile_cache_follows_environment(monkeypatch, tmp_path):
    """JAX_COMPILATION_CACHE_DIR wins when set; otherwise the cache sits in
    the checkout, derived from the package's location."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert runtime.compile_cache_dir() == str(tmp_path)
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
    checkout = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert runtime.compile_cache_dir() == os.path.join(checkout, ".jax_cache")
