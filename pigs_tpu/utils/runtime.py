"""Process set-up shared by the scripts: the compile cache and the GPU check."""

from __future__ import annotations

import os
import subprocess

import jax

__all__ = ["compile_cache_dir", "enable_compile_cache", "require_gpu",
           "card_line"]

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def compile_cache_dir() -> str:
    """``JAX_COMPILATION_CACHE_DIR`` when it is set, else ``<checkout>/.jax_cache``
    (a fixed path: the cache key includes it)."""
    return (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or os.path.join(CHECKOUT, ".jax_cache"))


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at :func:`compile_cache_dir`."""
    path = compile_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def require_gpu():
    """The first device, which must be an NVIDIA GPU: measurements and the
    smoke run have no CPU fallback."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"no GPU: JAX found {dev.platform!r} devices")
    return dev


def card_line() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()
