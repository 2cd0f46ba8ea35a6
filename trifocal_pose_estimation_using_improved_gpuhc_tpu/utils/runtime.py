"""Process set-up shared by the entry points: the compile cache and the
accelerator check."""

from __future__ import annotations

import os
from typing import Mapping, Optional

REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
# Fixed, inside the checkout: the cache directory is part of the cache's
# key, so a path that moved between runs would never hit.
DEFAULT_CACHE_DIR = os.path.join(REPO_ROOT, ".jax_cache")


def compile_cache_dir(environ: Mapping[str, str] = os.environ
                      ) -> Optional[str]:
    """The directory to set for JAX's persistent compile cache.

    None when JAX_COMPILATION_CACHE_DIR is set: JAX reads that variable
    itself and nothing may override it.  Otherwise the fixed
    DEFAULT_CACHE_DIR.
    """
    if environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return DEFAULT_CACHE_DIR


def enable_compile_cache() -> None:
    import jax

    d = compile_cache_dir()
    if d is not None:
        jax.config.update("jax_compilation_cache_dir", d)


def require_gpu():
    """The JAX devices, or RuntimeError when the backend is not a GPU."""
    import jax

    backend = jax.default_backend()
    if backend != "gpu":
        raise RuntimeError(f"no GPU: JAX runs on {backend!r}")
    return jax.devices()


def gpu_card_line() -> str:
    """``nvidia-smi`` name and power limit of each card, or raise."""
    import subprocess

    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip()
