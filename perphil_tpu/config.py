"""Global runtime configuration for perphil-tpu.

The reference stack (Firedrake/PETSc) computes everything in float64. For
numerical parity (iteration counts, condition numbers, L2 errors) we enable
JAX's x64 mode by default; set ``PERPHIL_TPU_X64=0`` before import to run in
float32 (looser parity).
"""

from __future__ import annotations

import os

_configured = False


def setup() -> None:
    """Configure JAX once, at package import time."""
    global _configured
    if _configured:
        return
    import jax

    if os.environ.get("PERPHIL_TPU_X64", "1") != "0":
        jax.config.update("jax_enable_x64", True)
    _configured = True


def setup_compilation_cache() -> str:
    """Point JAX's persistent compilation cache at a fixed directory.

    Called by the entry-point scripts (``chip_smoke.py``, ``bench.py``);
    importing the library sets no cache. When ``JAX_COMPILATION_CACHE_DIR``
    is set, JAX reads it itself and this leaves the setting alone;
    otherwise the cache lives in ``<repo>/.jax_cache`` (gitignored). The
    path is part of the cache key, so it must not move between runs.
    Returns the directory in use.
    """
    import jax

    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = os.path.join(repo, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def gpu_identity() -> str:
    """The card's name and power limit as ``nvidia-smi`` reports them
    (``name, power.limit`` per card, one line each). Device timings depend
    on the power limit, so every measurement is reported beside it."""
    import subprocess

    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def default_dtype():
    """The working dtype: float64 in x64 mode (default), else float32."""
    import jax
    import jax.numpy as jnp

    return jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
