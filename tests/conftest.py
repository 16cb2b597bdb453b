"""Test configuration.

Tests run on a virtual 8-device CPU mesh regardless of the host's
accelerator: JAX executes the same XLA programs on CPU with native float64,
giving every test a real backend (the analogue of the reference's
"skip-if-no-Firedrake" strategy — see reference ``src/conftest.py:1-12`` and
SURVEY §4 — except nothing needs to skip). Sharding tests use the 8 CPU
devices as a stand-in for a multi-GPU mesh.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402  (import after env setup)

# Force CPU even on hosts with an accelerator (the config update wins over
# any platform list set at interpreter start). Tests validate numerics and
# sharding on the virtual 8-device CPU mesh; chip_smoke.py and bench.py
# exercise the GPU.
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

# The suite is XLA-compile-dominated (one host core): persist compiled
# executables across runs. Cold run ~11 min; warm runs drop ~3x. The cache
# directory is repo-local and gitignored; delete it to force recompiles.
from pathlib import Path as _Path  # noqa: E402

jax.config.update(
    "jax_compilation_cache_dir",
    os.environ.get(
        "JAX_COMPILATION_CACHE_DIR",
        str(_Path(__file__).parent / ".jax_compilation_cache"),
    ),
)
jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)

import pytest  # noqa: E402


def pytest_collection_modifyitems(config, items):
    """Default runs skip `slow`-marked tests (interpret-mode fused-kernel
    validation and long halo benchmarks) to keep the everyday suite fast.
    They still run when PERPHIL_RUN_SLOW=1 (CI / `python tasks.py tests`)
    or when the user's -m expression names `slow` explicitly."""
    if os.environ.get("PERPHIL_RUN_SLOW"):
        return
    import re

    expr = config.getoption("-m") or ""

    def _positively_selects(marker: str) -> bool:
        # word-boundary match NOT preceded by `not` — `-m "not regression"`
        # must not disable the slow-skip (substring matching did)
        return bool(re.search(rf"\b{marker}\b", expr)) and not re.search(
            rf"\bnot\s+{marker}\b", expr
        )

    if _positively_selects("slow"):
        return
    if _positively_selects("regression"):
        # `pytest -m regression` is the documented golden-parity suite — it
        # must run its slow members (e.g. the 3D hex EOC check) in full
        return
    skip = pytest.mark.skip(
        reason="slow test (set PERPHIL_RUN_SLOW=1 or -m slow to run)"
    )
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)
