"""One platform policy: native float64 on every backend.

The solver's automatic choices must not depend on which backend JAX
reports: a GPU takes exactly the native-f64 path the CPU takes (golden
counts, PETSc-parity CGS), and the double-float stack is reached only on
explicit request. Also covers the device-keyed roofline table, the
compilation-cache helper and the memory-derived partri cap.
"""

import sys
from pathlib import Path

import jax
import pytest

from perphil_tpu.ops import krylov
from perphil_tpu.solvers import solver as S


@pytest.fixture(params=["gpu", "cpu"])
def backend(request, monkeypatch):
    """Pretend JAX's default backend is ``request.param``."""
    monkeypatch.setattr(jax, "default_backend", lambda: request.param)
    for var in ("PERPHIL_TPU_KSP_DTYPE", "PERPHIL_TPU_EXACT_SOLVES",
                "PERPHIL_TPU_KRYLOV_BATCH", "PERPHIL_TPU_BAND_ILU"):
        monkeypatch.delenv(var, raising=False)
    return request.param


def test_krylov_arithmetic_is_native(backend):
    assert S._ksp_mode() == "native"


def test_exact_solves_are_native_f64(backend):
    assert S._use_mixed_exact() is False


def test_krylov_batch_is_one(backend):
    assert krylov.default_krylov_batch() == 1


def test_gmres_defaults_to_plain_cgs(backend):
    import inspect

    assert inspect.signature(krylov.gmres).parameters["reorthogonalize"].default is False


def test_parity_ilu_engine_defaults_to_host(backend):
    from perphil_tpu.forms import create_function_spaces, mixed_space
    from perphil_tpu.mesh import create_cube_mesh
    from perphil_tpu.models.dpp import DPPParameters
    from perphil_tpu.solvers.parameters import GMRES_ILU_PARAMS

    mesh = create_cube_mesh(2, 2, 2)
    _, V = create_function_spaces(mesh)
    sp = {**GMRES_ILU_PARAMS, "pc_factor_mat_ordering_type": "rcm"}
    solve = S._build_linear_solver(mixed_space(V), DPPParameters(), S._freeze(sp))
    assert getattr(solve, "_host_only", False)


@pytest.mark.parametrize(
    "var,value,mode",
    [("PERPHIL_TPU_KSP_DTYPE", "df32", "df32"), ("PERPHIL_TPU_KSP_DTYPE", "float64", "native")],
)
def test_double_float_only_on_request(monkeypatch, var, value, mode):
    monkeypatch.setenv(var, value)
    assert S._ksp_mode() == mode


def test_mixed_exact_only_on_request(monkeypatch):
    monkeypatch.setenv("PERPHIL_TPU_EXACT_SOLVES", "mixed")
    assert S._use_mixed_exact() is True


def test_solver_stack_imports_no_pallas():
    from perphil_tpu.forms import create_function_spaces, mixed_space
    from perphil_tpu.mesh import create_mesh
    from perphil_tpu.models.dpp import DPPParameters
    from perphil_tpu.ops.assembly import DirichletBC
    from perphil_tpu.solvers import solve_dpp
    from perphil_tpu.solvers.parameters import GMRES_ILU_PARAMS

    mesh = create_mesh(4, 4)
    _, V = create_function_spaces(mesh)
    W = mixed_space(V)
    bcs = [DirichletBC(W.sub(0), 1.0), DirichletBC(W.sub(1), 0.0)]
    solve_dpp(W, DPPParameters(), bcs, solver_parameters=GMRES_ILU_PARAMS)
    assert not [m for m in sys.modules if "pallas" in m]


# -- roofline table --------------------------------------------------------


def test_roofline_knows_h100():
    from perphil_tpu.utils.roofline import device_peaks

    pk = device_peaks("NVIDIA H100 80GB HBM3")
    assert (pk.bf16_tflops, pk.fp64_tflops, pk.hbm_gbs) == (989.0, 67.0, 3350.0)


@pytest.mark.parametrize("kind", ["cpu", "Tesla V100-SXM2-16GB", "NVIDIA A100-SXM4-80GB"])
def test_roofline_unknown_device_raises(kind):
    from perphil_tpu.utils.roofline import device_peaks

    with pytest.raises(KeyError):
        device_peaks(kind)


def test_roofline_point_bounds():
    from perphil_tpu.utils.roofline import analyze, device_peaks

    pk = device_peaks("NVIDIA H100 80GB HBM3")
    pt = analyze("copy", 1e-3, flops=0.0, bytes_accessed=3.35e9, peaks=pk)
    assert pt.hbm_frac == pytest.approx(1.0)
    assert pt.bound == "memory"
    pt = analyze("gemm", 1e-3, flops=67e9, bytes_accessed=1e6, peaks=pk)
    assert pt.fp64_frac == pytest.approx(1.0)
    assert pt.bound == "compute"


# -- compilation cache -----------------------------------------------------


def _record_updates(monkeypatch):
    calls = []
    monkeypatch.setattr(jax.config, "update", lambda k, v: calls.append((k, v)))
    return calls


def test_cache_dir_env_is_honoured(monkeypatch, tmp_path):
    from perphil_tpu.config import setup_compilation_cache

    calls = _record_updates(monkeypatch)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert setup_compilation_cache() == str(tmp_path)
    assert calls == []


def test_cache_dir_defaults_to_repo(monkeypatch):
    from perphil_tpu.config import setup_compilation_cache

    calls = _record_updates(monkeypatch)
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = setup_compilation_cache()
    assert Path(path) == Path(__file__).resolve().parents[1] / ".jax_cache"
    assert calls == [("jax_compilation_cache_dir", path)]


# -- partri memory cap -----------------------------------------------------


class _FakeDevice:
    def __init__(self, stats):
        self._stats = stats

    def memory_stats(self):
        return self._stats


def test_partri_cap_follows_device_limit(monkeypatch):
    from perphil_tpu.ops import ilu

    monkeypatch.setattr(jax, "devices", lambda: [_FakeDevice({"bytes_limit": 16 * 2**30})])
    assert ilu._partri_max_bytes() == int(ilu._PARTRI_MEMORY_FRACTION * 16 * 2**30)


def test_partri_cap_without_device_limit_uses_host_memory(monkeypatch):
    import os

    from perphil_tpu.ops import ilu

    monkeypatch.setattr(jax, "devices", lambda: [_FakeDevice(None)])
    host = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    assert ilu._partri_max_bytes() == int(ilu._PARTRI_MEMORY_FRACTION * host)


# -- double-float stack on XLA:GPU -----------------------------------------


def _tiny_problem(n=3):
    from perphil_tpu.forms import create_function_spaces, mixed_space
    from perphil_tpu.mesh import create_cube_mesh
    from perphil_tpu.models.dpp import DPPParameters
    from perphil_tpu.ops.assembly import DirichletBC

    mesh = create_cube_mesh(n, n, n, hexahedral=True)
    _, V = create_function_spaces(mesh)
    W = mixed_space(V)
    bcs = [DirichletBC(W.sub(0), 1.0), DirichletBC(W.sub(1), 0.0)]
    return W, DPPParameters(), bcs


@pytest.mark.parametrize("entry", ["fastdiag_mixed", "ksp_df32", "exact_mixed"])
def test_double_float_refused_on_gpu(entry, monkeypatch):
    from perphil_tpu.ops.df32 import DoubleFloatUnsupported
    from perphil_tpu.solvers import solve_dpp
    from perphil_tpu.solvers.parameters import (
        FIELDSPLIT_LU_PARAMS,
        GMRES_PARAMS,
        PLAIN_GMRES_PARAMS,
        TPU_DIRECT_PARAMS,
    )

    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    S._build_linear_solver.cache_clear()
    sp = {
        "fastdiag_mixed": TPU_DIRECT_PARAMS,
        "ksp_df32": PLAIN_GMRES_PARAMS,
        "exact_mixed": {**GMRES_PARAMS, **FIELDSPLIT_LU_PARAMS},
    }[entry]
    if entry == "ksp_df32":
        monkeypatch.setenv("PERPHIL_TPU_KSP_DTYPE", "df32")
    if entry == "exact_mixed":
        monkeypatch.setenv("PERPHIL_TPU_EXACT_SOLVES", "mixed")
    W, params, bcs = _tiny_problem()
    try:
        with pytest.raises(DoubleFloatUnsupported, match="native float64"):
            solve_dpp(W, params, bcs, solver_parameters=sp)
    finally:
        S._build_linear_solver.cache_clear()


def test_chip_smoke_phase_b_reports_refusal_on_gpu(monkeypatch):
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    S._build_linear_solver.cache_clear()
    try:
        rec = chip_smoke.phase_df_direct(3)
    finally:
        S._build_linear_solver.cache_clear()
    assert "XLA:GPU" in rec["refused"]


def test_double_float_allowed_on_cpu():
    from perphil_tpu.ops.df32 import require_exact_eft

    assert jax.default_backend() == "cpu"
    require_exact_eft()
