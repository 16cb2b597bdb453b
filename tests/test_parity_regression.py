"""Golden-number regression tests against the reference's committed CSV
artifacts (BASELINE.md). These are the headline parity checks:

  - L2/H1 errors of the discrete solution (convergence.csv),
  - plain GMRES iteration counts (292 at N=16),
  - fieldsplit-LU GMRES: 4 iterations at every N,
  - GMRES+ILU(0) iteration counts (5/11/20 at N=4/16/32),
  - condition numbers to machine precision (conditioning.csv).
"""

import numpy as np
import pytest

from perphil_tpu.forms import create_function_spaces, mixed_space
from perphil_tpu.mesh import create_mesh
from perphil_tpu.models.dpp import DPPParameters
from perphil_tpu.ops.assembly import DirichletBC
from perphil_tpu.solvers import solve_dpp, solve_dpp_nonlinear
from perphil_tpu.solvers import parameters as sp
from perphil_tpu.utils.manufactured_solutions import exact_expressions
from perphil_tpu.utils.postprocessing import h1_seminorm_error, l2_error

pytestmark = pytest.mark.regression


def _setup(N):
    mesh = create_mesh(N, N)
    _, V = create_function_spaces(mesh)
    W = mixed_space(V)
    params = DPPParameters()
    _, p1e, _, p2e = exact_expressions(mesh, params)
    bcs = [DirichletBC(W.sub(0), p1e), DirichletBC(W.sub(1), p2e)]
    return mesh, W, params, bcs, p1e, p2e


# reference: notebooks/results-conforming-2d/convergence.csv (MUMPS rows)
_L2_REFERENCE = {
    4: (1965.7375371673206, 196572.59548715068, 30018.89318007683),
    16: (154.91204152557083, 15491.16888191997, 9247.8237859725),
}


@pytest.mark.parametrize("N", [4, 16])
def test_direct_solve_errors_match_reference(N):
    mesh, W, params, bcs, p1e, p2e = _setup(N)
    sol = solve_dpp(W, params, bcs, solver_parameters=sp.LINEAR_SOLVER_PARAMS)
    assert sol.iteration_number == 1
    assert sol.residual_error == 0.0
    p1h, p2h = sol.solution.split()
    e1, e2, e1h = _L2_REFERENCE[N]
    assert abs(l2_error(p1h, p1e) - e1) / e1 < 1e-10
    assert abs(l2_error(p2h, p2e) - e2) / e2 < 1e-10
    assert abs(h1_seminorm_error(p1h, p1e) - e1h) / e1h < 1e-10


# reference: convergence.csv / petsc_perf_breakdown.csv iteration counts.
# Counts at the convergence boundary can shift by +-1 with the platform's
# floating-point reduction order (292 on plain CPU, 293 under the
# 8-virtual-device CPU test config).
@pytest.mark.parametrize("N,expected", [(4, 10), (16, 292)])
def test_plain_gmres_iterations_match_reference(N, expected):
    mesh, W, params, bcs, *_ = _setup(N)
    sol = solve_dpp(W, params, bcs, solver_parameters=sp.PLAIN_GMRES_PARAMS)
    assert abs(sol.iteration_number - expected) <= 1


@pytest.mark.parametrize("N", [4, 8, 16, 32])
def test_fieldsplit_lu_always_4_iterations(N):
    mesh, W, params, bcs, *_ = _setup(N)
    ss = {**sp.GMRES_PARAMS, **sp.FIELDSPLIT_LU_PARAMS}
    sol = solve_dpp(W, params, bcs, solver_parameters=ss)
    assert sol.iteration_number == 4


@pytest.mark.parametrize(
    "N,expected",
    [(4, 5), (16, 11), pytest.param(32, 20, marks=pytest.mark.slow)],
)
def test_gmres_ilu_iterations_match_reference(N, expected):
    mesh, W, params, bcs, *_ = _setup(N)
    sol = solve_dpp(W, params, bcs, solver_parameters=sp.GMRES_ILU_PARAMS)
    assert sol.iteration_number == expected


@pytest.mark.slow
def test_gmres_ilu_n64_exact_in_f64_parity_mode(monkeypatch):
    """The default f32 ILU application drifts +1 at N=64 (43 vs 42);
    PERPHIL_TPU_ILU_DTYPE=float64 is the documented exact-parity mode and
    must reproduce the reference count (convergence.csv row N=64)."""
    monkeypatch.setenv("PERPHIL_TPU_ILU_DTYPE", "float64")
    from perphil_tpu.solvers.solver import _build_linear_solver

    _build_linear_solver.cache_clear()  # cache key does not include the env
    mesh, W, params, bcs, *_ = _setup(64)
    sol = solve_dpp(W, params, bcs, solver_parameters=sp.GMRES_ILU_PARAMS)
    assert sol.iteration_number == 42


def _force_df_mode(monkeypatch):
    """Route solves through the opt-in df32 builder on CPU (the
    native-f64 parity builder would otherwise serve them and prove nothing
    about the df32 path)."""
    monkeypatch.setenv("PERPHIL_TPU_KSP_DTYPE", "df32")
    from perphil_tpu.solvers import solver as S

    S._build_linear_solver.cache_clear()
    S._build_tensor_linear_solver.cache_clear()


@pytest.mark.parametrize("N,expected", [(4, 10), (8, 40)])
def test_plain_gmres_knife_edge_exact_ef64(monkeypatch, N, expected):
    """Tiny unpreconditioned systems (<=512 DoF) on the df32
    builder route to the knife-edge ef64 mode (f64-FAITHFUL arithmetic,
    ``gmres_ef64``) — the 2D N=8 cell must land PETSc's
    exact 40 (petsc_perf_breakdown.csv row N=8; measured: df32 drifts to
    42 on this path and tf32 UNDERSHOOTS to 38 — docs/design.md §7)."""
    _force_df_mode(monkeypatch)
    mesh, W, params, bcs, *_ = _setup(N)
    sol = solve_dpp(W, params, bcs, solver_parameters=sp.PLAIN_GMRES_PARAMS)
    assert sol.iteration_number == expected


@pytest.mark.slow
def test_plain_gmres_3d_knife_edge_exact_ef64(monkeypatch):
    """3D nx=4 plain GMRES on the df32 builder: 27 exactly via
    the ef64 knife-edge mode (petsc_perf_breakdown_3d.csv; df32 drifts to
    28 — docs/design.md §7)."""
    from perphil_tpu.mesh import create_cube_mesh
    from perphil_tpu.utils.manufactured_solutions import exact_expressions_3d

    _force_df_mode(monkeypatch)
    mesh = create_cube_mesh(4, 4, 4)
    _, V = create_function_spaces(mesh)
    W = mixed_space(V)
    params = DPPParameters()
    _, p1e, _, p2e = exact_expressions_3d(mesh, params)
    bcs = [DirichletBC(W.sub(0), p1e), DirichletBC(W.sub(1), p2e)]
    sol = solve_dpp(W, params, bcs, solver_parameters=sp.PLAIN_GMRES_PARAMS)
    assert sol.iteration_number == 27


@pytest.mark.parametrize("N,ref_its", [(4, 16), (8, 63), (16, 194)])
def test_picard_ngs_iterations_exact(N, ref_its):
    """SNES 'ngs' Picard counts are EXACT under the pinned coloring draw
    (ops/ordering.py::ngs_parity_coloring): the reference publishes
    16/63/194/635/1673/5135 at N=4..128
    (petsc_perf_breakdown-with-picard.csv) and the multicolor secant
    sweeper reproduces every row."""
    mesh, W, params, bcs, *_ = _setup(N)
    sol = solve_dpp_nonlinear(W, params, bcs, solver_parameters=sp.PICARD_LU_SOLVER_PARAMS)
    assert sol.iteration_number == ref_its


@pytest.mark.slow
def test_gmres_ilu_n64_exact_in_df32_production_mode(monkeypatch):
    """The opt-in df32 Krylov path applies the monolithic ILU in
    double-float (defect-corrected f32 trisolves against the df-stored f64
    factor, ops/ilu.py::StructuredILU0.apply_flat_df) — the knife-edge 2D
    N=64 cell must land PETSc's exact 42 in this mode (convergence.csv row
    N=64; the pre-round-5 f32 apply drifted to 43)."""
    monkeypatch.setenv("PERPHIL_TPU_KSP_DTYPE", "df32")
    from perphil_tpu.solvers.solver import _build_linear_solver

    _build_linear_solver.cache_clear()  # cache key does not include the env
    mesh, W, params, bcs, *_ = _setup(64)
    sol = solve_dpp(W, params, bcs, solver_parameters=sp.GMRES_ILU_PARAMS)
    _build_linear_solver.cache_clear()  # do not leak df32 solvers to others
    assert sol.iteration_number == 42
