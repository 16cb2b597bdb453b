"""Double-float Krylov layer: algebra accuracy + solver count parity."""

import numpy as np
import jax.numpy as jnp
import pytest

from perphil_tpu.ops.df32 import df_from_f64
from perphil_tpu.ops.dfvec import (
    df_basis_comb,
    df_basis_dot,
    df_dot,
    df_norm,
    df_sum_tree,
)


def _rnd(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape)


def test_df_sum_tree_accuracy():
    x = _rnd(10_001, 0) * np.logspace(-6, 6, 10_001)
    s = df_sum_tree(df_from_f64(jnp.asarray(x)))
    got = float(s[0]) + float(s[1])
    want = float(np.sum(np.sort(x)))  # well-conditioned reference
    assert abs(got - want) <= 1e-11 * np.sum(np.abs(x))


def test_df_dot_matches_f64():
    u = _rnd(5000, 1)
    v = _rnd(5000, 2)
    got = float(df_dot(df_from_f64(jnp.asarray(u)), df_from_f64(jnp.asarray(v))))
    want = float(u @ v)
    assert abs(got - want) <= 1e-12 * (np.abs(u) @ np.abs(v))


def test_df_basis_ops_match_f64():
    V = _rnd((7, 300), 3)
    w = _rnd(300, 4)
    Vdf = df_from_f64(jnp.asarray(V))
    wdf = df_from_f64(jnp.asarray(w))
    h = np.asarray(df_basis_dot(Vdf, wdf))
    np.testing.assert_allclose(h, V @ w, rtol=1e-12, atol=1e-12)
    h64 = jnp.asarray(V @ w)
    comb = df_basis_comb(h64, Vdf)
    got = np.asarray(comb[0], dtype=np.float64) + np.asarray(comb[1], dtype=np.float64)
    np.testing.assert_allclose(got, (V @ w) @ V, rtol=1e-11, atol=1e-11)
    n = float(df_norm(wdf))
    assert abs(n - np.linalg.norm(w)) <= 1e-12 * np.linalg.norm(w)


@pytest.mark.parametrize(
    "approach,N,want",
    [
        ("PLAIN_GMRES", 4, 10),
        ("GMRES_ILU", 4, 5),
        # the larger/fieldsplit cases dominate the fast suite's wall time;
        # they stay in CI via PERPHIL_RUN_SLOW=1
        pytest.param("GMRES_ILU", 16, 11, marks=pytest.mark.slow),
        pytest.param("SS_GMRES", 8, 4, marks=pytest.mark.slow),
        pytest.param("SS_GMRES_ILU", 8, 4, marks=pytest.mark.slow),
    ],
)
def test_df32_gmres_count_parity(approach, N, want, monkeypatch):
    """The df32 mode reproduces the golden preconditioned iteration counts
    (plain GMRES can drift by a few counts at larger N from the coarser
    ~6e-15 unit roundoff; preconditioned paths are exact)."""
    monkeypatch.setenv("PERPHIL_TPU_KSP_DTYPE", "df32")
    from perphil_tpu.experiments.iterative_bench import Approach, params_for
    from perphil_tpu.forms import create_function_spaces, mixed_space
    from perphil_tpu.mesh import create_mesh
    from perphil_tpu.models.dpp import DPPParameters
    from perphil_tpu.ops.assembly import DirichletBC
    from perphil_tpu.solvers import solve_dpp
    from perphil_tpu.solvers.solver import _build_linear_solver
    from perphil_tpu.utils.manufactured_solutions import exact_expressions

    _build_linear_solver.cache_clear()  # cached solvers bake in the mode
    params = DPPParameters()
    mesh = create_mesh(N, N)
    _, V = create_function_spaces(mesh)
    W = mixed_space(V)
    _, p1e, _, p2e = exact_expressions(mesh, params)
    bcs = [DirichletBC(W.sub(0), p1e), DirichletBC(W.sub(1), p2e)]
    sol = solve_dpp(W, params, bcs, solver_parameters=params_for(Approach[approach]))
    assert sol.iteration_number == want
    _build_linear_solver.cache_clear()


def test_df32_ngs_count_matches_native(monkeypatch):
    """The df32 pointwise-GS Picard driver (opt-in; residual carried in
    the loop state) reproduces the native-f64 sweep count exactly."""
    from perphil_tpu.forms import create_function_spaces, mixed_space
    from perphil_tpu.mesh import create_mesh
    from perphil_tpu.models.dpp import DPPParameters
    from perphil_tpu.ops.assembly import DirichletBC
    from perphil_tpu.solvers import solve_dpp_nonlinear
    from perphil_tpu.solvers.parameters import PICARD_LU_SOLVER_PARAMS
    from perphil_tpu.solvers.solver import _build_nonlinear_solver
    from perphil_tpu.utils.manufactured_solutions import exact_expressions

    params = DPPParameters()
    # N=4 (pinned golden count 16) keeps this fast-set item cheap; the
    # N=8 count (63) is covered by the regression suite's Picard column
    mesh = create_mesh(4, 4)
    _, V = create_function_spaces(mesh)
    W = mixed_space(V)
    _, p1e, _, p2e = exact_expressions(mesh, params)
    bcs = [DirichletBC(W.sub(0), p1e), DirichletBC(W.sub(1), p2e)]

    _build_nonlinear_solver.cache_clear()
    ref = solve_dpp_nonlinear(W, params, bcs, solver_parameters=PICARD_LU_SOLVER_PARAMS)

    monkeypatch.setenv("PERPHIL_TPU_KSP_DTYPE", "df32")
    _build_nonlinear_solver.cache_clear()
    got = solve_dpp_nonlinear(W, params, bcs, solver_parameters=PICARD_LU_SOLVER_PARAMS)
    _build_nonlinear_solver.cache_clear()

    assert got.iteration_number == ref.iteration_number
    # the converged function norms agree to df32 accuracy (~1e-6 absolute
    # on this O(1e-4) residual scale)
    assert abs(got.residual_error - ref.residual_error) <= 1e-4


def test_nonlinear_degree2_ksponly_and_clear_error():
    """Degree>1 spaces: ksponly routes through the tensor linear solver;
    iterative SNES drivers fail with a clear message, not a shape error."""
    import pytest

    from perphil_tpu.forms.spaces import FunctionSpace, mixed_space
    from perphil_tpu.mesh import create_mesh
    from perphil_tpu.models.dpp import DPPParameters
    from perphil_tpu.ops.assembly import DirichletBC
    from perphil_tpu.solvers import solve_dpp_nonlinear
    from perphil_tpu.solvers.parameters import (
        LINEAR_SOLVER_PARAMS,
        PICARD_LU_SOLVER_PARAMS,
    )
    from perphil_tpu.utils.manufactured_solutions import exact_expressions

    params = DPPParameters()
    mesh = create_mesh(4, 4)
    V = FunctionSpace(mesh, degree=2)
    W = mixed_space(V)
    _, p1e, _, p2e = exact_expressions(mesh, params)
    bcs = [DirichletBC(W.sub(0), p1e), DirichletBC(W.sub(1), p2e)]

    sol = solve_dpp_nonlinear(
        W, params, bcs,
        solver_parameters={"snes_type": "ksponly", **LINEAR_SOLVER_PARAMS},
    )
    assert sol.iteration_number == 1
    assert sol.residual_error < 1e-6

    with pytest.raises(ValueError, match="ksponly"):
        solve_dpp_nonlinear(W, params, bcs, solver_parameters=PICARD_LU_SOLVER_PARAMS)


def test_krylov_batch_equivalence():
    """k masked iterations per while-loop trip must reproduce the plain
    loop's iteration counts exactly and its iterates to the df32 noise
    floor (on CPU jit the documented EFT-contraction noise bounds the
    difference — see ops/df32)."""
    from perphil_tpu.ops.krylov import cg_df, gmres_df

    rng = np.random.default_rng(7)
    n = 96
    A = (
        np.eye(n) * 4.0
        + np.diag(-np.ones(n - 1), 1)
        + np.diag(-np.ones(n - 1), -1)
        + rng.normal(0.0, 0.05, (n, n))
    )
    A = (A + A.T) / 2 + np.eye(n) * 2.0
    b = rng.normal(size=n)
    Ad = jnp.asarray(A)
    bdf = df_from_f64(jnp.asarray(b))

    def mv(v):
        h = Ad @ v[0].astype(jnp.float64) + Ad @ v[1].astype(jnp.float64)
        hi = h.astype(jnp.float32)
        return hi, (h - hi.astype(jnp.float64)).astype(jnp.float32)

    # one batch size per solver keeps the masked-batch path covered while
    # halving the (cold-cache-dominant) compile count; k=3 on GMRES and
    # k=4 on CG cover both a restart-non-divisor and a power-of-two batch
    ref = gmres_df(mv, bdf, rtol=1e-10, restart=30, max_it=500, batch=1)
    xr = np.asarray(ref.x[0], np.float64) + np.asarray(ref.x[1], np.float64)
    got = gmres_df(mv, bdf, rtol=1e-10, restart=30, max_it=500, batch=3)
    assert int(got.iterations) == int(ref.iterations)
    xg = np.asarray(got.x[0], np.float64) + np.asarray(got.x[1], np.float64)
    np.testing.assert_allclose(xg, xr, rtol=0, atol=1e-7 * np.linalg.norm(xr))

    x1, its1, _ = cg_df(mv, bdf, rtol=1e-10, max_it=500, batch=1)
    xr = np.asarray(x1[0], np.float64) + np.asarray(x1[1], np.float64)
    xk, itsk, _ = cg_df(mv, bdf, rtol=1e-10, max_it=500, batch=4)
    assert int(itsk) == int(its1)
    xg = np.asarray(xk[0], np.float64) + np.asarray(xk[1], np.float64)
    np.testing.assert_allclose(xg, xr, rtol=0, atol=1e-6 * np.linalg.norm(xr))


def test_inner_block_pcg_matches_inner_gmres():
    """The fieldsplit inner-block solver substitutes tolerance-matched
    ILU-PCG for the preset's restarted GMRES (solvers/solver.py,
    _block_solver_df). Fast-suite coverage of that default branch: on one
    SPD block, the PCG solve must (a) run, (b) agree with the literal
    inner-GMRES solve to the shared stopping tolerance, which both test on
    the LEFT-PRECONDITIONED residual norm (cg_df conv_norm="preconditioned"
    == gmres_df's norm)."""
    from perphil_tpu.forms import create_function_spaces
    from perphil_tpu.mesh import create_mesh
    from perphil_tpu.models.dpp import DPPParameters
    from perphil_tpu.ops.assembly import FieldOperator
    from perphil_tpu.solvers.solver import _block_solver_df

    params = DPPParameters()
    mesh = create_mesh(8, 8)
    _, V = create_function_spaces(mesh)
    fop = FieldOperator(V, params.k1, params.beta, params.mu)

    sub = {
        "ksp_type": "gmres", "pc_type": "ilu",
        "ksp_rtol": 1e-8, "ksp_atol": 1e-12, "ksp_max_it": 1000,
    }
    b = _rnd(fop.mesh.node_shape, 7)
    bdry = np.asarray(fop.mesh.boundary_mask())
    b = np.where(bdry, 0.0, b)  # interior load (BC rows are identity)
    b_df = df_from_f64(jnp.asarray(b))

    x_cg = _block_solver_df(fop, sub)(b_df)

    import os

    os.environ["PERPHIL_TPU_INNER_KSP"] = "gmres"
    try:
        x_gm = _block_solver_df(fop, sub)(b_df)
    finally:
        del os.environ["PERPHIL_TPU_INNER_KSP"]

    cg = np.asarray(x_cg[0], dtype=np.float64) + np.asarray(x_cg[1], dtype=np.float64)
    gm = np.asarray(x_gm[0], dtype=np.float64) + np.asarray(x_gm[1], dtype=np.float64)
    scale = np.max(np.abs(gm))
    assert np.max(np.abs(cg - gm)) <= 1e-6 * scale
