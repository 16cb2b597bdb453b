"""3D performance profiling on unit-cube meshes.

Parity with ``/root/reference/src/perphil/experiments/petsc_profiling_3d.py``
(241 LoC): mirrors the 2D profiler on ``UnitCubeMesh(nx, nx, nx)``
(tetrahedral by default, like ``fd.UnitCubeMesh`` at reference ``:30-31``)
with the 3D manufactured-solution BCs (reference ``:63-68``), reusing all the
2D profiler internals (reference ``:96-124``), and producing the flattened
row schema of ``petsc_perf_breakdown_3d.csv`` (reference ``:174-200``).
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

import jax

import perphil_tpu
from perphil_tpu.experiments.iterative_bench import Approach, default_model_params, params_for
from perphil_tpu.experiments.profiling import (
    DEFAULT_LOGICAL_EVENTS,
    PerfResult,
    _analytic_flops,
    _block,
    _device_memory_stats,
    _get_rss_kb,
    _matrix_info,
    _measurement_class,
    _profile_with_events,
    save_perf_csv,
    splice_perf_csv,
    save_perf_json,
)
from perphil_tpu.forms.spaces import create_function_spaces, mixed_space
from perphil_tpu.mesh.structured import create_cube_mesh
from perphil_tpu.ops.assembly import DirichletBC, DPPOperator, bc_values_per_field
from perphil_tpu.solvers.solver import _build_linear_solver, _build_nonlinear_solver, _freeze
from perphil_tpu.utils.manufactured_solutions import exact_expressions_3d


def run_perf_once_3d(
    nx: int,
    approach: Approach,
    repeats: int = 3,
    backend: str = "auto",
    hexahedral: bool = False,
    use_manufactured: bool = True,
    ordering_parity: bool = False,
) -> PerfResult:
    """One profiled 3D solve (reference ``run_perf_once_3d`` ``:43-171``).

    ``ordering_parity=True`` runs the ILU-preconditioned approaches in the
    reference's DoF ordering (``pc_factor_mat_ordering_type: rcm`` — cell-RCM
    + finite-element fill pattern, host-native CSR kernels), reproducing the
    published iteration counts 6/8/15/26/33 exactly; without it the
    structured envelope ILU (the default, a strictly stronger PC)
    takes fewer iterations. Only ``GMRES_ILU`` is affected — the fieldsplit
    outer counts are ordering-independent (4 at every size).
    """
    mesh = create_cube_mesh(nx, nx, nx, hexahedral=hexahedral)
    _, V = create_function_spaces(mesh)
    W = mixed_space(V)
    params = default_model_params()

    if use_manufactured:
        _, p1e, _, p2e = exact_expressions_3d(mesh, params)
        bcs = [DirichletBC(W.sub(0), p1e), DirichletBC(W.sub(1), p2e)]
    else:
        bcs = [DirichletBC(W.sub(0), 0.0), DirichletBC(W.sub(1), 0.0)]

    sp_dict = params_for(approach)
    if ordering_parity and approach == Approach.GMRES_ILU:
        sp_dict["pc_factor_mat_ordering_type"] = "rcm"
        backend = "wall"  # host-native path: no device events to trace
    g1, g2 = bc_values_per_field(W, bcs)
    op = DPPOperator(W, params)

    t0 = time.perf_counter()
    if approach == Approach.PICARD_MUMPS:
        solver = _build_nonlinear_solver(W, params, _freeze(sp_dict))
    elif approach == Approach.PLAIN_GMRES and W.dim() > 60000:
        from perphil_tpu.experiments.profiling import build_chunked_plain_solver

        solver = build_chunked_plain_solver(W, params, sp_dict)
    else:
        solver = _build_linear_solver(W, params, _freeze(sp_dict))
    t_setup = time.perf_counter() - t0

    if getattr(solver, "_host_only", False):
        # host-resident BC grids, converted ONCE outside the timed windows
        # (no device readback inside them)
        import numpy as np

        g1, g2 = np.asarray(g1), np.asarray(g2)

    _block(solver(g1, g2))  # warmup / compile
    rss_before_kb = _get_rss_kb()

    times = {e: 0.0 for e in DEFAULT_LOGICAL_EVENTS}
    if backend in ("auto", "events", "trace"):
        ev_times, wall, _ = _profile_with_events(
            solver, g1, g2, op, approach, DEFAULT_LOGICAL_EVENTS, repeats
        )
        times.update(ev_times)
        backend_used = "events"
    else:
        from perphil_tpu.experiments.profiling import _solve_wall

        wall, _ = _solve_wall(solver, g1, g2, repeats)
        times["KSPSolve"] = wall
        backend_used = "wall"
    times["PCSetUp"] = t_setup

    z1, z2, its_arr, rnorm = solver(g1, g2)
    _block(z1)
    its = int(its_arr)

    rss_after_kb = _get_rss_kb()
    memory = {
        "rss_peak_kb": rss_after_kb,
        "rss_delta_kb": max(0.0, rss_after_kb - rss_before_kb),
    }
    memory.update(_matrix_info(mesh, W))
    memory.update(_device_memory_stats())

    return PerfResult(
        approach=approach.value,
        nx=nx,
        ny=nx,
        dofs=W.dim(),
        num_cells=mesh.num_cells,
        iterations=its,
        residual=float(rnorm),
        times=times,
        flops=_analytic_flops(mesh, its, approach),
        metadata={
            "jax_version": jax.__version__,
            "perphil_tpu_version": perphil_tpu.__version__,
            "backend": backend_used,
            "repeats": repeats,
            "dim": 3,
            "element": mesh.element,
            "ordering": (
                "rcm-parity"
                if ordering_parity and approach == Approach.GMRES_ILU
                else "natural"
            ),
            "device": str(jax.devices()[0]),
        },
        memory=memory,
        time_total=wall / max(1, repeats),
        time_total_repeats=wall,
        measurement_class=_measurement_class(solver),
    )


def run_perf_sweep_3d(
    sizes: List[int],
    approaches: Optional[List[Approach]] = None,
    repeats: int = 3,
    backend: str = "auto",
    hexahedral: bool = False,
    ordering_parity: bool = False,
) -> List[Dict[str, Any]]:
    """Sweep 3D sizes x approaches (reference ``run_perf_sweep_3d``
    ``:203-230``)."""
    approaches = approaches or list(Approach)
    rows: List[Dict[str, Any]] = []
    for n in sizes:
        for ap in approaches:
            try:
                res = run_perf_once_3d(
                    n, ap, repeats=repeats, backend=backend, hexahedral=hexahedral,
                    ordering_parity=ordering_parity,
                )
            except Exception as exc:
                print(f"[perf3d] nx={n} {ap.value}: FAILED ({type(exc).__name__})")
                continue
            rows.append(res.to_dict())
            print(f"[perf3d] nx={n} {ap.value}: "
                  f"its={res.iterations} time_total={res.time_total:.4g}s")
    return rows


__all__ = [
    "run_perf_once_3d",
    "run_perf_sweep_3d",
    "save_perf_csv",
    "splice_perf_csv",
    "save_perf_json",
]
