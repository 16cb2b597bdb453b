"""Run the DPP solver stack once on an NVIDIA GPU and check its answers.

Usage (from the repository root)::

    python chip_smoke.py                 # phases A-G on one card
    python chip_smoke.py --compile-only  # compile phases A-F, print memory
    python chip_smoke.py --four-cards    # sharded solves on four cards

Every phase goes through the public entry points ``solve_dpp`` /
``solve_dpp_nonlinear`` with manufactured-solution boundary data, in
float64 (x64 on):

- A. direct solve (``LINEAR_SOLVER_PARAMS``), 3D hex 128^3: true-f64
  relative residual < 1e-10; at 3D 64^3 and 2D N=256 the residual is also
  recomputed on the host with scipy from the independently assembled CSR.
- B. double-float mixed direct solve (``TPU_DIRECT_PARAMS``), 128^3: the
  same residual bound, or the documented refusal on GPU backends.
- C. SS-GMRES (fieldsplit-LU), 3D hex 128^3: exactly 4 iterations.
- D-F. published iteration counts (plain GMRES and GMRES+ILU at 2D N=128,
  Picard NGS at 2D N=64) within max(2, 1%).
- G. every solver family against scipy ``spsolve`` of the assembled CSR at
  2D N=64 (quad, tri) and 3D 16^3 (hex, tet), in max-norm relative to the
  largest entry.

The script refuses to run without a GPU (no CPU fallback) and prints, as
its last line, one JSON object ``{"ok": true, "device": {...}}`` only when
every phase passed.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import traceback

import numpy as np

# Precision of each family on the default (native) path. Every float32
# product on these paths is computed at precision=HIGHEST, so TF32 never
# applies (ops/partri.py, ops/direct.py, ops/bandsolve.py).
PRECISION = {
    "direct": "f64 fast diagonalization (simplicial: f64 PCG to 1e-13)",
    "gmres": "f64 throughout",
    "gmres_ilu": "f64 Krylov, f32 ILU(0) apply (partri, HIGHEST)",
    "ss_gmres": "f64 throughout (f64 fast-diag block solves)",
    "ss_gmres_ilu": "f64 Krylov, f32 ILU(0) block applies (HIGHEST)",
    "picard_ngs": "f64 throughout",
}
DIRECT_TOL = 1e-10  # relative residual / max-norm difference, direct solves
ITERATIVE_TOL = 1e-6  # max-norm difference at ksp_rtol = snes_rtol = 1e-8


class PhaseFailure(AssertionError):
    """A phase ran but its answer broke the contract."""


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseFailure(msg)


# ---------------------------------------------------------------------------
# problem set-up
# ---------------------------------------------------------------------------


def family_params(family: str) -> tuple:
    """(solver options, nonlinear?) of a solver family."""
    from perphil_tpu.experiments.iterative_bench import Approach, params_for

    approach = {
        "direct": Approach.MONOLITHIC_MUMPS,
        "gmres": Approach.PLAIN_GMRES,
        "gmres_ilu": Approach.GMRES_ILU,
        "ss_gmres": Approach.SS_GMRES,
        "ss_gmres_ilu": Approach.SS_GMRES_ILU,
        "picard_ngs": Approach.PICARD_MUMPS,
    }[family]
    return params_for(approach), approach == Approach.PICARD_MUMPS


def build_problem(element: str, n: int):
    """(W, params, bcs) on the unit square/cube with ``n`` cells per axis
    and manufactured-solution Dirichlet data."""
    from perphil_tpu.forms import create_function_spaces, mixed_space
    from perphil_tpu.mesh import create_cube_mesh, create_mesh
    from perphil_tpu.models.dpp import DPPParameters
    from perphil_tpu.ops.assembly import DirichletBC
    from perphil_tpu.utils.manufactured_solutions import (
        exact_expressions,
        exact_expressions_3d,
    )

    if element in ("quad", "tri"):
        mesh = create_mesh(n, n, quadrilateral=element == "quad")
        exact = exact_expressions
    else:
        mesh = create_cube_mesh(n, n, n, hexahedral=element == "hex")
        exact = exact_expressions_3d
    _, V = create_function_spaces(mesh)
    W = mixed_space(V)
    params = DPPParameters()
    _, p1e, _, p2e = exact(mesh, params)
    bcs = [DirichletBC(W.sub(0), p1e), DirichletBC(W.sub(1), p2e)]
    return W, params, bcs


def _solve(W, params, bcs, sp, nonlinear=False):
    import jax

    from perphil_tpu.solvers import solve_dpp, solve_dpp_nonlinear

    fn = solve_dpp_nonlinear if nonlinear else solve_dpp
    sol = fn(W, params, bcs, solver_parameters=sp)
    jax.block_until_ready(sol.solution.data)
    return sol


def timed_solve(W, params, bcs, sp, nonlinear=False) -> tuple:
    """Solve twice: the first call traces and compiles, the second is the
    steady solve. Returns (solution, first-call s, solve s)."""
    t0 = time.perf_counter()
    _solve(W, params, bcs, sp, nonlinear)
    t1 = time.perf_counter()
    sol = _solve(W, params, bcs, sp, nonlinear)
    t2 = time.perf_counter()
    return sol, t1 - t0, t2 - t1


def device_residual(W, params, bcs, sol) -> float:
    """True-f64 relative residual ||b - A z|| / ||b|| of the BC-eliminated
    system, evaluated with the device operator."""
    import jax.numpy as jnp

    from perphil_tpu.ops.assembly import DPPOperator, bc_values_per_field

    op = DPPOperator(W, params)
    g1, g2 = bc_values_per_field(W, bcs)
    b1, b2 = op.lifted_rhs(g1, g2)
    z1, z2 = sol.solution.data
    r1, r2 = op.residual(jnp.asarray(z1), jnp.asarray(z2), b1, b2)
    num = jnp.sqrt(jnp.vdot(r1, r1) + jnp.vdot(r2, r2))
    den = jnp.sqrt(jnp.vdot(b1, b1) + jnp.vdot(b2, b2))
    return float(num / den)


def host_system(W, params, bcs):
    """(A, b) on the host: the monolithic CSR assembled by
    ``materialize_monolithic_csr`` and the lifted right-hand side."""
    from perphil_tpu.ops.assembly import (
        DPPOperator,
        bc_values_per_field,
        materialize_monolithic_csr,
    )

    A, _, _ = materialize_monolithic_csr(W, params)
    g1, g2 = bc_values_per_field(W, bcs)
    b1, b2 = DPPOperator(W, params).lifted_rhs_np(np.asarray(g1), np.asarray(g2))
    return A, np.concatenate([np.ravel(b1), np.ravel(b2)])


def host_residual(W, params, bcs, sol) -> float:
    """The relative residual recomputed with scipy from the host CSR."""
    A, b = host_system(W, params, bcs)
    x = np.concatenate([np.ravel(np.asarray(d)) for d in sol.solution.data])
    return float(np.linalg.norm(b - A @ x) / np.linalg.norm(b))


def _memory() -> int:
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return int(stats.get("peak_bytes_in_use", 0))


def _report(name: str, **fields) -> dict:
    rec = {"phase": name, **fields, "peak_bytes_in_use": _memory()}
    print(json.dumps(rec), flush=True)
    return rec


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_direct(element: str, n: int, host_check: bool) -> dict:
    """A: direct solve, true-f64 residual (and the host recomputation)."""
    W, params, bcs = build_problem(element, n)
    sp, _ = family_params("direct")
    sol, t_first, t_solve = timed_solve(W, params, bcs, sp)
    rel = device_residual(W, params, bcs, sol)
    fields = dict(dofs=int(W.dim()), first_call_s=t_first, solve_s=t_solve,
                  iterations=sol.iteration_number, rel_residual=rel)
    if host_check:
        fields["rel_residual_host"] = host_residual(W, params, bcs, sol)
    rec = _report(f"A direct {element} n={n}", **fields)
    _check(rel < DIRECT_TOL, f"direct residual {rel:.3e} >= {DIRECT_TOL}")
    if host_check:
        _check(rec["rel_residual_host"] < DIRECT_TOL,
               f"host residual {rec['rel_residual_host']:.3e} >= {DIRECT_TOL}")
    return rec


def phase_df_direct(n: int) -> dict:
    """B: the double-float mixed direct solve. Passes on the residual
    bound of phase A, or when the df entry points refuse the backend."""
    from perphil_tpu.ops.df32 import DoubleFloatUnsupported
    from perphil_tpu.solvers.parameters import TPU_DIRECT_PARAMS

    W, params, bcs = build_problem("hex", n)
    try:
        sol, t_first, t_solve = timed_solve(W, params, bcs, TPU_DIRECT_PARAMS)
    except DoubleFloatUnsupported as e:
        return _report(f"B df direct hex n={n}", refused=str(e))
    rel = device_residual(W, params, bcs, sol)
    rec = _report(f"B df direct hex n={n}", dofs=int(W.dim()),
                  first_call_s=t_first, solve_s=t_solve, rel_residual=rel)
    _check(rel < DIRECT_TOL, f"df direct residual {rel:.3e} >= {DIRECT_TOL}")
    return rec


def phase_ss_gmres(n: int) -> dict:
    """C: SS-GMRES (fieldsplit-LU) takes exactly 4 iterations."""
    W, params, bcs = build_problem("hex", n)
    sp, _ = family_params("ss_gmres")
    sol, t_first, t_solve = timed_solve(W, params, bcs, sp)
    rec = _report(f"C ss-gmres hex n={n}", dofs=int(W.dim()),
                  first_call_s=t_first, solve_s=t_solve,
                  iterations=sol.iteration_number,
                  residual=sol.residual_error,
                  rel_residual=device_residual(W, params, bcs, sol))
    _check(sol.iteration_number == 4,
           f"SS-GMRES took {sol.iteration_number} iterations, not 4")
    return rec


def count_tolerance(published: int) -> int:
    """Allowed distance from a published count: 2 iterations or 1%,
    whichever is larger (reduction order differs between backends)."""
    return max(2, int(np.ceil(0.01 * published)))


def phase_count(family: str, element: str, n: int, published: int) -> dict:
    """D-F: a published iteration count, within ``count_tolerance``."""
    W, params, bcs = build_problem(element, n)
    sp, nonlinear = family_params(family)
    sol, t_first, t_solve = timed_solve(W, params, bcs, sp, nonlinear)
    its = sol.iteration_number
    rec = _report(f"count {family} {element} n={n}", dofs=int(W.dim()),
                  first_call_s=t_first, solve_s=t_solve, iterations=its,
                  published=published, drift=its - published,
                  residual=sol.residual_error)
    _check(abs(its - published) <= count_tolerance(published),
           f"{family} n={n}: {its} iterations vs published {published}")
    return rec


def phase_reference(family: str, element: str, n: int) -> dict:
    """G: the solution against scipy ``spsolve`` of the host CSR."""
    from scipy.sparse.linalg import spsolve

    W, params, bcs = build_problem(element, n)
    sp, nonlinear = family_params(family)
    sol, t_first, t_solve = timed_solve(W, params, bcs, sp, nonlinear)
    A, b = host_system(W, params, bcs)
    ref = spsolve(A.tocsc(), b)
    x = np.concatenate([np.ravel(np.asarray(d)) for d in sol.solution.data])
    diff = float(np.abs(x - ref).max() / np.abs(ref).max())
    tol = DIRECT_TOL if family == "direct" else ITERATIVE_TOL
    rec = _report(f"G {family} {element} n={n}", first_call_s=t_first,
                  solve_s=t_solve, iterations=sol.iteration_number,
                  max_rel_diff=diff, tol=tol, precision=PRECISION[family])
    _check(diff < tol, f"{family} {element}: max-norm difference {diff:.3e} >= {tol}")
    return rec


FAMILIES = tuple(PRECISION)
REFERENCE_MESHES = (("quad", 64), ("tri", 64), ("hex", 16), ("tet", 16))


def single_card_phases() -> list:
    """The (name, thunk) list of phases A-G at full size."""
    phases = [
        ("A direct hex 128", lambda: phase_direct("hex", 128, False)),
        ("A direct hex 64", lambda: phase_direct("hex", 64, True)),
        ("A direct quad 256", lambda: phase_direct("quad", 256, True)),
        ("B df direct hex 128", lambda: phase_df_direct(128)),
        ("C ss-gmres hex 128", lambda: phase_ss_gmres(128)),
        ("D gmres quad 128", lambda: phase_count("gmres", "quad", 128, 11765)),
        ("E gmres-ilu quad 128", lambda: phase_count("gmres_ilu", "quad", 128, 74)),
        ("F picard quad 64", lambda: phase_count("picard_ngs", "quad", 64, 1673)),
    ]
    for element, n in REFERENCE_MESHES:
        for fam in FAMILIES:
            phases.append((f"G {fam} {element} {n}",
                           lambda f=fam, e=element, m=n: phase_reference(f, e, m)))
    return phases


def compile_phases() -> list:
    """(name, thunk) list that lowers and compiles the solver of each
    phase A-F at full size and prints its memory analysis, without
    running it."""
    from perphil_tpu.ops.assembly import bc_values_per_field
    from perphil_tpu.solvers.parameters import TPU_DIRECT_PARAMS
    from perphil_tpu.solvers.solver import (
        _build_linear_solver,
        _build_nonlinear_solver,
        _freeze,
    )

    def compile_one(label, element, n, sp, nonlinear=False):
        W, params, bcs = build_problem(element, n)
        build = _build_nonlinear_solver if nonlinear else _build_linear_solver
        t0 = time.perf_counter()
        solver = build(W, params, _freeze(sp))
        g1, g2 = bc_values_per_field(W, bcs)
        compiled = solver.lower(g1, g2).compile()
        secs = time.perf_counter() - t0
        mem = compiled.memory_analysis()
        return _report(f"compile {label}", dofs=int(W.dim()), compile_s=secs,
                       memory_analysis=str(mem))

    cases = [
        ("A direct hex 128", "hex", 128, family_params("direct")[0]),
        ("A direct hex 64", "hex", 64, family_params("direct")[0]),
        ("A direct quad 256", "quad", 256, family_params("direct")[0]),
        ("B df direct hex 128", "hex", 128, TPU_DIRECT_PARAMS),
        ("C ss-gmres hex 128", "hex", 128, family_params("ss_gmres")[0]),
        ("D gmres quad 128", "quad", 128, family_params("gmres")[0]),
        ("E gmres-ilu quad 128", "quad", 128, family_params("gmres_ilu")[0]),
        ("F picard quad 64", "quad", 64, family_params("picard_ngs")[0], True),
    ]
    return [(c[0], lambda c=c: compile_one(*c)) for c in cases]


def four_card_phases(n: int = 255, n3: int = 63, n2: int = 127, q2_cells: int = 63) -> list:
    """The sharded path on a (2, 2) ("z", "y") mesh of four cards, each
    solve compared with the single-card solve in the same process: direct
    and SS-GMRES at 3D hex ``n``^3, and the six dry-run paths at ``n3``^3 /
    ``n2``^2 (degree 2 on ``q2_cells``^2 cells)."""
    import jax

    from perphil_tpu.parallel.sharding import device_mesh, sharded_solve_dpp

    def sharded_vs_single(family: str, n: int):
        W, params, bcs = build_problem("hex", n)
        sp, _ = family_params(family)
        single, t1_first, t1 = timed_solve(W, params, bcs, sp)
        dmesh = device_mesh([2, 2])
        t0 = time.perf_counter()
        sharded_solve_dpp(W, params, bcs, dmesh, solver_parameters=sp)
        t_first = time.perf_counter() - t0
        t0 = time.perf_counter()
        sol = sharded_solve_dpp(W, params, bcs, dmesh, solver_parameters=sp)
        jax.block_until_ready(sol.solution.data)
        t_solve = time.perf_counter() - t0
        devs = {len(d.sharding.device_set) for d in sol.solution.data}
        diff = max(
            float(np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(np.asarray(b)).max())
            for a, b in zip(sol.solution.data, single.solution.data)
        )
        rec = _report(f"4-card {family} hex n={n}", dofs=int(W.dim()),
                      single_first_call_s=t1_first, single_solve_s=t1,
                      sharded_first_call_s=t_first, sharded_solve_s=t_solve,
                      iterations_single=single.iteration_number,
                      iterations_sharded=sol.iteration_number,
                      devices_per_array=sorted(devs), max_rel_diff=diff)
        _check(sol.iteration_number == single.iteration_number,
               f"{family}: sharded {sol.iteration_number} vs single "
               f"{single.iteration_number} iterations")
        _check(devs == {4}, f"{family}: solution spans {devs} devices, not 4")
        _check(diff < 1e-8, f"{family}: sharded solution deviates by {diff:.3e}")
        return rec

    def dry_run_paths():
        from __graft_entry__ import sharded_paths

        results = sharded_paths(device_mesh([2, 2]), n3=n3, n2=n2, q2_cells=q2_cells)
        return _report(f"4-card dryrun paths n3={n3} n2={n2}", paths=results)

    return [
        (f"4-card direct hex {n}", lambda: sharded_vs_single("direct", n)),
        (f"4-card ss-gmres hex {n}", lambda: sharded_vs_single("ss_gmres", n)),
        ("4-card dryrun paths", dry_run_paths),
    ]


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------


def require_gpu(count: int):
    """The first JAX device, which must be a GPU; ``count`` cards needed."""
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise SystemExit(
            f"chip_smoke: needs an NVIDIA GPU, JAX found platform "
            f"{devices[0].platform!r}"
        )
    if len(devices) < count:
        raise SystemExit(f"chip_smoke: needs {count} GPUs, JAX found {len(devices)}")
    return devices[0]


def run_phases(phases: list) -> list:
    """Run every phase; return the names of those that failed."""
    failed = []
    for name, thunk in phases:
        print(f"--- {name}", flush=True)
        try:
            thunk()
        except Exception:  # record the phase as failed, keep going
            traceback.print_exc()
            failed.append(name)
    return failed


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    mode = parser.add_mutually_exclusive_group()
    mode.add_argument("--four-cards", action="store_true",
                      help="run only the sharded path on four cards")
    mode.add_argument("--compile-only", action="store_true",
                      help="compile phases A-F and print their memory analysis")
    args = parser.parse_args(argv)
    count = 4 if args.four_cards else 1

    import perphil_tpu  # noqa: F401  (enables x64)
    from perphil_tpu.config import gpu_identity, setup_compilation_cache

    dev = require_gpu(count)
    print(f"compilation cache: {setup_compilation_cache()}", flush=True)
    print("nvidia-smi --query-gpu=name,power.limit --format=csv,noheader:", flush=True)
    print(gpu_identity(), flush=True)
    print(f"device: {dev.platform} {dev.device_kind}", flush=True)

    if args.four_cards:
        phases = four_card_phases()
    elif args.compile_only:
        phases = compile_phases()
    else:
        phases = single_card_phases()
    t0 = time.perf_counter()
    failed = run_phases(phases)
    print(f"total {time.perf_counter() - t0:.1f} s", flush=True)
    if failed:
        print(f"FAILED phases: {failed}", file=sys.stderr, flush=True)
        return 1
    import jax

    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
