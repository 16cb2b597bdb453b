"""Headline benchmark: 3D DPP assemble+solve at 64^3 and 128^3 hex on one GPU.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", ...} with
the device it ran on (platform, device_kind, device count, and the card's
name and power limit from nvidia-smi). Refuses to run without a GPU.

What is measured: the default direct-solve pipeline of
``solve_dpp(..., LINEAR_SOLVER_PARAMS)`` — boundary-condition lift (stencil
RHS assembly) + exact float64 fast-diagonalization solve of the coupled
two-pressure DPP system — at 64^3 hexes (274,625 nodes x 2 fields = 549,250
DoF) and at 128^3 hexes (4,293,378 DoF), each residual-verified below 1e-10
relative in float64 after timing.

Timing protocol: the pipeline runs K times *inside one jitted lax.scan*
with data-dependent chaining (no call can be elided) and a single scalar
host readback at the end; reported value = the MARGINAL between a K-trip
and a 2K-trip chain, (T(2K) - T(K)) / K, with K grown until the marginal
window reaches >= 0.25 s, so the fixed per-call cost (dispatch, host
readback) cancels (perphil_tpu/utils/marginal.py holds the protocol).

vs_baseline: the reference's CPU/PETSc direct solve on its LARGEST published
3D problem — MUMPS at nx=40 tets, 137,842 DoF, time_total 18.56 s
(reference notebooks/results-conforming-3d/petsc_profiling/
petsc_perf_breakdown_3d.csv) — divided by our time on this 4x-larger
problem.
"""

from __future__ import annotations

import json

BASELINE_MUMPS_3D_NX40_SECONDS = 18.56  # largest published 3D direct solve


class _Case:
    """One problem size: mesh, operator, solver, boundary data, the jitted
    pipeline, and the chained-timing factory. Shared by both sizes so the
    protocol cannot diverge between them."""

    def __init__(self, N: int):
        import jax
        import jax.numpy as jnp

        from perphil_tpu.forms import create_function_spaces, mixed_space
        from perphil_tpu.forms.spaces import _evaluate
        from perphil_tpu.mesh import create_cube_mesh
        from perphil_tpu.models.dpp import DPPParameters
        from perphil_tpu.ops.assembly import DPPOperator
        from perphil_tpu.ops.direct import FastDiagDPPSolver
        from perphil_tpu.utils.manufactured_solutions import exact_expressions_3d

        self.N = N
        self.mesh = create_cube_mesh(N, N, N, hexahedral=True)
        _, V = create_function_spaces(self.mesh)
        self.W = mixed_space(V)
        params = DPPParameters()
        self.op = op = DPPOperator(self.W, params)
        solver = FastDiagDPPSolver(self.mesh, params)

        _, p1e, _, p2e = exact_expressions_3d(self.mesh, params)
        self.g1 = _evaluate(p1e, self.mesh, ())
        self.g2 = _evaluate(p2e, self.mesh, ())

        def assemble_and_solve(g1, g2):
            b1, b2 = op.lifted_rhs(g1, g2)
            return solver.solve(b1, b2)

        self.pipeline = jax.jit(assemble_and_solve)

        def make_chain(length):
            @jax.jit
            def timed_chain(g1, g2):
                # every trip re-solves the identical system behind an
                # optimization_barrier carrying BOTH inputs and the
                # previous output, so XLA can neither hoist loop-invariant
                # subcomputations out of the scan nor DCE any output leaf;
                # the final reduction keeps both solution fields live.
                zeros = (jnp.zeros_like(g1), jnp.zeros_like(g2))

                def body(carry, _):
                    c1, c2, _prev = carry
                    out = assemble_and_solve(c1, c2)
                    return jax.lax.optimization_barrier((c1, c2, out)), None

                (_, _, out), _ = jax.lax.scan(
                    body, (g1, g2, zeros), None, length=length
                )
                return jnp.sum(out[0]) + jnp.sum(out[1])

            return timed_chain

        self.make_chain = make_chain

    def measure(self, k_pilot: int) -> float:
        from perphil_tpu.utils.marginal import chained_marginal

        float(self.pipeline(self.g1, self.g2)[0].sum())  # warmup / compile
        return chained_marginal(self.make_chain, (self.g1, self.g2), k_pilot)

    def rel_residual_f64(self) -> float:
        """True-float64 relative residual of the solve, outside timing."""
        import jax.numpy as jnp

        z1, z2 = self.pipeline(self.g1, self.g2)
        b1, b2 = self.op.lifted_rhs(self.g1, self.g2)
        r1, r2 = self.op.residual(z1, z2, b1, b2)
        return float(
            jnp.sqrt(jnp.vdot(r1, r1) + jnp.vdot(r2, r2)).real
            / jnp.sqrt(jnp.vdot(b1, b1) + jnp.vdot(b2, b2)).real
        )

    def record(self, k_pilot: int) -> dict:
        from perphil_tpu.utils.roofline import analyze_compiled

        t = self.measure(k_pilot)
        rel = self.rel_residual_f64()
        if not rel < 1e-10:
            raise RuntimeError(f"{self.N}^3 direct solve residual too large: {rel}")
        point = analyze_compiled(
            f"pipeline_{self.N}cube", self.pipeline, (self.g1, self.g2), t
        )
        return {
            "value": t,
            "dofs": int(self.W.dim()),
            "rel_residual_f64": rel,
            "achieved_gflops": point.gflops,
            "achieved_gbs": point.gbs,
            "fp64_peak_frac": point.fp64_frac,
            "hbm_bw_frac": point.hbm_frac,
            "roofline_bound": point.bound,
        }


def main() -> None:
    import jax

    import perphil_tpu  # noqa: F401  (enables x64)
    from perphil_tpu.config import gpu_identity, setup_compilation_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench: needs an NVIDIA GPU, JAX found {dev.platform!r}")
    setup_compilation_cache()

    r64 = _Case(64).record(20)
    r128 = _Case(128).record(10)
    record = {
        "metric": "3d_dpp_assemble_plus_direct_solve_64cube_hex",
        "value": r64["value"],
        "unit": "s",
        "vs_baseline": BASELINE_MUMPS_3D_NX40_SECONDS / r64["value"],
        **{k: v for k, v in r64.items() if k != "value"},
        "value_128cube": r128["value"],
        **{f"{k}_128cube": v for k, v in r128.items() if k != "value"},
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
        "nvidia_smi": gpu_identity(),
    }
    print(json.dumps(record))


if __name__ == "__main__":
    main()
