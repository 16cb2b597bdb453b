"""Linear and nonlinear DPP solvers.

Parity with ``/root/reference/src/perphil/solvers/solver.py``:
  - ``Solution``            (reference ``:14-27``)
  - ``solve_dpp``           (reference ``:30-76``)
  - ``solve_dpp_nonlinear`` (reference ``:79-128``)

The reference hands PETSc option dicts to Firedrake's variational solvers;
here the same dicts configure a JAX-native stack:

  ksp_type=gmres            -> restarted GMRES (``ops/krylov.py``)
  ksp_type=preonly + pc=lu  -> exact tensor fast-diagonalization direct
                               solve (``ops/direct.py``); on simplicial
                               meshes, machine-tolerance PCG with the
                               lumped-tensor preconditioner (documented
                               MUMPS substitution)
  pc_type=fieldsplit        -> explicit 2x2 block Gauss-Seidel
                               (multiplicative) / block Jacobi (additive)
  pc_type=ilu               -> structured ILU(0), wavefront-scheduled
  pc_type=jacobi / none     -> diagonal / identity
  snes_type=ngs             -> Picard block Gauss-Seidel sweeps
  snes_type=nrichardson     -> damped preconditioned Richardson
  snes_type=ksponly         -> one linear solve

Compiled solvers are cached per (space, parameters, options) so repeated
solves (convergence sweeps, profiling repeats) reuse the XLA executable and
differ only in boundary-condition data.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from functools import lru_cache
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np

from perphil_tpu.forms.spaces import Function, MixedFunctionSpace
from perphil_tpu.mesh.structured import StructuredMesh
from perphil_tpu.models.dpp.parameters import DPPParameters
from perphil_tpu.ops.assembly import (
    DirichletBC,
    DPPOperator,
    FieldOperator,
    bc_values_per_field,
)
from perphil_tpu.ops.direct import FastDiagDPPSolver, FastDiagFieldSolver
from perphil_tpu.ops.krylov import cg, gmres
from perphil_tpu.ops.stencil import apply_stencil, compile_stencils

logger = logging.getLogger(__name__)

_DIRECT_RTOL = 1e-13  # inner tolerance when "LU" is emulated by PCG


_LIFT_CONST_BYTES = 1 << 16  # embed constants below this size, lift the rest


def _lifted_jit(fn: Callable, *example_args) -> Callable:
    """``jit`` with large closure-captured arrays lifted to arguments.

    Solve functions close over precomputed preconditioner tensors (the
    parallel-prefix ILU trees reach ~540 MB at 2D N=256). As closure
    constants those land in the HLO constant pool: a 2D N=256 ILU solve
    lowers to >1 GB of HLO text, the executable embeds a copy of every
    tensor, and each recompilation serializes them again. This traces
    ``fn`` once, swaps every constant above ``_LIFT_CONST_BYTES`` for a
    runtime argument, and jits the re-wired jaxpr, so the tensors stay
    ordinary device buffers. (``jax.closure_convert`` is not enough: it
    hoists only AD-perturbed consts, not plain concrete arrays.)
    """
    flat_args, in_tree = jax.tree_util.tree_flatten(example_args)
    out_trees = []

    def flat_fn(*flat):
        args = jax.tree_util.tree_unflatten(in_tree, flat)
        out = fn(*args)
        out_flat, out_tree = jax.tree_util.tree_flatten(out)
        out_trees.append(out_tree)
        return out_flat

    closed = jax.make_jaxpr(flat_fn)(*flat_args)
    out_tree = out_trees[-1]
    consts = closed.consts
    big = {
        i
        for i, c in enumerate(consts)
        if getattr(c, "nbytes", 0) > _LIFT_CONST_BYTES
    }
    small = [c for i, c in enumerate(consts) if i not in big]
    big_vals = [consts[i] for i in sorted(big)]

    def run(big_args, *flat):
        it_small = iter(small)
        it_big = iter(big_args)
        merged = [
            next(it_big) if i in big else next(it_small) for i in range(len(consts))
        ]
        return jax.core.eval_jaxpr(closed.jaxpr, merged, *flat)

    jitted = jax.jit(run)

    def call(*args):
        flat, _ = jax.tree_util.tree_flatten(args)
        out_flat = jitted(big_vals, *flat)
        return jax.tree_util.tree_unflatten(out_tree, out_flat)

    def lower(*args):
        """AOT lowering for ``args`` (``.compile().memory_analysis()``)."""
        flat, _ = jax.tree_util.tree_flatten(args)
        return jitted.lower(big_vals, *flat)

    call.lower = lower
    return call


def _example_grids(op: "DPPOperator", k: int):
    from perphil_tpu.config import default_dtype

    shape = op.grid_shape
    return tuple(jnp.zeros(shape, dtype=default_dtype()) for _ in range(k))


@dataclass(frozen=True)
class Solution:
    """Result of a solve; parity with reference ``solver.py:14-27``."""

    solution: Union[Function, Tuple[Function, Function]]
    iteration_number: int
    residual_error: float


# ---------------------------------------------------------------------------
# solver-option plumbing
# ---------------------------------------------------------------------------


def _flatten_options(sp: Dict, prefix: str = "") -> Dict[str, object]:
    """Flatten nested option dicts (``{"fieldsplit_0": {...}}``) into
    PETSc-style prefixed keys (``fieldsplit_0_ksp_type``), which the
    reference also uses interchangeably (``iterative_bench.py:134-154``)."""
    out: Dict[str, object] = {}
    for k, v in (sp or {}).items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten_options(v, prefix=f"{key}_"))
        else:
            out[key] = v
    return out


def _freeze(sp: Dict) -> Tuple:
    flat = _flatten_options(sp)
    return tuple(sorted(flat.items()))


def _sub_options(flat: Dict[str, object], prefix: str) -> Dict[str, object]:
    plen = len(prefix)
    return {k[plen:]: v for k, v in flat.items() if k.startswith(prefix)}


# ---------------------------------------------------------------------------
# block solvers and preconditioners (grid-shaped, single field)
# ---------------------------------------------------------------------------


def _use_mixed_exact() -> bool:
    """Choose the implementation of 'exact' (LU-role) solves.

    Native float64 fast diagonalization on every backend.
    ``PERPHIL_TPU_EXACT_SOLVES=mixed`` selects the f32 + double-float
    iterative-refinement variant (``ops/mixed.py``) instead.
    """
    import os

    return os.environ.get("PERPHIL_TPU_EXACT_SOLVES", "f64") == "mixed"


def _exact_field_solver(fop: FieldOperator) -> Callable:
    """Exact 'LU-class' solve of one BC-eliminated block."""
    mesh = fop.mesh
    if mesh.is_tensor_product:
        if _use_mixed_exact():
            from perphil_tpu.ops.mixed import MixedPrecisionFieldDirect

            return MixedPrecisionFieldDirect(
                mesh, fop.k, fop.beta, fop.mu, padding=fop.padding
            ).solve
        fd = FastDiagFieldSolver(mesh, fop.k, fop.beta, fop.mu)
        return fd.solve
    # simplicial: PCG with the lumped-tensor fast-diag preconditioner,
    # converged to machine tolerance (plays the exact-LU role).
    pc = FastDiagFieldSolver(mesh, fop.k, fop.beta, fop.mu, lumped=True)

    def solve(b):
        x, _, _ = cg(
            fop.matvec, b, rtol=_DIRECT_RTOL, atol=0.0, max_it=1000, M_inv=pc.solve
        )
        return x

    return solve


def _field_pc(fop: FieldOperator, pc_type: str, flat: Dict) -> Optional[Callable]:
    if pc_type in ("none", None):
        return None
    if pc_type == "jacobi":
        center = (1,) * fop.mesh.dim
        dc = float(np.asarray(fop.stencil)[center])
        bdry = jnp.asarray(fop._mask_arrays[0])  # padded-aware mask
        dinv = jnp.where(bdry, 1.0, 1.0 / dc)
        return lambda r: dinv * r
    if pc_type in ("lu", "cholesky"):
        return _exact_field_solver(fop)
    if pc_type == "ilu":
        from perphil_tpu.ops.ilu import StructuredILU0

        ilu = StructuredILU0.for_field(fop)
        if not any(fop.padding):
            return ilu.apply_grid
        # ILU runs on the unpadded system; phantom rows are identity
        crop = tuple(slice(0, n) for n in fop.mesh.node_shape)

        def apply_ilu_padded(r):
            return r.at[crop].set(ilu.apply_grid(r[crop]))

        return apply_ilu_padded
    raise ValueError(f"Unsupported block pc_type: {pc_type!r}")


def _block_solver(fop: FieldOperator, sub: Dict[str, object]) -> Callable:
    """Build a grid->grid solver for one fieldsplit block from its
    sub-options (reference nests full KSP configs per block,
    ``parameters.py:30-57``)."""
    ksp = str(sub.get("ksp_type", "preonly"))
    pc_type = str(sub.get("pc_type", "ilu"))
    if ksp == "preonly":
        if pc_type in ("lu", "cholesky"):
            return _exact_field_solver(fop)
        pc = _field_pc(fop, pc_type, sub)
        return pc if pc is not None else (lambda r: r)
    if ksp in ("gmres", "cg"):
        rtol = float(sub.get("ksp_rtol", 1e-5))
        atol = float(sub.get("ksp_atol", 1e-50))
        max_it = int(sub.get("ksp_max_it", 10000))
        restart = int(sub.get("ksp_gmres_restart", 30))
        pc = _field_pc(fop, pc_type, sub)

        if ksp == "gmres":

            def solve(b):
                # gmres is shape-general: operate on the grid directly so
                # device shardings propagate through nested block solves
                res = gmres(
                    fop.matvec, b, rtol=rtol, atol=atol, max_it=max_it,
                    restart=restart, M_inv=pc,
                )
                return res.x

        else:

            def solve(b):
                x, _, _ = cg(fop.matvec, b, rtol=rtol, atol=atol, max_it=max_it, M_inv=pc)
                return x

        return solve
    raise ValueError(f"Unsupported block ksp_type: {ksp!r}")


def _coupling_apply(
    mesh: StructuredMesh, params: DPPParameters, padding: Tuple[int, ...] = ()
) -> Callable:
    """The off-diagonal block ``C = -(beta/mu) M`` with BC rows/cols zeroed."""
    from perphil_tpu.ops.assembly import _masks

    _, M_st = compile_stencils(mesh)
    bdry, _ = _masks(mesh, padding)
    bdry = jnp.asarray(bdry)
    coef = -(params.beta / params.mu)

    def C(z):
        zi = jnp.where(bdry, 0.0, z)
        return jnp.where(bdry, 0.0, coef * apply_stencil(zi, M_st))

    return C


def _monolithic_pc(
    op: DPPOperator, flat: Dict[str, object]
) -> Optional[Callable]:
    """Left preconditioner on stacked fields (2, *node_shape) -> same,
    from PETSc-style options. The stacked layout keeps grid axes intact so
    device-mesh shardings flow through every PC except ILU (which is
    sequential by nature and reshapes to the flat row order internally)."""
    pc_type = str(flat.get("pc_type", "none"))
    mesh = op.mesh
    gshape = op.grid_shape

    if pc_type == "none":
        return None
    if pc_type == "jacobi":
        dinv = (1.0 / op.diagonal()).reshape((2,) + gshape)
        return lambda r: dinv * r
    if pc_type in ("lu", "cholesky"):
        direct = _monolithic_direct(op)

        def apply_lu(r):
            z1, z2 = direct(r[0], r[1])
            return jnp.stack([z1, z2])

        return apply_lu
    if pc_type == "ilu":
        from perphil_tpu.ops.ilu import StructuredILU0

        levels = int(flat.get("pc_factor_levels", 0) or 0)
        if levels != 0:
            raise NotImplementedError(
                "Only ILU(0) is implemented (the only level any reference "
                "workload uses, parameters.py:27)"
            )
        ilu = StructuredILU0.for_monolithic(op)
        crop = (slice(None),) + tuple(slice(0, n) for n in mesh.node_shape)

        def apply_ilu(r):
            # ILU is sequential (wavefront) and runs on the unpadded system;
            # phantom rows are identity, so the PC passes them through.
            rr = r[crop]
            z = ilu.apply_flat(rr.reshape(-1)).reshape(rr.shape)
            return r.at[crop].set(z)

        return apply_ilu
    if pc_type == "fieldsplit":
        fs_type = str(flat.get("pc_fieldsplit_type", "multiplicative"))
        p = op.params
        f0 = FieldOperator(op.W.sub(0), p.k1, p.beta, p.mu, op.padding)
        f1 = FieldOperator(op.W.sub(1), p.k2, p.beta, p.mu, op.padding)
        B0 = _block_solver(f0, _sub_options(flat, "fieldsplit_0_"))
        B1 = _block_solver(f1, _sub_options(flat, "fieldsplit_1_"))
        C = _coupling_apply(mesh, p, op.padding)

        if fs_type == "multiplicative":

            def apply_fs(r):
                y1 = B0(r[0])
                y2 = B1(r[1] - C(y1))
                return jnp.stack([y1, y2])

        elif fs_type == "additive":

            def apply_fs(r):
                y1 = B0(r[0])
                y2 = B1(r[1])
                return jnp.stack([y1, y2])

        else:
            raise ValueError(f"Unsupported pc_fieldsplit_type: {fs_type!r}")

        return apply_fs
    raise ValueError(f"Unsupported pc_type: {pc_type!r}")


# ---------------------------------------------------------------------------
# double-float (df32) Krylov path — explicit opt-in
# ---------------------------------------------------------------------------


def _ksp_mode() -> str:
    """Krylov arithmetic: 'native' (float64, exact PETSc parity; the golden
    regression suite runs it) on every backend, or 'df32' (two-f32 vectors,
    f64 scalars) when ``PERPHIL_TPU_KSP_DTYPE=df32`` asks for it.
    """
    import os

    return "df32" if os.environ.get("PERPHIL_TPU_KSP_DTYPE") == "df32" else "native"


def _df_of(g64):
    from perphil_tpu.ops.df32 import df_from_f64

    return df_from_f64(g64)


def _f64_of(df):
    return df[0].astype(jnp.float64) + df[1].astype(jnp.float64)


def _exact_field_solver_df(fop: FieldOperator) -> Callable:
    """df-pair exact block solve (the fieldsplit 'LU' role)."""
    from perphil_tpu.ops.krylov import cg_df

    mesh = fop.mesh
    if mesh.is_tensor_product:
        from perphil_tpu.ops.mixed import MixedPrecisionFieldDirect

        return MixedPrecisionFieldDirect(
            mesh, fop.k, fop.beta, fop.mu, padding=fop.padding
        ).solve_df
    # simplicial: machine-tolerance df CG with the f32 lumped fast-diag PC
    pc32 = FastDiagFieldSolver(mesh, fop.k, fop.beta, fop.mu, lumped=True)

    def pc_df(v):
        z = pc32.solve(v[0] + v[1])
        return z, jnp.zeros_like(z)

    def solve(b_df):
        x, _, _ = cg_df(
            fop.matvec_df, b_df, rtol=_DIRECT_RTOL, atol=0.0, max_it=1000,
            M_inv_df=pc_df,
        )
        return x

    return solve


def _field_pc_df(fop: FieldOperator, pc_type: str, sub: Dict) -> Optional[Callable]:
    if pc_type in ("none", None):
        return None
    if pc_type == "jacobi":
        center = (1,) * fop.mesh.dim
        dc = float(np.asarray(fop.stencil)[center])
        bdry = jnp.asarray(fop._mask_arrays[0])
        dinv = jnp.where(bdry, 1.0, 1.0 / dc).astype(jnp.float32)
        return lambda v: (dinv * v[0], dinv * v[1])
    if pc_type in ("lu", "cholesky"):
        return _exact_field_solver_df(fop)
    if pc_type == "ilu":
        from perphil_tpu.ops import partri
        from perphil_tpu.ops.ilu import StructuredILU0

        # PERPHIL_TPU_PARTRI_WEIGHT_DTYPE may store the inner blocks'
        # chain maps in a narrower dtype (only the OUTER iteration count,
        # 4 at every size, is a published artifact).
        import os

        inner_wd = os.environ.get("PERPHIL_TPU_PARTRI_WEIGHT_DTYPE")
        with partri.weight_dtype(inner_wd):
            ilu = StructuredILU0.for_field(fop)
        crop = tuple(slice(0, n) for n in fop.mesh.node_shape)
        padded = any(fop.padding)

        def apply_ilu_df(v):
            v32 = v[0] + v[1]
            if padded:
                z = v32.at[crop].set(ilu.apply_grid(v32[crop]))
            else:
                z = ilu.apply_grid(v32)
            return z, jnp.zeros_like(z)

        return apply_ilu_df
    raise ValueError(f"Unsupported block pc_type: {pc_type!r}")


def _block_solver_df(fop: FieldOperator, sub: Dict[str, object]) -> Callable:
    """df-pair grid->grid fieldsplit block solver."""
    from perphil_tpu.ops.krylov import cg_df, gmres_df

    ksp = str(sub.get("ksp_type", "preonly"))
    pc_type = str(sub.get("pc_type", "ilu"))
    if ksp == "preonly":
        if pc_type in ("lu", "cholesky"):
            return _exact_field_solver_df(fop)
        pc = _field_pc_df(fop, pc_type, sub)
        return pc if pc is not None else (lambda v: v)
    if ksp in ("gmres", "cg"):
        rtol = float(sub.get("ksp_rtol", 1e-5))
        atol = float(sub.get("ksp_atol", 1e-50))
        max_it = int(sub.get("ksp_max_it", 10000))
        restart = int(sub.get("ksp_gmres_restart", 30))
        pc = _field_pc_df(fop, pc_type, sub)

        # Inner fieldsplit blocks are SPD (scalar diffusion + mass with
        # symmetric BC elimination) and their solutions — not their Krylov
        # trajectories — feed the outer solve, so the inner method is an
        # implementation detail as long as it converges to the same
        # tolerances. Tolerance-matched PCG replaces restarted GMRES: CG
        # costs ~4 vector ops per iteration against GMRES(30)'s growing
        # CGS projection sweep (and loses nothing on SPD blocks); the
        # outer 4-iteration signature is invariant to the substitution.
        # conv_norm="preconditioned" makes the CG stop on
        # the same left-preconditioned norm gmres_df tests (true-residual
        # stopping would be a DIFFERENT effective tolerance under ILU).
        # PERPHIL_TPU_INNER_KSP=gmres restores literal inner-GMRES
        # semantics.
        import os

        if ksp == "gmres" and os.environ.get("PERPHIL_TPU_INNER_KSP") == "gmres":

            def solve(b_df):
                res = gmres_df(
                    fop.matvec_df, b_df, rtol=rtol, atol=atol, max_it=max_it,
                    restart=restart, M_inv_df=pc,
                )
                return res.x

        else:
            # substituting for gmres: stop on the left-preconditioned norm
            # gmres_df would have tested; a literal ksp_type=cg keeps the
            # true-residual test (cg_df's default)
            norm = "preconditioned" if ksp == "gmres" else "unpreconditioned"

            def solve(b_df):
                x, _, _ = cg_df(
                    fop.matvec_df, b_df, rtol=rtol, atol=atol, max_it=max_it,
                    M_inv_df=pc, conv_norm=norm,
                )
                return x

        return solve
    raise ValueError(f"Unsupported block ksp_type: {ksp!r}")


def _coupling_apply_df(
    mesh: StructuredMesh, params: DPPParameters, padding: Tuple[int, ...] = ()
) -> Callable:
    """df analogue of :func:`_coupling_apply`."""
    from perphil_tpu.ops.assembly import _masks
    from perphil_tpu.ops.df32 import df_apply_stencil, df_axpy_wf64

    _, M_st = compile_stencils(mesh)
    bdry, _ = _masks(mesh, padding)
    bdry = jnp.asarray(bdry)
    coef = -(params.beta / params.mu)

    def C(z):
        zi = (jnp.where(bdry, 0.0, z[0]), jnp.where(bdry, 0.0, z[1]))
        y = df_apply_stencil(zi, np.asarray(M_st))
        zero = (jnp.zeros_like(z[0]), jnp.zeros_like(z[1]))
        y = df_axpy_wf64(zero, coef, y)
        return (jnp.where(bdry, 0.0, y[0]), jnp.where(bdry, 0.0, y[1]))

    return C


def _monolithic_pc_df(op: DPPOperator, flat: Dict[str, object]) -> Optional[Callable]:
    """df analogue of :func:`_monolithic_pc`: stacked df pairs in and out.

    PC internals run at their natural precision: f32 for ILU/Jacobi (a
    preconditioner needs no more), double-float refinement for exact-LU
    roles (accuracy ~1e-12, needed for the fieldsplit-LU 4-iteration
    signature)."""
    from perphil_tpu.ops.df32 import df_sub as _df_sub

    pc_type = str(flat.get("pc_type", "none"))
    mesh = op.mesh

    def _split(r):
        rh, rl = r
        return (rh[0], rl[0]), (rh[1], rl[1])

    def _stack(a, b):
        return jnp.stack([a[0], b[0]]), jnp.stack([a[1], b[1]])

    if pc_type == "none":
        return None
    if pc_type == "jacobi":
        dinv = (1.0 / op.diagonal()).reshape((2,) + op.grid_shape).astype(jnp.float32)
        return lambda r: (dinv * r[0], dinv * r[1])
    if pc_type in ("lu", "cholesky"):
        if mesh.is_tensor_product:
            from perphil_tpu.ops.mixed import MixedPrecisionDPPDirect

            direct = MixedPrecisionDPPDirect(mesh, op.params, padding=op.padding)

            def apply_lu(r):
                r1, r2 = _split(r)
                z1, z2 = direct.solve_df(r1, r2)
                return _stack(z1, z2)

            return apply_lu
        # simplicial monolithic LU role: f64 fallback through the native
        # direct solver (not used by any benchmark approach)
        direct64 = _monolithic_direct(op)

        def apply_lu64(r):
            r1, r2 = _split(r)
            z1, z2 = direct64(_f64_of(r1), _f64_of(r2))
            from perphil_tpu.ops.df32 import df_from_f64

            return _stack(df_from_f64(z1), df_from_f64(z2))

        return apply_lu64
    if pc_type == "ilu":
        from perphil_tpu.ops.ilu import StructuredILU0

        levels = int(flat.get("pc_factor_levels", 0) or 0)
        if levels != 0:
            raise NotImplementedError(
                "Only ILU(0) is implemented (the only level any reference "
                "workload uses, parameters.py:27)"
            )
        # PC-apply precision policy (docs/design.md §7): convergence margins
        # TIGHTEN as systems shrink (measured: f32 apply drifts N=64 to 43
        # vs PETSc's 42, while N=128/256 are exact in f32), so small
        # monolithic systems get the df-grade apply — defect-corrected f32
        # trisolves against the df-stored f64 factor, matching PETSc's f64
        # ILU operator to ~1e-14 — and large ones keep the cheap f32 apply
        # (2x less PCApply cost; counts exact there). Overrides:
        # PERPHIL_TPU_ILU_DTYPE, PERPHIL_TPU_ILU_DF_MAX_DOF.
        import os as _os

        df_max = int(_os.environ.get("PERPHIL_TPU_ILU_DF_MAX_DOF", "20000"))
        mode = "df32" if int(op.W.dim()) <= df_max else None
        ilu = StructuredILU0.for_monolithic(op, dtype_mode=mode)
        crop = (slice(None),) + tuple(slice(0, n) for n in mesh.node_shape)

        if ilu.factors_lo is not None:
            # PERPHIL_TPU_ILU_DTYPE=df32: double-float PC application
            # (defect-corrected f32 trisolves against the df-stored f64
            # factor) — matches PETSc's f64 ILU apply to ~1e-14 and keeps
            # the N=64 golden count at 42 (docs/design.md §7)
            def apply_ilu_df(r):
                shape = r[0][crop].shape
                rr = (r[0][crop].reshape(-1), r[1][crop].reshape(-1))
                zh, zl = ilu.apply_flat_df(rr)
                out_h = r[0].at[crop].set(zh.reshape(shape))
                out_l = r[1].at[crop].set(zl.reshape(shape))
                return out_h, out_l

            return apply_ilu_df

        def apply_ilu_df(r):
            r32 = r[0] + r[1]
            rr = r32[crop]
            z = ilu.apply_flat(rr.reshape(-1)).reshape(rr.shape)
            out = r32.at[crop].set(z)
            return out, jnp.zeros_like(out)

        return apply_ilu_df
    if pc_type == "fieldsplit":
        fs_type = str(flat.get("pc_fieldsplit_type", "multiplicative"))
        p = op.params
        f0 = FieldOperator(op.W.sub(0), p.k1, p.beta, p.mu, op.padding)
        f1 = FieldOperator(op.W.sub(1), p.k2, p.beta, p.mu, op.padding)
        B0 = _block_solver_df(f0, _sub_options(flat, "fieldsplit_0_"))
        B1 = _block_solver_df(f1, _sub_options(flat, "fieldsplit_1_"))
        C = _coupling_apply_df(mesh, p, op.padding)

        if fs_type == "multiplicative":

            def apply_fs(r):
                r1, r2 = _split(r)
                y1 = B0(r1)
                y2 = B1(_df_sub(r2, C(y1)))
                return _stack(y1, y2)

        elif fs_type == "additive":

            def apply_fs(r):
                r1, r2 = _split(r)
                return _stack(B0(r1), B1(r2))

        else:
            raise ValueError(f"Unsupported pc_fieldsplit_type: {fs_type!r}")

        return apply_fs
    raise ValueError(f"Unsupported pc_type: {pc_type!r}")


def _monolithic_direct(op: DPPOperator) -> Callable:
    """Exact direct solve of the monolithic system (grids -> grids)."""
    mesh = op.mesh
    if mesh.is_tensor_product:
        if _use_mixed_exact():
            from perphil_tpu.ops.mixed import MixedPrecisionDPPDirect

            return MixedPrecisionDPPDirect(mesh, op.params, padding=op.padding).solve
        return FastDiagDPPSolver(mesh, op.params).solve
    # simplicial: machine-tolerance PCG (monolithic matrix is SPD) with a
    # block-diagonal lumped fast-diag preconditioner
    p = op.params
    pc1 = FastDiagFieldSolver(mesh, p.k1, p.beta, p.mu, lumped=True)
    pc2 = FastDiagFieldSolver(mesh, p.k2, p.beta, p.mu, lumped=True)
    shape = op.grid_shape
    n = int(np.prod(shape))
    mv = op.flat_matvec()

    def pc(r):
        return jnp.concatenate(
            [pc1.solve(r[:n].reshape(shape)).ravel(), pc2.solve(r[n:].reshape(shape)).ravel()]
        )

    def solve(b1, b2):
        b = jnp.concatenate([b1.ravel(), b2.ravel()])
        x, _, _ = cg(mv, b, rtol=_DIRECT_RTOL, atol=0.0, max_it=2000, M_inv=pc)
        return x[:n].reshape(shape), x[n:].reshape(shape)

    return solve


# ---------------------------------------------------------------------------
# compiled linear solver cache
# ---------------------------------------------------------------------------


@lru_cache(maxsize=16)
def _build_band_parity_ilu_solver(
    W: MixedFunctionSpace, params: DPPParameters, frozen_sp: Tuple
) -> Callable:
    """ON-DEVICE ordering-parity GMRES+ILU(0): the dense-band block
    trisolve (``ops/bandsolve.py``), selected with
    ``pc_band_execution="device"``.

    Same DoF numbering and factor values as the host path
    (``_build_host_parity_ilu_solver``): cell-RCM parity permutation, FE
    fill pattern, host-side IKJ ILU(0) (native C kernels). The SOLVES run
    on the device: the RCM band is covered with dense blocks whose inverses
    are built on device (batched f32 triangular solve + Newton), so the
    trisolve is a ``lax.scan`` of dense matvecs — no unstructured
    gathers. Outer Krylov is ``gmres_df``. Iteration-count
    parity across apply precisions measured in
    ``experiments/blockinv_precision_probe.py``: f32 blocks land the
    published counts at nx<=36; nx=40 additionally needs the df
    defect-correction pass (``PERPHIL_TPU_BAND_ILU_DF`` overrides the
    size-based default).
    """
    import os as _os

    from perphil_tpu.ops import ordering as od
    from perphil_tpu.ops.bandsolve import build_band_parity_ilu
    from perphil_tpu.ops.df32 import df_from_f64, require_exact_eft
    from perphil_tpu.ops.ilu import build_monolithic_system
    from perphil_tpu.ops.krylov import gmres_df

    require_exact_eft()  # df32 outer Krylov and defect correction
    flat = dict(frozen_sp)
    mesh = W.mesh
    rtol = float(flat.get("ksp_rtol", 1e-5))
    atol = float(flat.get("ksp_atol", 1e-50))
    max_it = int(flat.get("ksp_max_it", 10000))
    restart = int(flat.get("ksp_gmres_restart", 30))

    op = DPPOperator(W, params)
    sysm = build_monolithic_system(mesh, params)
    A = od.to_csr(sysm)
    nv = mesh.num_vertices
    if mesh.is_tensor_product:
        perm = np.arange(2 * nv)
    else:
        A = od.tighten_pattern(A, sysm, mesh, params)
        perm = od.blocked(od.cell_rcm_parity(mesh))
    Ap = A[perm][:, perm].tocsr()
    Ap.sort_indices()
    F, _ = od.native_ilu0(Ap)

    # df defect correction DEFAULT-ON: a pure-f32 apply drifts counts at
    # knife cells (CPU probe: +1 at nx=40; with df32 couplings and outer
    # Krylov instead of the probe's f64, -1 at nx=16). Precedence mirrors
    # the engine switch: forcing env ("0"/"1"), then the
    # "pc_band_defect_correct" option (off trades the knife-size counts
    # for ~2x apply speed), then the safe default (on).
    df_mode = _os.environ.get("PERPHIL_TPU_BAND_ILU_DF", "auto")
    if df_mode in ("0", "1"):
        correct = df_mode == "1"
    elif "pc_band_defect_correct" in flat:
        correct = bool(flat["pc_band_defect_correct"])
    else:
        correct = True
    band = build_band_parity_ilu(
        Ap, perm, nv, op.grid_shape, F, with_correction=correct
    )

    mv_df = op.stacked_matvec_df()
    bdry = jnp.asarray(op._mask_arrays[0])

    def solve_band(g1, g2):
        g1d = df_from_f64(g1)
        g2d = df_from_f64(g2)
        b1, b2 = op.lifted_rhs_df(g1d, g2d)
        b = (jnp.stack([b1[0], b2[0]]), jnp.stack([b1[1], b2[1]]))
        x0h = jnp.stack(
            [jnp.where(bdry, g1d[0], 0.0), jnp.where(bdry, g2d[0], 0.0)]
        )
        x0l = jnp.stack(
            [jnp.where(bdry, g1d[1], 0.0), jnp.where(bdry, g2d[1], 0.0)]
        )
        res = gmres_df(
            mv_df, b, x0_df=(x0h, x0l), rtol=rtol, atol=atol,
            max_it=max_it, restart=restart, M_inv_df=band.apply_nat_df,
        )
        xh, xl = res.x
        z1 = xh[0].astype(jnp.float64) + xl[0].astype(jnp.float64)
        z2 = xh[1].astype(jnp.float64) + xl[1].astype(jnp.float64)
        return z1, z2, res.iterations, res.residual_norm

    return _lifted_jit(solve_band, *_example_grids(op, 2))


def _build_host_parity_ilu_solver(
    W: MixedFunctionSpace, params: DPPParameters, frozen_sp: Tuple
) -> Callable:
    """DoF-ordering-faithful GMRES+ILU(0) — the ``pc_factor_mat_ordering_type``
    analog (PETSc option at reference ``solvers/parameters.py:27`` context:
    ``pc_type: ilu``).

    Selected with ``{"pc_factor_mat_ordering_type": "rcm"}``: solves in the
    reference's DMPlex/Firedrake numbering emulation (cell-RCM traversal,
    finite-element fill pattern — see ``ops/ordering.py::cell_rcm_parity``)
    instead of the structured lexicographic envelope ILU. The factorization
    and trisolves in an unstructured row order are inherently sequential, so
    this runs on the HOST via the native C++ CSR kernels
    (``csrc/csr_solver.cpp``) — the same division of labor as PETSc, whose
    ILU/GMRES are host C kernels. Reproduces the published 3D tet counts
    6/8/15/26/33 at nx=4..40 exactly; the structured envelope ILU (the
    default without the ordering option) is a strictly stronger
    preconditioner with fewer iterations (documented deviation in
    PARITY.md).
    """
    from perphil_tpu.ops import ordering as od
    from perphil_tpu.ops.ilu import build_monolithic_system

    flat = dict(frozen_sp)
    mesh = W.mesh
    rtol = float(flat.get("ksp_rtol", 1e-5))
    atol = float(flat.get("ksp_atol", 1e-50))
    max_it = int(flat.get("ksp_max_it", 10000))
    restart = int(flat.get("ksp_gmres_restart", 30))

    op = DPPOperator(W, params)
    sysm = build_monolithic_system(mesh, params)
    A = od.to_csr(sysm)
    nv = mesh.num_vertices
    if mesh.is_tensor_product:
        # quad/hex: every envelope offset couples, so FE pattern == envelope,
        # and the natural lexicographic order already reproduces the
        # reference counts (ordering_sensitivity.csv) — identity permutation.
        perm = np.arange(2 * nv)
    else:
        # dropped entries are exact zeros, so Ap serves both as the ILU
        # pattern (PETSc allocates only the FE adjacency) and as the matvec
        A = od.tighten_pattern(A, sysm, mesh, params)
        perm = od.blocked(od.cell_rcm_parity(mesh))
    Ap = A[perm][:, perm].tocsr()
    Ap.sort_indices()
    iperm = np.empty_like(perm)
    iperm[perm] = np.arange(perm.shape[0])
    bmask = np.asarray(mesh.boundary_mask()).ravel().astype(bool)
    shape = op.grid_shape

    # PCSetUp analogue: factor ONCE at solver build (PETSc factorizes in
    # PCSetUp, outside KSPSolve; re-factorizing per solve would bill setup
    # into every profiled solve window)
    native_solve = od.native_ilu_gmres_solver(
        Ap, rtol=rtol, atol=atol, restart=restart, max_it=max_it
    )
    host_factors = None if native_solve is not None else od.host_ilu0(Ap)

    # The solve body stays on the host end to end, so a solve pays no
    # device dispatch or transfer. The BC lift runs through
    # DPPOperator.lifted_rhs_np (the numpy mirror of the jnp op); inputs
    # are converted with np.asarray (a no-op when the profiling harness
    # has already moved them to host; see run_perf_once's _host_only
    # handling).

    def solve_host(g1, g2):
        g1g = np.asarray(g1, dtype=np.float64)
        g2g = np.asarray(g2, dtype=np.float64)
        b1, b2 = op.lifted_rhs_np(g1g, g2g)
        b = np.concatenate([b1.ravel(), b2.ravel()])
        g1v = g1g.ravel()
        g2v = g2g.ravel()
        x0 = np.concatenate(
            [np.where(bmask, g1v, 0.0), np.where(bmask, g2v, 0.0)]
        ).astype(np.float64)
        # Newton-step system A d = b - A x0 (x0 = BC lift), like the jitted
        # paths: the KSP convergence denominator is the interior-scale ||r0||
        r0p = (b - A @ x0)[perm]
        if native_solve is not None:
            its, dp, rnorm = native_solve(r0p)
        else:  # no C++ toolchain: numpy fallback, same semantics
            F, diag = host_factors
            its, dp, rnorm = od.host_gmres(
                lambda v: Ap @ v,
                r0p,
                lambda v: od.host_ilu_apply(F, diag, v),
                rtol=rtol,
                atol=atol,
                restart=restart,
                max_it=max_it,
                return_solution=True,
            )
        x = x0 + dp[iperm]
        # numpy outputs: a jnp.asarray here would add a host-to-device copy
        # to every profiled solve. Consumers treat them generically
        # (Solution/float()/error norms auto-convert).
        z1 = x[:nv].reshape(shape)
        z2 = x[nv:].reshape(shape)
        return z1, z2, int(its), float(rnorm)

    # host-level solve: the profiling harness must not attempt to jit-chain
    # it (lax.scan would trace the numpy body)
    solve_host._host_only = True
    return solve_host


@lru_cache(maxsize=64)
def _build_linear_solver(
    W: MixedFunctionSpace,
    params: DPPParameters,
    frozen_sp: Tuple,
    padding: Tuple[int, ...] = (),
) -> Callable:
    """Compile a linear solve ``(g1, g2) -> (z1, z2, its, rnorm)`` for
    boundary-value grids g1, g2.

    With ``padding``, inputs/outputs carry phantom nodes at the high end of
    each grid axis (identity rows, zero data) — used by the sharded path to
    make node counts divisible by device-mesh axes."""
    flat = dict(frozen_sp)

    if (
        str(flat.get("pc_type", "")) == "ilu"
        and str(flat.get("pc_factor_mat_ordering_type", "natural")) == "rcm"
    ):
        if padding:
            raise ValueError(
                "pc_factor_mat_ordering_type=rcm is a dedicated parity "
                "path; not available under sharding padding"
            )
        # Execution engine selection, precedence: the PERPHIL_TPU_BAND_ILU
        # env var when set to a non-auto value (forced experiments), then
        # the "pc_band_execution" option ("device"/"host" — cache-safe:
        # part of the frozen options key), then the default: the host C++
        # CSR kernels. The dense-band device engine (ops/bandsolve.py)
        # stays reachable through "pc_band_execution": "device".
        import os as _os

        mode = _os.environ.get("PERPHIL_TPU_BAND_ILU", "auto")
        opt = str(flat.get("pc_band_execution", ""))
        if mode in ("0", "1"):
            on_device = mode == "1"
        else:
            on_device = opt == "device"
        if on_device:
            return _build_band_parity_ilu_solver(W, params, frozen_sp)
        return _build_host_parity_ilu_solver(W, params, frozen_sp)

    op = DPPOperator(W, params, padding)
    mesh = W.mesh
    shape = op.grid_shape
    n = int(np.prod(shape))
    ksp = str(flat.get("ksp_type", "gmres"))

    if ksp == "preonly":
        pc_type = str(flat.get("pc_type", "lu"))
        if pc_type in ("lu", "cholesky"):
            if str(flat.get("pc_factor_mat_solver_type", "")) == "fastdiag_mixed":
                # mixed-precision direct solve: f32 fast-diag + double-float
                # iterative refinement (ops/mixed.py)
                from perphil_tpu.ops.mixed import MixedPrecisionDPPDirect

                direct = MixedPrecisionDPPDirect(mesh, params, padding=padding).solve
            else:
                direct = _monolithic_direct(op)

            def solve_preonly(g1, g2):
                b1, b2 = op.lifted_rhs(g1, g2)
                z1, z2 = direct(b1, b2)
                # preonly reports 1 iteration and residual 0.0 (PETSc
                # semantics; see reference convergence.csv MUMPS rows)
                return z1, z2, jnp.asarray(1), jnp.asarray(0.0, dtype=b1.dtype)

            return _lifted_jit(solve_preonly, *_example_grids(op, 2))
        pc = _monolithic_pc(op, flat)

        def solve_pc_once(g1, g2):
            b1, b2 = op.lifted_rhs(g1, g2)
            b = jnp.stack([b1, b2])
            z = pc(b) if pc is not None else b
            return z[0], z[1], jnp.asarray(1), jnp.asarray(0.0, dtype=b.dtype)

        return _lifted_jit(solve_pc_once, *_example_grids(op, 2))

    if ksp not in ("gmres", "cg"):
        raise ValueError(f"Unsupported ksp_type: {ksp!r}")

    rtol = float(flat.get("ksp_rtol", 1e-5))
    atol = float(flat.get("ksp_atol", 1e-50))
    max_it = int(flat.get("ksp_max_it", 10000))
    restart = int(flat.get("ksp_gmres_restart", 30))

    if ksp == "gmres" and _ksp_mode() == "df32":
        return _build_linear_solver_df(op, flat, rtol, atol, max_it, restart)

    pc = _monolithic_pc(op, flat)
    mv = op.stacked_matvec()

    bdry = jnp.asarray(op._mask_arrays[0])
    # PETSc's ksp_initial_guess_nonzero means "start from the current
    # solution values" — with Firedrake's zero-initialized, BC-applied
    # solution Function that is exactly the BC-lift start our default
    # Newton-step formulation already uses, so the public option is an
    # accepted no-op. The internal "_x0_continuation" key (set by
    # build_chunked_plain_solver) selects the 5-argument continuation
    # variant that takes an explicit iterate + absolute tolerance.
    with_guess = bool(flat.get("_x0_continuation", False))

    def _solve_from(x01, x02, b1, b2, rtol_, atol_):
        r1, r2 = op.residual(x01, x02, b1, b2)
        r = jnp.stack([r1, r2])
        if ksp == "gmres":
            res = gmres(
                mv, r, rtol=rtol_, atol=atol_, max_it=max_it, restart=restart,
                M_inv=pc,
            )
            d, its, rnorm = res.x, res.iterations, res.residual_norm
        else:
            d, its, rnorm = cg(mv, r, rtol=rtol_, atol=atol_, max_it=max_it, M_inv=pc)
        return x01 + d[0], x02 + d[1], its, rnorm

    if with_guess:
        # PETSc's KSPSetInitialGuessNonzero analogue: the caller supplies the
        # starting iterate (used e.g. to chunk very long Krylov runs across
        # multiple device executions) and an absolute tolerance.
        def solve_krylov_x0(g1, g2, x01, x02, atol_abs):
            b1, b2 = op.lifted_rhs(g1, g2)
            return _solve_from(x01, x02, b1, b2, 0.0, atol_abs)

        return _lifted_jit(
            solve_krylov_x0,
            *_example_grids(op, 4),
            jnp.zeros((), dtype=_example_grids(op, 1)[0].dtype),
        )

    def solve_krylov(g1, g2):
        # Firedrake's LinearVariationalSolver is SNES ksponly: the KSP sees
        # the Newton-step system A d = b - A x0 with x0 the BC lift, so the
        # convergence denominator is the interior-scale ||r0||, not ||b||.
        # Reproducing this is required for iteration-count parity.
        b1, b2 = op.lifted_rhs(g1, g2)
        x01 = jnp.where(bdry, g1, 0.0)
        x02 = jnp.where(bdry, g2, 0.0)
        return _solve_from(x01, x02, b1, b2, rtol, atol)

    return _lifted_jit(solve_krylov, *_example_grids(op, 2))


def _restart_residual_df(op) -> "Optional[Callable]":
    """Optional high-precision restart-boundary residual for the df32 XLA
    GMRES path (see ``ops/krylov.gmres_df``'s ``residual_df``).

    PERPHIL_TPU_RESTART_RESIDUAL selects the mode:
      - ``df32`` (default): keep the plain df residual (b - A x in df).
      - ``f64``: evaluate b - A x in float64 once per restart cycle (an
        accuracy experiment / validation mode).
    """
    import os

    mode = os.environ.get("PERPHIL_TPU_RESTART_RESIDUAL", "df32").lower()
    if mode in ("df32", "", "default"):
        return None
    if mode == "f64":
        from perphil_tpu.ops.df32 import df_from_f64

        def residual64(x_df, b_df):
            x64 = x_df[0].astype(jnp.float64) + x_df[1].astype(jnp.float64)
            b64 = b_df[0].astype(jnp.float64) + b_df[1].astype(jnp.float64)
            a1, a2 = op.matvec(x64[0], x64[1])
            return df_from_f64(b64 - jnp.stack([a1, a2]))

        return residual64
    raise ValueError(f"Unknown PERPHIL_TPU_RESTART_RESIDUAL mode: {mode!r}")


def _build_linear_solver_df(
    op: DPPOperator, flat: Dict, rtol: float, atol: float, max_it: int, restart: int
) -> Callable:
    """Compile the df32 (two-f32) GMRES solve (``PERPHIL_TPU_KSP_DTYPE=df32``).

    Same Newton-step formulation as the native path (``A d = b - A x0`` with
    x0 the BC lift; convergence relative to the initial preconditioned
    residual), with assembly, operator, and Krylov vectors in double-float.
    Inputs/outputs stay float64 at the API boundary.
    """
    from perphil_tpu.ops.df32 import df_from_f64, require_exact_eft
    from perphil_tpu.ops.krylov import gmres_df

    require_exact_eft()
    pc_df = _monolithic_pc_df(op, flat)
    mv_df = op.stacked_matvec_df()
    bdry = jnp.asarray(op._mask_arrays[0])
    with_guess = bool(flat.get("_x0_continuation", False))
    residual_df = _restart_residual_df(op)

    # knife-edge ef64 mode (docs/design.md §7): tiny unpreconditioned
    # systems run f64-FAITHFUL arithmetic. Measured landscape at the two
    # knife-edge cells (2D N=8 / 3D nx=4; PETSc: 40/27): df32 42/28,
    # tf32 (~71-bit) 38 — MORE precision undershoots because PETSc's own
    # f64 rounding delays convergence in the stagnation tail — and only
    # f64-grade per-op rounding lands the published counts (pinned by
    # experiments/f64_structure_probe.py; order within the class is free).
    # Larger systems keep df32 (all published counts exact there).
    import os as _os

    ef64_max = int(
        _os.environ.get(
            "PERPHIL_TPU_EF64_MAX_DOF",
            _os.environ.get("PERPHIL_TPU_TF32_MAX_DOF", "512"),
        )
    )
    if pc_df is None and not with_guess and int(op.W.dim()) <= ef64_max:
        from perphil_tpu.ops.krylov import gmres_ef64

        mv = op.stacked_matvec()

        def solve_krylov_ef64(g1, g2):
            b1, b2 = op.lifted_rhs(g1, g2)  # straight-line f64: exact-grade
            b = jnp.stack([b1, b2])
            x0 = jnp.stack(
                [jnp.where(bdry, g1, 0.0), jnp.where(bdry, g2, 0.0)]
            )
            res = gmres_ef64(
                mv, b, x0=x0, rtol=rtol, atol=atol, max_it=max_it,
                restart=restart,
            )
            return res.x[0], res.x[1], res.iterations, res.residual_norm

        return _lifted_jit(solve_krylov_ef64, *_example_grids(op, 2))

    def _gmres(b, x0, **kw):
        return gmres_df(
            mv_df, b, x0_df=x0, restart=restart, M_inv_df=pc_df,
            residual_df=residual_df, **kw
        )

    def _stack(a, b):
        return jnp.stack([a[0], b[0]]), jnp.stack([a[1], b[1]])

    def _prep(g1, g2):
        g1d = df_from_f64(g1)
        g2d = df_from_f64(g2)
        b1, b2 = op.lifted_rhs_df(g1d, g2d)
        b = _stack(b1, b2)
        x01 = (jnp.where(bdry, g1d[0], 0.0), jnp.where(bdry, g1d[1], 0.0))
        x02 = (jnp.where(bdry, g2d[0], 0.0), jnp.where(bdry, g2d[1], 0.0))
        return b, _stack(x01, x02)

    def _finish(res):
        xh, xl = res.x
        z1 = xh[0].astype(jnp.float64) + xl[0].astype(jnp.float64)
        z2 = xh[1].astype(jnp.float64) + xl[1].astype(jnp.float64)
        return z1, z2, res.iterations, res.residual_norm

    if with_guess:

        def solve_krylov_x0_df(g1, g2, x01, x02, atol_abs):
            b, _ = _prep(g1, g2)
            x0h = jnp.stack([x01, x02]).astype(jnp.float32)
            x0l = (jnp.stack([x01, x02]) - x0h.astype(jnp.float64)).astype(jnp.float32)
            res = _gmres(
                b, (x0h, x0l), rtol=0.0, atol=atol_abs, max_it=max_it
            )
            return _finish(res)

        return _lifted_jit(
            solve_krylov_x0_df,
            *_example_grids(op, 4),
            jnp.zeros((), dtype=_example_grids(op, 1)[0].dtype),
        )

    def solve_krylov_df(g1, g2):
        b, x0 = _prep(g1, g2)
        res = _gmres(b, x0, rtol=rtol, atol=atol, max_it=max_it)
        return _finish(res)

    return _lifted_jit(solve_krylov_df, *_example_grids(op, 2))


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------


def _validate_mixed(W) -> None:
    if not hasattr(W, "num_sub_spaces") or W.num_sub_spaces() != 2:
        raise ValueError(f"Expected a 2-field MixedFunctionSpace, got {type(W)}")


@lru_cache(maxsize=64)
def _build_tensor_linear_solver(
    W: MixedFunctionSpace,
    params: DPPParameters,
    frozen_sp: Tuple,
    padding: Tuple[int, ...] = (),
) -> Callable:
    """Degree-p (Qp) linear solver on tensor-product meshes
    (``ops/tensorfem``): exact fast-diagonalization direct solve for
    preonly+lu, GMRES with none/jacobi/fieldsplit-LU preconditioning
    otherwise. ILU has no degree-p structured factorization and is
    rejected explicitly. ``padding`` (per grid axis) enables the sharded
    path's phantom rows — inert identity dofs, trajectories unchanged
    (``TensorDPPOperator.padding``)."""
    from perphil_tpu.ops.krylov import gmres
    from perphil_tpu.ops.tensorfem import (
        TensorDPPOperator,
        TensorFastDiagDPP,
        interior_eig_1d,
    )

    flat = dict(frozen_sp)
    degree = W.spaces[0].degree
    mesh = W.mesh
    op = TensorDPPOperator(mesh, params, degree, padding)
    ksp = str(flat.get("ksp_type", "preonly"))
    pc_type = str(flat.get("pc_type", "lu"))
    rtol = float(flat.get("ksp_rtol", 1e-5))
    atol = float(flat.get("ksp_atol", 1e-50))
    max_it = int(flat.get("ksp_max_it", 10000))
    restart = int(flat.get("ksp_gmres_restart", 30))

    from perphil_tpu.config import default_dtype

    # Example DoF-lattice grids for _lifted_jit: the eigen/diag/mask tensors
    # closed over below scale with the lattice and must be runtime arguments,
    # not HLO constants (see _lifted_jit).
    _ex = jnp.zeros(op.dof_shape, dtype=default_dtype())

    if ksp == "preonly":
        if pc_type != "lu":
            raise ValueError(f"degree-{degree} preonly supports pc_type=lu only")
        direct = TensorFastDiagDPP(mesh, params, degree, padding)

        def solve_direct(g1, g2):
            b1, b2 = op.lifted_rhs(g1, g2)
            z1, z2 = direct.solve(b1, b2)
            return z1, z2, jnp.asarray(1), jnp.asarray(0.0, dtype=g1.dtype)

        return _lifted_jit(solve_direct, _ex, _ex)

    if ksp != "gmres":
        raise ValueError(f"degree-{degree} spaces support preonly/gmres, got {ksp!r}")

    bdry = jnp.asarray(op.boundary_mask)
    if pc_type in ("none", ""):
        pc = None
    elif pc_type == "jacobi":
        # diagonal of the tensor operator from the (padding-aware) 1D
        # matrix diagonals
        dK, dM = [], []
        for K1, M1 in op._mats:
            dK.append(np.diag(K1))
            dM.append(np.diag(M1))
        d = mesh.dim
        diag_K = np.zeros(op.dof_shape)
        diag_M = np.ones(op.dof_shape)
        for ax in range(d):  # grid axes slowest-first
            shape = [1] * d
            shape[ax] = op.dof_shape[ax]
            term = np.ones(op.dof_shape)
            for ax2 in range(d):
                shape2 = [1] * d
                shape2[ax2] = op.dof_shape[ax2]
                v = dK[d - 1 - ax2] if ax2 == ax else dM[d - 1 - ax2]
                term = term * v.reshape(shape2)
            diag_K = diag_K + term
            diag_M = diag_M * dM[d - 1 - ax].reshape(shape)
        p = params
        d1 = (p.k1 / p.mu) * diag_K + (p.beta / p.mu) * diag_M
        d2 = (p.k2 / p.mu) * diag_K + (p.beta / p.mu) * diag_M
        d1 = np.where(np.asarray(op.boundary_mask), 1.0, d1)
        d2 = np.where(np.asarray(op.boundary_mask), 1.0, d2)
        dstack = jnp.asarray(np.stack([d1, d2]))

        def pc(r):
            return r / dstack

    elif pc_type == "fieldsplit":
        # multiplicative 2x2 block GS with exact per-block fast-diag solves
        eig = tuple(
            interior_eig_1d(degree, c, h) for c, h in zip(mesh.cells, mesh.h)
        )
        lams = [lam for (_, lam) in eig]
        d = mesh.dim
        lam_sum = np.zeros(tuple(len(l) for l in reversed(lams)))
        for ax in range(d):
            shape = [1] * d
            shape[ax] = len(lams[d - 1 - ax])
            lam_sum = lam_sum + lams[d - 1 - ax].reshape(shape)
        p = params
        scale1 = jnp.asarray((p.k1 * lam_sum + p.beta) / p.mu)
        scale2 = jnp.asarray((p.k2 * lam_sum + p.beta) / p.mu)
        mats = [S for (S, _) in eig]

        from perphil_tpu.ops.tensorfem import _apply_axis

        def _tr(f, transpose):
            out = f
            for ax in range(d):
                S = mats[d - 1 - ax]
                out = _apply_axis(out, jnp.asarray(S.T if transpose else S, dtype=f.dtype), ax)
            return out

        def _block_solve(r, scale):
            inner = op.phys_interior  # excludes phantom padding too
            fh = _tr(r[inner], True)
            z = _tr(fh / scale.astype(r.dtype), False)
            return r.at[inner].set(z)

        Mc = op._M  # mass coupling application
        beta_mu = params.beta / params.mu

        def pc(r):
            r1, r2 = r[0], r[1]
            z1 = _block_solve(r1, scale1)
            # multiplicative: second block sees the updated first field
            coup = beta_mu * Mc(jnp.where(bdry, 0.0, z1))
            z2 = _block_solve(r2 + jnp.where(bdry, 0.0, coup), scale2)
            return jnp.stack([z1, z2])

    elif pc_type == "ilu":
        raise ValueError(
            f"pc_type=ilu has no degree-{degree} structured factorization; "
            "use fieldsplit/jacobi or the preonly fast-diag direct solve"
        )
    else:
        raise ValueError(f"Unsupported pc_type {pc_type!r} for degree>{1}")

    mv = op.stacked_matvec()

    def solve_gmres(g1, g2):
        b1, b2 = op.lifted_rhs(g1, g2)
        x0 = jnp.stack([jnp.where(bdry, g1, 0.0), jnp.where(bdry, g2, 0.0)])
        b = jnp.stack([b1, b2])
        res = gmres(
            mv, b, x0=x0, rtol=rtol, atol=atol, max_it=max_it,
            restart=restart, M_inv=pc,
        )
        return res.x[0], res.x[1], res.iterations, res.residual_norm

    return _lifted_jit(solve_gmres, _ex, _ex)


@lru_cache(maxsize=16)
def _build_simplex_p2_linear_solver(
    W: MixedFunctionSpace,
    params: DPPParameters,
    frozen_sp: Tuple,
    padding: Tuple[int, ...] = (),
) -> Callable:
    """P2 linear solver on simplex meshes (``ops/simplexfem``): GMRES with
    none/jacobi preconditioning on the parity-class stencil operator
    (device path), host sparse-LU for preonly+lu (the MUMPS role — simplex
    P2 has no tensor fast-diagonalization structure). ``padding`` builds
    the phantom-padded operator for sharded solves (identity phantom rows;
    trajectories match the unpadded solve)."""
    from perphil_tpu.config import default_dtype
    from perphil_tpu.ops.krylov import gmres
    from perphil_tpu.ops.simplexfem import P2SimplexDPPOperator

    flat = dict(frozen_sp)
    mesh = W.mesh
    op = P2SimplexDPPOperator(mesh, params, padding)
    ksp = str(flat.get("ksp_type", "preonly"))
    pc_type = str(flat.get("pc_type", "lu"))
    rtol = float(flat.get("ksp_rtol", 1e-5))
    atol = float(flat.get("ksp_atol", 1e-50))
    max_it = int(flat.get("ksp_max_it", 10000))
    restart = int(flat.get("ksp_gmres_restart", 30))
    shape = op.dof_shape
    n = int(np.prod(shape))

    if ksp == "preonly":
        if any(padding):
            raise NotImplementedError(
                "P2 simplex preonly+lu is a host sparse-direct path "
                "(scipy splu) with no SPMD partitioning; sharded P2 "
                "simplex solves support ksp_type=gmres with "
                "pc_type none/jacobi"
            )
        if pc_type not in ("lu", "cholesky"):
            raise ValueError(f"P2 simplex preonly supports pc_type=lu, got {pc_type!r}")
        from scipy.sparse.linalg import splu

        from perphil_tpu.ops.simplexfem import assemble_p2_monolithic

        lu = splu(assemble_p2_monolithic(mesh, params).tocsc())

        def solve_direct(g1, g2):
            b1, b2 = op.lifted_rhs(g1, g2)
            b = np.concatenate([np.asarray(b1).ravel(), np.asarray(b2).ravel()])
            x = lu.solve(b)
            z1 = jnp.asarray(x[:n].reshape(shape))
            z2 = jnp.asarray(x[n:].reshape(shape))
            return z1, z2, jnp.asarray(1), jnp.asarray(0.0)

        return solve_direct

    if ksp != "gmres":
        raise ValueError(f"P2 simplex spaces support preonly/gmres, got {ksp!r}")

    bdry = jnp.asarray(op.boundary_mask)
    if pc_type in ("none", ""):
        pc = None
    elif pc_type == "jacobi":
        dstack = op.diagonal_stacked()

        def pc(r):
            return r / dstack

    else:
        raise ValueError(
            f"Unsupported pc_type {pc_type!r} for P2 simplex (none/jacobi/"
            "preonly+lu)"
        )

    mv = op.stacked_matvec()

    def solve_gmres(g1, g2):
        b1, b2 = op.lifted_rhs(g1, g2)
        x0 = jnp.stack([jnp.where(bdry, g1, 0.0), jnp.where(bdry, g2, 0.0)])
        b = jnp.stack([b1, b2])
        res = gmres(
            mv, b, x0=x0, rtol=rtol, atol=atol, max_it=max_it,
            restart=restart, M_inv=pc,
        )
        return res.x[0], res.x[1], res.iterations, res.residual_norm

    _ex = jnp.zeros(shape, dtype=default_dtype())
    return _lifted_jit(solve_gmres, _ex, _ex)


def solve_dpp(
    W: MixedFunctionSpace,
    model_params: DPPParameters,
    bcs: Sequence[DirichletBC],
    solver_parameters: Dict = {},
    options_prefix: str = "dpp",
) -> Solution:
    """Solve the monolithic/preconditioned DPP linear system; parity with
    reference ``solver.py:30-76`` (returns ``Solution`` with the KSP
    iteration count and residual norm)."""
    _validate_mixed(W)
    from perphil_tpu.solvers.options import apply_prefix_overrides

    solver_parameters = apply_prefix_overrides(solver_parameters, options_prefix)
    g1, g2 = bc_values_per_field(W, bcs)
    degree = W.spaces[0].degree
    if degree > 1 and not W.mesh.is_tensor_product:
        solver = _build_simplex_p2_linear_solver(
            W, model_params, _freeze(solver_parameters)
        )
    elif degree > 1:
        solver = _build_tensor_linear_solver(W, model_params, _freeze(solver_parameters))
    else:
        solver = _build_linear_solver(W, model_params, _freeze(solver_parameters))
    z1, z2, its, rnorm = solver(g1, g2)
    sol = Function(W, (z1, z2))
    return Solution(sol, int(its), float(rnorm))


def solve_dpp_nonlinear(
    W: MixedFunctionSpace,
    model_params: DPPParameters,
    bcs: Sequence[DirichletBC],
    solver_parameters: Dict = {},
    options_prefix: str = "dpp_nonlinear",
) -> Solution:
    """Solve via Picard-style nonlinear iteration; parity with reference
    ``solver.py:79-128`` (SNES ``nrichardson``/``ngs`` dispatch, iteration
    count from the SNES, residual = final function norm)."""
    _validate_mixed(W)
    from perphil_tpu.solvers.options import apply_prefix_overrides

    solver_parameters = apply_prefix_overrides(solver_parameters, options_prefix)
    g1, g2 = bc_values_per_field(W, bcs)
    flat = _flatten_options(solver_parameters)
    snes = str(flat.get("snes_type", "ngs"))
    degree = W.spaces[0].degree
    if snes == "ksponly":
        # PETSc parity (reference solver.py:123-125): SNESKSPONLY reports
        # snes.getIterationNumber() == 1 and snes.getFunctionNorm() — the
        # true nonlinear residual after the single linear solve — NOT the
        # inner KSP iteration count / KSP residual.
        ksp_opts = {k: v for k, v in flat.items() if not k.startswith("snes_")}
        if degree > 1:
            from perphil_tpu.ops.tensorfem import TensorDPPOperator

            solver = _build_tensor_linear_solver(W, model_params, _freeze(ksp_opts))
            op = TensorDPPOperator(W.mesh, model_params, degree)
        else:
            solver = _build_linear_solver(W, model_params, _freeze(ksp_opts))
            op = DPPOperator(W, model_params)
        z1, z2, _its, _rnorm = solver(g1, g2)
        b1, b2 = op.lifted_rhs(g1, g2)
        r1, r2 = op.residual(z1, z2, b1, b2)
        fnorm = float(jnp.sqrt(jnp.vdot(r1, r1) + jnp.vdot(r2, r2)).real)
        return Solution(Function(W, (z1, z2)), 1, fnorm)
    if degree > 1:
        # The Picard/NGS drivers are built on the Q1 stencil machinery;
        # fail at the API boundary instead of with an opaque shape error
        # deep inside jit tracing.
        raise ValueError(
            f"solve_dpp_nonlinear supports degree-{degree} spaces only with "
            "snes_type='ksponly'; ngs/nrichardson/block_gs drivers are "
            "degree-1 (use the linear solve_dpp path for Qp systems)"
        )
    solver = _build_nonlinear_solver(W, model_params, _freeze(solver_parameters))
    z1, z2, its, fnorm = solver(g1, g2)
    return Solution(Function(W, (z1, z2)), int(its), float(fnorm))


def _ngs_sweeper(mesh, params, dtype=None):
    """Pick the SNES-ngs sweep implementation: the pinned-coloring
    multicolor secant sweeper on quad meshes (exact reference Picard
    counts — ``ops/ilu.py::ColoredNGSSweeper``); the sequential
    lexicographic wavefront sweeper elsewhere, or everywhere when
    ``PERPHIL_TPU_NGS_COLORING=0``."""
    import os

    from perphil_tpu.ops.ilu import ColoredNGSSweeper, GaussSeidelSweeper

    if (
        mesh.element == "quad"
        and os.environ.get("PERPHIL_TPU_NGS_COLORING", "1") != "0"
    ):
        return ColoredNGSSweeper.for_monolithic(mesh, params, dtype=dtype)
    return GaussSeidelSweeper.for_monolithic(mesh, params, dtype=dtype)


def _build_ngs_solver_df(
    op: DPPOperator, flat: Dict, rtol: float, atol: float, max_it: int
) -> Callable:
    """Pointwise-GS Picard in mixed precision (``PERPHIL_TPU_KSP_DTYPE=df32``).

    Two modes:

    - **Colored parity mode** (quad meshes): multicolor secant sweeps under
      the pinned coloring draw (``ops/ordering.py::ngs_parity_coloring``),
      carried END-TO-END in double-float — per color the residual is a df
      matvec and the diagonal-secant step multiplies by a precomputed df
      reciprocal (relative error ~6e-14). The trajectory is
      f64-faithful, so the iteration counts reproduce the reference's
      published Picard column EXACTLY (16/63/194/635/1673/5135), not just
      to within f32 knife-edge drift.
    - **Lexicographic mode** (other elements, or
      ``PERPHIL_TPU_NGS_COLORING=0``): one GS sweep from iterate x equals
      x + e where e is one sweep *from zero* on the error equation
      A e = r (both are affine with the same linear part — exact
      identity). The sweep itself runs in f32 (the parallel-prefix (D+L)
      solve) while x and the residual stay double-float; counts track the
      f64 trajectory to ±1 at knife edges.
    """
    import os

    from perphil_tpu.ops.df32 import df_add, df_from_f64, df_mul, require_exact_eft
    from perphil_tpu.ops.dfvec import df_norm, split64

    require_exact_eft()
    mesh = op.mesh
    shape = mesh.node_shape
    n = int(np.prod(shape))
    with_guess = bool(flat.get("_x0_continuation", False))

    def _residual_df(x_df, b_df):
        # per-field df matvec on grid shapes. The subtraction MUST be a df
        # (two_sum-compensated) op: near convergence b ≈ A x cancels
        # catastrophically, and a plain component-wise subtraction leaves
        # the residual only f32-accurate — enough to drift iteration counts
        # at knife edges (observed: N=8 converging one sweep early).
        from perphil_tpu.ops.dfvec import df_vec_sub

        x1 = (x_df[0][:n].reshape(shape), x_df[1][:n].reshape(shape))
        x2 = (x_df[0][n:].reshape(shape), x_df[1][n:].reshape(shape))
        y1, y2 = op.matvec_df(x1, x2)
        yh = jnp.concatenate([y1[0].ravel(), y2[0].ravel()])
        yl = jnp.concatenate([y1[1].ravel(), y2[1].ravel()])
        return df_vec_sub(b_df, (yh, yl))

    colored = (
        mesh.element == "quad"
        and os.environ.get("PERPHIL_TPU_NGS_COLORING", "1") != "0"
    )
    if colored:
        from perphil_tpu.ops.ilu import build_monolithic_system
        from perphil_tpu.ops.ordering import ngs_parity_coloring

        sysm = build_monolithic_system(mesh, op.params)
        diag64 = np.asarray(sysm.vals[:, sysm.center_index], dtype=np.float64)
        rinv_df = split64(jnp.asarray(1.0 / diag64))
        colors = ngs_parity_coloring(mesh)
        masks = jnp.asarray(
            np.stack([colors == c for c in range(int(colors.max()) + 1)]),
            dtype=jnp.bool_,
        )

        def _df_sweep(x_df, b_df, r):
            # df twin of ``ops/ilu.ColoredNGSSweeper.sweep`` (the f32/f64
            # XLA path): SAME pinned coloring, SAME per-color
            # diagonal-secant update — any change to the sweep semantics
            # (color order, slope, residual reuse) must be mirrored there,
            # or the parity-critical Picard counts (16/63/194/...) split
            # between the df and native modes.
            # ``r`` is the residual at the incoming ``x_df`` — the loop
            # already carries it (it served the convergence test), so
            # color 0 reuses it instead of recomputing the identical df
            # matvec; colors 1.. recompute after each partial update.
            for c in range(int(masks.shape[0])):
                if c > 0:
                    r = _residual_df(x_df, b_df)
                q = df_mul(r, rinv_df)
                m = masks[c]
                x_df = df_add(
                    x_df,
                    (jnp.where(m, q[0], 0.0), jnp.where(m, q[1], 0.0)),
                )
            return x_df

    else:
        sweeper = _ngs_sweeper(mesh, op.params, dtype=jnp.float32)

    def _ngs_from_df(x_df, b_df, tol, budget):
        # The residual is carried in the loop state: one matvec per Picard
        # iteration (it serves both the convergence test and the next
        # sweep), not two. Trajectory identical to recomputing it.
        def cond(state):
            x_df, its, fn, r = state
            return (fn > tol) & (its < budget)

        def body(state):
            x_df, its, fn, r = state
            if colored:
                x_df = _df_sweep(x_df, b_df, r)
            else:
                e = sweeper.sweep(jnp.zeros_like(r[0]), r[0] + r[1])
                x_df = df_add(x_df, (e, jnp.zeros_like(e)))
            r_new = _residual_df(x_df, b_df)
            return x_df, its + 1, df_norm(r_new), r_new

        r0 = _residual_df(x_df, b_df)
        x_df, its, fn, _ = jax.lax.while_loop(
            cond, body, (x_df, jnp.asarray(0), df_norm(r0), r0)
        )
        return x_df, its, fn

    def _prep(g1, g2):
        g1d = df_from_f64(g1)
        g2d = df_from_f64(g2)
        b1, b2 = op.lifted_rhs_df(g1d, g2d)
        b_df = (
            jnp.concatenate([b1[0].ravel(), b2[0].ravel()]),
            jnp.concatenate([b1[1].ravel(), b2[1].ravel()]),
        )
        return g1d, g2d, b_df

    def _finish(x_df, its, fn):
        x64 = x_df[0].astype(jnp.float64) + x_df[1].astype(jnp.float64)
        return x64[:n].reshape(shape), x64[n:].reshape(shape), its, fn

    if with_guess:

        def solve_ngs_x0_df(g1, g2, x01, x02, atol_abs):
            _, _, b_df = _prep(g1, g2)
            xh = jnp.concatenate([x01.ravel(), x02.ravel()]).astype(jnp.float32)
            x64 = jnp.concatenate([x01.ravel(), x02.ravel()])
            xl = (x64 - xh.astype(jnp.float64)).astype(jnp.float32)
            x_df, its, fn = _ngs_from_df((xh, xl), b_df, atol_abs, max_it)
            return _finish(x_df, its, fn)

        return _lifted_jit(
            solve_ngs_x0_df,
            *_example_grids(op, 4),
            jnp.zeros((), dtype=_example_grids(op, 1)[0].dtype),
        )

    bdry = jnp.asarray(mesh.boundary_mask())

    def solve_ngs_df(g1, g2):
        g1d, g2d, b_df = _prep(g1, g2)
        x1h = jnp.where(bdry, g1d[0], 0.0)
        x1l = jnp.where(bdry, g1d[1], 0.0)
        x2h = jnp.where(bdry, g2d[0], 0.0)
        x2l = jnp.where(bdry, g2d[1], 0.0)
        x_df = (
            jnp.concatenate([x1h.ravel(), x2h.ravel()]),
            jnp.concatenate([x1l.ravel(), x2l.ravel()]),
        )
        r0 = _residual_df(x_df, b_df)
        from perphil_tpu.ops.dfvec import df_norm as _dfn

        f0n = _dfn(r0)
        tol = jnp.maximum(rtol * f0n, atol)
        x_df, its, fn = _ngs_from_df(x_df, b_df, tol, max_it)
        return _finish(x_df, its, fn)

    return _lifted_jit(solve_ngs_df, *_example_grids(op, 2))


@lru_cache(maxsize=64)
def _build_nonlinear_solver(
    W: MixedFunctionSpace, params: DPPParameters, frozen_sp: Tuple
) -> Callable:
    flat = dict(frozen_sp)
    snes = str(flat.get("snes_type", "ngs"))
    rtol = float(flat.get("snes_rtol", 1e-8))
    atol = float(flat.get("snes_atol", 1e-50))
    max_it = int(flat.get("snes_max_it", 50))
    op = DPPOperator(W, params)
    mesh = W.mesh
    p = params
    C = _coupling_apply(mesh, p)
    f0 = FieldOperator(W.sub(0), p.k1, p.beta, p.mu)
    f1 = FieldOperator(W.sub(1), p.k2, p.beta, p.mu)

    def fnorm_of(z1, z2, b1, b2):
        r1, r2 = op.residual(z1, z2, b1, b2)
        return jnp.sqrt(jnp.vdot(r1, r1) + jnp.vdot(r2, r2)).real

    if snes == "ngs":
        # PETSc's SNES "ngs" default is a coloring-based *pointwise* secant
        # Gauss-Seidel; the nested fieldsplit options in the reference's
        # Picard presets are inert for it (parameters.py:71-95). On quad
        # meshes we reproduce that algorithm exactly — multicolor secant
        # sweeps under the pinned coloring draw
        # (ops/ordering.py::ngs_parity_coloring) — so the reference's
        # Picard iteration counts (16/63/194/635/1673/5135 for N=4..128,
        # petsc_perf_breakdown-with-picard.csv) are matched EXACTLY;
        # elsewhere, forward pointwise GS sweeps in natural ordering.
        if _ksp_mode() == "df32":
            return _build_ngs_solver_df(op, flat, rtol, atol, max_it)

        sweeper = _ngs_sweeper(mesh, params)
        mv = op.flat_matvec()
        shape = mesh.node_shape
        n = int(np.prod(shape))
        with_guess = bool(flat.get("_x0_continuation", False))

        def _ngs_from(x, b, tol, budget):
            def cond(state):
                x, its, fn = state
                return (fn > tol) & (its < budget)

            def body(state):
                x, its, fn = state
                x = sweeper.sweep(x, b)
                return x, its + 1, jnp.linalg.norm(b - mv(x))

            f0 = jnp.linalg.norm(b - mv(x))
            return jax.lax.while_loop(cond, body, (x, jnp.asarray(0), f0))

        if with_guess:
            # continuation variant for chunking very long sweep runs
            def solve_ngs_x0(g1, g2, x01, x02, atol_abs):
                b1, b2 = op.lifted_rhs(g1, g2)
                b = jnp.concatenate([b1.ravel(), b2.ravel()])
                x = jnp.concatenate([x01.ravel(), x02.ravel()])
                x, its, fn = _ngs_from(x, b, atol_abs, max_it)
                return x[:n].reshape(shape), x[n:].reshape(shape), its, fn

            return _lifted_jit(
                solve_ngs_x0,
                *_example_grids(op, 4),
                jnp.zeros((), dtype=_example_grids(op, 1)[0].dtype),
            )

        def solve_pointwise_ngs(g1, g2):
            b1, b2 = op.lifted_rhs(g1, g2)
            b = jnp.concatenate([b1.ravel(), b2.ravel()])
            bdry = jnp.asarray(mesh.boundary_mask())
            x = jnp.concatenate(
                [jnp.where(bdry, g1, 0.0).ravel(), jnp.where(bdry, g2, 0.0).ravel()]
            )
            f0n = jnp.linalg.norm(b - mv(x))
            tol = jnp.maximum(rtol * f0n, atol)
            x, its, fn = _ngs_from(x, b, tol, max_it)
            return x[:n].reshape(shape), x[n:].reshape(shape), its, fn

        return _lifted_jit(solve_pointwise_ngs, *_example_grids(op, 2))

    if snes == "block_gs":
        # Picard block Gauss-Seidel: exact alternating field solves — the
        # fixed-stress-style splitting the delayed form encodes
        # (reference dpp.py:135-205). This is what the reference's Picard
        # presets *intend*; it converges in O(1) iterations vs pointwise GS.
        B0 = _block_solver(f0, _sub_options(flat, "fieldsplit_0_"))
        B1 = _block_solver(f1, _sub_options(flat, "fieldsplit_1_"))

        def solve_ngs(g1, g2):
            b1, b2 = op.lifted_rhs(g1, g2)
            bdry = jnp.asarray(mesh.boundary_mask())
            z1 = jnp.where(bdry, g1, 0.0)
            z2 = jnp.where(bdry, g2, 0.0)
            f0n = fnorm_of(z1, z2, b1, b2)
            tol = jnp.maximum(rtol * f0n, atol)

            def cond(state):
                z1, z2, its, fn = state
                return (fn > tol) & (its < max_it)

            def body(state):
                z1, z2, its, fn = state
                z1 = B0(b1 - C(z2))
                z2 = B1(b2 - C(z1))
                return z1, z2, its + 1, fnorm_of(z1, z2, b1, b2)

            z1, z2, its, fn = jax.lax.while_loop(
                cond, body, (z1, z2, jnp.asarray(0), f0n)
            )
            return z1, z2, its, fn

        return _lifted_jit(solve_ngs, *_example_grids(op, 2))

    if snes == "nrichardson":
        # DOCUMENTED DEVIATION from PETSc: SNESNRICHARDSON with no inner
        # npc configured performs *unpreconditioned* damped Richardson
        # (x += damping * (-F)) and ignores the ksp_/pc_ option dicts — on
        # this stiff system that iteration diverges, so the reference's
        # RICHARDSON_SOLVER_PARAMS preset is effectively unusable and no
        # golden artifact exists for it. We intentionally upgrade it to
        # *preconditioned* damped Richardson (the fieldsplit/ILU options are
        # honored as the preconditioner), which converges; iteration counts
        # for this snes_type are therefore NOT comparable to PETSc and are
        # excluded from parity claims (docs/benchmarks.md).
        damping = float(flat.get("snes_linesearch_damping", 1.0))
        pc = _monolithic_pc(op, flat)
        shape = mesh.node_shape
        n = int(np.prod(shape))

        def solve_rich(g1, g2):
            b1, b2 = op.lifted_rhs(g1, g2)
            bdry = jnp.asarray(mesh.boundary_mask())
            z1 = jnp.where(bdry, g1, 0.0)
            z2 = jnp.where(bdry, g2, 0.0)
            f0n = fnorm_of(z1, z2, b1, b2)
            tol = jnp.maximum(rtol * f0n, atol)

            def cond(state):
                z1, z2, its, fn = state
                return (fn > tol) & (its < max_it)

            def body(state):
                z1, z2, its, fn = state
                r1, r2 = op.residual(z1, z2, b1, b2)
                r = jnp.stack([r1, r2])
                d = pc(r) if pc is not None else r
                z1 = z1 + damping * d[0]
                z2 = z2 + damping * d[1]
                return z1, z2, its + 1, fnorm_of(z1, z2, b1, b2)

            z1, z2, its, fn = jax.lax.while_loop(
                cond, body, (z1, z2, jnp.asarray(0), f0n)
            )
            return z1, z2, its, fn

        return _lifted_jit(solve_rich, *_example_grids(op, 2))

    raise ValueError(f"Unsupported snes_type: {snes!r}")
