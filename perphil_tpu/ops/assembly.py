"""Operator assembly with Dirichlet boundary conditions.

The JAX replacement for Firedrake/PETSc assembly
(``fd.assemble(form, bcs=..., mat_type="aij")`` at
``/root/reference/src/perphil/solvers/conditioning.py:51-63`` and the implicit
assembly inside ``LinearVariationalSolver`` at ``solvers/solver.py:66-71``).

Dirichlet BCs are eliminated *symmetrically* (rows and columns zeroed, unit
diagonal, RHS lifted) — verified to reproduce the reference's assembled
matrices exactly: the 2D N=4 condition numbers match
``notebooks/results-conforming-2d/conditioning/conditioning.csv`` to machine
precision (81.91800877610804 monolithic / 3.357638888888892 macro /
24.368707087045706 micro).

Two operator forms are provided:
  - matrix-free grid operators (stencil shifted-adds) — the hot path for
    Krylov solvers;
  - scipy CSR materialization (host) — for conditioning studies and ILU,
    mirroring ``petsc_matrix.getValuesCSR()`` extraction at
    ``conditioning.py:85-86``.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property
from typing import Callable, Optional, Sequence, Tuple, Union

import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp

from perphil_tpu.config import default_dtype
from perphil_tpu.forms.spaces import (
    Expr,
    Function,
    FunctionSpace,
    MixedFunctionSpace,
    _evaluate,
)
from perphil_tpu.mesh.structured import StructuredMesh
from perphil_tpu.models.dpp.parameters import DPPParameters
from perphil_tpu.ops.stencil import apply_stencil, compile_stencils


# ---------------------------------------------------------------------------
# Dirichlet boundary conditions
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class DirichletBC:
    """Dirichlet condition on the whole boundary of one (sub-)space.

    API parity with ``fd.DirichletBC(W.sub(i), value, "on_boundary")``
    (``/root/reference/src/perphil/experiments/convergence_2d.py:57-64``).

    :param space: a ``FunctionSpace`` or an indexed sub-space from
        ``MixedFunctionSpace.sub(i)``.
    :param value: constant, array, or callable of coordinates.
    :param region: only "on_boundary" is supported (the only region any
        reference workload uses).
    """

    space: FunctionSpace
    value: Expr
    region: str = "on_boundary"

    def __post_init__(self):
        if self.region != "on_boundary":
            raise ValueError("Only region='on_boundary' is supported")

    @property
    def sub_index(self) -> int:
        return getattr(self.space, "index", 0)

    def grid_values(self, mesh: StructuredMesh) -> jnp.ndarray:
        """Boundary values interpolated at mesh vertices (grid-shaped; only
        boundary entries are meaningful)."""
        return _evaluate(self.value, mesh, ())


def bc_values_per_field(
    W: MixedFunctionSpace, bcs: Optional[Sequence[DirichletBC]]
) -> Tuple[jnp.ndarray, ...]:
    """Collect per-field boundary-value grids (zero where no BC given).
    Values live on each sub-space's DoF lattice (the refined grid for Qp)."""
    dtype = default_dtype()
    vals = [
        jnp.zeros(s.dof_shape, dtype=dtype) for s in W.spaces
    ]
    for bc in bcs or ():
        vals[bc.sub_index] = bc.grid_values(W.spaces[bc.sub_index].dof_mesh)
    return tuple(vals)


# ---------------------------------------------------------------------------
# Matrix-free operators
# ---------------------------------------------------------------------------


def _masks(mesh: StructuredMesh, padding: Tuple[int, ...] = ()):
    # kept as numpy: these are cached on operator instances that outlive any
    # single jit trace — jnp constants created inside a trace would leak
    bdry = mesh.boundary_mask()
    if padding and any(padding):
        # phantom nodes (high end of each grid axis) are marked boundary:
        # identity rows with zero data, so solves on the padded grid produce
        # exactly the unpadded iterates. Used to make node counts divisible
        # by device-mesh axes (GSPMD rejects uneven shardings).
        bdry = np.pad(
            bdry, [(0, p) for p in padding], mode="constant", constant_values=True
        )
    return bdry, ~bdry


def normalize_padding(mesh: StructuredMesh, padding) -> Tuple[int, ...]:
    """Validate/normalize a per-grid-axis (slowest-first) padding tuple."""
    if not padding:
        return (0,) * mesh.dim
    padding = tuple(int(p) for p in padding)
    if len(padding) != mesh.dim or any(p < 0 for p in padding):
        raise ValueError(f"Bad padding {padding} for a {mesh.dim}D mesh")
    return padding


@dataclass(frozen=True)
class DPPOperator:
    """The BC-eliminated monolithic DPP operator.

    Block structure (reference weak forms ``forms/dpp.py:31-92``):

        A = [[ (k1/mu) K + (beta/mu) M,        -(beta/mu) M        ],
             [       -(beta/mu) M,        (k2/mu) K + (beta/mu) M ]]

    with identity rows/columns at boundary DoFs of each field. ``matvec``
    costs three stencil applications (K z1, K z2, M (z1 - z2)).
    """

    W: MixedFunctionSpace
    params: DPPParameters
    padding: Tuple[int, ...] = ()

    def __post_init__(self):
        if self.W.num_sub_spaces() != 2:
            raise ValueError(f"Expected a 2-field MixedFunctionSpace, got {type(self.W)}")
        if self.W.spaces[0].degree > 1:
            raise NotImplementedError(
                "DPPOperator is the Q1 node-grid stencil operator; degree-"
                f"{self.W.spaces[0].degree} spaces use ops.tensorfem."
                "TensorDPPOperator (solve_dpp dispatches automatically)"
            )
        object.__setattr__(self, "padding", normalize_padding(self.W.mesh, self.padding))

    @property
    def mesh(self) -> StructuredMesh:
        return self.W.mesh

    @property
    def grid_shape(self) -> Tuple[int, ...]:
        """Working grid shape (node grid plus phantom padding)."""
        return tuple(n + p for n, p in zip(self.mesh.node_shape, self.padding))

    @cached_property
    def _stencils(self) -> Tuple[np.ndarray, np.ndarray]:
        return compile_stencils(self.mesh)

    @cached_property
    def _mask_arrays(self):
        return _masks(self.mesh, self.padding)

    def matvec(self, z1: jnp.ndarray, z2: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
        """Apply the BC-eliminated operator to grid-shaped fields."""
        p = self.params
        bdry, interior = self._mask_arrays
        z1i = jnp.where(interior, z1, 0.0)
        z2i = jnp.where(interior, z2, 0.0)
        K_st, M_st = self._stencils
        Kz1 = apply_stencil(z1i, K_st)
        Kz2 = apply_stencil(z2i, K_st)
        Md = apply_stencil(z1i - z2i, M_st)
        y1 = (p.k1 / p.mu) * Kz1 + (p.beta / p.mu) * Md
        y2 = (p.k2 / p.mu) * Kz2 - (p.beta / p.mu) * Md
        return jnp.where(bdry, z1, y1), jnp.where(bdry, z2, y2)

    def residual(
        self, z1: jnp.ndarray, z2: jnp.ndarray, b1: jnp.ndarray, b2: jnp.ndarray
    ) -> Tuple[jnp.ndarray, jnp.ndarray]:
        y1, y2 = self.matvec(z1, z2)
        return b1 - y1, b2 - y2

    def lifted_rhs(
        self, g1: jnp.ndarray, g2: jnp.ndarray
    ) -> Tuple[jnp.ndarray, jnp.ndarray]:
        """RHS of the BC-eliminated system for zero forcing (the reference's
        ``L`` is identically zero, ``forms/dpp.py:58,90``): interior rows get
        ``-A[interior, boundary] g``, boundary rows get ``g``."""
        K_st, M_st = self._stencils
        p = self.params
        bdry, interior = self._mask_arrays
        g1b = jnp.where(bdry, g1, 0.0)
        g2b = jnp.where(bdry, g2, 0.0)
        Kg1 = apply_stencil(g1b, K_st)
        Kg2 = apply_stencil(g2b, K_st)
        Mgd = apply_stencil(g1b - g2b, M_st)
        a1 = (p.k1 / p.mu) * Kg1 + (p.beta / p.mu) * Mgd
        a2 = (p.k2 / p.mu) * Kg2 - (p.beta / p.mu) * Mgd
        b1 = jnp.where(bdry, g1, -a1)
        b2 = jnp.where(bdry, g2, -a2)
        return b1, b2

    def lifted_rhs_np(
        self, g1: np.ndarray, g2: np.ndarray
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Numpy mirror of :meth:`lifted_rhs`, for host-native solver paths
        whose timed bodies must never dispatch to the device (the
        ordering-parity ILU solve, ``solvers/solver.py``). Kept in lockstep
        with the jnp version by
        ``tests/test_ordering.py::test_host_lifted_rhs_matches_device``."""
        from perphil_tpu.ops.stencil import apply_stencil_np

        K_st, M_st = (np.asarray(s, dtype=np.float64) for s in self._stencils)
        p = self.params
        bdry = np.asarray(self._mask_arrays[0])
        g1 = np.asarray(g1, dtype=np.float64)
        g2 = np.asarray(g2, dtype=np.float64)
        g1b = np.where(bdry, g1, 0.0)
        g2b = np.where(bdry, g2, 0.0)
        Kg1 = apply_stencil_np(g1b, K_st)
        Kg2 = apply_stencil_np(g2b, K_st)
        Mgd = apply_stencil_np(g1b - g2b, M_st)
        a1 = float(p.k1 / p.mu) * Kg1 + float(p.beta / p.mu) * Mgd
        a2 = float(p.k2 / p.mu) * Kg2 - float(p.beta / p.mu) * Mgd
        return np.where(bdry, g1, -a1), np.where(bdry, g2, -a2)

    # -- flat-vector views (Krylov solvers store bases as flat vectors) ----

    def flat_matvec(self) -> Callable[[jnp.ndarray], jnp.ndarray]:
        shape = self.grid_shape
        n = int(np.prod(shape))

        def mv(x: jnp.ndarray) -> jnp.ndarray:
            z1 = x[:n].reshape(shape)
            z2 = x[n:].reshape(shape)
            y1, y2 = self.matvec(z1, z2)
            return jnp.concatenate([y1.ravel(), y2.ravel()])

        return mv

    def stacked_matvec(self) -> Callable[[jnp.ndarray], jnp.ndarray]:
        """Operator on stacked fields (2, *node_shape) — the sharding-
        friendly layout (grid axes survive, so device meshes partition the
        stencil with automatic halo exchange)."""

        def mv(x: jnp.ndarray) -> jnp.ndarray:
            y1, y2 = self.matvec(x[0], x[1])
            return jnp.stack([y1, y2])

        return mv

    def diagonal(self) -> jnp.ndarray:
        """Flat diagonal of the BC-eliminated operator (Jacobi PC)."""
        K_st, M_st = self._stencils
        p = self.params
        center = (1,) * self.mesh.dim
        bdry, _ = self._mask_arrays
        bdry = jnp.asarray(bdry)
        d1c = (p.k1 / p.mu) * float(K_st[center]) + (p.beta / p.mu) * float(M_st[center])
        d2c = (p.k2 / p.mu) * float(K_st[center]) + (p.beta / p.mu) * float(M_st[center])
        dtype = default_dtype()
        one = jnp.ones(self.grid_shape, dtype=dtype)
        d1 = jnp.where(bdry, 1.0, d1c * one)
        d2 = jnp.where(bdry, 1.0, d2c * one)
        return jnp.concatenate([d1.ravel(), d2.ravel()])

    # -- double-float (two-f32) views: the df32 Krylov mode ------------------

    def matvec_df(self, z1, z2):
        """Operator application on per-field double-float pairs (see
        ``ops/dfvec``): native-f32 VPU work with ~49-bit accuracy, replacing
        the 30-100x-slower emulated-f64 matvec in Krylov loops."""
        from perphil_tpu.ops.df32 import df_apply_stencil, df_axpy_wf64, df_sub

        p = self.params
        K_st, M_st = self._stencils
        bdry, interior = self._mask_arrays

        def mask(x, keep, fb):
            return (jnp.where(keep, x[0], fb[0]), jnp.where(keep, x[1], fb[1]))

        zero = (jnp.zeros_like(z1[0]), jnp.zeros_like(z1[1]))
        z1i = mask(z1, interior, zero)
        z2i = mask(z2, interior, zero)
        Kz1 = df_apply_stencil(z1i, np.asarray(K_st))
        Kz2 = df_apply_stencil(z2i, np.asarray(K_st))
        Md = df_apply_stencil(df_sub(z1i, z2i), np.asarray(M_st))
        y1 = df_axpy_wf64(df_axpy_wf64(zero, p.k1 / p.mu, Kz1), p.beta / p.mu, Md)
        y2 = df_axpy_wf64(df_axpy_wf64(zero, p.k2 / p.mu, Kz2), -p.beta / p.mu, Md)
        return mask(y1, interior, z1), mask(y2, interior, z2)

    def stacked_matvec_df(self) -> Callable:
        """df analogue of :meth:`stacked_matvec`: operates on a df pair of
        stacked fields ``((2, *grid) hi, (2, *grid) lo)``."""

        def mv(x):
            xh, xl = x
            y1, y2 = self.matvec_df((xh[0], xl[0]), (xh[1], xl[1]))
            return jnp.stack([y1[0], y2[0]]), jnp.stack([y1[1], y2[1]])

        return mv

    # -- triple-float (three-f32) views: the knife-edge tiny-system mode ----

    def matvec_tf(self, z1, z2):
        """Operator application on per-field triple-float vectors
        (``ops/tf32``, ~71-bit): used by ``gmres_tf`` on tiny systems where
        the df32 49-bit trajectory sits on a convergence knife edge
        (docs/design.md §7)."""
        from perphil_tpu.ops.tf32 import tf_apply_stencil, tf_axpy64, tf_sub

        p = self.params
        K_st, M_st = self._stencils
        bdry, interior = self._mask_arrays

        def mask(x, keep, fb):
            return tuple(jnp.where(keep, a, b) for a, b in zip(x, fb))

        zero = tuple(jnp.zeros_like(c) for c in z1)
        z1i = mask(z1, interior, zero)
        z2i = mask(z2, interior, zero)
        Kz1 = tf_apply_stencil(z1i, np.asarray(K_st))
        Kz2 = tf_apply_stencil(z2i, np.asarray(K_st))
        Md = tf_apply_stencil(tf_sub(z1i, z2i), np.asarray(M_st))
        y1 = tf_axpy64(tf_axpy64(zero, p.k1 / p.mu, Kz1), p.beta / p.mu, Md)
        y2 = tf_axpy64(tf_axpy64(zero, p.k2 / p.mu, Kz2), -p.beta / p.mu, Md)
        return mask(y1, interior, z1), mask(y2, interior, z2)

    def stacked_matvec_tf(self) -> Callable:
        """tf analogue of :meth:`stacked_matvec_df`: a triple of stacked
        ``(2, *grid)`` arrays in and out."""

        def mv(x):
            y1, y2 = self.matvec_tf(
                tuple(c[0] for c in x), tuple(c[1] for c in x)
            )
            return tuple(jnp.stack([a, b]) for a, b in zip(y1, y2))

        return mv

    def lifted_rhs_tf(self, g1, g2):
        """tf analogue of :meth:`lifted_rhs` (per-field tf triples in/out)."""
        from perphil_tpu.ops.tf32 import tf_apply_stencil, tf_axpy64, tf_neg, tf_sub

        p = self.params
        K_st, M_st = self._stencils
        bdry, interior = self._mask_arrays

        def mask(x, keep, fb):
            return tuple(jnp.where(keep, a, b) for a, b in zip(x, fb))

        zero = tuple(jnp.zeros_like(c) for c in g1)
        g1b = mask(g1, bdry, zero)
        g2b = mask(g2, bdry, zero)
        Kg1 = tf_apply_stencil(g1b, np.asarray(K_st))
        Kg2 = tf_apply_stencil(g2b, np.asarray(K_st))
        Mgd = tf_apply_stencil(tf_sub(g1b, g2b), np.asarray(M_st))
        a1 = tf_axpy64(tf_axpy64(zero, p.k1 / p.mu, Kg1), p.beta / p.mu, Mgd)
        a2 = tf_axpy64(tf_axpy64(zero, p.k2 / p.mu, Kg2), -p.beta / p.mu, Mgd)
        b1 = mask(tf_neg(a1), ~bdry, g1)
        b2 = mask(tf_neg(a2), ~bdry, g2)
        return b1, b2

    def lifted_rhs_df(self, g1, g2):
        """df analogue of :meth:`lifted_rhs` (per-field df pairs in/out)."""
        from perphil_tpu.ops.df32 import df_apply_stencil, df_axpy_wf64, df_sub

        p = self.params
        K_st, M_st = self._stencils
        bdry, interior = self._mask_arrays

        def mask(x, keep, fb):
            return (jnp.where(keep, x[0], fb[0]), jnp.where(keep, x[1], fb[1]))

        zero = (jnp.zeros_like(g1[0]), jnp.zeros_like(g1[1]))
        g1b = mask(g1, bdry, zero)
        g2b = mask(g2, bdry, zero)
        Kg1 = df_apply_stencil(g1b, np.asarray(K_st))
        Kg2 = df_apply_stencil(g2b, np.asarray(K_st))
        Mgd = df_apply_stencil(df_sub(g1b, g2b), np.asarray(M_st))
        a1 = df_axpy_wf64(df_axpy_wf64(zero, p.k1 / p.mu, Kg1), p.beta / p.mu, Mgd)
        a2 = df_axpy_wf64(df_axpy_wf64(zero, p.k2 / p.mu, Kg2), -p.beta / p.mu, Mgd)
        b1 = mask((-a1[0], -a1[1]), ~bdry, g1)
        b2 = mask((-a2[0], -a2[1]), ~bdry, g2)
        return b1, b2


@dataclass(frozen=True)
class FieldOperator:
    """One diagonal block ``(k/mu) K + (beta/mu) M`` with BC elimination.

    Used by the delayed/Picard split (``forms/dpp.py:135-205``) and as the
    fieldsplit preconditioner blocks (``solvers/parameters.py:30-57``).
    """

    V: FunctionSpace
    k: float
    beta: float
    mu: float
    padding: Tuple[int, ...] = ()

    def __post_init__(self):
        if self.V.degree > 1:
            raise NotImplementedError(
                f"FieldOperator is Q1-only; degree-{self.V.degree} spaces "
                "use the tensor-product operators in ops.tensorfem"
            )
        object.__setattr__(self, "padding", normalize_padding(self.V.mesh, self.padding))

    @property
    def mesh(self) -> StructuredMesh:
        return self.V.mesh

    @cached_property
    def _stencils(self):
        return compile_stencils(self.mesh)

    @cached_property
    def _mask_arrays(self):
        return _masks(self.mesh, self.padding)

    @cached_property
    def stencil(self) -> np.ndarray:
        K_st, M_st = self._stencils
        return (self.k / self.mu) * K_st + (self.beta / self.mu) * M_st

    def matvec(self, z: jnp.ndarray) -> jnp.ndarray:
        bdry, interior = self._mask_arrays
        zi = jnp.where(interior, z, 0.0)
        y = apply_stencil(zi, self.stencil)
        return jnp.where(bdry, z, y)

    def mass_apply(self, z: jnp.ndarray) -> jnp.ndarray:
        """Interior-stencil consistent-mass application ``(beta/mu) M z``
        — used to build delayed-form RHS terms, whose boundary rows are
        discarded by the caller. NOT exact on boundary rows (the constant
        interior stencil ignores the truncated element support there);
        callers that need true boundary values must use
        :class:`FullMassOperator` below."""
        _, M_st = self._stencils
        return (self.beta / self.mu) * apply_stencil(z, M_st)

    def matvec_df(self, z):
        """Block application on a double-float pair (df32 Krylov mode)."""
        from perphil_tpu.ops.df32 import df_apply_stencil

        bdry, interior = self._mask_arrays
        zi = (jnp.where(interior, z[0], 0.0), jnp.where(interior, z[1], 0.0))
        y = df_apply_stencil(zi, np.asarray(self.stencil))
        return (jnp.where(bdry, z[0], y[0]), jnp.where(bdry, z[1], y[1]))

    def lifted_rhs(self, g: jnp.ndarray, f: Optional[jnp.ndarray] = None) -> jnp.ndarray:
        """RHS for ``A z = f`` with boundary values ``g``; ``f`` is a full
        (pre-elimination) load vector or None for zero forcing."""
        bdry, interior = self._mask_arrays
        gb = jnp.where(bdry, g, 0.0)
        lift = apply_stencil(gb, self.stencil)
        b = -lift if f is None else f - lift
        return jnp.where(bdry, g, b)


@dataclass(frozen=True)
class FullMassOperator:
    """The raw (no-BC) consistent mass matrix as a gather/scatter element
    matvec — exact on boundary rows, unlike the interior-only stencil path.
    Used for L2 projections (``fd.project`` parity)."""

    mesh: StructuredMesh

    @cached_property
    def _subcells(self):
        from perphil_tpu.ops.element import cell_subcells

        return cell_subcells(self.mesh.element, self.mesh.h, self.mesh.diagonal)

    def _slices(self, off) -> Tuple[slice, ...]:
        # vertex offsets are coordinate-ordered; grid axes are reversed
        return tuple(
            slice(int(o), int(o) + c)
            for o, c in zip(reversed(off), reversed(self.mesh.cells))
        )

    def matvec(self, u: jnp.ndarray) -> jnp.ndarray:
        out = jnp.zeros_like(u)
        for verts, _, Me in self._subcells:
            for a in range(verts.shape[0]):
                sa = self._slices(verts[a])
                acc = None
                for b in range(verts.shape[0]):
                    term = float(Me[a, b]) * u[self._slices(verts[b])]
                    acc = term if acc is None else acc + term
                out = out.at[sa].add(acc)
        return out

    def diagonal(self) -> jnp.ndarray:
        d = jnp.zeros(self.mesh.node_shape, dtype=default_dtype())
        for verts, _, Me in self._subcells:
            for a in range(verts.shape[0]):
                d = d.at[self._slices(verts[a])].add(float(Me[a, a]))
        return d


# ---------------------------------------------------------------------------
# CSR materialization (host-side; conditioning / ILU setup)
# ---------------------------------------------------------------------------


def _block_csr(
    mesh: StructuredMesh,
    stencil: np.ndarray,
    zero_bc_rows_cols: bool = True,
    unit_diagonal: bool = False,
) -> sp.csr_matrix:
    """Materialize one stencil block as scipy CSR with BC elimination.

    Valid because after symmetric elimination every surviving off-diagonal
    entry connects two interior vertices, whose raw rows carry the full
    stencil weights.
    """
    shape = mesh.node_shape
    d = len(shape)
    n = int(np.prod(shape))
    bdry = mesh.boundary_mask().ravel()
    strides = np.array([int(np.prod(shape[ax + 1 :])) for ax in range(d)])
    idx_grids = np.meshgrid(*[np.arange(s) for s in shape], indexing="ij")
    flat = np.arange(n).reshape(shape)

    rows, cols, vals = [], [], []
    for off in np.ndindex(*((3,) * d)):
        w = stencil[off]
        if w == 0.0:
            continue
        delta = np.array(off) - 1
        valid = np.ones(shape, dtype=bool)
        for ax in range(d):
            if delta[ax] == -1:
                valid &= idx_grids[ax] >= 1
            elif delta[ax] == 1:
                valid &= idx_grids[ax] <= shape[ax] - 2
        r = flat[valid]
        c = r + int(np.dot(delta, strides))
        keep = np.ones(r.shape, dtype=bool)
        if zero_bc_rows_cols:
            keep = ~bdry[r] & ~bdry[c]
        rows.append(r[keep])
        cols.append(c[keep])
        vals.append(np.full(keep.sum(), w))
    if unit_diagonal and zero_bc_rows_cols:
        db = np.where(bdry)[0]
        rows.append(db)
        cols.append(db)
        vals.append(np.ones(db.shape[0]))
    A = sp.coo_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=(n, n),
    )
    return A.tocsr()


def materialize_field_csr(op: FieldOperator) -> sp.csr_matrix:
    """CSR of one BC-eliminated diagonal block."""
    return _block_csr(op.mesh, np.asarray(op.stencil), True, True)


def materialize_monolithic_csr(
    W: MixedFunctionSpace, params: DPPParameters
) -> Tuple[sp.csr_matrix, int, int]:
    """CSR of the BC-eliminated monolithic matrix, field-major DoF order.

    Mirrors ``assemble_monolithic_matrix`` at
    ``/root/reference/src/perphil/experiments/iterative_bench.py:255-287``:
    returns (csr, n0, n1) with n0/n1 the per-field block sizes.
    """
    if W.spaces[0].degree > 1:
        raise NotImplementedError(
            "CSR materialization covers the Q1 stencil pattern only; "
            f"degree-{W.spaces[0].degree} conditioning analysis is not "
            "supported (the published conditioning artifacts are all Q1)"
        )
    mesh = W.mesh
    K_st, M_st = compile_stencils(mesh)
    p = params
    S1 = (p.k1 / p.mu) * K_st + (p.beta / p.mu) * M_st
    S2 = (p.k2 / p.mu) * K_st + (p.beta / p.mu) * M_st
    C = -(p.beta / p.mu) * M_st
    A11 = _block_csr(mesh, S1, True, True)
    A22 = _block_csr(mesh, S2, True, True)
    A12 = _block_csr(mesh, C, True, False)
    A = sp.bmat([[A11, A12], [A12, A22]], format="csr")
    A.eliminate_zeros()
    n0 = W.sub(0).dim()
    n1 = W.sub(1).dim()
    return A, n0, n1
