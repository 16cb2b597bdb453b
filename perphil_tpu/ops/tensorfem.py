"""Arbitrary-degree tensor-product (Qp) DPP operators and direct solves.

The reference supports any polynomial degree through Firedrake
(``/root/reference/src/perphil/forms/spaces.py:5-36`` — ``pressure_deg`` is
a free parameter even though every published artifact uses degree 1). The
generalization here exploits the tensor-product structure that
Firedrake cannot: on uniform quad/hex meshes the degree-p stiffness and
mass operators factor as

    K_d = sum_i  K1 (x) M1 (x) ... ,      M_d = M1 (x) M1 (x) ...

where (K1, M1) are the 1D degree-p Lagrange matrices on p*N+1 uniform
nodes. Every operator application is then d dense (n x n) matmuls over the
DoF lattice at any degree, and the generalized 1D
eigenproblem gives the exact fast-diagonalization direct solve of the
coupled 2-field system, exactly as in ``ops/direct.py`` for Q1.

DoFs live on the refined lattice (p*N+1 nodes per axis, spacing h/p), so
grid-shaped storage, boundary masks, and sharding all carry over from the
Q1 machinery unchanged.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property, lru_cache
from typing import Callable, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import scipy.linalg

from perphil_tpu.config import default_dtype
from perphil_tpu.mesh.structured import StructuredMesh
from perphil_tpu.models.dpp.parameters import DPPParameters


@lru_cache(maxsize=None)
def lagrange_ref_matrices(p: int) -> Tuple[np.ndarray, np.ndarray]:
    """Reference-element 1D matrices for degree-p Lagrange bases on [0, 1]
    with equispaced nodes j/p: (Khat, Mhat), where the physical element
    matrices are Khat/h and Mhat*h. Gauss-Legendre integration exact to
    degree 2p."""
    nodes = np.linspace(0.0, 1.0, p + 1)
    # Lagrange basis polynomials via numpy.polynomial
    from numpy.polynomial import polynomial as P

    basis = []
    for i in range(p + 1):
        c = np.array([1.0])
        for j in range(p + 1):
            if j == i:
                continue
            c = P.polymul(c, np.array([-nodes[j], 1.0]) / (nodes[i] - nodes[j]))
        basis.append(c)
    q, w = np.polynomial.legendre.leggauss(p + 1)  # exact to degree 2p+1
    q = 0.5 * (q + 1.0)
    w = 0.5 * w
    vals = np.array([P.polyval(q, c) for c in basis])  # (p+1, nq)
    ders = np.array([P.polyval(q, P.polyder(c)) for c in basis])
    Mhat = (vals * w) @ vals.T
    Khat = (ders * w) @ ders.T
    return Khat, Mhat


@lru_cache(maxsize=None)
def assemble_1d(p: int, cells: int, h: float) -> Tuple[np.ndarray, np.ndarray]:
    """Global 1D degree-p (K1, M1) on ``cells`` uniform elements of size h:
    dense (p*cells+1)^2 arrays (n stays small enough that dense storage and
    matmuls are the right representation)."""
    Khat, Mhat = lagrange_ref_matrices(p)
    n = p * cells + 1
    K = np.zeros((n, n))
    M = np.zeros((n, n))
    for e in range(cells):
        s = p * e
        K[s : s + p + 1, s : s + p + 1] += Khat / h
        M[s : s + p + 1, s : s + p + 1] += Mhat * h
    return K, M


@lru_cache(maxsize=None)
def interior_eig_1d(p: int, cells: int, h: float) -> Tuple[np.ndarray, np.ndarray]:
    """Generalized eigenpairs of the interior (Dirichlet-eliminated) 1D
    degree-p pair: K1 S = M1 S diag(lam), S^T M1 S = I."""
    K, M = assemble_1d(p, cells, h)
    Ki, Mi = K[1:-1, 1:-1], M[1:-1, 1:-1]
    lam, S = scipy.linalg.eigh(Ki, Mi)
    return np.ascontiguousarray(S), np.ascontiguousarray(lam)


def _pad_identity(A: np.ndarray, pad: int) -> np.ndarray:
    """Extend a 1D factor matrix with an identity phantom block and zero
    cross-coupling: ``[[A, 0], [0, I]]`` — the padded dofs are exactly
    inert in every tensor-product term (see TensorDPPOperator.padding)."""
    n = A.shape[0]
    out = np.zeros((n + pad, n + pad), dtype=A.dtype)
    out[:n, :n] = A
    out[n:, n:] = np.eye(pad, dtype=A.dtype)
    return out


def _apply_axis(u: jnp.ndarray, A: jnp.ndarray, axis: int) -> jnp.ndarray:
    """Contract matrix A against one grid axis (dense matmul)."""
    return jnp.moveaxis(
        jnp.tensordot(A, u, axes=([1], [axis]), precision=jax.lax.Precision.HIGHEST),
        0,
        axis,
    )


@dataclass(frozen=True)
class TensorDPPOperator:
    """BC-eliminated monolithic DPP operator at degree p on a quad/hex mesh.

    Mirrors ``ops/assembly.py::DPPOperator`` semantics (symmetric BC
    elimination: boundary rows/columns replaced by identity) on the refined
    DoF lattice. ``matvec``/``lifted_rhs``/``residual`` have the same
    signatures, so the Krylov stack runs unchanged.
    """

    mesh: StructuredMesh
    params: DPPParameters
    degree: int
    # phantom padding per GRID axis (slowest-first, like dof_shape):
    # identity 1D rows with ZERO coupling to the physical lattice, so
    # padded dofs are exactly inert — real-row matrix entries referencing
    # a phantom column vanish in every tensor term, residuals/iterates
    # stay zero on the phantom slab, and Krylov trajectories are
    # bit-identical to the unpadded problem (the sharded-path phantom
    # padding, mirroring ops/assembly.py's Q1 convention).
    padding: Tuple[int, ...] = ()

    def __post_init__(self):
        if not self.mesh.is_tensor_product:
            raise ValueError("Tensor-product degree-p spaces need quad/hex cells")
        if self.degree < 1:
            raise ValueError("degree must be >= 1")
        pad = tuple(int(p) for p in self.padding) or (0,) * self.mesh.dim
        if len(pad) != self.mesh.dim or any(p < 0 for p in pad):
            raise ValueError(f"padding must be {self.mesh.dim} nonneg ints, got {self.padding}")
        object.__setattr__(self, "padding", pad)

    @property
    def phys_shape(self) -> Tuple[int, ...]:
        """The physical DoF lattice (no phantom rows)."""
        return tuple(self.degree * c + 1 for c in reversed(self.mesh.cells))

    @property
    def dof_shape(self) -> Tuple[int, ...]:
        return tuple(n + p for n, p in zip(self.phys_shape, self.padding))

    @property
    def phys_interior(self) -> Tuple[slice, ...]:
        """Slices of the physical interior (excludes physical boundary AND
        any phantom padding)."""
        return tuple(slice(1, n - 1) for n in self.phys_shape)

    @cached_property
    def _mats(self) -> Tuple[Tuple[np.ndarray, np.ndarray], ...]:
        """(K1, M1) per coordinate axis (x first), identity-extended over
        any phantom padding on that axis."""
        d = self.mesh.dim
        out = []
        for c_ax, (c, h) in enumerate(zip(self.mesh.cells, self.mesh.h)):
            K1, M1 = assemble_1d(self.degree, c, h)
            pad = self.padding[d - 1 - c_ax]  # grid axis for this coord axis
            if pad:
                K1 = _pad_identity(K1, pad)
                M1 = _pad_identity(M1, pad)
            out.append((K1, M1))
        return tuple(out)

    @cached_property
    def boundary_mask(self) -> np.ndarray:
        """Physical-boundary rows (identity/BC rows). Phantom slabs stay
        unmarked: they are inert interior rows with zero data, not BCs."""
        shape = self.dof_shape
        phys = self.phys_shape
        m = np.zeros(shape, dtype=bool)
        for ax in range(len(shape)):
            sl = [slice(None)] * len(shape)
            sl[ax] = 0
            m[tuple(sl)] = True
            sl[ax] = phys[ax] - 1
            m[tuple(sl)] = True
        return m

    def _K(self, u: jnp.ndarray) -> jnp.ndarray:
        """Stiffness: sum over axes of K1 on that axis, M1 on the others."""
        d = u.ndim
        out = jnp.zeros_like(u)
        for kax in range(d):
            term = u
            for ax in range(d):
                K1, M1 = self._mats[d - 1 - ax]  # grid axes are reversed
                A = K1 if ax == kax else M1
                term = _apply_axis(term, jnp.asarray(A, dtype=u.dtype), ax)
            out = out + term
        return out

    def _M(self, u: jnp.ndarray) -> jnp.ndarray:
        d = u.ndim
        for ax in range(d):
            _, M1 = self._mats[d - 1 - ax]
            u = _apply_axis(u, jnp.asarray(M1, dtype=u.dtype), ax)
        return u

    def _raw_blocks(self, z1, z2):
        p = self.params
        K1z = self._K(z1)
        K2z = self._K(z2)
        Md = self._M(z1 - z2)
        y1 = (p.k1 / p.mu) * K1z + (p.beta / p.mu) * Md
        y2 = (p.k2 / p.mu) * K2z - (p.beta / p.mu) * Md
        return y1, y2

    def matvec(self, z1: jnp.ndarray, z2: jnp.ndarray):
        bdry = jnp.asarray(self.boundary_mask)
        z1i = jnp.where(bdry, 0.0, z1)
        z2i = jnp.where(bdry, 0.0, z2)
        y1, y2 = self._raw_blocks(z1i, z2i)
        return jnp.where(bdry, z1, y1), jnp.where(bdry, z2, y2)

    def lifted_rhs(self, g1: jnp.ndarray, g2: jnp.ndarray):
        """RHS of the BC-eliminated system for zero forcing: interior rows
        get ``-A[interior, boundary] g``, boundary rows get ``g`` (same
        convention as ``DPPOperator.lifted_rhs``)."""
        bdry = jnp.asarray(self.boundary_mask)
        g1b = jnp.where(bdry, g1, 0.0)
        g2b = jnp.where(bdry, g2, 0.0)
        a1, a2 = self._raw_blocks(g1b, g2b)
        return jnp.where(bdry, g1, -a1), jnp.where(bdry, g2, -a2)

    def residual(self, z1, z2, b1, b2):
        y1, y2 = self.matvec(z1, z2)
        return b1 - y1, b2 - y2

    # -- flat-vector views (for the Krylov drivers) ------------------------

    def stacked_matvec(self) -> Callable[[jnp.ndarray], jnp.ndarray]:
        def mv(x):
            y1, y2 = self.matvec(x[0], x[1])
            return jnp.stack([y1, y2])

        return mv


@dataclass(frozen=True)
class TensorFastDiagDPP:
    """Exact direct solve of the degree-p coupled DPP system via
    generalized fast diagonalization (the MUMPS role at any degree)."""

    mesh: StructuredMesh
    params: DPPParameters
    degree: int
    # phantom padding per grid axis (see TensorDPPOperator.padding):
    # padded rows pass through as identity alongside the boundary rows
    padding: Tuple[int, ...] = ()

    def __post_init__(self):
        pad = tuple(int(p) for p in self.padding) or (0,) * self.mesh.dim
        if len(pad) != self.mesh.dim or any(p < 0 for p in pad):
            # same check as TensorDPPOperator: a wrong-length tuple would
            # otherwise silently truncate solve()'s zip over interior slices
            raise ValueError(
                f"padding must be {self.mesh.dim} nonneg ints, got {self.padding}"
            )
        object.__setattr__(self, "padding", pad)

    @cached_property
    def _eig(self):
        return tuple(
            interior_eig_1d(self.degree, c, h)
            for c, h in zip(self.mesh.cells, self.mesh.h)
        )

    @cached_property
    def _mode_data(self):
        lams = [lam for (_, lam) in self._eig]
        d = len(lams)
        lam_sum = np.zeros(tuple(len(l) for l in reversed(lams)))
        for ax in range(d):
            shape = [1] * d
            shape[ax] = len(lams[d - 1 - ax])
            lam_sum = lam_sum + lams[d - 1 - ax].reshape(shape)
        p = self.params
        a11 = (p.k1 * lam_sum + p.beta) / p.mu
        a22 = (p.k2 * lam_sum + p.beta) / p.mu
        a12 = -p.beta / p.mu
        det = a11 * a22 - a12 * a12
        return a11, a22, det

    def _transform(self, f: jnp.ndarray, transpose: bool) -> jnp.ndarray:
        d = f.ndim
        out = f
        for ax in range(d):
            S, _ = self._eig[d - 1 - ax]
            Sj = jnp.asarray(S.T if transpose else S, dtype=f.dtype)
            out = _apply_axis(out, Sj, ax)
        return out

    def solve(self, b1: jnp.ndarray, b2: jnp.ndarray):
        """Solve on full DoF grids: boundary rows (and any phantom padding)
        pass through as identity (matching the eliminated operator),
        physical interior solved exactly."""
        inner = tuple(
            slice(1, n - p - 1) for n, p in zip(b1.shape, self.padding)
        )
        a11, a22, det = (jnp.asarray(m, dtype=b1.dtype) for m in self._mode_data)
        a12 = -self.params.beta / self.params.mu
        f1h = self._transform(b1[inner], transpose=True)
        f2h = self._transform(b2[inner], transpose=True)
        u1h = (a22 * f1h - a12 * f2h) / det
        u2h = (a11 * f2h - a12 * f1h) / det
        z1 = self._transform(u1h, transpose=False)
        z2 = self._transform(u2h, transpose=False)
        return b1.at[inner].set(z1), b2.at[inner].set(z2)


# ---------------------------------------------------------------------------
# degree-aware error norms (tensor-product quadrature with the Qp basis)


def _basis_at(p: int, pts: np.ndarray) -> np.ndarray:
    """(p+1, len(pts)) values of the degree-p Lagrange basis at reference
    coordinates pts in [0, 1]."""
    from numpy.polynomial import polynomial as P

    nodes = np.linspace(0.0, 1.0, p + 1)
    out = []
    for i in range(p + 1):
        c = np.array([1.0])
        for j in range(p + 1):
            if j == i:
                continue
            c = P.polymul(c, np.array([-nodes[j], 1.0]) / (nodes[i] - nodes[j]))
        out.append(P.polyval(pts, c))
    return np.array(out)


def _dbasis_at(p: int, pts: np.ndarray) -> np.ndarray:
    from numpy.polynomial import polynomial as P

    nodes = np.linspace(0.0, 1.0, p + 1)
    out = []
    for i in range(p + 1):
        c = np.array([1.0])
        for j in range(p + 1):
            if j == i:
                continue
            c = P.polymul(c, np.array([-nodes[j], 1.0]) / (nodes[i] - nodes[j]))
        out.append(P.polyval(pts, P.polyder(c)))
    return np.array(out)


def _cellwise_dofs(u: jnp.ndarray, p: int, cells: Tuple[int, ...]) -> jnp.ndarray:
    """Gather per-cell DoF blocks: (ncells..., (p+1)...) from the lattice.

    Grid axes are slowest-first; output axes are (cell_axes..., local_axes...)
    in the same slowest-first order.
    """
    d = u.ndim
    out = u
    # successively expand each axis n_ax = p*c+1 -> (c, p+1) with overlap
    for ax in range(d):
        c = cells[d - 1 - ax]
        idx = (p * np.arange(c))[:, None] + np.arange(p + 1)[None, :]
        out = jnp.take(out, jnp.asarray(idx.ravel()), axis=ax)
        new_shape = out.shape[:ax] + (c, p + 1) + out.shape[ax + 1 :]
        out = out.reshape(new_shape)
        # move the local axis to the end
        out = jnp.moveaxis(out, ax + 1, -1)
    return out


def errornorm_p(
    u: jnp.ndarray,
    exact: Callable,
    mesh: StructuredMesh,
    p: int,
    kind: str = "l2",
    quadrature_degree: int = 14,
) -> float:
    """L2 or H1-seminorm error of a degree-p lattice function against a
    callable exact solution, integrated with tensor-product Gauss-Legendre
    quadrature of the requested degree (default 14 — the parity-critical
    degree shared with ``utils/postprocessing``).

    ``exact`` may also be a same-space :class:`~perphil_tpu.forms.spaces.Function`
    (the reference-vs-refined comparison the Q1 error paths support via
    ``_exact_at``): the lattices are differenced and the norm of the
    difference field is integrated exactly."""
    from perphil_tpu.forms import spaces as _spaces

    if isinstance(exact, _spaces.Function):
        ef = exact
        if (
            tuple(ef.space.mesh.node_shape) != tuple(mesh.node_shape)
            or ef.space.degree != p
        ):
            raise TypeError(
                "Function-valued exact must live on the same mesh and degree "
                f"(got degree {ef.space.degree} on {ef.space.mesh.node_shape} "
                f"vs degree {p} on {mesh.node_shape})"
            )
        u = jnp.asarray(u) - jnp.asarray(ef.data)

        def exact(*xs):  # noqa: F811 - difference field vs zero
            return jnp.zeros_like(xs[0])

    d = mesh.dim
    nq = quadrature_degree // 2 + 1
    q, w = np.polynomial.legendre.leggauss(nq)
    q = 0.5 * (q + 1.0)
    w = 0.5 * w
    B = _basis_at(p, q)  # (p+1, nq)
    D = _dbasis_at(p, q)
    cells = mesh.cells  # coordinate order (x first)
    hs = mesh.h

    ud = _cellwise_dofs(jnp.asarray(u), p, cells)  # (*cells_rev, *(p+1)*d)

    # evaluate u (or du/dx_k) at tensor quadrature points per cell
    def eval_field(mats):
        out = ud
        for ax in range(d):
            Bax = jnp.asarray(mats[d - 1 - ax])  # matches local axis order
            out = jnp.tensordot(
                out, Bax, axes=([d], [0]), precision=jax.lax.Precision.HIGHEST
            )
            # contracted local axis d; result appends quad axis at the end
        return out  # (*cells_rev, *nq*d)

    # quadrature point physical coordinates per cell, per axis
    coords = []
    for ax_c in range(d):  # coordinate order
        base = (np.arange(cells[ax_c])[:, None]) * hs[ax_c]
        pts = base + q[None, :] * hs[ax_c]
        coords.append(pts)  # (c, nq)

    # mesh-grid the per-cell quadrature coords into (*cells_rev, *nq_rev)
    def coord_grid(ax_c):
        pts = coords[ax_c]  # (c, nq)
        shape_cells = [1] * d
        shape_cells[d - 1 - ax_c] = cells[ax_c]
        shape_q = [1] * d
        shape_q[d - 1 - ax_c] = nq
        return pts.reshape(
            tuple(shape_cells) + tuple(shape_q)
        )  # broadcastable

    Xs = [coord_grid(ax_c) for ax_c in range(d)]

    wgrid = np.ones(())
    for ax_c in range(d):
        shape_q = [1] * d
        shape_q[d - 1 - ax_c] = nq
        wgrid = wgrid * (w * hs[ax_c]).reshape(tuple(shape_q))

    if kind == "l2":
        uq = eval_field([B] * d)
        ex = exact(*[jnp.asarray(np.broadcast_to(X, uq.shape)) for X in Xs])
        err2 = jnp.sum((uq - ex) ** 2 * jnp.asarray(np.broadcast_to(wgrid, uq.shape)))
        return float(jnp.sqrt(err2))
    if kind == "h1s":
        # d(exact)/dx_k via central finite differences is not acceptable —
        # require the caller to pass grad components; here we use jax.grad
        # through the callable on scalar inputs, vectorized.
        total = 0.0
        for k in range(d):
            mats = [B] * d
            mats[k] = D  # derivative along coordinate axis k
            duq = eval_field([mats[d - 1 - ax] for ax in range(d)][::-1]) / hs[k]
            gfun = _grad_component(exact, k, d)
            ex = gfun(*[jnp.asarray(np.broadcast_to(X, duq.shape)) for X in Xs])
            total = total + jnp.sum(
                (duq - ex) ** 2 * jnp.asarray(np.broadcast_to(wgrid, duq.shape))
            )
        return float(jnp.sqrt(total))
    raise ValueError(kind)


def _grad_component(exact: Callable, k: int, d: int) -> Callable:
    def g(*xs):
        flat = [x.ravel() for x in xs]

        def scalar(*pt):
            return exact(*pt)

        gk = jax.vmap(jax.grad(scalar, argnums=k))(*flat)
        return gk.reshape(xs[0].shape)

    return g
