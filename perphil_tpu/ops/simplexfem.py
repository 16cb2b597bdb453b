"""Degree-2 (P2) Lagrange operators on structured simplex meshes.

The reference accepts any polynomial degree on any cell through Firedrake
(``/root/reference/src/perphil/forms/spaces.py:5-36``); the tensor-product
generalization (``ops/tensorfem.py``) covers Qp on quads/hexes, and this
module closes the remaining surface: P2 on triangles/tets.

The key observation: on the Kuhn-triangulated structured meshes this
library builds (2 triangles per quad, 6 tets per cube — ``ops/element.py``),
the P2 DoFs (vertices + edge midpoints) are EXACTLY the nodes of the
once-refined lattice: every edge of the triangulation (axis edges, face
diagonals, the 3D body diagonal) has its midpoint on the half-index grid,
and every half-index point is the midpoint of exactly one edge. So P2
fields are grid-shaped arrays of shape ``(2N+1,)^d`` (the ``dof_mesh``
lattice ``forms/spaces.py`` already exposes), and the assembled operator is
a PARITY-CLASS STENCIL: translation-invariant with period 2, with one
weight table per node class (vertex / axis-edge / face-diagonal /
body-diagonal — ``2^d`` classes) and offsets in ``[-2, 2]^d``. Applying it
is a fused chain of shifted multiply-adds whose weights are multilinear in
the per-axis index parities — pure elementwise XLA, no gathers, sharding
and boundary masks carry over from the Q1 machinery unchanged.

No published reference artifact exercises degree>1 (every workload sets
``pressure_deg=1``), so there are no golden numbers to match; correctness
is pinned by matvec == assembled-CSR and the O(h^3) L2 convergence order
(``tests/test_simplexfem.py``).
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from functools import cached_property, lru_cache
from typing import Callable, List, Tuple

import jax.numpy as jnp
import numpy as np

from perphil_tpu.config import default_dtype
from perphil_tpu.mesh.structured import StructuredMesh
from perphil_tpu.models.dpp.parameters import DPPParameters
from perphil_tpu.ops.element import cell_subcells

__all__ = [
    "p2_dof_mesh",
    "p2_local_nodes",
    "p2_simplex_matrices",
    "p2_class_stencils",
    "apply_p2_stencil",
    "p2_stencil_diagonal",
    "P2SimplexDPPOperator",
    "assemble_p2_monolithic",
]


def p2_dof_mesh(mesh: StructuredMesh) -> StructuredMesh:
    """The once-refined lattice holding the P2 DoFs — the degree-2 case of
    the general convention in ``forms/spaces.FunctionSpace.dof_mesh``
    (``replace(mesh, cells=degree*cells)``); kept here so ``ops`` does not
    import ``forms``, with the agreement pinned by
    ``tests/test_simplexfem.py::test_dof_mesh_matches_function_space``."""
    from dataclasses import replace

    return replace(mesh, cells=tuple(2 * c for c in mesh.cells))


def p2_local_nodes(verts_unit: np.ndarray) -> List[np.ndarray]:
    """P2 node positions of one simplex on the DOUBLED lattice: vertices at
    ``2*v`` then edge midpoints ``v_i + v_j`` in ``combinations`` order."""
    d = verts_unit.shape[1]
    nodes = [2 * verts_unit[i] for i in range(d + 1)]
    for i, j in itertools.combinations(range(d + 1), 2):
        nodes.append(verts_unit[i] + verts_unit[j])
    return [n.astype(np.int64) for n in nodes]


def _p2_basis(lam: np.ndarray, grads_l: np.ndarray):
    """P2 values and physical gradients from barycentric coordinates.

    :param lam: (d+1,) barycentric values at the point.
    :param grads_l: (d+1, d) constant barycentric gradients.
    :returns: (phi (nn,), grad (nn, d)) in ``p2_local_nodes`` order.
    """
    d = grads_l.shape[1]
    nn = (d + 1) + (d + 1) * d // 2
    phi = np.zeros(nn)
    grad = np.zeros((nn, d))
    for i in range(d + 1):
        phi[i] = lam[i] * (2.0 * lam[i] - 1.0)
        grad[i] = (4.0 * lam[i] - 1.0) * grads_l[i]
    for k, (i, j) in enumerate(itertools.combinations(range(d + 1), 2)):
        a = d + 1 + k
        phi[a] = 4.0 * lam[i] * lam[j]
        grad[a] = 4.0 * (lam[j] * grads_l[i] + lam[i] * grads_l[j])
    return phi, grad


def p2_simplex_matrices(
    verts_unit: np.ndarray, h: Tuple[float, ...], nq: int = 6
) -> Tuple[List[np.ndarray], np.ndarray, np.ndarray]:
    """P2 stiffness/mass on one simplex (physical scaling baked in).

    Duffy-collapsed Gauss quadrature, ``nq`` points per axis — exact to
    machine precision for the degree<=4 integrands here.
    :returns: (nodes on the doubled lattice, Ke, Me).
    """
    from perphil_tpu.ops.element import simplex_geometry
    from perphil_tpu.utils.quadrature import _duffy, gauss_legendre_01

    d = verts_unit.shape[1]
    detE, grads_l = simplex_geometry(verts_unit, h)
    detE = abs(detE)

    nodes = p2_local_nodes(verts_unit)
    nn = len(nodes)
    K = np.zeros((nn, nn))
    M = np.zeros((nn, nn))
    xq, wq = gauss_legendre_01(nq)
    for idx in itertools.product(range(nq), repeat=d):
        u = np.array([xq[i] for i in idx])
        w = float(np.prod([wq[i] for i in idx]))
        x, jac = _duffy(u)  # simplex coords (lam_1..lam_d), duffy Jacobian
        lam = np.concatenate([[1.0 - x.sum()], x])
        phi, grad = _p2_basis(lam, grads_l)
        wt = w * jac * detE
        K += wt * (grad @ grad.T)
        M += wt * np.outer(phi, phi)
    return nodes, K, M


@lru_cache(maxsize=None)
def _class_stencils_cached(
    element: str, h: Tuple[float, ...], diagonal: str
) -> Tuple[np.ndarray, np.ndarray]:
    d = len(h)
    shape = (2,) * d + (5,) * d
    Kw = np.zeros(shape)
    Mw = np.zeros(shape)
    for verts, _, _ in cell_subcells(element, h, diagonal):
        nodes, Ke, Me = p2_simplex_matrices(verts, h)
        for a, na in enumerate(nodes):
            # grid axes are reversed coordinate axes (x fastest)
            ca = tuple(int(v) % 2 for v in reversed(na))
            for b, nb in enumerate(nodes):
                delta = tuple(int(v) + 2 for v in reversed(nb - na))
                Kw[ca + delta] += Ke[a, b]
                Mw[ca + delta] += Me[a, b]
    # the cache hands out shared arrays: freeze them so an in-place edit by
    # a caller cannot corrupt every later operator with the same key
    Kw.setflags(write=False)
    Mw.setflags(write=False)
    return Kw, Mw


def p2_class_stencils(mesh: StructuredMesh) -> Tuple[np.ndarray, np.ndarray]:
    """Parity-class stencil tables ``(Kw, Mw)`` of shape ``(2,)*d + (5,)*d``
    (class index in grid-axis order, then offset index, 0 <-> -2).

    Every interior refined-lattice row is exact: all cells incident to an
    interior node exist (the node's cell neighborhood lies inside the
    domain), so the class-uniform accumulation over one cell per type is
    the true assembled row. Boundary rows are replaced by identity
    (Dirichlet) in the operator, so their table entries are never read.
    """
    if mesh.is_tensor_product:
        raise ValueError("p2_class_stencils is for simplex meshes; use ops/tensorfem")
    return _class_stencils_cached(mesh.element, tuple(mesh.h), mesh.diagonal)


def _parity_vectors(shape: Tuple[int, ...], dtype) -> List[jnp.ndarray]:
    d = len(shape)
    out = []
    for ax in range(d):
        p = (jnp.arange(shape[ax]) % 2).astype(dtype)
        out.append(p.reshape((1,) * ax + (-1,) + (1,) * (d - ax - 1)))
    return out


def _parity_weight(Wc: np.ndarray, pb: List[jnp.ndarray]):
    """Multilinear-in-parity weight field: sum_c Wc[c] prod_k pb_k^{c_k}."""
    d = len(pb)
    w = None
    for c in itertools.product((0, 1), repeat=d):
        coeff = float(Wc[c])
        if coeff == 0.0:
            continue
        term = coeff
        for k in range(d):
            term = term * (pb[k] if c[k] else (1.0 - pb[k]))
        w = term if w is None else w + term
    return w


def apply_p2_stencil(u: jnp.ndarray, W: np.ndarray) -> jnp.ndarray:
    """``y[r] = sum_D W[class(r), D] u[r+D]`` on a refined-lattice grid.

    Weights are reconstructed as multilinear expressions in the per-axis
    index parities (broadcast (n,1..)/(1,n..) vectors), so nothing
    grid-sized materializes besides the shifted reads — XLA fuses the whole
    chain into one elementwise pass over ~|offsets| shifted views.
    """
    d = u.ndim
    shape = u.shape
    up = jnp.pad(u, 2)
    pb = _parity_vectors(shape, u.dtype)
    y = None
    for off in itertools.product(range(-2, 3), repeat=d):
        Wc = W[(slice(None),) * d + tuple(o + 2 for o in off)]
        if not np.any(Wc):
            continue
        w = _parity_weight(Wc, pb)
        if w is None:
            continue
        sl = tuple(slice(2 + o, 2 + o + s) for o, s in zip(off, shape))
        term = w * up[sl]
        y = term if y is None else y + term
    return y if y is not None else jnp.zeros_like(u)


def p2_stencil_diagonal(shape: Tuple[int, ...], W: np.ndarray, dtype) -> jnp.ndarray:
    """Grid of diagonal entries (the zero-offset class weights)."""
    d = len(shape)
    Wc = W[(slice(None),) * d + (2,) * d]
    pb = _parity_vectors(shape, dtype)
    w = _parity_weight(Wc, pb)
    return jnp.broadcast_to(w, shape).astype(dtype)


@dataclass(frozen=True)
class P2SimplexDPPOperator:
    """BC-eliminated 2-field DPP operator for P2 on simplex meshes.

    Same block structure and conventions as the Q1 ``ops/assembly.py::
    DPPOperator`` (symmetric elimination, zero forcing), with fields stored
    on the refined DoF lattice ``(2N+1,)^d``.

    ``padding`` appends phantom lattice entries at the high end of each
    axis (the sharding divisibility mechanism, ``parallel/sharding.py::
    mesh_padding``). Phantom rows ride the existing Dirichlet machinery:
    they are marked boundary with zero data, so they are identity rows
    with permanently-zero residual — Krylov trajectories and iteration
    counts match the unpadded solve exactly. Real-node parities are
    unaffected (padding never shifts indices) and real stencil reads into
    the phantom region hit eliminated (zeroed) values.
    """

    mesh: StructuredMesh
    params: DPPParameters
    padding: Tuple[int, ...] = ()

    def __post_init__(self):
        if self.mesh.is_tensor_product:
            raise ValueError(
                "P2SimplexDPPOperator is for simplex meshes; tensor-product "
                "cells use ops/tensorfem.TensorDPPOperator"
            )
        if self.padding and len(self.padding) != self.mesh.dim:
            raise ValueError(
                f"padding {self.padding} must have one entry per axis "
                f"({self.mesh.dim})"
            )

    @cached_property
    def dof_mesh(self) -> StructuredMesh:
        return p2_dof_mesh(self.mesh)

    @property
    def dof_shape(self) -> Tuple[int, ...]:
        base = self.dof_mesh.node_shape
        if not self.padding:
            return base
        return tuple(n + p for n, p in zip(base, self.padding))

    @cached_property
    def boundary_mask(self) -> np.ndarray:
        mask = np.asarray(self.dof_mesh.boundary_mask())
        if self.padding:
            # phantom entries are identity rows: mark them boundary
            mask = np.pad(
                mask, [(0, p) for p in self.padding], constant_values=True
            )
        return mask

    @cached_property
    def _stencils(self) -> Tuple[np.ndarray, np.ndarray]:
        return p2_class_stencils(self.mesh)

    @cached_property
    def _bdry(self) -> jnp.ndarray:
        # device-resident mask, uploaded once (the Q1 DPPOperator caches
        # its masks the same way in ops/assembly.py::_mask_arrays)
        return jnp.asarray(self.boundary_mask)

    def matvec(self, z1: jnp.ndarray, z2: jnp.ndarray):
        p = self.params
        Kw, Mw = self._stencils
        bdry = self._bdry
        z1i = jnp.where(bdry, 0.0, z1)
        z2i = jnp.where(bdry, 0.0, z2)
        Kz1 = apply_p2_stencil(z1i, Kw)
        Kz2 = apply_p2_stencil(z2i, Kw)
        Md = apply_p2_stencil(z1i - z2i, Mw)
        y1 = (p.k1 / p.mu) * Kz1 + (p.beta / p.mu) * Md
        y2 = (p.k2 / p.mu) * Kz2 - (p.beta / p.mu) * Md
        return jnp.where(bdry, z1, y1), jnp.where(bdry, z2, y2)

    def lifted_rhs(self, g1: jnp.ndarray, g2: jnp.ndarray):
        p = self.params
        Kw, Mw = self._stencils
        bdry = jnp.asarray(self.boundary_mask)
        g1b = jnp.where(bdry, g1, 0.0)
        g2b = jnp.where(bdry, g2, 0.0)
        Kg1 = apply_p2_stencil(g1b, Kw)
        Kg2 = apply_p2_stencil(g2b, Kw)
        Mgd = apply_p2_stencil(g1b - g2b, Mw)
        a1 = (p.k1 / p.mu) * Kg1 + (p.beta / p.mu) * Mgd
        a2 = (p.k2 / p.mu) * Kg2 - (p.beta / p.mu) * Mgd
        b1 = jnp.where(bdry, g1, -a1)
        b2 = jnp.where(bdry, g2, -a2)
        return b1, b2

    def residual(self, z1, z2, b1, b2):
        y1, y2 = self.matvec(z1, z2)
        return b1 - y1, b2 - y2

    def stacked_matvec(self) -> Callable[[jnp.ndarray], jnp.ndarray]:
        def mv(x: jnp.ndarray) -> jnp.ndarray:
            y1, y2 = self.matvec(x[0], x[1])
            return jnp.stack([y1, y2])

        return mv

    def diagonal_stacked(self) -> jnp.ndarray:
        """(2, *dof_shape) diagonal of the eliminated operator (Jacobi)."""
        p = self.params
        Kw, Mw = self._stencils
        dtype = default_dtype()
        dK = p2_stencil_diagonal(self.dof_shape, Kw, dtype)
        dM = p2_stencil_diagonal(self.dof_shape, Mw, dtype)
        bdry = jnp.asarray(self.boundary_mask)
        d1 = jnp.where(bdry, 1.0, (p.k1 / p.mu) * dK + (p.beta / p.mu) * dM)
        d2 = jnp.where(bdry, 1.0, (p.k2 / p.mu) * dK + (p.beta / p.mu) * dM)
        return jnp.stack([d1, d2])


def _assemble_p2_scalar(mesh: StructuredMesh):
    """Host assembly of raw (pre-elimination) P2 K and M CSR matrices on the
    refined lattice — analysis/verification only (production applies the
    class stencils matrix-free)."""
    import scipy.sparse as sp

    d = mesh.dim
    ref_shape = tuple(2 * c + 1 for c in reversed(mesh.cells))  # grid order
    n = int(np.prod(ref_shape))
    strides = np.ones(d, dtype=np.int64)  # coordinate-axis strides, x first
    acc = 1
    for ax in range(d):
        strides[ax] = acc
        acc *= ref_shape[d - 1 - ax]

    # all cell bases (coordinate order), refined by factor 2
    ranges = [np.arange(c) for c in mesh.cells]
    grids = np.meshgrid(*ranges, indexing="ij")
    bases = 2 * np.stack([g.ravel() for g in grids], axis=1)  # (ncells, d)

    rows, cols, vals_K, vals_M = [], [], [], []
    for verts, _, _ in cell_subcells(mesh.element, tuple(mesh.h), mesh.diagonal):
        nodes, Ke, Me = p2_simplex_matrices(verts, tuple(mesh.h))
        gidx = np.stack(
            [(bases + nn[None, :]) @ strides for nn in nodes], axis=1
        )  # (ncells, nn)
        nn = len(nodes)
        # K and M share the sparsity pattern: one (rows, cols) pair serves both
        for a in range(nn):
            for b in range(nn):
                rows.append(gidx[:, a])
                cols.append(gidx[:, b])
                vals_K.append(np.full(gidx.shape[0], Ke[a, b]))
                vals_M.append(np.full(gidx.shape[0], Me[a, b]))
    ij = (np.concatenate(rows), np.concatenate(cols))
    K = sp.csr_matrix((np.concatenate(vals_K), ij), shape=(n, n))
    M = sp.csr_matrix((np.concatenate(vals_M), ij), shape=(n, n))
    return K, M


def assemble_p2_monolithic(mesh: StructuredMesh, params: DPPParameters):
    """Symmetric-BC-eliminated monolithic 2-field CSR (host, analysis and
    the preonly+lu direct path). Same elimination convention as the Q1
    ``build_monolithic_system``: boundary rows/columns identity."""
    import scipy.sparse as sp

    K, M = _assemble_p2_scalar(mesh)
    p = params
    A11 = (p.k1 / p.mu) * K + (p.beta / p.mu) * M
    A22 = (p.k2 / p.mu) * K + (p.beta / p.mu) * M
    C = -(p.beta / p.mu) * M
    A = sp.bmat([[A11, C], [C, A22]], format="csr")

    bmask = np.asarray(p2_dof_mesh(mesh).boundary_mask()).ravel().astype(bool)
    bmask2 = np.concatenate([bmask, bmask])
    keep = sp.diags((~bmask2).astype(float))
    ident = sp.diags(bmask2.astype(float))
    A = keep @ A @ keep + ident
    return A.tocsr()
