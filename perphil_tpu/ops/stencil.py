"""Stencil compilation and application.

On a uniform structured mesh every interior row of an assembled FEM operator
has identical weights, so the whole matrix is a constant ``3^d`` stencil.
``compile_stencil`` performs, once per (mesh, form) pair on the host, the work
the reference delegates to generated PyOP2 C kernels plus PETSc MatAssembly
(``/root/reference/src/perphil/solvers/solver.py:66-71``): it assembles the
row of a representative interior vertex from element matrices.

``apply_stencil`` is the device-side operator application: a 3^d-point
shifted-add over a padded grid, which XLA fuses into a single
bandwidth-bound pass.

Axis convention: stencil arrays are indexed ``[dz+1, dy+1, dx+1]`` (slowest
axis first), matching grid arrays ``u[k, j, i]``.
"""

from __future__ import annotations

import itertools
from functools import lru_cache
from typing import Tuple

import jax.numpy as jnp
import numpy as np

from perphil_tpu.mesh.structured import StructuredMesh
from perphil_tpu.ops.element import cell_subcells


@lru_cache(maxsize=None)
def _stencils_cached(
    cells: Tuple[int, ...], element: str, diagonal: str, extent: Tuple[float, ...]
) -> Tuple[np.ndarray, np.ndarray]:
    mesh = StructuredMesh(cells=cells, element=element, diagonal=diagonal, extent=extent)
    d = mesh.dim
    h = mesh.h
    K_st = np.zeros((3,) * d)
    M_st = np.zeros((3,) * d)
    subcells = cell_subcells(element, h, diagonal)
    # Sum contributions of every sub-cell of every grid cell touching the
    # central vertex (cell corner offsets in {-1, 0}^d).
    for corner in itertools.product((-1, 0), repeat=d):
        corner = np.asarray(corner, dtype=np.int64)
        for verts, Ke, Me in subcells:
            pos = verts + corner  # vertex offsets relative to central vertex
            center_hits = np.where((pos == 0).all(axis=1))[0]
            for a in center_hits:
                for b in range(pos.shape[0]):
                    # stencil index: [slowest..fastest] = reversed coord order
                    idx = tuple(int(o) + 1 for o in reversed(pos[b]))
                    K_st[idx] += Ke[a, b]
                    M_st[idx] += Me[a, b]
    K_st.setflags(write=False)
    M_st.setflags(write=False)
    return K_st, M_st


def compile_stencils(mesh: StructuredMesh) -> Tuple[np.ndarray, np.ndarray]:
    """Return (K_stencil, M_stencil), each a read-only ``(3,)*dim`` array.

    ``K`` is the Laplace/stiffness stencil for unit conductivity; ``M`` is the
    consistent-mass stencil. Any DPP operator block is a linear combination
    ``(k/mu) K + (beta/mu) M`` (see the weak forms at
    ``/root/reference/src/perphil/forms/dpp.py:57,89``).
    """
    return _stencils_cached(mesh.cells, mesh.element, mesh.diagonal, mesh.extent)


def apply_stencil(u: jnp.ndarray, stencil: np.ndarray) -> jnp.ndarray:
    """Apply a constant 3^d stencil to a grid array via shifted adds.

    Valid at *interior* vertices only (boundary rows of an assembled operator
    have truncated stencils, but after symmetric Dirichlet elimination those
    rows are identity and never touched through this path).

    Zero-weight offsets are skipped at trace time, so e.g. the triangle
    5-point Laplacian costs 5 shifted adds, not 9.
    """
    d = u.ndim
    up = jnp.pad(u, 1)
    shape = u.shape
    out = None
    for idx in itertools.product(range(3), repeat=d):
        w = float(stencil[idx])
        if w == 0.0:
            continue
        slices = tuple(slice(k, k + s) for k, s in zip(idx, shape))
        term = w * up[slices]
        out = term if out is None else out + term
    if out is None:
        out = jnp.zeros_like(u)
    return out


def apply_stencil_np(u: np.ndarray, stencil: np.ndarray) -> np.ndarray:
    """Numpy mirror of :func:`apply_stencil` (same pad/slice convention).

    Used by host-native solver paths (e.g. the ordering-parity ILU GMRES,
    ``solvers/solver.py::_build_host_parity_ilu_solver``) so their timed
    bodies never touch the device: a jitted dispatch plus readback per
    solve would add device round trips to a pure host solve.
    Kept in lockstep with ``apply_stencil`` by
    ``tests/test_ordering.py::test_host_lifted_rhs_matches_device``.
    """
    d = u.ndim
    up = np.pad(u, 1)
    out = np.zeros_like(u)
    for idx in itertools.product(range(3), repeat=d):
        w = float(stencil[idx])
        if w == 0.0:
            continue
        slices = tuple(slice(k, k + s) for k, s in zip(idx, u.shape))
        out += w * up[slices]
    return out
