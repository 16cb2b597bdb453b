"""Structured meshes on the unit square / unit cube.

The reference builds meshes through Firedrake's DMPlex
(``/root/reference/src/perphil/mesh/builtin.py:4-20`` for 2D,
``fd.UnitCubeMesh`` in ``experiments/petsc_profiling_3d.py:30-31`` and
``notebooks/condition-number-study-3d.py:66`` for 3D). All of perphil's
workloads run on *uniform tensor-product* meshes, so this rebuild stores no
connectivity at all: a mesh is shape metadata, and every derived quantity
(coordinates, boundary masks, DoF numbering, element adjacency) is index
arithmetic. This is what makes assembly and SpMV stencil-shaped and therefore
XLA friendly.

Element types:
  - ``quad`` / ``hex``: tensor-product Q1 cells (Firedrake ``quadrilateral=True``
    and ``hexahedral=True``).
  - ``triangle``: each grid square split in two (Firedrake's default
    ``UnitSquareMesh``); ``diagonal="left"`` matches the Firedrake default.
  - ``tet``: Kuhn/Freudenthal subdivision of each grid cube into 6 tetrahedra
    (Firedrake's default ``UnitCubeMesh``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Tuple

import numpy as np

_SIMPLEX_MULTIPLICITY = {"quad": 1, "hex": 1, "triangle": 2, "tet": 6}


@dataclass(frozen=True)
class StructuredMesh:
    """A uniform structured mesh of the unit box [0,1]^d.

    :param cells: number of grid cells per dimension, ordered (nx, ny[, nz]).
    :param element: one of "quad", "triangle", "hex", "tet".
    :param diagonal: split direction for simplicial meshes ("left" matches the
        Firedrake ``UnitSquareMesh`` default).
    """

    cells: Tuple[int, ...]
    element: str = "quad"
    diagonal: str = "left"
    extent: Tuple[float, ...] = field(default=())

    def __post_init__(self):
        if self.element not in _SIMPLEX_MULTIPLICITY:
            raise ValueError(f"Unknown element type: {self.element!r}")
        dim = 2 if self.element in ("quad", "triangle") else 3
        if len(self.cells) != dim:
            raise ValueError(
                f"{self.element} mesh needs {dim} cell counts, got {self.cells}"
            )
        if any(n < 1 for n in self.cells):
            raise ValueError(f"Cell counts must be >= 1, got {self.cells}")
        if not self.extent:
            object.__setattr__(self, "extent", (1.0,) * dim)

    # -- basic metadata -------------------------------------------------

    @property
    def dim(self) -> int:
        """Geometric/topological dimension."""
        return len(self.cells)

    @property
    def h(self) -> Tuple[float, ...]:
        """Grid spacing per dimension (hx, hy[, hz])."""
        return tuple(e / n for e, n in zip(self.extent, self.cells))

    @property
    def node_shape(self) -> Tuple[int, ...]:
        """Vertex-grid array shape, slowest-varying axis first.

        2D: (ny+1, nx+1) so that arrays index as ``u[j, i]``;
        3D: (nz+1, ny+1, nx+1) indexing as ``u[k, j, i]``.
        """
        return tuple(n + 1 for n in reversed(self.cells))

    @property
    def num_vertices(self) -> int:
        return int(np.prod(self.node_shape))

    @property
    def num_cells(self) -> int:
        """Number of FE cells, counting simplicial subdivision (mirrors
        Firedrake's cell count used in ``petsc_profiling.py:761``)."""
        return int(np.prod(self.cells)) * _SIMPLEX_MULTIPLICITY[self.element]

    @property
    def is_tensor_product(self) -> bool:
        """True for quad/hex cells (enables the exact fast-diagonalization
        direct solver)."""
        return self.element in ("quad", "hex")

    # -- geometry -------------------------------------------------------

    def coordinates(self) -> Tuple[np.ndarray, ...]:
        """Vertex coordinate grids (X, Y[, Z]), each of shape ``node_shape``.

        Returned in coordinate order (x first), each array indexed
        grid-style ([k, j, i] in 3D).
        """
        axes_1d = [
            np.linspace(0.0, e, n + 1) for e, n in zip(self.extent, self.cells)
        ]
        # meshgrid with indexing "ij" over reversed axes gives grid-style
        # arrays; reverse the result back to coordinate order.
        grids = np.meshgrid(*reversed(axes_1d), indexing="ij")
        return tuple(reversed(grids))

    def boundary_mask(self) -> np.ndarray:
        """Boolean grid marking vertices on the domain boundary
        ("on_boundary" in the reference's DirichletBC convention,
        ``experiments/convergence_2d.py:57-64``)."""
        mask = np.zeros(self.node_shape, dtype=bool)
        for axis in range(len(self.node_shape)):
            sl_lo = [slice(None)] * len(self.node_shape)
            sl_hi = [slice(None)] * len(self.node_shape)
            sl_lo[axis] = 0
            sl_hi[axis] = -1
            mask[tuple(sl_lo)] = True
            mask[tuple(sl_hi)] = True
        return mask

    def interior_mask(self) -> np.ndarray:
        return ~self.boundary_mask()

    @property
    def num_interior_vertices(self) -> int:
        return int(np.prod([n - 1 for n in self.cells]))

    def hmax(self) -> float:
        """Largest cell diameter (matches ``1/N`` bookkeeping of
        ``convergence_2d.py:80-83`` for unit square meshes)."""
        return math.sqrt(sum(hi * hi for hi in self.h))


def create_mesh(num_x: int, num_y: int, quadrilateral: bool = True) -> StructuredMesh:
    """2D unit-square mesh (API parity with
    ``/root/reference/src/perphil/mesh/builtin.py:4-20``).

    :param num_x: cells in x.
    :param num_y: cells in y.
    :param quadrilateral: quads (True, default) or triangles.
    """
    return StructuredMesh(
        cells=(num_x, num_y), element="quad" if quadrilateral else "triangle"
    )


def create_cube_mesh(
    num_x: int, num_y: int, num_z: int, hexahedral: bool = False
) -> StructuredMesh:
    """3D unit-cube mesh.

    Mirrors ``fd.UnitCubeMesh(nx, ny, nz)`` (tetrahedral by default, used by
    ``experiments/petsc_profiling_3d.py:30-31``) and
    ``fd.UnitCubeMesh(..., hexahedral=True)`` (used by
    ``notebooks/condition-number-study-3d.py:66``).
    """
    return StructuredMesh(
        cells=(num_x, num_y, num_z), element="hex" if hexahedral else "tet"
    )
