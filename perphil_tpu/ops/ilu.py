"""Structured ILU(0) and pointwise Gauss-Seidel with wavefront scheduling.

JAX replacement for PETSc's ``pc_type: ilu`` (``pc_factor_levels: 0``,
reference ``solvers/parameters.py:27``) and the pointwise nonlinear
Gauss-Seidel behind ``snes_type: ngs`` (``parameters.py:71-77``; PETSc's
default NGS is a coloring-based pointwise secant sweep — the reference's
nested fieldsplit options are inert for it, so the observed Picard iteration
counts are those of pointwise GS).

Both algorithms are inherently sequential in row order. On a structured
grid the dependency graph of the natural (lexicographic, field-major)
ordering admits a *wavefront* schedule: with the level function

    level(field, x, y, z) = x + 2 y + 4 z + field * (max|level step| + 1)

every row depends only on strictly lower levels, so each level is a
data-parallel batch. Factorization runs once on the host (numpy, vectorized
per level); triangular solves and GS sweeps run on device as a
``lax.scan`` over padded level batches.

Matrix storage is structural: every row holds the same static offset list
(block shift x geometric 3^d stencil offsets); entries that fall outside the
grid are masked. On quads/hexes this equals PETSc's allocated AIJ pattern
(every offset couples), so 2D ILU iteration counts match the reference
exactly. On simplex meshes the 3^d envelope carries explicit zeros at
never-coupled offsets (12 of 27 for tets) that PETSc does not allocate —
extra ILU(0) fill positions that make this a strictly STRONGER
preconditioner: 3D tet GMRES+ILU counts are 4/7/12/21 at nx=4/8/16/32 vs
the reference's 6/8/15/26 (up to 24% fewer). The reference counts are
reproduced exactly by the finite-element pattern + cell-RCM (DMPlex-like)
ordering; see ``ops/ordering.py``, ``experiments/ordering_study.py`` and
the committed ``ordering_sensitivity.csv`` for the full sensitivity study.
Pointwise-GS sweep counts are ordering-insensitive to within a few percent
(same study); the Picard ngs gap vs the reference (~10-20%) is dominated by
SNES convergence-test details, not ordering.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from perphil_tpu.mesh.structured import StructuredMesh
from perphil_tpu.models.dpp.parameters import DPPParameters
from perphil_tpu.ops.stencil import compile_stencils

_LAMBDA = (1, 2, 4)  # level weights per coordinate (x, y, z)


def _geom_offsets(d: int) -> List[Tuple[int, ...]]:
    """All 3^d stencil offsets in coordinate order (x, y[, z])."""
    rng = (-1, 0, 1)
    if d == 2:
        return [(dx, dy) for dy in rng for dx in rng]
    return [(dx, dy, dz) for dz in rng for dy in rng for dx in rng]


@dataclass
class StructuredSystem:
    """A block-structured sparse matrix with static per-row offset lists.

    :param mesh: the structured mesh (geometry / strides).
    :param nfields: 1 (single block) or 2 (monolithic DPP).
    :param vals: (nrows, noffs) float array of entries.
    :param deltas: global flat column deltas per offset.
    :param valid: (nrows, noffs) bool mask of structurally-present entries.
    """

    mesh: StructuredMesh
    nfields: int
    vals: np.ndarray
    deltas: np.ndarray
    blocks: np.ndarray
    geoms: np.ndarray
    valid: np.ndarray
    levels: List[np.ndarray]

    @property
    def n_nodes(self) -> int:
        return self.mesh.num_vertices

    @property
    def nrows(self) -> int:
        return self.n_nodes * self.nfields

    @property
    def center_index(self) -> int:
        return int(np.where((self.blocks == 0) & (self.geoms == 0).all(axis=1))[0][0])


def _build_system(
    mesh: StructuredMesh,
    block_stencils,  # dict {(row_field, col_field): stencil ndarray}
    nfields: int,
) -> StructuredSystem:
    d = mesh.dim
    shape = mesh.node_shape  # slowest-first
    n = mesh.num_vertices
    geoms = _geom_offsets(d)
    blocks = list(range(-(nfields - 1), nfields))  # {-1,0,1} or {0}
    # strides in coordinate order (x fastest)
    strides = [1]
    for ax in range(1, d):
        strides.append(strides[-1] * shape[d - ax])
    strides = np.array(strides)  # coordinate-ordered

    pos = np.stack(
        [g.ravel() for g in np.meshgrid(*[np.arange(s) for s in shape], indexing="ij")][::-1],
        axis=1,
    )  # (n, d) coordinate-ordered positions
    bdry = mesh.boundary_mask().ravel()

    noffs = len(blocks) * len(geoms)
    nrows = n * nfields
    vals = np.zeros((nrows, noffs))
    valid = np.zeros((nrows, noffs), dtype=bool)
    deltas = np.zeros(noffs, dtype=np.int64)
    blk_arr = np.zeros(noffs, dtype=np.int64)
    geom_arr = np.zeros((noffs, d), dtype=np.int64)

    for t, (bd, g) in enumerate(((bd, g) for bd in blocks for g in geoms)):
        deltas[t] = bd * n + int(np.dot(g, strides))
        blk_arr[t] = bd
        geom_arr[t] = g
        gnp = np.asarray(g)
        geo_ok = ((pos + gnp) >= 0).all(axis=1) & ((pos + gnp) < pos.max(axis=0) + 1).all(axis=1)
        col_bdry = np.zeros(n, dtype=bool)
        col_idx = np.clip(pos + gnp, 0, np.asarray(shape[::-1]) - 1)
        flat_col = col_idx @ strides
        col_bdry = bdry[flat_col]
        for f in range(nfields):
            cf = f + bd
            rows = slice(f * n, (f + 1) * n)
            if cf < 0 or cf >= nfields:
                continue
            st = block_stencils.get((f, cf))
            if st is None:
                continue
            # stencil indexed slowest-first: reverse the geometric offset
            w = float(st[tuple(int(o) + 1 for o in reversed(g))])
            v = np.where(geo_ok, w, 0.0)
            # symmetric BC elimination: zero bc rows and bc cols
            v = np.where(bdry | col_bdry, 0.0, v)
            if bd == 0 and (gnp == 0).all():
                v = np.where(bdry, 1.0, v)  # unit diagonal at bc rows
            vals[rows, t] = v
            valid[rows, t] = geo_ok

    # wavefront levels
    lam = np.asarray(_LAMBDA[:d])
    sched = pos @ lam
    shift = int(np.abs(np.asarray(geoms) @ lam).max()) + 1
    levels_key = np.concatenate([sched + f * shift for f in range(nfields)])
    order = np.argsort(levels_key, kind="stable")
    keys_sorted = levels_key[order]
    boundaries = np.flatnonzero(np.diff(keys_sorted)) + 1
    levels = [lv.astype(np.int64) for lv in np.split(order, boundaries)]

    return StructuredSystem(
        mesh=mesh,
        nfields=nfields,
        vals=vals,
        deltas=deltas,
        blocks=blk_arr,
        geoms=geom_arr,
        valid=valid,
        levels=levels,
    )


def build_monolithic_system(mesh: StructuredMesh, params: DPPParameters) -> StructuredSystem:
    """Field-major 2-field DPP matrix in structured form."""
    K_st, M_st = compile_stencils(mesh)
    p = params
    S1 = (p.k1 / p.mu) * K_st + (p.beta / p.mu) * M_st
    S2 = (p.k2 / p.mu) * K_st + (p.beta / p.mu) * M_st
    C = -(p.beta / p.mu) * M_st
    return _build_system(mesh, {(0, 0): S1, (1, 1): S2, (0, 1): C, (1, 0): C}, 2)


def build_field_system(mesh: StructuredMesh, k: float, beta: float, mu: float) -> StructuredSystem:
    K_st, M_st = compile_stencils(mesh)
    S = (k / mu) * K_st + (beta / mu) * M_st
    return _build_system(mesh, {(0, 0): S}, 1)


# ---------------------------------------------------------------------------
# ILU(0) factorization (host, level-vectorized)
# ---------------------------------------------------------------------------


def _factorization_tables(sys: StructuredSystem):
    """Shared precomputation: lower-offset order, offset-difference map, and
    per-k upper-update lists."""
    deltas = sys.deltas
    noffs = deltas.shape[0]
    order_lower = [t for t in np.argsort(deltas) if deltas[t] < 0]
    # offset-difference map: m[k][j] = index with delta == delta_j - delta_k
    # (and matching block/geom difference), or -1
    key = {(int(b), tuple(int(x) for x in g)): t for t, (b, g) in enumerate(zip(sys.blocks, sys.geoms))}
    mmap = -np.ones((noffs, noffs), dtype=np.int64)
    for k in range(noffs):
        for j in range(noffs):
            db = int(sys.blocks[j] - sys.blocks[k])
            dg = tuple(int(x) for x in (sys.geoms[j] - sys.geoms[k]))
            t = key.get((db, dg), -1)
            if t >= 0:
                mmap[k, j] = t
    uppers_of = {
        k: [j for j in range(noffs) if deltas[j] > deltas[k] and mmap[k, j] >= 0]
        for k in order_lower
    }
    return order_lower, mmap, uppers_of


def ilu0_factorize(sys: StructuredSystem) -> np.ndarray:
    """In-pattern incomplete LU with no fill outside the structural pattern.

    Returns a new (nrows, noffs) array holding L (unit diagonal implied,
    entries at lower offsets) and U (diagonal + upper offsets), like PETSc's
    combined factor storage. Uses the native C++ kernel when available
    (``csrc/structured_ilu.cpp``), else the level-vectorized numpy fallback.
    """
    order_lower, mmap, uppers_of = _factorization_tables(sys)

    from perphil_tpu import _native

    lib = _native.load()
    if lib is not None:
        import ctypes

        vals = np.ascontiguousarray(sys.vals, dtype=np.float64).copy()
        deltas = np.ascontiguousarray(sys.deltas, dtype=np.int64)
        valid = np.ascontiguousarray(sys.valid, dtype=np.uint8)
        lower = np.ascontiguousarray(order_lower, dtype=np.int64)
        mmap_c = np.ascontiguousarray(mmap, dtype=np.int64)
        uppers_list, uptr = [], [0]
        for k in order_lower:
            uppers_list.extend(uppers_of[k])
            uptr.append(len(uppers_list))
        uppers = np.ascontiguousarray(uppers_list or [0], dtype=np.int64)
        uppers_ptr = np.ascontiguousarray(uptr, dtype=np.int64)

        def p64(a):
            return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))

        lib.ilu0_factorize(
            vals.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            p64(deltas),
            valid.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            sys.nrows,
            deltas.shape[0],
            p64(lower),
            len(order_lower),
            p64(mmap_c),
            p64(uppers),
            p64(uppers_ptr),
            sys.center_index,
        )
        return vals

    return _ilu0_factorize_numpy(sys, order_lower, mmap, uppers_of)


def _ilu0_factorize_numpy(sys: StructuredSystem, order_lower, mmap, uppers_of) -> np.ndarray:
    """Level-vectorized numpy fallback (bit-identical to the native path)."""
    vals = sys.vals.copy()
    deltas = sys.deltas
    center = sys.center_index
    nrows = sys.nrows

    for R in sys.levels:
        for k in order_lower:
            a_ik = vals[R, k]
            nz = a_ik != 0.0
            if not nz.any():
                continue
            pivot_rows = np.clip(R + deltas[k], 0, nrows - 1)
            piv = vals[pivot_rows, center]
            piv_safe = np.where(piv != 0.0, piv, 1.0)
            f = np.where(nz, a_ik / piv_safe, 0.0)
            vals[R, k] = f
            for j in uppers_of[k]:
                m = mmap[k, j]
                upd = f * vals[pivot_rows, m]
                # restrict fill to the structural pattern
                vals[R, j] = np.where(sys.valid[R, j], vals[R, j] - upd, 0.0)
    return vals


# ---------------------------------------------------------------------------
# parallel-prefix (scan-tree) triangular applications — the fast path
# ---------------------------------------------------------------------------


def _trisolve_backend() -> str:
    import os

    return os.environ.get("PERPHIL_TPU_TRISOLVE", "partri")


# Dense plane maps in 3D cost ~2 * nz * (ny*nx)^2 floats per directional
# solver; the total (all solvers of one PC) may take at most this fraction
# of the device's memory limit before the PC falls back to the wavefront
# path. The largest published 3D ILU case (nx=40 monolithic) needs ~3.7 GiB.
_PARTRI_MEMORY_FRACTION = 0.375


def _partri_max_bytes() -> int:
    """The partri byte cap: ``_PARTRI_MEMORY_FRACTION`` of the default
    device's ``bytes_limit``; backends that report no limit (XLA:CPU) use
    the host's physical memory instead."""
    import os

    stats = jax.devices()[0].memory_stats() or {}
    limit = stats.get("bytes_limit")
    if not limit:
        limit = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    return int(_PARTRI_MEMORY_FRACTION * limit)


def _partri_fits(sys: StructuredSystem, itemsize: int) -> bool:
    if sys.mesh.dim == 2:
        ny, nx = sys.mesh.node_shape
        per = 2 * ny * nx * nx * itemsize
    else:
        nz, ny, nx = sys.mesh.node_shape
        per = 2 * nz * (ny * nx) ** 2 * itemsize
    return 2 * sys.nfields * per <= _partri_max_bytes()


def _grid_entries(sys: StructuredSystem, values: np.ndarray, f: int, bd: int, dtype):
    """Per-offset entry grids of one (row-field, block) pair.

    Returns {coordinate-ordered geom offset: (node_shape) jnp grid}.
    """
    n = sys.n_nodes
    shape = sys.mesh.node_shape
    key = {
        (int(b), tuple(int(x) for x in g)): t
        for t, (b, g) in enumerate(zip(sys.blocks, sys.geoms))
    }
    out = {}
    for g in _geom_offsets(sys.mesh.dim):
        t = key.get((bd, g))
        if t is None:
            continue
        col = values[f * n : (f + 1) * n, t]
        out[g] = jnp.asarray(col.reshape(shape), dtype=dtype)
    return out


def _flip_all(a: jnp.ndarray) -> jnp.ndarray:
    return jnp.flip(a, axis=tuple(range(a.ndim)))


class DirTriSolve:
    """Directional triangular solve ``(D? + A) x = r`` on one field's grid.

    ``entries`` maps coordinate-ordered geometric offsets (the strictly
    lower/upper part) to raw matrix-entry grids; ``diag`` is the diagonal
    grid (None = unit). ``reverse=True`` solves in anti-lexicographic order
    (upper solves) by flipping every axis. Pytree-registered so it can be
    built under jit and passed as a compiled-solver argument.
    """

    def __init__(self, dim: int, entries: dict, diag, reverse: bool):
        from perphil_tpu.ops.partri import GridTriSolve2D, GridTriSolve3D

        self.reverse = bool(reverse)
        if reverse:
            entries = {
                tuple(-int(o) for o in g): _flip_all(w) for g, w in entries.items()
            }
            diag = _flip_all(diag) if diag is not None else None
        self.diag = diag

        def nrm(g: Tuple[int, ...]) -> jnp.ndarray:
            w = -entries[g]
            return w / diag if diag is not None else w

        if dim == 2:
            self.solver = GridTriSolve2D(
                nrm((-1, 0)), nrm((-1, -1)), nrm((0, -1)), nrm((1, -1))
            )
        else:
            from perphil_tpu.ops import partri

            # Build the plane solver FULL precision even under a bf16
            # weight-dtype scope: GridTriSolve3D densifies its plane maps
            # through plane.apply, and that composition must run in f32
            # (the 3D solver truncates the plane's stored maps afterwards).
            with partri.weight_dtype(None):
                plane = GridTriSolve2D(
                    nrm((-1, 0, 0)), nrm((-1, -1, 0)), nrm((0, -1, 0)), nrm((1, -1, 0))
                )
            bz = {
                (dx, dy): nrm((dx, dy, -1)) for dy in (-1, 0, 1) for dx in (-1, 0, 1)
            }
            self.solver = GridTriSolve3D(plane, bz)

    def tree_flatten(self):
        return (self.solver, self.diag), (self.reverse,)

    @classmethod
    def tree_unflatten(cls, aux, children):
        obj = object.__new__(cls)
        obj.solver, obj.diag = children
        (obj.reverse,) = aux
        return obj

    def __call__(self, r: jnp.ndarray) -> jnp.ndarray:
        if self.reverse:
            r = _flip_all(r)
        c = r / self.diag if self.diag is not None else r
        x = self.solver.apply(c)
        if self.reverse:
            x = _flip_all(x)
        return x


class PartriILU:
    """ILU(0) application ``z = U^{-1} L^{-1} r`` via parallel-prefix
    triangular solves (field-major natural ordering; see ``ops/partri``).

    For the monolithic 2-field system the lower factor visits all field-0
    rows before field-1 rows, so L^{-1} = (field-0 grid solve) then
    (field-1 grid solve with the cross-block contribution subtracted);
    U^{-1} mirrors this bottom-up.

    Pytree-registered; build with :func:`build_partri_ilu` (single compiled
    setup program).
    """

    def __init__(self, sys: StructuredSystem, factors, dtype):
        mesh = sys.mesh
        d = mesh.dim
        self.nfields = sys.nfields
        self.shape = mesh.node_shape
        self.n = sys.n_nodes
        center = (0,) * d

        self.lower_solve = []
        self.upper_solve = []
        for f in range(sys.nfields):
            ent = _grid_entries(sys, factors, f, 0, dtype)
            diag = ent[center]
            low = {g: w for g, w in ent.items() if _is_lower_geom(g, self.shape)}
            upp = {
                g: w
                for g, w in ent.items()
                if not _is_lower_geom(g, self.shape) and g != center
            }
            self.lower_solve.append(DirTriSolve(d, low, None, reverse=False))
            self.upper_solve.append(DirTriSolve(d, upp, diag, reverse=True))
        self.cross_lower = None
        self.cross_upper = None
        if sys.nfields == 2:
            self.cross_lower = _grid_entries(sys, factors, 1, -1, dtype)  # f1 rows
            self.cross_upper = _grid_entries(sys, factors, 0, +1, dtype)  # f0 rows

    def tree_flatten(self):
        children = (self.lower_solve, self.upper_solve, self.cross_lower, self.cross_upper)
        return children, (self.nfields, self.shape, self.n)

    @classmethod
    def tree_unflatten(cls, aux, children):
        obj = object.__new__(cls)
        obj.lower_solve, obj.upper_solve, obj.cross_lower, obj.cross_upper = children
        obj.nfields, obj.shape, obj.n = aux
        return obj

    def apply_flat(self, r: jnp.ndarray) -> jnp.ndarray:
        from perphil_tpu.ops.partri import apply_varcoef_stencil

        n = self.n
        if self.nfields == 1:
            y = self.lower_solve[0](r.reshape(self.shape))
            return self.upper_solve[0](y).reshape(r.shape)
        r1 = r[:n].reshape(self.shape)
        r2 = r[n:].reshape(self.shape)
        y1 = self.lower_solve[0](r1)
        y2 = self.lower_solve[1](r2 - apply_varcoef_stencil(y1, self.cross_lower))
        z2 = self.upper_solve[1](y2)
        z1 = self.upper_solve[0](y1 - apply_varcoef_stencil(z2, self.cross_upper))
        return jnp.concatenate([z1.ravel(), z2.ravel()])


class PartriGS:
    """One forward pointwise Gauss-Seidel sweep via parallel-prefix solves:
    ``x_new = (D + L)^{-1} (b - U x_old)`` in lexicographic field-major order
    (exactly the wavefront sweep's algebra, log-depth on device).
    Pytree-registered; build with :func:`build_partri_gs`."""

    def __init__(self, sys: StructuredSystem, values, dtype):
        mesh = sys.mesh
        d = mesh.dim
        self.nfields = sys.nfields
        self.shape = mesh.node_shape
        self.n = sys.n_nodes
        center = (0,) * d

        self.ld_solve = []
        self.upper_entries = []
        for f in range(sys.nfields):
            ent = _grid_entries(sys, values, f, 0, dtype)
            diag = ent[center]
            low = {g: w for g, w in ent.items() if _is_lower_geom(g, self.shape)}
            upp = {
                g: w
                for g, w in ent.items()
                if not _is_lower_geom(g, self.shape) and g != center
            }
            self.ld_solve.append(DirTriSolve(d, low, diag, reverse=False))
            self.upper_entries.append(upp)
        self.cross_lower = None
        self.cross_upper = None
        if sys.nfields == 2:
            self.cross_lower = _grid_entries(sys, values, 1, -1, dtype)
            self.cross_upper = _grid_entries(sys, values, 0, +1, dtype)

    def tree_flatten(self):
        children = (
            self.ld_solve,
            self.upper_entries,
            self.cross_lower,
            self.cross_upper,
        )
        return children, (self.nfields, self.shape, self.n)

    @classmethod
    def tree_unflatten(cls, aux, children):
        obj = object.__new__(cls)
        obj.ld_solve, obj.upper_entries, obj.cross_lower, obj.cross_upper = children
        obj.nfields, obj.shape, obj.n = aux
        return obj

    def sweep_flat(self, x: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
        from perphil_tpu.ops.partri import apply_varcoef_stencil

        n = self.n
        if self.nfields == 1:
            c = b.reshape(self.shape) - apply_varcoef_stencil(
                x.reshape(self.shape), self.upper_entries[0]
            )
            return self.ld_solve[0](c).reshape(x.shape)
        x1 = x[:n].reshape(self.shape)
        x2 = x[n:].reshape(self.shape)
        b1 = b[:n].reshape(self.shape)
        b2 = b[n:].reshape(self.shape)
        c1 = (
            b1
            - apply_varcoef_stencil(x1, self.upper_entries[0])
            - apply_varcoef_stencil(x2, self.cross_upper)
        )
        y1 = self.ld_solve[0](c1)
        c2 = (
            b2
            - apply_varcoef_stencil(x2, self.upper_entries[1])
            - apply_varcoef_stencil(y1, self.cross_lower)
        )
        y2 = self.ld_solve[1](c2)
        return jnp.concatenate([y1.ravel(), y2.ravel()])


def _is_lower_geom(g, shape) -> bool:
    """Lexicographic comparison via strides: flat delta < 0 <=> lower."""
    d = len(shape)
    strides = [1]
    for ax in range(1, d):
        strides.append(strides[-1] * shape[d - ax])
    return int(np.dot(g, strides)) < 0


for _cls in (DirTriSolve, PartriILU, PartriGS):
    jax.tree_util.register_pytree_node(_cls, _cls.tree_flatten, _cls.tree_unflatten)


def build_partri_ilu(sys: StructuredSystem, factors: np.ndarray, dtype) -> PartriILU:
    """Build the parallel-prefix ILU applier in ONE compiled program (eager
    construction would dispatch thousands of tiny ops one by one)."""
    F = jnp.asarray(factors, dtype=dtype)
    return jax.jit(lambda F_: PartriILU(sys, F_, dtype))(F)


def build_partri_gs(sys: StructuredSystem, values, dtype) -> PartriGS:
    """Build the parallel-prefix GS sweeper in one compiled program."""
    V = jnp.asarray(values, dtype=dtype)
    return jax.jit(lambda V_: PartriGS(sys, V_, dtype))(V)


# ---------------------------------------------------------------------------
# device-side wavefront kernels
# ---------------------------------------------------------------------------


def _padded_levels(sys: StructuredSystem, unroll: int = 1) -> np.ndarray:
    """Pad the wavefront schedule to (L/unroll, unroll, W): each scan step
    processes ``unroll`` consecutive levels sequentially in its body,
    trading per-step loop overhead for a longer (static) body — the scan
    step cost dominates the device-side sweeps at large N."""
    width = max(len(lv) for lv in sys.levels)
    nlv = len(sys.levels)
    nsteps = -(-nlv // unroll)
    out = np.full((nsteps * unroll, width), sys.nrows, dtype=np.int32)
    for i, lv in enumerate(sys.levels):
        out[i, : len(lv)] = lv
    return out.reshape(nsteps, unroll, width)


def _wavefront_unroll() -> int:
    import os

    return max(1, int(os.environ.get("PERPHIL_TPU_WAVEFRONT_UNROLL", "4")))


def _leveled_clip_sweep(
    levels, vals, deltas, center, offs, rhs_ext, zext, nrows: int, scale_diag: bool
):
    """Shared wavefront kernel for the leveled clip-gather sweeps
    (``StructuredILU0`` triangular solves and ``GaussSeidelSweeper``):
    per level block, the block's rows update simultaneously as
    ``acc = rhs[rows] - sum_t vals[rows, t] * z[clip(rows + deltas[t])]``
    (invalid offsets carry zero vals, so the negative clip onto row 0 and
    the OOB landing on the zero pad row contribute nothing), optionally
    scaled by the diagonal. ``levels`` is ``(steps, unroll, width)``
    padded with ``nrows``; ``rhs_ext``/``zext`` carry one zero pad row."""
    diag_ext = jnp.concatenate([vals[:, center], jnp.ones(1, dtype=zext.dtype)])
    unroll = int(levels.shape[1])

    def step(z, rows_blk):
        for u in range(unroll):
            rows = rows_blk[u]
            acc = rhs_ext[rows]
            for t in offs:
                cols = jnp.clip(rows + deltas[t], 0, nrows)
                v = jnp.where(rows < nrows, vals[jnp.minimum(rows, nrows - 1), t], 0.0)
                acc = acc - v * z[cols]
            if scale_diag:
                acc = acc / diag_ext[rows]
            z = z.at[rows].set(jnp.where(rows < nrows, acc, z[rows]))
        return z, None

    zout, _ = jax.lax.scan(step, zext, levels)
    return zout[:nrows]


@dataclass(frozen=True)
class StructuredILU0:
    """Compiled ILU(0) preconditioner application: z = U^{-1} L^{-1} r."""

    mesh: StructuredMesh
    nfields: int
    factors: jnp.ndarray  # (nrows, noffs)
    deltas: Tuple[int, ...]
    center: int
    levels: jnp.ndarray  # (L, W) padded with nrows
    partri: Optional[PartriILU] = None
    # df32 mode: low words of the f64 factor (factors == hi words), enabling
    # apply_flat_df's defect-corrected double-float application
    factors_lo: Optional[jnp.ndarray] = None

    @classmethod
    def _from_system(
        cls, sys: StructuredSystem, dtype_mode: Optional[str] = None
    ) -> "StructuredILU0":
        import os

        f = ilu0_factorize(sys)
        # The PC application dtype: float32 by default — it halves the
        # bytes the trisolves move, and a preconditioner needs no more than
        # f32 accuracy (golden iteration counts 5/11/20 are preserved;
        # large-N counts can shift by +-1). Modes for the knife-edge cells:
        #   PERPHIL_TPU_ILU_DTYPE=float64 — full f64 (CPU parity mode);
        #   PERPHIL_TPU_ILU_DTYPE=df32    — f32 trisolves + double-float
        #     defect correction against the df-stored f64 factor
        #     (apply_flat_df): PC application accurate to ~1e-14 of
        #     PETSc's f64 ILU at f32 trisolve speed (2 extra trisolves +
        #     2 stencil matvecs per apply).
        # The env var overrides the caller's dtype_mode either way.
        mode = os.environ.get("PERPHIL_TPU_ILU_DTYPE", dtype_mode or "float32")
        df_mode = mode == "df32"
        dtype = jnp.dtype("float32" if df_mode else mode)
        f_hi = np.asarray(f, dtype=np.float32)
        f_lo = np.asarray(f - f_hi.astype(np.float64), dtype=np.float32)
        partri = None
        if _trisolve_backend() == "partri" and _partri_fits(sys, dtype.itemsize):
            partri = build_partri_ilu(sys, f, dtype)
        return cls(
            mesh=sys.mesh,
            nfields=sys.nfields,
            factors=jnp.asarray(f_hi) if df_mode else jnp.asarray(f, dtype=dtype),
            deltas=tuple(int(x) for x in sys.deltas),
            center=sys.center_index,
            levels=jnp.asarray(_padded_levels(sys, _wavefront_unroll())),
            partri=partri,
            factors_lo=jnp.asarray(f_lo) if df_mode else None,
        )

    @classmethod
    def for_monolithic(cls, op, dtype_mode: Optional[str] = None) -> "StructuredILU0":
        return cls._from_system(
            build_monolithic_system(op.mesh, op.params), dtype_mode
        )

    @classmethod
    def for_field(cls, fop, dtype_mode: Optional[str] = None) -> "StructuredILU0":
        return cls._from_system(
            build_field_system(fop.mesh, fop.k, fop.beta, fop.mu), dtype_mode
        )

    def _sweep(self, rhs: jnp.ndarray, offs: Sequence[int], z0, reverse: bool, scale_diag: bool):
        nrows = rhs.shape[0]
        # (steps, unroll, width); reverse sweeps flip both step and
        # intra-step order
        levels = self.levels[::-1, ::-1] if reverse else self.levels
        zext = jnp.concatenate([z0, jnp.zeros(1, dtype=rhs.dtype)])
        rhs_ext = jnp.concatenate([rhs, jnp.zeros(1, dtype=rhs.dtype)])
        return _leveled_clip_sweep(
            levels, self.factors, self.deltas, self.center,
            offs, rhs_ext, zext, nrows, scale_diag,
        )

    def apply_flat(self, r: jnp.ndarray) -> jnp.ndarray:
        """z = U^{-1} (L^{-1} r) with unit-lower L (computed in the factor
        dtype — float32 by default — and cast back). Uses the parallel-prefix
        path when built (default), else the wavefront sweeps."""
        out_dtype = r.dtype
        r = r.astype(self.factors.dtype)
        if self.partri is not None:
            return self.partri.apply_flat(r).astype(out_dtype)
        lower = tuple(t for t, d in enumerate(self.deltas) if d < 0)
        upper = tuple(t for t, d in enumerate(self.deltas) if d > 0)
        y = self._sweep(r, lower, jnp.zeros_like(r), reverse=False, scale_diag=False)
        z = self._sweep(y, upper, jnp.zeros_like(r), reverse=True, scale_diag=True)
        return z.astype(out_dtype)

    def apply_grid(self, r: jnp.ndarray) -> jnp.ndarray:
        """Single-field convenience: grid -> grid."""
        shape = r.shape
        return self.apply_flat(r.ravel()).reshape(shape)

    # -- double-float application (PERPHIL_TPU_ILU_DTYPE=df32) ------------

    def _df_taps(self, z_df, taps, with_identity: bool, scale_center: bool):
        """df matvec over a subset of the factor's offsets:
        ``y_i = [z_i] + sum_t f[i,t] * z_{i+delta_t}`` with error-free tap
        products against the df-stored f64 factor (two_prod hi*hi + cross
        terms). Out-of-range taps read a zero pad (invalid offsets carry
        zero factor values, matching _leveled_clip_sweep's clip semantics)."""
        from perphil_tpu.ops.df32 import df_add, fast_two_sum, two_prod

        zh, zl = z_df
        n = zh.shape[0]
        deltas = self.deltas
        maxneg = max(0, -min(deltas))
        maxpos = max(0, max(deltas))
        zh_p = jnp.pad(zh, (maxneg, maxpos))
        zl_p = jnp.pad(zl, (maxneg, maxpos))
        if with_identity:
            acc = (zh, zl)
        else:
            acc = (jnp.zeros_like(zh), jnp.zeros_like(zh))
        for t in taps:
            d = deltas[t]
            sh = jax.lax.dynamic_slice_in_dim(zh_p, maxneg + d, n)
            sl = jax.lax.dynamic_slice_in_dim(zl_p, maxneg + d, n)
            fh = self.factors[:, t]
            fl = self.factors_lo[:, t]
            p, e = two_prod(fh, sh)
            e = e + fh * sl + fl * sh
            acc = df_add(acc, fast_two_sum(p, e))
        if scale_center:
            c = self.center
            fh = self.factors[:, c]
            fl = self.factors_lo[:, c]
            p, e = two_prod(fh, zh)
            e = e + fh * zl + fl * zh
            acc = df_add(acc, fast_two_sum(p, e))
        return acc

    def _lu_matvec_df(self, z_df):
        """``M z`` for the factored ``M = L U`` in double-float: U has the
        stored diagonal + upper offsets, L is unit-lower."""
        uppers = tuple(t for t, d in enumerate(self.deltas) if d > 0)
        lowers = tuple(t for t, d in enumerate(self.deltas) if d < 0)
        uz = self._df_taps(z_df, uppers, with_identity=False, scale_center=True)
        return self._df_taps(uz, lowers, with_identity=True, scale_center=False)

    def apply_flat_df(self, r_df, n_refine: int = 1):
        """Double-float PC application ``z ~= M^{-1} r`` by defect
        correction: f32 trisolves against the hi factor, residuals against
        the df-stored f64 factor. One refinement contracts the application
        error from ~eps_f32 to ~eps_f32^2 ~= eps_df, so the applied
        preconditioner matches PETSc's f64 ILU to double-float accuracy
        while every trisolve stays f32 (the knife-edge 2D N=64 GMRES+ILU
        cell needs this; docs/design.md §7). Requires df32 mode
        (PERPHIL_TPU_ILU_DTYPE=df32)."""
        from perphil_tpu.ops.df32 import df_add
        from perphil_tpu.ops.dfvec import df_vec_sub

        if self.factors_lo is None:
            raise ValueError(
                "apply_flat_df needs the df-stored factor: set "
                "PERPHIL_TPU_ILU_DTYPE=df32 before building the PC"
            )
        z32 = self.apply_flat(r_df[0] + r_df[1])
        z = (z32, jnp.zeros_like(z32))
        for _ in range(int(n_refine)):
            s = df_vec_sub(r_df, self._lu_matvec_df(z))
            c32 = self.apply_flat(s[0] + s[1])
            z = df_add(z, (c32, jnp.zeros_like(c32)))
        return z


@dataclass(frozen=True)
class GaussSeidelSweeper:
    """Forward pointwise Gauss-Seidel sweeps over the monolithic system —
    the analogue of PETSc's default SNES NGS (pointwise secant GS)."""

    mesh: StructuredMesh
    nfields: int
    vals: jnp.ndarray
    deltas: Tuple[int, ...]
    center: int
    levels: jnp.ndarray
    partri: Optional[PartriGS] = None

    @classmethod
    def for_monolithic(
        cls, mesh: StructuredMesh, params: DPPParameters, dtype=None
    ) -> "GaussSeidelSweeper":
        sys = build_monolithic_system(mesh, params)
        vals = jnp.asarray(sys.vals) if dtype is None else jnp.asarray(sys.vals, dtype)
        partri = None
        if _trisolve_backend() == "partri" and _partri_fits(sys, vals.dtype.itemsize):
            partri = build_partri_gs(sys, sys.vals, vals.dtype)
        return cls(
            mesh=mesh,
            nfields=2,
            vals=vals,
            deltas=tuple(int(x) for x in sys.deltas),
            center=sys.center_index,
            levels=jnp.asarray(_padded_levels(sys, _wavefront_unroll())),
            partri=partri,
        )

    def sweep(self, x: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
        """One forward GS sweep: x_i <- (b_i - sum_{j != i} a_ij x_j)/a_ii
        in lexicographic field-major order (parallel-prefix by default,
        wavefront-scheduled fallback)."""
        if self.partri is not None:
            return self.partri.sweep_flat(x, b)
        nrows = x.shape[0]
        xext = jnp.concatenate([x, jnp.zeros(1, dtype=x.dtype)])
        b_ext = jnp.concatenate([b, jnp.zeros(1, dtype=x.dtype)])
        offs = tuple(t for t in range(len(self.deltas)) if t != self.center)
        return _leveled_clip_sweep(
            self.levels, self.vals, self.deltas, self.center,
            offs, b_ext, xext, nrows, scale_diag=True,
        )


@dataclass(frozen=True)
class ColoredNGSSweeper:
    """Multicolor secant Gauss-Seidel sweeps over the monolithic system —
    the faithful analogue of PETSc's default SNES ``ngs``
    (``SNESComputeNGSDefaultSecant``): for each color, every DoF of that
    color updates simultaneously from the current residual; for the linear
    DPP residual the secant slope is exactly the diagonal.

    With the pinned coloring draw (``ops/ordering.py::ngs_parity_coloring``)
    the sweep counts reproduce the reference's published Picard iterations
    16/63/194/635/1673/5135 at N=4..128 EXACTLY
    (``petsc_perf_breakdown-with-picard.csv``). Unlike the sequential
    ``GaussSeidelSweeper`` (a wavefront-scheduled serial recurrence), each
    color update is an embarrassingly parallel masked Jacobi step — the
    natural formulation for a vector machine.

    Exposes the same ``sweep(x, b)`` interface as ``GaussSeidelSweeper``:
    one sweep is affine in (x, b) with fixed point b = A x, so the
    error-equation identity used by the mixed-precision Picard driver
    (sweep(x, b) = x + sweep(0, b - A x)) holds unchanged.

    NOTE: the production df32 Picard driver carries a double-float twin of
    this sweep (``solvers/solver._df_sweep``) — same pinned coloring, same
    per-color diagonal-secant update. Any change to the sweep semantics
    here must be mirrored there (and vice versa), or the parity-critical
    published counts split between the native and df modes.
    """

    mesh: StructuredMesh
    nfields: int
    vals: jnp.ndarray
    deltas: Tuple[int, ...]
    center: int
    masks: jnp.ndarray  # (ncolors, nrows) bool, ascending color index

    @classmethod
    def for_monolithic(
        cls, mesh: StructuredMesh, params: DPPParameters, dtype=None
    ) -> "ColoredNGSSweeper":
        from perphil_tpu.ops.ordering import ngs_parity_coloring

        sys = build_monolithic_system(mesh, params)
        vals = jnp.asarray(sys.vals) if dtype is None else jnp.asarray(sys.vals, dtype)
        colors = ngs_parity_coloring(mesh)
        ncolors = int(colors.max()) + 1
        masks = jnp.asarray(
            np.stack([colors == c for c in range(ncolors)]), dtype=jnp.bool_
        )
        return cls(
            mesh=mesh,
            nfields=2,
            vals=vals,
            deltas=tuple(int(x) for x in sys.deltas),
            center=sys.center_index,
            masks=masks,
        )

    def _matvec(self, x: jnp.ndarray) -> jnp.ndarray:
        nrows = x.shape[0]
        xext = jnp.concatenate([x, jnp.zeros(1, dtype=x.dtype)])
        rows = jnp.arange(nrows)
        acc = jnp.zeros(nrows, dtype=x.dtype)
        for t, d in enumerate(self.deltas):
            # invalid offsets carry zero vals; clip negatives onto row 0
            cols = jnp.clip(rows + d, 0, nrows)
            acc = acc + self.vals[:, t] * xext[cols]
        return acc

    def sweep(self, x: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
        """One NGS iteration: ascending pass over the colors, each color's
        DoFs taking a simultaneous diagonal-secant step on the residual at
        the current iterate (recomputed per color, like PETSc's two
        function evaluations per color)."""
        diag = self.vals[:, self.center]
        ncolors = int(self.masks.shape[0])
        for c in range(ncolors):
            r = b - self._matvec(x)
            x = jnp.where(self.masks[c], x + r / diag, x)
        return x
