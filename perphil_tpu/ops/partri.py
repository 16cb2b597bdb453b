"""Parallel-prefix (scan-tree) exact triangular solves on structured grids.

JAX replacement for the sequential sparse triangular solves inside
PETSc's ILU(0) preconditioner application and Gauss-Seidel sweeps
(``MatSolve`` on factored AIJ matrices; reference usage via
``pc_type: ilu`` at ``/root/reference/src/perphil/solvers/parameters.py:27``
and ``snes_type: ngs`` at ``parameters.py:71-77``).

Why not a wavefront: level-scheduled sweeps (``ops/ilu.py``) take one tiny
gather/scatter step per level — thousands of latency-bound device steps per
solve. Here the same recurrences are solved *exactly* in O(log n) stages of
batched matrix-vector products — bandwidth-bound work.

The key identity: a lower-triangular solve on a structured grid in
lexicographic order is a linear recurrence

    2D:  x[y] = T_y (c[y] + B_y x[y-1])        (rows y; T_y = within-row
                                                bidiagonal inverse, B_y the
                                                three cross-row couplings)
    3D:  x[z] = T_z (c[z] + B_z x[z-1])        (planes z; T_z = within-plane
                                                2D solve, B_z the nine
                                                cross-plane couplings)

i.e. a first-order *affine* recurrence  x_t = M_t x_{t-1} + g_t  whose maps
``M_t = T_t B_t`` are data-independent (fixed per factorization). Affine maps
compose associatively::

    (M2, g2) o (M1, g1) = (M2 M1, M2 g1 + g2)

so all x_t follow from a parallel prefix scan. The matrix parts of every
tree node are precomputed once at factorization time; each solve performs
only ~2n batched matrix-vector products in ~2 log2(n) dependent stages.

Within a row (1D recurrence), maps are scalars and the same tree runs as
pure vector arithmetic (``ScalarChainScan``). In 3D the plane maps are dense
(ny*nx)^2 matrices built by applying the batched 2D solver to the sparse
cross-plane couplings — a one-time batched matmul job.

All matrix products/matvecs run with ``precision=HIGHEST`` (f32 matmuls
otherwise may run in bf16 or TF32, which would destroy the exactness this
module exists to provide).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

_PREC = jax.lax.Precision.HIGHEST


_WEIGHT_DTYPE_OVERRIDE: list = []  # scoped override stack, see weight_dtype()


def _weight_dtype():
    """Optional storage dtype for the composed chain maps
    (``PERPHIL_TPU_PARTRI_WEIGHT_DTYPE=bfloat16``, or scoped via
    :func:`weight_dtype`): halves the dominant memory traffic of every
    tree mat-vec at the cost of ~3 decimal digits of preconditioner
    quality (the recurrence STATE stays f32; only the fixed maps are
    stored low-precision). Off by default — the golden ILU iteration
    counts require full-f32 application; the SS-GMRES+ILU outer count
    stays at 4. Its effect on GPU time is not measured."""
    import os

    if _WEIGHT_DTYPE_OVERRIDE:
        d = _WEIGHT_DTYPE_OVERRIDE[-1]
        return jnp.dtype(d) if d else None
    d = os.environ.get("PERPHIL_TPU_PARTRI_WEIGHT_DTYPE")
    return jnp.dtype(d) if d else None


class weight_dtype:
    """Context manager scoping the chain-map storage dtype for trees built
    inside the block (construction is eager, so the scope is effective).
    ``None`` forces full precision regardless of the env default."""

    def __init__(self, d):
        self.d = d

    def __enter__(self):
        _WEIGHT_DTYPE_OVERRIDE.append(self.d)

    def __exit__(self, *exc):
        _WEIGHT_DTYPE_OVERRIDE.pop()


def _group_size() -> int:
    """Row-group size for the grouped 2D trisolve (see GridTriSolve2D).
    Default 0 = the dense-map tree. The grouped pass trades the tree's
    streaming of ~135 MB of composite maps (2D N=256) for ~13k tiny
    dependent ops, and the unrolled passes inflate compile time ~5x.
    Kept as an env-gated experiment (exactness pinned by
    ``test_grouped_trisolve_matches_tree``); which side wins depends on
    the backend's per-op cost, not measured on the GPU yet."""
    import os

    return max(0, int(os.environ.get("PERPHIL_TPU_PARTRI_GROUP", "0")))


def _matmat(a, b):
    # (k, *B, i, j) @ (k, *B, j, l) -> (k, *B, i, l)
    return jnp.einsum("...ij,...jl->...il", a, b, precision=_PREC)


def _matvec(a, v):
    # (k, *B, i, j) @ (k, *B, j) -> (k, *B, i)
    if a.dtype == jnp.bfloat16:
        # bf16 STORED maps only: the recurrence state stays f32 (the
        # _weight_dtype contract). The bf16->f32 convert fuses into the
        # dot, so the dominant HBM traffic (the (m,m) maps) stays bf16
        # while accumulation and the carried state are f32.
        return jnp.einsum(
            "...ij,...j->...i", a, v, preferred_element_type=jnp.float32
        )
    return jnp.einsum("...ij,...j->...i", a, v, precision=_PREC)


def _unit_bidiag_solve(wr: jnp.ndarray, B: jnp.ndarray) -> jnp.ndarray:
    """Solve ``(I - diag(wr, -1)) M = B`` along the row axis, exactly.

    ``wr``: ``(*batch, ny, nx)``; ``B``: ``(*batch, ny, nx, ncol)``.
    Row recurrence ``M[i] = B[i] + wr[i] * M[i-1]`` as one compiled scan
    (pure VPU adds/multiplies — no precision surprises).
    """
    wr_first = jnp.moveaxis(wr, -1, 0)  # (nx, *batch, ny)
    B_first = jnp.moveaxis(B, -2, 0)  # (nx, *batch, ny, ncol)

    def step(prev, inp):
        w, b = inp
        cur = b + w[..., None] * prev
        return cur, cur

    init = jnp.zeros_like(B_first[0])
    _, M = jax.lax.scan(step, init, (wr_first, B_first))
    return jnp.moveaxis(M, 0, -2)


def _interleave(even: jnp.ndarray, odd: jnp.ndarray) -> jnp.ndarray:
    """Interleave along axis 0: [e0, o0, e1, o1, ...]."""
    k = even.shape[0]
    stacked = jnp.stack([even, odd], axis=1)  # (k, 2, ...)
    return stacked.reshape((2 * k,) + even.shape[1:])


class AffineChainScan:
    """Exact solver for ``x_t = M_t x_{t-1} + g_t`` (t = 0..n-1, x_{-1} = 0).

    :param M: ``(n, *batch, m, m)`` maps (``M[0]`` is forced to zero — row 0
        has no predecessor). For scalar chains pass ``(n, *batch)`` with
        ``scalar=True``.

    Precomputation (`__init__`): a work-efficient scan tree. At each level,
    adjacent elements pair up; an odd element at the end is carried to the
    next level unpaired. Stored per level: the even elements' segment maps
    (needed by the down-sweep) and the odd elements' segment maps (needed by
    both sweeps) — ~2n maps total.

    ``apply(g)``: per-solve vector work only; ~2 log2(n) dependent stages of
    batched matvecs (or elementwise multiplies for scalar chains).

    Registered as a pytree (maps are leaves), so instances can be built
    inside ``jit`` (one compiled setup program instead of thousands of
    eagerly dispatched ops) and passed as arguments to compiled solvers
    (keeping multi-hundred-MB trees out of HLO constant pools).
    """

    def __init__(self, M: jnp.ndarray, scalar: bool = False):
        self.scalar = bool(scalar)
        self.n = int(M.shape[0])
        zero0 = jnp.zeros_like(M[:1])
        S = jnp.concatenate([zero0, M[1:]], axis=0) if self.n > 1 else zero0
        mul = (lambda a, b: a * b) if self.scalar else _matmat
        self.level_mats: List[Tuple[jnp.ndarray, jnp.ndarray]] = []
        self.level_tails: List[bool] = []
        while S.shape[0] > 1:
            k = int(S.shape[0]) // 2
            odd_tail = (int(S.shape[0]) % 2) == 1
            S_even = S[0 : 2 * k : 2]
            S_odd = S[1 : 2 * k : 2]
            self.level_mats.append((S_even, S_odd))
            self.level_tails.append(odd_tail)
            S_next = mul(S_odd, S_even)
            if odd_tail:
                S_next = jnp.concatenate([S_next, S[-1:]], axis=0)
            S = S_next
        wd = _weight_dtype()
        if wd is not None and not self.scalar:
            # compositions above ran in full f32; only the STORED maps are
            # truncated (see _weight_dtype)
            self.level_mats = [
                (e.astype(wd), o.astype(wd)) for e, o in self.level_mats
            ]

    def cast_weights(self, wd) -> None:
        """Truncate the STORED maps to ``wd`` after the fact (used when
        compositions must run in full precision before storage-dtype
        truncation, e.g. the 3D plane-map densification)."""
        if wd is not None and not self.scalar:
            self.level_mats = [
                (e.astype(wd), o.astype(wd)) for e, o in self.level_mats
            ]

    def tree_flatten(self):
        return tuple(self.level_mats), (self.scalar, self.n, tuple(self.level_tails))

    @classmethod
    def tree_unflatten(cls, aux, children):
        obj = object.__new__(cls)
        obj.scalar, obj.n, tails = aux
        obj.level_mats = list(children)
        obj.level_tails = list(tails)
        return obj

    def apply(self, g: jnp.ndarray) -> jnp.ndarray:
        """All prefix states: returns ``x`` with ``x[t]`` the recurrence
        solution at step t. ``g``: ``(n, *batch, m)`` (or ``(n, *batch)``
        scalar)."""
        mv = (lambda a, v: a * v) if self.scalar else _matvec
        # up-sweep: combine pairs; keep each level's input for the down-sweep
        saved: List[jnp.ndarray] = []
        v = g
        for (S_even, S_odd), odd_tail in zip(self.level_mats, self.level_tails):
            k = S_even.shape[0]
            v_even = v[0 : 2 * k : 2]
            v_odd = v[1 : 2 * k : 2]
            saved.append(v)
            v_pair = mv(S_odd, v_even) + v_odd
            if odd_tail:
                v_pair = jnp.concatenate([v_pair, v[-1:]], axis=0)
            v = v_pair
        # v now holds the single-element inclusive scan
        y = v
        # down-sweep: expand coarse inclusive results back to fine positions
        for ((S_even, S_odd), odd_tail), v_orig in zip(
            zip(reversed(self.level_mats), reversed(self.level_tails)),
            reversed(saved),
        ):
            k = S_even.shape[0]
            y_odd = y[:k]  # inclusive results at fine odd positions
            # even positions: x_{2i} = S_{2i} x_{2i-1} + v_{2i}; i=0 has no
            # predecessor (S[0] is zero anyway, but skip the matvec)
            if k > 1:
                y_even_rest = mv(S_even[1:], y_odd[:-1]) + v_orig[2 : 2 * k : 2]
                y_even = jnp.concatenate([v_orig[0:1], y_even_rest], axis=0)
            else:
                y_even = v_orig[0:1]
            y_fine = _interleave(y_even, y_odd)
            if odd_tail:
                y_fine = jnp.concatenate([y_fine, y[k : k + 1]], axis=0)
            y = y_fine
        return y


class GridTriSolve2D:
    """Exact lower-triangular solve of the 2D grid recurrence

        x[y,i] = c[y,i] + wr[y,i] x[y,i-1]
               + bm[y,i] x[y-1,i-1] + b0[y,i] x[y-1,i] + bp[y,i] x[y-1,i+1]

    (out-of-range terms zero; callers encode upper solves by flipping axes
    and pre-dividing by the diagonal). Coefficients may carry leading batch
    axes: shapes ``(*batch, ny, nx)``.

    Per-row maps ``M_y = T_y B_y`` (``T_y`` the unit-bidiagonal inverse) are
    densified once; solves run the scalar tree within rows and the affine
    tree across rows.

    GROUPED mode (``PERPHIL_TPU_PARTRI_GROUP``, default 0 = off): the full
    dense-map tree stores/streams ~2*ny nx^2 maps per apply (~135 MB at
    ny=nx=257 — measured HBM-bound at ~520 GB/s, ~0.26 ms per trisolve).
    Grouping rows into blocks of G keeps only the ny/G per-GROUP composite
    maps and re-derives within-group states from the banded coefficients
    (two unrolled G-step passes + one short boundary chain): ~10x less
    memory traffic for the same exact recurrence, at the cost of computing
    each within-group row twice (see :func:`_group_size`) — the tree is
    the default; this stays as the evaluated alternative. Applies only to
    unbatched solves with
    ny >= 2G (the 3D plane solver stays on the tree: its batched
    densification path needs ``chain``/vmap semantics).
    """

    def __init__(self, wr: jnp.ndarray, bm: jnp.ndarray, b0: jnp.ndarray, bp: jnp.ndarray):
        wr = jnp.asarray(wr)
        self.batch = wr.shape[:-2]
        ny, nx = int(wr.shape[-2]), int(wr.shape[-1])
        self.ny, self.nx = ny, nx
        dtype = wr.dtype

        # within-row scalar chain over x, batched over (*batch, y):
        # element axis first -> (nx, *batch, ny)
        wr_x_first = jnp.moveaxis(wr, -1, 0)
        self.row_scan = AffineChainScan(wr_x_first, scalar=True)

        G = _group_size()
        grouped = bool(G) and not self.batch and ny >= 2 * G
        self.G = G if grouped else 0

        # dense B_y: (*batch, ny, nx, nx); B[..., y, i, i+d] = b_d[..., y, i]
        i = np.arange(nx)
        B = jnp.zeros(self.batch + (ny, nx, nx), dtype=dtype)
        B = B.at[..., i[1:], i[1:] - 1].set(bm[..., 1:])
        B = B.at[..., i, i].set(b0)
        B = B.at[..., i[:-1], i[:-1] + 1].set(bp[..., :-1])
        # M_y = T_y B_y: solve (I - diag(wr,-1)) M = B. Done by the exact
        # sequential recurrence (one compiled scan, setup-only) rather than
        # XLA's blocked TriangularSolve, whose internal matmuls would run at
        # the backend's default (possibly bf16 or TF32) precision.
        M = _unit_bidiag_solve(wr, B)
        # element axis (y) first for the chain: (ny, *batch, nx, nx)
        M = jnp.moveaxis(M, len(self.batch), 0)

        if not grouped:
            self.chain = AffineChainScan(M)
            self.g_coeffs = self.g_chains = self.g_Mhat = None
            self.ngroups = self.pad = 0
            return

        self.chain = None
        ngroups = -(-ny // G)
        pad = ngroups * G - ny
        self.ngroups, self.pad = ngroups, pad

        def _steps(a):  # (ny, nx) zero-padded -> (G, ngroups, nx)
            ap = jnp.pad(a, ((0, pad), (0, 0)))
            return ap.reshape(ngroups, G, nx).swapaxes(0, 1)

        # banded coefficients per within-group step (padded rows decouple:
        # all-zero coefficients make x = c there, and outputs are cropped)
        self.g_coeffs = (_steps(bm), _steps(b0), _steps(bp))
        # per-step within-row bidiagonal chains, batched over groups
        self.g_chains = tuple(
            AffineChainScan(jnp.moveaxis(w, -1, 0), scalar=True)
            for w in _steps(wr)
        )
        # per-group composite maps Mhat_k = M_{kG+G-1} ... M_{kG}
        # (row 0 has no predecessor: M[0] contributes nothing — force zero
        # exactly like AffineChainScan does; zero-map padding rows likewise)
        Mz = M.at[0].set(jnp.zeros_like(M[0]))
        Mp = jnp.pad(Mz, ((0, pad), (0, 0), (0, 0)))
        Mg = Mp.reshape(ngroups, G, nx, nx)
        Mhat = Mg[:, 0]
        for s in range(1, G):
            Mhat = _matmat(Mg[:, s], Mhat)
        wd = _weight_dtype()
        if wd is not None:
            # composition above ran full-f32; only the STORED maps truncate
            Mhat = Mhat.astype(wd)
        self.g_Mhat = Mhat  # (ngroups, nx, nx)

    def cast_weights(self, wd) -> None:
        """Truncate stored chain maps to ``wd`` (row scans are scalar and
        stay full precision regardless)."""
        if self.chain is not None:
            self.chain.cast_weights(wd)
        elif wd is not None:
            self.g_Mhat = self.g_Mhat.astype(wd)

    def tree_flatten(self):
        children = (
            self.row_scan,
            self.chain,
            self.g_coeffs,
            self.g_chains,
            self.g_Mhat,
        )
        return children, (self.batch, self.ny, self.nx, self.G, self.ngroups, self.pad)

    @classmethod
    def tree_unflatten(cls, aux, children):
        obj = object.__new__(cls)
        (obj.row_scan, obj.chain, obj.g_coeffs, obj.g_chains, obj.g_Mhat) = children
        obj.batch, obj.ny, obj.nx, obj.G, obj.ngroups, obj.pad = aux
        return obj

    def row_solve(self, c: jnp.ndarray) -> jnp.ndarray:
        """Solve the within-row bidiagonal systems only: (I - L_y) g = c."""
        c_x_first = jnp.moveaxis(c, -1, 0)  # (nx, *batch, ny)
        g = self.row_scan.apply(c_x_first)
        return jnp.moveaxis(g, 0, -1)

    def apply(self, c: jnp.ndarray) -> jnp.ndarray:
        """Solve for ``x`` given ``c`` of shape ``(*batch, ny, nx)``."""
        if self.chain is None:
            return self._grouped_apply(c)
        g = self.row_solve(c)
        g_y_first = jnp.moveaxis(g, -2, 0)  # (ny, *batch, nx)
        x = self.chain.apply(g_y_first)
        return jnp.moveaxis(x, 0, -2)

    def _grouped_apply(self, c: jnp.ndarray) -> jnp.ndarray:
        """Grouped-row exact solve: unrolled within-group recurrences +
        a short cross-group boundary chain (see class docstring)."""
        G, ngroups, nx = self.G, self.ngroups, self.nx
        bm_s, b0_s, bp_s = self.g_coeffs
        cp = (
            jnp.pad(c, ((0, self.pad), (0, 0)))
            .reshape(ngroups, G, nx)
            .swapaxes(0, 1)
        )  # (G, ngroups, nx)

        def run_pass(x_start, collect: bool):
            # x_start: (ngroups, nx) — the true solution one row above each
            # group (zeros in the homogeneous first pass)
            x_prev = x_start
            outs = []
            for s in range(G):
                left = jnp.pad(x_prev[:, :-1], ((0, 0), (1, 0)))
                right = jnp.pad(x_prev[:, 1:], ((0, 0), (0, 1)))
                cc = cp[s] + bm_s[s] * left + b0_s[s] * x_prev + bp_s[s] * right
                xs = jnp.moveaxis(
                    self.g_chains[s].apply(jnp.moveaxis(cc, -1, 0)), 0, -1
                )
                if collect:
                    outs.append(xs)
                x_prev = xs
            return outs, x_prev

        # pass 1 (homogeneous): last row per group = the groups' affine
        # offsets zb_k; then xb_k = Mhat_k xb_{k-1} + zb_k sequentially
        _, zb = run_pass(jnp.zeros((ngroups, nx), c.dtype), collect=False)
        xb = [zb[0]]
        for k in range(1, ngroups):
            xb.append(_matvec(self.g_Mhat[k], xb[-1]) + zb[k])
        starts = jnp.concatenate(
            [jnp.zeros((1, nx), c.dtype), jnp.stack(xb[:-1])], axis=0
        )
        # pass 2: the same recurrences from the true boundary states
        outs, _ = run_pass(starts, collect=True)
        x = jnp.stack(outs).swapaxes(0, 1).reshape(ngroups * G, nx)
        return x[: self.ny]


class GridTriSolve3D:
    """Exact lower-triangular solve of the 3D grid recurrence over planes:

        x[z] = plane_solve_z( c[z] + sum_{dx,dy} bz[dy,dx][z] * shift(x[z-1]) )

    ``plane2d`` is a z-batched :class:`GridTriSolve2D` (the within-plane
    lower structure); ``bz`` maps coordinate-ordered offsets (dx, dy) ->
    coefficient grids ``(nz, ny, nx)`` for the nine cross-plane couplings.

    Plane maps ``M_z = T_z B_z`` are densified (``(nz, ny*nx, ny*nx)``) by
    applying the batched 2D solver to the sparse cross-plane couplings —
    a one-time batched matmul job — then the affine tree runs over planes.
    """

    def __init__(self, plane2d: GridTriSolve2D, bz: dict):
        self.plane2d = plane2d
        nz = int(plane2d.batch[-1]) if plane2d.batch else 1
        ny, nx = plane2d.ny, plane2d.nx
        self.nz, self.ny, self.nx = nz, ny, nx
        m2 = ny * nx
        some = next(iter(bz.values()))
        dtype = some.dtype

        # dense cross-plane coupling B_z: (nz, m2, m2)
        yy, xx = np.meshgrid(np.arange(ny), np.arange(nx), indexing="ij")
        rows = (yy * nx + xx).ravel()
        B = jnp.zeros((nz, m2, m2), dtype=dtype)
        for (dx, dy), w in bz.items():
            oy, ox = yy + dy, xx + dx
            valid = (oy >= 0) & (oy < ny) & (ox >= 0) & (ox < nx)
            cols = (np.clip(oy, 0, ny - 1) * nx + np.clip(ox, 0, nx - 1)).ravel()
            vmask = jnp.asarray(valid.ravel())
            wflat = w.reshape(nz, m2) * vmask
            B = B.at[:, rows, cols].add(wflat)

        # M_z = T_z B_z: batched 2D solves over (z, column). Columns of B_z
        # are plane-shaped vectors over the ROW index, so transpose first.
        Bcols = jnp.swapaxes(B, 1, 2).reshape(nz, m2, ny, nx)  # [z, col] -> plane
        Bcols = jnp.swapaxes(Bcols, 0, 1)  # (m2, nz, ny, nx)
        # plane2d has batch (nz,); vmap adds the leading column axis
        Mcols = jax.vmap(self.plane2d.apply)(Bcols)  # [col, z] -> T_z B_z e_col
        M = jnp.transpose(Mcols.reshape(m2, nz, m2), (1, 2, 0))  # (nz, row, col)
        self.chain = AffineChainScan(M)
        wd = _weight_dtype()
        if wd is not None:
            # The densification above must compose in full f32, so callers
            # pass a FULL-precision plane solver (DirTriSolve builds it under
            # ``weight_dtype(None)``); truncate its stored maps only now that
            # the plane-map composition is done.
            self.plane2d.cast_weights(wd)

    def tree_flatten(self):
        return (self.plane2d, self.chain), (self.nz, self.ny, self.nx)

    @classmethod
    def tree_unflatten(cls, aux, children):
        obj = object.__new__(cls)
        obj.plane2d, obj.chain = children
        obj.nz, obj.ny, obj.nx = aux
        return obj

    def apply(self, c: jnp.ndarray) -> jnp.ndarray:
        """Solve for ``x`` given ``c`` of shape ``(nz, ny, nx)``."""
        g = self.plane2d.apply(c)  # (nz, ny, nx)
        x = self.chain.apply(g.reshape(self.nz, self.ny * self.nx))
        return x.reshape(self.nz, self.ny, self.nx)


for _cls in (AffineChainScan, GridTriSolve2D, GridTriSolve3D):
    jax.tree_util.register_pytree_node(
        _cls, _cls.tree_flatten, _cls.tree_unflatten
    )


def apply_varcoef_stencil(x: jnp.ndarray, coeffs: dict) -> jnp.ndarray:
    """Apply a variable-coefficient stencil: ``y = sum_o w_o * shift(x, o)``.

    :param coeffs: maps coordinate-ordered offsets ``(dx, dy[, dz])`` to
        weight grids shaped like ``x`` (slowest-first axes). Out-of-range
        shifts contribute zero. Weights must already be zero where the
        offset leaves the grid (guaranteed for factor arrays built by
        ``ops/ilu._build_system`` via its ``valid`` mask).
    """
    d = x.ndim
    xp = jnp.pad(x, 1)
    shape = x.shape
    acc = jnp.zeros_like(x)
    for off, w in coeffs.items():
        # offset is coordinate-ordered (dx, dy, dz); axes are slowest-first
        rev = tuple(int(o) for o in reversed(off))
        slices = tuple(slice(1 + o, 1 + o + s) for o, s in zip(rev, shape))
        acc = acc + w * xp[slices]
    return acc
