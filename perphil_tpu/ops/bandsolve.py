"""Dense-band block trisolve: the on-device RCM ordering-parity ILU apply.

On-device execution engine (``pc_band_execution="device"``) for the
DoF-ordering-faithful GMRES+ILU rows
(PETSc ``pc_factor_mat_ordering_type: rcm`` analog; reference
``solvers/parameters.py:27`` context, counts published in
``petsc_perf_breakdown_3d.csv``). The factorization itself is inherently
sequential and stays on the host (``csrc/csr_solver.cpp`` /
``ops/ordering.py::host_ilu0``) — PETSc's division of labor — but the
SOLVES move on-device by restructuring the unstructured-order trisolve
around the band structure that cell-RCM creates:

- The parity permutation is (reverse) Cuthill-McKee per field: the per-field
  factor blocks L11/L22/U11/U22 are BANDED (bandwidth ~nx^2 in 3D, measured
  34..2125 for nx=4..40), and the inter-field couplings L21/U12 share the
  same band.
- Cover each banded triangular factor with ``nb = ceil(nv/B)`` dense B x B
  diagonal blocks (B >= bandwidth+1, lane-aligned): the trisolve becomes a
  block recurrence  ``y_k = inv(D_k) r_k - [inv(D_k) C_k] y_{k +- 1}`` —
  2 dense matvecs per block, a ``lax.scan`` over ~30 blocks. All FLOPs are
  dense matvec work; there are NO unstructured gathers (each level step
  of a gather-based trisolve is a dependent gather+scatter,
  ``experiments/levelsched_eval.py``).
- The diagonal-block inverses are computed ON DEVICE (batched f32
  triangular solve + Newton refinement steps) from the ~30 MB CSR factor,
  rather than shipping GBs of host-inverted dense blocks (nx=40).
- Inter-field couplings (L21, U12) apply as *varying-coefficient* stencils
  in the NATURAL ordering (values scattered back through the permutation at
  setup): 3^d shifted multiply-adds, one permutation gather each way.

Precision: the dense blocks and matvecs run in f32. Measured in
``experiments/blockinv_precision_probe.py``: the published iteration counts
6/8/12/15/17/20/26/29/33 are insensitive to f32-vs-f64 block-inverse
applies (the ILU apply is a preconditioner, not the residual arithmetic).

Sibling paths: structured envelope ILU (``ops/ilu.py``, the stronger
default), parallel-prefix structured trisolves
(``ops/partri.py``, 2D lexicographic parity).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp

_LANE = 256  # block-size quantum (sublane*lane aligned for f32 tiles)


def band_block_size(bandwidth: int) -> int:
    """Smallest lane-aligned B with B >= bandwidth + 1 (so couplings reach
    at most one block back)."""
    return max(_LANE, int(-(-(bandwidth + 1) // _LANE)) * _LANE)


def split_monolithic_factor(
    F: sp.csr_matrix, nv: int
) -> Tuple[sp.csr_matrix, ...]:
    """Split the combined ILU(0) factor into the six 2-field blocks
    (L11, L21, L22 strictly lower, unit diag implied; U11, U12, U22 upper
    including diag). Index arrays are copied — ``eliminate_zeros`` mutates
    them in place and must not corrupt the caller's ``F``."""
    n = F.shape[0]
    rows = np.repeat(np.arange(n), np.diff(F.indptr))

    def _part(mask):
        M = sp.csr_matrix(
            (F.data * mask, F.indices.copy(), F.indptr.copy()), shape=F.shape
        )
        M.eliminate_zeros()
        return M

    L = _part(F.indices < rows)
    U = _part(F.indices >= rows)
    return (
        L[:nv, :nv], L[nv:, :nv], L[nv:, nv:],
        U[:nv, :nv], U[:nv, nv:], U[nv:, nv:],
    )


def _block_coo(M: sp.spmatrix, B: int, lower: bool):
    """(diag_idx, diag_vals, coup_idx, coup_vals) flat scatter indices into
    (nb, B, B) dense diagonal / off-diagonal coupling blocks of a banded
    triangular factor. ``lower``: couplings reach block k-1 (forward
    recurrence); else block k+1 (backward)."""
    n = M.shape[0]
    nb = -(-n // B)
    coo = M.tocoo()
    r, c, v = coo.row.astype(np.int64), coo.col.astype(np.int64), coo.data
    k = r // B
    lr = r - k * B
    in_diag = c // B == k
    d_idx = (k[in_diag] * B + lr[in_diag]) * B + (c[in_diag] - k[in_diag] * B)
    off = ~in_diag
    kc = c[off] // B
    expect = k[off] - 1 if lower else k[off] + 1
    if not np.array_equal(kc, expect):
        raise ValueError(
            "bandwidth exceeds block size: coupling entry reaches beyond "
            "the adjacent block"
        )
    c_idx = (k[off] * B + lr[off]) * B + (c[off] - kc * B)
    return (
        d_idx.astype(np.int32), v[in_diag].astype(np.float32),
        c_idx.astype(np.int32), v[off].astype(np.float32),
        nb,
    )


@partial(jax.jit, static_argnames=("nb", "B", "lower", "unit", "newton"))
def _build_blocks_device(
    d_idx, d_vals, c_idx, c_vals, *, nb: int, B: int, lower: bool,
    unit: bool, newton: int = 2
):
    """Scatter the CSR factor into dense blocks, invert the diagonal blocks
    on device (batched f32 triangular solve + ``newton`` refinement steps
    ``X <- X(2I - D X)`` — quadratic, so 1-2 steps reach the f32 rounding
    floor regardless of the triangular-solve's internal blocking error),
    and PACK inverse + coupling into ONE (nb, B, B) array.

    The supports are disjoint: with pad = B - bandwidth >= 1, a forward
    coupling entry sits at local column c >= r + pad while the (strictly)
    lower inverse sits at c <= r-1 (the unit diagonal is implied and
    reconstructed in the apply); backward couplings sit at c <= r - pad
    while the upper inverse (diagonal included) sits at c >= r. Packing
    halves the HBM stream per trisolve — the dominant cost of the apply.
    """
    eye = jnp.eye(B, dtype=jnp.float32)
    D = (
        jnp.zeros((nb * B * B,), jnp.float32)
        .at[d_idx].set(d_vals)
        .reshape(nb, B, B)
    )
    if unit:
        D = D + eye  # strictly-lower storage, unit diagonal implied
    else:
        # padded tail rows have no stored diagonal: make them identity
        dg = jnp.einsum("kii->ki", D)
        D = D + jnp.where(dg == 0.0, 1.0, 0.0)[:, :, None] * eye
    C = (
        jnp.zeros((nb * B * B,), jnp.float32)
        .at[c_idx].set(c_vals)
        .reshape(nb, B, B)
    )
    X = jax.vmap(
        lambda Dk: jax.scipy.linalg.solve_triangular(Dk, eye, lower=lower)
    )(D)
    for _ in range(newton):
        X = jnp.einsum(
            "kij,kjl->kil", X, 2.0 * eye - jnp.einsum("kij,kjl->kil", D, X),
            precision=jax.lax.Precision.HIGHEST,
        )
    r_i = jax.lax.broadcasted_iota(jnp.int32, (B, B), 0)
    c_i = jax.lax.broadcasted_iota(jnp.int32, (B, B), 1)
    xmask = (c_i < r_i) if lower else (c_i >= r_i)
    return jnp.where(xmask, X, C)


def tri_apply(P, r, lower: bool, pad: int):
    """Banded triangular solve via the packed dense block recurrence.

    ``P``: (nb, B, B) packed [inverse | coupling] blocks (see
    ``_build_blocks_device``); ``r``: (nb*B,) padded right-hand side;
    ``pad``: B - bandwidth (support separator). A ``lax.scan`` over blocks;
    each block of P is read once per trip and serves both the coupling and
    the inverse matvec.
    """
    nb, B, _ = P.shape
    rk = r.reshape(nb, B)
    r_i = jax.lax.broadcasted_iota(jnp.int32, (B, B), 0)
    c_i = jax.lax.broadcasted_iota(jnp.int32, (B, B), 1)
    if lower:
        xmask = c_i < r_i
        cmask = c_i >= r_i + pad
    else:
        xmask = c_i >= r_i
        cmask = c_i <= r_i - pad
    hi = jax.lax.Precision.HIGHEST  # true f32 (default may be bf16/TF32)

    def body(carry, inp):
        Pk, rb = inp
        u = rb - jnp.dot(jnp.where(cmask, Pk, 0.0), carry, precision=hi)
        Xu = jnp.dot(jnp.where(xmask, Pk, 0.0), u, precision=hi)
        y = u + Xu if lower else Xu  # unit diag implied for the L factors
        return y, y

    _, ys = jax.lax.scan(
        body, jnp.zeros((B,), r.dtype), (P, rk), reverse=not lower
    )
    return ys.reshape(-1)


def coupling_stencil_vals(
    M: sp.spmatrix, vperm: np.ndarray, grid_shape: Tuple[int, ...]
) -> np.ndarray:
    """Scatter a permuted-space inter-field factor block back to a
    varying-coefficient 3^d stencil in the NATURAL ordering.

    ``M[i, j]`` couples permuted row-vertex i to permuted col-vertex j;
    naturally these are vperm[i] -> vperm[j], always grid-adjacent (the
    ILU(0) pattern is the FE adjacency). Returns (3^d, *grid_shape) f32.
    """
    return coupling_stencil_vals_f64(M, vperm, grid_shape).astype(np.float32)


def apply_varying_stencil(u: jnp.ndarray, vals: jnp.ndarray) -> jnp.ndarray:
    """y[p] = sum_o vals[o, p] * u[p + off_o] — per-vertex-coefficient
    stencil apply (same pad/slice convention as ``stencil.apply_stencil``).
    """
    import itertools

    d = u.ndim
    up = jnp.pad(u, 1)
    shape = u.shape
    out = None
    for n, idx in enumerate(itertools.product(range(3), repeat=d)):
        slices = tuple(slice(k, k + s) for k, s in zip(idx, shape))
        term = vals[n] * up[slices]
        out = term if out is None else out + term
    return out


def df_apply_varying_stencil(x_df, vals_df):
    """df-grade varying-coefficient stencil apply: y = sum_o vals[o] * x
    shifted by off_o, every product and accumulation in double-float
    (compensated two-f32). Streams ~3^d * n * 16 B — trivial next to the
    dense block streams; this is what makes the defect-correction pass
    df-grade without any unstructured arithmetic."""
    import itertools

    from perphil_tpu.ops.df32 import df_add, df_mul

    xh, xl = x_df
    vh, vl = vals_df
    d = xh.ndim
    ph = jnp.pad(xh, 1)
    pl = jnp.pad(xl, 1)
    shape = xh.shape
    out = None
    for n, idx in enumerate(itertools.product(range(3), repeat=d)):
        slices = tuple(slice(k, k + s) for k, s in zip(idx, shape))
        term = df_mul((vh[n], vl[n]), (ph[slices], pl[slices]))
        out = term if out is None else df_add(out, term)
    return out


def factor_nat_stencils(F: sp.csr_matrix, nv: int, vperm: np.ndarray,
                        grid_shape: Tuple[int, ...]):
    """Natural-ordering varying-stencil form of the monolithic ILU(0)
    factor, as df pairs: (L11, L21, L22 strictly lower — unit diag NOT
    stored — and U11, U12, U22 upper incl diag). Used by the df
    defect-correction pass: d = r - (I+NL)(U z) evaluated with 3^d shifted
    df multiply-adds per block."""
    parts = split_monolithic_factor(F, nv)

    def df_vals(M):
        v64 = coupling_stencil_vals_f64(M, vperm, grid_shape)
        hi = v64.astype(np.float32)
        lo = (v64 - hi.astype(np.float64)).astype(np.float32)
        return jnp.asarray(hi), jnp.asarray(lo)

    return tuple(df_vals(M) for M in parts)


def coupling_stencil_vals_f64(
    M: sp.spmatrix, vperm: np.ndarray, grid_shape: Tuple[int, ...]
) -> np.ndarray:
    """f64 twin of :func:`coupling_stencil_vals` (same scatter, full
    precision — callers round to the storage format they need)."""
    d = len(grid_shape)
    coo = M.tocoo()
    ri = vperm[coo.row]
    ci = vperm[coo.col]
    rpos = np.stack(np.unravel_index(ri, grid_shape), axis=1)
    cpos = np.stack(np.unravel_index(ci, grid_shape), axis=1)
    delta = cpos - rpos
    if len(coo.data) and (delta.min() < -1 or delta.max() > 1):
        raise ValueError("factor entry is not grid-adjacent")
    oidx = np.zeros(len(coo.data), dtype=np.int64)
    for ax in range(d):
        oidx = oidx * 3 + (delta[:, ax] + 1)
    vals = np.zeros((3**d,) + grid_shape, dtype=np.float64)
    vals[(oidx,) + tuple(rpos.T)] = coo.data
    return vals


@dataclass
class BandParityILU:
    """Device-resident parity-ILU apply. Built once per solver (PCSetUp
    analog); ``apply_nat`` maps a natural-ordering monolithic residual to
    the preconditioned correction, everything on device."""

    nv: int
    B: int
    pad: int  # B - bandwidth: the packed-support separator
    grid_shape: Tuple[int, ...]
    vperm: jnp.ndarray  # natural index of each permuted vertex (int32)
    ivperm: jnp.ndarray  # permuted index of each natural vertex (int32)
    PL1: jnp.ndarray  # packed [strict-lower inverse | coupling] per factor
    PL2: jnp.ndarray
    PU1: jnp.ndarray
    PU2: jnp.ndarray
    vals21: jnp.ndarray  # L21 natural varying stencil (3^d, *grid)
    vals12: jnp.ndarray  # U12 natural varying stencil
    # df natural stencils of the full factor (L11,L21,L22,U11,U12,U22),
    # present when the df defect-correction pass is enabled (nx=40-class
    # sizes where a pure-f32 apply drifts the count by +1 — measured in
    # experiments/blockinv_precision_probe.py)
    nat_factors: tuple = None

    def apply_nat(self, r1: jnp.ndarray, r2: jnp.ndarray):
        """z = P^T (U^-1 L^-1) P r for natural grid-shaped fields r1, r2."""
        nv, B = self.nv, self.B
        tail = self.PL1.shape[0] * B - nv

        def to_p(u):  # natural grid -> permuted padded flat
            return jnp.pad(u.ravel()[self.vperm], (0, tail))

        def to_n(yp):  # permuted padded flat -> natural grid
            return yp[:nv][self.ivperm].reshape(self.grid_shape)

        rp1 = to_p(r1)
        y1 = tri_apply(self.PL1, rp1, lower=True, pad=self.pad)
        # r2' = r2 - L21 y1 (natural varying stencil, one gather each way)
        y1n = to_n(y1)
        rp2 = to_p(r2 - apply_varying_stencil(y1n, self.vals21))
        y2 = tri_apply(self.PL2, rp2, lower=True, pad=self.pad)
        x2 = tri_apply(self.PU2, y2, lower=False, pad=self.pad)
        x2n = to_n(x2)
        # y1' = y1 - U12 x2
        yp1 = y1 - to_p(apply_varying_stencil(x2n, self.vals12))
        x1 = tri_apply(self.PU1, yp1, lower=False, pad=self.pad)
        return to_n(x1), x2n

    def apply_nat_df(self, r_df):
        """df-pair interface for the outer ``gmres_df``: input/output are
        stacked (2, *grid) df pairs. Without correction the f32 apply's
        result is returned as (z, 0); with correction one df-grade defect
        pass (d = r - L U z, natural varying stencils) plus a second f32
        trisolve lands the apply at df accuracy on the dense-block path.
        """
        from perphil_tpu.ops.df32 import df_add, df_sub, two_sum

        rh, rl = r_df
        z1, z2 = self.apply_nat(rh[0], rh[1])
        if self.nat_factors is None:
            z = jnp.stack([z1, z2])
            return z, jnp.zeros_like(z)
        L11, L21, L22, U11, U12, U22 = self.nat_factors
        zero1 = jnp.zeros_like(z1)
        z1d, z2d = (z1, zero1), (z2, zero1)
        # w = U z  (upper factor includes its diagonal)
        w1 = df_add(
            df_apply_varying_stencil(z1d, U11),
            df_apply_varying_stencil(z2d, U12),
        )
        w2 = df_apply_varying_stencil(z2d, U22)
        # M z = (I + N_L) w
        Mz1 = df_add(w1, df_apply_varying_stencil(w1, L11))
        Mz2 = df_add(
            w2,
            df_add(
                df_apply_varying_stencil(w1, L21),
                df_apply_varying_stencil(w2, L22),
            ),
        )
        d1 = df_sub((rh[0], rl[0]), Mz1)
        d2 = df_sub((rh[1], rl[1]), Mz2)
        dz1, dz2 = self.apply_nat(d1[0] + d1[1], d2[0] + d2[1])
        c1 = two_sum(z1, dz1)
        c2 = two_sum(z2, dz2)
        return jnp.stack([c1[0], c2[0]]), jnp.stack([c1[1], c2[1]])


def build_band_parity_ilu(
    Ap: sp.csr_matrix,
    perm: np.ndarray,
    nv: int,
    grid_shape: Tuple[int, ...],
    F: sp.csr_matrix,
    with_correction: bool = False,
) -> BandParityILU:
    """Construct the device-resident apply from the (host-factored)
    parity-permuted system. ``Ap`` is used only for shape/bandwidth; ``F``
    is the combined ILU(0) factor of ``Ap`` (``ordering.host_ilu0`` /
    the native ``csr_ilu0_factorize``)."""
    L11, L21, L22, U11, U12, U22 = split_monolithic_factor(F, nv)
    bw = 0
    for M in (L11, L22):
        coo = M.tocoo()
        if coo.nnz:
            bw = max(bw, int((coo.row - coo.col).max()))
    for M in (U11, U22):
        coo = M.tocoo()
        if coo.nnz:
            bw = max(bw, int((coo.col - coo.row).max()))
    B = band_block_size(bw)

    def build(M, lower, unit):
        d_idx, d_vals, c_idx, c_vals, nb = _block_coo(M, B, lower)
        return _build_blocks_device(
            jnp.asarray(d_idx), jnp.asarray(d_vals),
            jnp.asarray(c_idx), jnp.asarray(c_vals),
            nb=nb, B=B, lower=lower, unit=unit,
        )

    PL1 = build(L11, True, True)
    PL2 = build(L22, True, True)
    PU1 = build(U11, False, False)
    PU2 = build(U22, False, False)

    vperm = perm[:nv].astype(np.int32)  # blocked perm: field-1 rows first
    ivperm = np.empty_like(vperm)
    ivperm[vperm] = np.arange(nv, dtype=np.int32)
    vals21 = coupling_stencil_vals(L21, vperm.astype(np.int64), grid_shape)
    vals12 = coupling_stencil_vals(U12, vperm.astype(np.int64), grid_shape)

    return BandParityILU(
        nv=nv, B=B, pad=B - bw, grid_shape=grid_shape,
        vperm=jnp.asarray(vperm), ivperm=jnp.asarray(ivperm),
        PL1=PL1, PL2=PL2, PU1=PU1, PU2=PU2,
        vals21=jnp.asarray(vals21), vals12=jnp.asarray(vals12),
        nat_factors=(
            factor_nat_stencils(F, nv, vperm.astype(np.int64), grid_shape)
            if with_correction
            else None
        ),
    )
