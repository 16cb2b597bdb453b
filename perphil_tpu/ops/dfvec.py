"""Double-float vector algebra for Krylov solvers.

Pure f32 Krylov is not an option for f64-grade answers —
unpreconditioned GMRES stalls at the kappa*eps_f32 noise floor (measured:
7709 instead of 3307 iterations at 2D N=64). This module provides the
middle path used by ``ops/krylov``'s df32 mode (an explicit opt-in; the
default Krylov path is native float64): Krylov vectors as double-float (hi, lo) float32 pairs (~49-bit
mantissa, unit roundoff ~6e-15), with the two numerically critical
reductions — basis projections and norms — computed by error-free
transformations:

  - products of hi parts via Dekker two_prod (exact),
  - summation via a pairwise double-float tree (deterministic, ~eps-accurate
    regardless of length),
  - hi*lo cross terms via ordinary f32 contractions (their relative weight
    is ~1e-8, so f32/bf16 accuracy there contributes ~1e-15 overall).

Scalars (Hessenberg entries, Givens rotations, residual norms) stay in
float64.

Replaces the PETSc f64 KSP arithmetic (reference
``/root/reference/src/perphil/solvers/parameters.py:12-27`` runs PETSc's
default double-precision GMRES) with an f32-built equivalent of the same
effective precision.
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp
import numpy as np

from perphil_tpu.ops.df32 import (
    DF,
    df_add,
    df_from_f64,
    df_to_f64,
    fast_two_sum,
    two_prod,
    two_sum,
)

__all__ = [
    "DF",
    "df_from_f64",
    "df_to_f64",
    "df_vec_add",
    "df_vec_sub",
    "df_scale64",
    "df_axpy64",
    "df_sum_tree",
    "df_dot",
    "df_norm",
    "df_basis_dot",
    "df_basis_comb",
    "split64",
]


def split64(s64) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Split f64 scalars/arrays into (hi, lo) f32 pairs (IO boundary)."""
    s64 = jnp.asarray(s64)
    if s64.dtype == jnp.float32:
        return s64, jnp.zeros_like(s64)
    hi = s64.astype(jnp.float32)
    lo = (s64 - hi.astype(s64.dtype)).astype(jnp.float32)
    return hi, lo


def df_vec_add(x: DF, y: DF) -> DF:
    return df_add(x, y)


def df_vec_sub(x: DF, y: DF) -> DF:
    from perphil_tpu.ops.df32 import df_sub

    return df_sub(x, y)


def df_scale64(x: DF, s64) -> DF:
    """x * s with s a float64 scalar (or broadcastable array)."""
    sh, sl = split64(s64)
    p, e = two_prod(x[0], sh)
    e = e + x[0] * sl + x[1] * sh
    return fast_two_sum(p, e)


def df_axpy64(y: DF, a64, x: DF) -> DF:
    """y + a * x with a in float64."""
    return df_add(y, df_scale64(x, a64))


def df_sum_tree(p: DF, keep_leading: int = 0) -> DF:
    """Sum a double-float array over all but the first ``keep_leading`` axes
    by pairwise double-float reduction (deterministic, error ~eps_df).

    Pads the flattened trailing extent to a power of two; every halving is
    one fused elementwise df-add on shrinking arrays (~log2(L) kernels).
    """
    ph, pl = p
    lead = ph.shape[:keep_leading]
    L = int(np.prod(ph.shape[keep_leading:])) if ph.ndim > keep_leading else 1
    ph = ph.reshape(lead + (L,))
    pl = pl.reshape(lead + (L,))
    L2 = 1 << max(0, (L - 1).bit_length())
    if L2 != L:
        pad = [(0, 0)] * len(lead) + [(0, L2 - L)]
        ph = jnp.pad(ph, pad)
        pl = jnp.pad(pl, pad)
    while L2 > 1:
        half = L2 // 2
        a = (ph[..., :half], pl[..., :half])
        b = (ph[..., half:], pl[..., half:])
        ph, pl = df_add(a, b)
        L2 = half
    return ph[..., 0], pl[..., 0]


def df_dot(u: DF, v: DF) -> jnp.ndarray:
    """Double-float-accurate inner product, returned as float64 scalar.

    Main term sum(u_hi * v_hi) via exact two_prod + df tree; cross terms
    (relative weight ~2^-24) via plain f32 contractions.
    """
    p, e = two_prod(u[0], v[0])
    e = e + u[0] * v[1] + u[1] * v[0]
    s = df_sum_tree((p, e))
    return s[0].astype(jnp.float64) + s[1].astype(jnp.float64)


def df_norm(v: DF) -> jnp.ndarray:
    return jnp.sqrt(df_dot(v, v))


def df_basis_dot(V: DF, w: DF) -> jnp.ndarray:
    """(m1, *shape) basis x (*shape) vector -> (m1,) float64 projections."""
    Vh, Vl = V
    wh, wl = w
    p, e = two_prod(Vh, wh)  # broadcast over the basis axis
    e = e + Vh * wl + Vl * wh
    s = df_sum_tree((p, e), keep_leading=1)
    return s[0].astype(jnp.float64) + s[1].astype(jnp.float64)


def df_basis_comb(h64: jnp.ndarray, V: DF) -> DF:
    """sum_i h[i] * V[i] with h in float64; returns a df vector."""
    Vh, Vl = V
    hh, hl = split64(h64)
    bshape = (-1,) + (1,) * (Vh.ndim - 1)
    hh_b = hh.reshape(bshape)
    hl_b = hl.reshape(bshape)
    p, e = two_prod(hh_b, Vh)
    e = e + hh_b * Vl + hl_b * Vh
    # reduce over the basis axis (small) by df pairwise tree
    acc_h = jnp.moveaxis(p, 0, -1)
    acc_l = jnp.moveaxis(e, 0, -1)
    out = df_sum_tree((acc_h, acc_l), keep_leading=Vh.ndim - 1)
    return out
