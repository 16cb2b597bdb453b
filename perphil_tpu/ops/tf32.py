"""Triple-float (three-f32) vector algebra: the knife-edge Krylov mode.

Why this exists (docs/design.md §7): the production df32 (two-f32, ~49-bit)
Krylov path reproduces PETSc's f64 iteration counts everywhere except at
convergence knife edges on TINY systems — 2D N=8 plain GMRES lands 41 vs
PETSc's 40 and 3D nx=4 lands 28 vs 27, because near convergence the
residual's RELATIVE accuracy is amplified by ||b||/||r|| ~ 1/rtol, and
kappa * eps_df * 1e8 lands within the cells' convergence margin. Raising
only the SCALAR recurrence does not help: the XLA df path already carries
the Hessenberg/Givens chain in exact float64 and still drifts — the error
lives in the 49-bit VECTOR arithmetic (measured; see the deviation table).

This module provides deterministic ~71-bit vectors from pure f32 ops:
triples
``(hi, mid, lo)`` with |mid| <= ulp(hi), |lo| <= ulp(mid), built on the
same error-free transformations as ``ops/df32`` (Dekker/Knuth two_sum /
two_prod — contraction-immune on XLA:CPU via the masked split). A tf32
trajectory tracks exact arithmetic ~2^-18 below PETSc's own f64 rounding,
so at the knife edge it lands on PETSc's side of the boundary.

Used by ``ops/krylov.gmres_tf`` for tiny unpreconditioned systems only
(PERPHIL_TPU_TF32_MAX_DOF, default 512): at those sizes the ~2.5x op-count
overhead is invisible (the cells are tiny), and every
published count at larger sizes is already exact in df32.

Reference role: PETSc's f64 KSP vectors
(``/root/reference/src/perphil/solvers/parameters.py:12-27``).
"""

from __future__ import annotations

import itertools
from typing import Tuple

import jax.numpy as jnp
import numpy as np

from perphil_tpu.ops.df32 import dyadic_factor, fast_two_sum, two_prod, two_sum

TF = Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]

__all__ = [
    "TF",
    "tf_from_f64",
    "tf_to_f64",
    "tf_add",
    "tf_neg",
    "tf_sub",
    "tf_scale64",
    "tf_axpy64",
    "tf_sum_tree",
    "tf_dot",
    "tf_norm",
    "tf_basis_dot",
    "tf_basis_comb",
    "tf_apply_stencil",
    "split64_3",
]


def split64_3(s64):
    """f64 scalar/array -> three f32 words summing EXACTLY to it (24*3=72
    mantissa bits cover f64's 53)."""
    s64 = jnp.asarray(s64, jnp.float64)
    hi = s64.astype(jnp.float32)
    r = s64 - hi.astype(jnp.float64)
    mid = r.astype(jnp.float32)
    lo = (r - mid.astype(jnp.float64)).astype(jnp.float32)
    return hi, mid, lo


def _split64_3_const(w: float):
    """Trace-time 3-word split of a python/np f64 constant (np.float32
    scalars stay inline HLO literals, as in df32._split_const)."""
    hi = np.float32(w)
    r = float(w) - float(hi)
    mid = np.float32(r)
    lo = np.float32(r - float(mid))
    return hi, mid, lo


def tf_from_f64(x64) -> TF:
    return split64_3(x64)


def tf_to_f64(x: TF):
    return (
        x[0].astype(jnp.float64)
        + x[1].astype(jnp.float64)
        + x[2].astype(jnp.float64)
    )


def _renorm3(a0, a1, a2) -> TF:
    """Compress three roughly-ordered components into a canonical triple."""
    s1, e2 = two_sum(a1, a2)
    s0, e1 = two_sum(a0, s1)
    t1, t2 = fast_two_sum(e1, e2)
    return s0, t1, t2


def tf_add(x: TF, y: TF) -> TF:
    """Triple-float addition, error O(eps_f32^3) ~ 2^-72 relative."""
    r0, e0 = two_sum(x[0], y[0])
    t1, d1 = two_sum(x[1], y[1])
    r1, d2 = two_sum(e0, t1)
    r2 = d1 + d2 + x[2] + y[2]
    return _renorm3(r0, r1, r2)


def tf_neg(x: TF) -> TF:
    return -x[0], -x[1], -x[2]


def tf_sub(x: TF, y: TF) -> TF:
    return tf_add(x, tf_neg(y))


def _tf_mul_words(x: TF, w_hi, w_mid, w_lo) -> TF:
    """x * w with w given as three f32 words (array or np scalar)."""
    p0, e0 = two_prod(x[0], w_hi)
    p1, e1 = two_prod(x[0], w_mid)
    p2, e2 = two_prod(x[1], w_hi)
    # O(eps^2)-relative terms: plain f32 products round at O(eps^3) overall
    t3 = x[1] * w_mid + x[0] * w_lo + x[2] * w_hi
    s1, d1 = two_sum(p1, p2)
    s1, d2 = two_sum(s1, e0)
    s2 = d1 + d2 + e1 + e2 + t3
    return _renorm3(p0, s1, s2)


def tf_mul(x: TF, y: TF) -> TF:
    return _tf_mul_words(x, y[0], y[1], y[2])


def tf_scale64(x: TF, s64) -> TF:
    """x * s with s a float64 scalar (exact 3-word split)."""
    if isinstance(s64, (float, int, np.floating)):
        wh, wm, wl = _split64_3_const(float(s64))
    else:
        wh, wm, wl = split64_3(s64)
    return _tf_mul_words(x, wh, wm, wl)


def tf_axpy64(y: TF, a64, x: TF) -> TF:
    return tf_add(y, tf_scale64(x, a64))


def tf_sum_tree(p: TF, keep_leading: int = 0) -> TF:
    """Pairwise triple-float reduction over all but the leading axes
    (deterministic, ~eps_tf accurate — the tf analogue of
    ``dfvec.df_sum_tree``)."""
    ph, pm, pl = p
    lead = ph.shape[:keep_leading]
    L = int(np.prod(ph.shape[keep_leading:])) if ph.ndim > keep_leading else 1
    ph = ph.reshape(lead + (L,))
    pm = pm.reshape(lead + (L,))
    pl = pl.reshape(lead + (L,))
    L2 = 1 << max(0, (L - 1).bit_length())
    if L2 != L:
        pad = [(0, 0)] * len(lead) + [(0, L2 - L)]
        ph, pm, pl = jnp.pad(ph, pad), jnp.pad(pm, pad), jnp.pad(pl, pad)
    while L2 > 1:
        half = L2 // 2
        a = (ph[..., :half], pm[..., :half], pl[..., :half])
        b = (ph[..., half:], pm[..., half:], pl[..., half:])
        ph, pm, pl = tf_add(a, b)
        L2 = half
    return ph[..., 0], pm[..., 0], pl[..., 0]


def _tf_prod_terms(u: TF, v: TF) -> TF:
    """Elementwise u*v as an (unnormalized) triple: exact two_prod main and
    first-order cross terms, f32 second-order tail."""
    p0, e0 = two_prod(u[0], v[0])
    p1, e1 = two_prod(u[0], v[1])
    p2, e2 = two_prod(u[1], v[0])
    tail = u[1] * v[1] + u[0] * v[2] + u[2] * v[0] + e1 + e2
    s1, d1 = two_sum(p1, p2)
    s1, d2 = two_sum(s1, e0)
    return _renorm3(p0, s1, d1 + d2 + tail)


def tf_dot(u: TF, v: TF) -> jnp.ndarray:
    """Triple-float-accurate inner product -> float64 scalar (the f64
    rounding at the END mirrors PETSc handing a VecDot result to its f64
    Hessenberg — trajectory-relevant error ~2^-70, far below f64 ulp)."""
    terms = _tf_prod_terms(u, v)
    s = tf_sum_tree(terms)
    return tf_to_f64(s)


def tf_norm(v: TF) -> jnp.ndarray:
    return jnp.sqrt(tf_dot(v, v))


def tf_basis_dot(V: TF, w: TF) -> jnp.ndarray:
    """(m1, *shape) tf basis x (*shape) tf vector -> (m1,) f64 projections."""
    terms = _tf_prod_terms(V, (w[0][None], w[1][None], w[2][None]))
    s = tf_sum_tree(terms, keep_leading=1)
    return tf_to_f64(s)


def tf_basis_comb(h64: jnp.ndarray, V: TF) -> TF:
    """sum_i h[i] * V[i] with h float64; returns a tf vector."""
    hh, hm, hl = split64_3(h64)
    bshape = (-1,) + (1,) * (V[0].ndim - 1)
    terms = _tf_mul_words(V, hh.reshape(bshape), hm.reshape(bshape), hl.reshape(bshape))
    acc = tuple(jnp.moveaxis(t, 0, -1) for t in terms)
    return tf_sum_tree(acc, keep_leading=V[0].ndim - 1)


# ---------------------------------------------------------------------------
# stencil application (mirrors df32.df_apply_stencil's dyadic fast path)
# ---------------------------------------------------------------------------


def tf_apply_stencil(x: TF, stencil: np.ndarray) -> TF:
    """Apply a constant 3^d f64-weight stencil to a triple-float grid.

    Dyadic fast path (every uniform-grid stencil in the library,
    ``df32.dyadic_factor``): each pow2-term tap product is EXACT per
    component, accumulation via two_sum cascades on (s, e1) with an f32
    tail e2, then ONE tf scale by the factored-out ``c``. General
    fallback: per-tap exact 3-word weight products.
    """
    d = x[0].ndim
    shape = x[0].shape
    hi = jnp.pad(x[0], 1)
    mid = jnp.pad(x[1], 1)
    lo = jnp.pad(x[2], 1)

    fac = dyadic_factor(np.asarray(stencil, np.float64))
    zero = jnp.zeros(shape, dtype=jnp.float32)
    if fac is not None:
        c, D, R, terms_by_tap = fac
        s, e1, e2 = zero, zero, zero
        for idx in itertools.product(range(3), repeat=d):
            m = float(D[idx])
            r = 0.0 if R is None else float(R[idx])
            if m == 0.0 and r == 0.0:
                continue
            slices = tuple(slice(k, k + n) for k, n in zip(idx, shape))
            hs, ms, ls = hi[slices], mid[slices], lo[slices]
            for t in terms_by_tap.get(idx, ()):
                tf32_t = jnp.float32(t)
                s, err = two_sum(s, tf32_t * hs)  # exact product (pow2)
                # two separate two_sums: pre-adding err + t*ms in f32 would
                # round at ulp(err) ~ 1e-15 ABSOLUTE and silently drop it
                e1, err2a = two_sum(e1, err)
                e1, err2b = two_sum(e1, tf32_t * ms)  # exact product
                e2 = e2 + err2a + err2b + tf32_t * ls
            if r != 0.0:
                # assembly-rounding residual (~ulps of the tap): exact
                # product into the second/third words, pre-divided by c
                rp, re = two_prod(jnp.float32(r / c), hs)
                e1, err2 = two_sum(e1, rp)
                e2 = e2 + err2 + re
            s, e1 = fast_two_sum(s, e1)
        ch, cm, cl = _split64_3_const(c)
        return _tf_mul_words((s, e1, e2), ch, cm, cl)

    # general path: exact 3-word weight per tap
    acc = (zero, zero, zero)
    st = np.asarray(stencil, np.float64)
    for idx in itertools.product(range(3), repeat=d):
        w = float(st[idx])
        if w == 0.0:
            continue
        slices = tuple(slice(k, k + n) for k, n in zip(idx, shape))
        tap = (hi[slices], mid[slices], lo[slices])
        wh, wm, wl = _split64_3_const(w)
        acc = tf_add(acc, _tf_mul_words(tap, wh, wm, wl))
    return acc
