"""JAX-native Krylov solvers: restarted GMRES and CG.

The JAX replacement for PETSc's KSP (``ksp_type: gmres`` presets at
``/root/reference/src/perphil/solvers/parameters.py:12-27``). Semantics match
PETSc so iteration counts reproduce:

  - GMRES restarts every 30 iterations (PETSc default ``ksp_gmres_restart``),
  - classical Gram-Schmidt orthogonalization (PETSc default),
  - left preconditioning with the preconditioned-residual norm,
  - default convergence test ``rnorm <= max(rtol * rnorm0, atol)`` with
    ``rnorm0`` the initial (preconditioned) residual norm, and divergence
    at ``rnorm > 1e4 * rnorm0`` (``KSPConvergedDefault``'s divtol default,
    ``DEFAULT_DTOL`` below),
  - iteration counts reported like ``ksp.getIterationNumber()``
    (``solvers/solver.py:73-74``).

Everything is ``lax.while_loop``-based with static shapes: the Krylov basis
is a fixed ``(restart+1, n)`` buffer whose unused rows stay zero, so the
classical Gram-Schmidt projection is a single ``V @ w`` tall-matrix
product.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

# PETSc's KSPConvergedDefault divergence tolerance (divtol) default.
DEFAULT_DTOL = 1.0e4

Array = jnp.ndarray
Op = Callable[[Array], Array]


class KrylovResult(NamedTuple):
    x: Array
    iterations: Array  # int
    residual_norm: Array  # float
    converged: Array  # bool


def _identity(v: Array) -> Array:
    return v


def gmres(
    A: Op,
    b: Array,
    x0: Optional[Array] = None,
    rtol: float = 1.0e-5,
    atol: float = 1.0e-50,
    max_it: int = 10000,
    restart: int = 30,
    M_inv: Optional[Op] = None,
    dtol: float = DEFAULT_DTOL,
    reorthogonalize: bool = False,
) -> KrylovResult:
    """Left-preconditioned restarted GMRES, PETSc-compatible.

    :param A: matrix-free operator (flat vector -> flat vector).
    :param b: right-hand side (flat).
    :param M_inv: left preconditioner application (None = identity).
    :param reorthogonalize: CGS2 (second Gram-Schmidt pass). Default off:
        plain CGS, PETSc's default, which the golden counts assume.
    :returns: KrylovResult(x, iterations, residual_norm, converged).
    """
    P = M_inv or _identity
    dtype = b.dtype
    m = int(restart)
    x0 = jnp.zeros_like(b) if x0 is None else x0

    # Shape-general: b may be a flat vector or a stacked grid (e.g.
    # (2, nz, ny, nx) for two sharded pressure fields) — the Krylov basis
    # keeps the operand's shape so device shardings propagate untouched.
    nd = b.ndim
    op_axes = (tuple(range(1, nd + 1)), tuple(range(nd)))

    def basis_dot(V, w):  # (m+1, *shape) x (*shape) -> (m+1,)
        return jnp.tensordot(V, w, axes=op_axes)

    def basis_comb(h, V):  # (m+1,) x (m+1, *shape) -> (*shape)
        return jnp.tensordot(h, V, axes=((0,), (0,)))

    def vnorm(v):
        return jnp.sqrt(jnp.vdot(v, v)).real

    r0 = P(b - A(x0))
    rnorm0 = vnorm(r0)
    tol = jnp.maximum(rtol * rnorm0, atol)
    div = dtol * rnorm0

    def arnoldi_step(carry):
        V, R, g, cs, sn, j, its, rnorm, x = carry
        w = P(A(V[j]))
        # classical Gram-Schmidt: unused rows of V are zero, so the full
        # products are exact projections onto the current basis.
        h = basis_dot(V, w)
        w = w - basis_comb(h, V)
        if reorthogonalize:
            # CGS2: one reorthogonalization pass restores orthogonality lost
            # to reduction rounding; spans the same Krylov space, so
            # iteration counts in clean arithmetic are unchanged.
            c = basis_dot(V, w)
            w = w - basis_comb(c, V)
            h = h + c
        hj1 = vnorm(w)
        V = V.at[j + 1].set(w / jnp.where(hj1 > 0.0, hj1, 1.0))
        # apply stored Givens rotations to column h (entries 0..j)
        def rot(i, hv):
            hi = hv[i]
            hi1 = hv[i + 1]
            keep = i < j
            new_i = jnp.where(keep, cs[i] * hi + sn[i] * hi1, hi)
            new_i1 = jnp.where(keep, -sn[i] * hi + cs[i] * hi1, hi1)
            return hv.at[i].set(new_i).at[i + 1].set(new_i1)

        hfull = h.at[jnp.minimum(j + 1, m)].set(jnp.where(j + 1 <= m, hj1, 0.0))
        hfull = lax.fori_loop(0, m, rot, hfull)
        # new rotation zeroing hfull[j+1]
        a_ = hfull[j]
        b_ = hfull[j + 1]
        denom = jnp.sqrt(a_ * a_ + b_ * b_)
        denom_safe = jnp.where(denom > 0.0, denom, 1.0)
        c_new = jnp.where(denom > 0.0, a_ / denom_safe, 1.0)
        s_new = jnp.where(denom > 0.0, b_ / denom_safe, 0.0)
        cs = cs.at[j].set(c_new)
        sn = sn.at[j].set(s_new)
        hfull = hfull.at[j].set(c_new * a_ + s_new * b_).at[j + 1].set(0.0)
        R = R.at[:, j].set(hfull[:m])
        gj = g[j]
        g = g.at[j].set(c_new * gj).at[j + 1].set(-s_new * gj)
        rnorm = jnp.abs(g[j + 1])
        return V, R, g, cs, sn, j + 1, its + 1, rnorm, x

    def cycle(state):
        x, its, rnorm, done = state
        r = P(b - A(x))
        beta = vnorm(r)
        V = jnp.zeros((m + 1,) + b.shape, dtype=dtype)
        V = V.at[0].set(r / jnp.where(beta > 0.0, beta, 1.0))
        R = jnp.zeros((m, m), dtype=dtype)
        g = jnp.zeros(m + 1, dtype=dtype).at[0].set(beta)
        cs = jnp.zeros(m, dtype=dtype)
        sn = jnp.zeros(m, dtype=dtype)

        def inner_cond(carry):
            *_, j, its_i, rnorm_i, _x = carry
            ok = (j < m) & (its_i < max_it)
            ok &= rnorm_i > jnp.maximum(tol, 0.0)
            ok &= rnorm_i <= div
            return ok

        carry = (V, R, g, cs, sn, jnp.asarray(0), its, beta, x)
        V, R, g, cs, sn, j, its, rnorm, x = lax.while_loop(
            inner_cond, arnoldi_step, carry
        )
        # solve R[:j,:j] y = g[:j]; pad unused diagonal with 1, rhs with 0
        col = jnp.arange(m)
        Rm = jnp.where((col[None, :] >= j) & (col[:, None] == col[None, :]), 1.0, R)
        Rm = jnp.where((col[None, :] >= j) & (col[:, None] != col[None, :]), 0.0, Rm)
        gm = jnp.where(col < j, g[:m], 0.0)
        y = jax.scipy.linalg.solve_triangular(Rm, gm, lower=False)
        x = x + basis_comb(y, V[:m])
        # PETSc returns KSP_DIVERGED_NANORINF on a non-finite residual;
        # without this guard a NaN makes the inner loop exit without
        # iterating while `done` stays False -> an unbounded on-device
        # outer loop. j == 0 is the same belt-and-braces:
        # an inner loop that made no progress can never set done.
        done = (
            (rnorm <= tol) | (its >= max_it) | (rnorm > div)
            | ~jnp.isfinite(rnorm) | (j == 0)
        )
        return x, its, rnorm, done

    def outer_cond(state):
        _, its, rnorm, done = state
        return ~done

    # handle the trivial b = 0 / already-converged case
    init_done = rnorm0 <= tol
    x, its, rnorm, _ = lax.while_loop(
        outer_cond, cycle, (x0, jnp.asarray(0), rnorm0, init_done)
    )
    return KrylovResult(x, its, rnorm, rnorm <= tol)


# ---------------------------------------------------------------------------
# double-float (two-float32) variants — explicit opt-in
# ---------------------------------------------------------------------------
#
# Same PETSc semantics as gmres()/cg() above, but Krylov vectors are
# double-float (hi, lo) f32 pairs and the critical reductions run through
# error-free transformations (ops/dfvec.py). Effective unit roundoff ~6e-15.
# Scalar recurrences (Hessenberg, Givens) stay float64.
#
# The stored-rotation application is vectorized via an associative scan over
# the affine recurrence t_{i+1} = -sn_i t_i + cs_i h_{i+1} (identity
# rotations for i >= j make the masked form exact) — the sequential
# fori_loop in gmres() costs ~30 latency-bound scalar ops per iteration,
# which would dominate at small N. The native-dtype gmres() keeps the
# sequential loop so its CPU float64 trajectories (golden iteration-count
# parity) are untouched.


def _apply_rotations_scanned(hfull, cs, sn, j, m):
    """Apply stored Givens rotations 0..j-1 to column hfull (length m+1)."""
    idx = jnp.arange(m)
    cs_eff = jnp.where(idx < j, cs, 1.0)
    sn_eff = jnp.where(idx < j, sn, 0.0)
    # t_0 = h_0; t_{i+1} = -sn_i t_i + cs_i h_{i+1}
    a = -sn_eff  # multipliers, length m
    bv = cs_eff * hfull[1:]  # offsets, length m

    def combine(x, y):
        # affine composition (later o earlier): (a2 a1, a2 b1 + b2)
        a1, b1 = x
        a2, b2 = y
        return a2 * a1, a2 * b1 + b2

    aa, bb = lax.associative_scan(combine, (a, bv))
    # prefix state after i+1 steps: t_{i+1} = aa[i] * t_0 + bb[i]
    t = jnp.concatenate([hfull[0:1], aa * hfull[0] + bb])  # t_0..t_m
    new_h = cs_eff * t[:m] + sn_eff * hfull[1:]
    return jnp.concatenate([new_h, t[m : m + 1]])


def default_krylov_batch() -> int:
    """Iterations fused per ``lax.while_loop`` trip in the df Krylov loops.

    Running k masked iterations per trip divides the per-trip sequencing
    overhead by k. The masked steps reproduce the one-iteration-per-trip
    numerics and iteration counts EXACTLY (converged state is frozen via
    selects), so this is a pure overhead knob, not an algorithmic change.
    Default 1; ``PERPHIL_TPU_KRYLOV_BATCH`` overrides.
    """
    import os

    env = os.environ.get("PERPHIL_TPU_KRYLOV_BATCH")
    if env:
        return max(1, int(env))
    return 1


def gmres_df(
    A_df: Callable,
    b_df,
    x0_df=None,
    rtol: float = 1.0e-5,
    atol: float = 1.0e-50,
    max_it: int = 10000,
    restart: int = 30,
    M_inv_df: Optional[Callable] = None,
    dtol: float = DEFAULT_DTOL,
    batch: Optional[int] = None,
    residual_df: Optional[Callable] = None,
):
    """Left-preconditioned restarted GMRES on double-float vectors.

    ``residual_df(x_df, b_df) -> df``, when given, replaces the default
    restart-boundary residual ``b - A x`` (before preconditioning) with a
    higher-precision evaluation: the df default carries ~eps_df * |b|
    ABSOLUTE error, which near convergence (|r| << |b|) dominates the
    restart direction and can drift the iteration count by +-1 against
    an f64 implementation at knife-edge cells (see docs/design.md §7).

    ``A_df``/``M_inv_df`` map df pairs to df pairs; ``b_df`` is a df pair of
    f32 arrays of any shape. Returns ``KrylovResult`` with a df pair ``x``.
    Orthogonalization is single-pass classical Gram-Schmidt (PETSc's
    default) — df32 arithmetic is deterministic, so the CGS2 pass that
    guards the emulated-f64 path against backend reduction noise is not
    needed here.

    ``batch`` (default :func:`default_krylov_batch`) runs that many masked
    Arnoldi steps per while-loop trip: identical iterates and iteration
    counts, k× less per-trip sequencing overhead on this backend.
    """
    from perphil_tpu.ops.dfvec import (
        df_basis_comb,
        df_basis_dot,
        df_norm,
        df_scale64,
        df_vec_sub,
    )

    P = M_inv_df or (lambda v: v)
    m = int(restart)
    k_batch = default_krylov_batch() if batch is None else max(1, int(batch))
    shape = b_df[0].shape
    f32 = b_df[0].dtype
    if x0_df is None:
        z = jnp.zeros(shape, dtype=f32)
        x0_df = (z, z)

    if residual_df is None:

        def _raw_residual(x_df):
            return df_vec_sub(b_df, A_df(x_df))

    else:

        def _raw_residual(x_df):
            return residual_df(x_df, b_df)

    def _residual(x_df):
        return P(_raw_residual(x_df))

    r0 = _residual(x0_df)
    rnorm0 = df_norm(r0)
    tol = jnp.maximum(rtol * rnorm0, atol)
    div = dtol * rnorm0

    def arnoldi_step(carry):
        V, R, g, cs, sn, j, its, rnorm, x = carry
        vj = (V[0][j], V[1][j])
        w = P(A_df(vj))
        h = df_basis_dot(V, w)  # (m+1,) f64; unused rows of V are zero
        w = df_vec_sub(w, df_basis_comb(h, V))
        hj1 = df_norm(w)
        inv = jnp.where(hj1 > 0.0, 1.0 / hj1, 1.0)
        wn = df_scale64(w, inv)
        V = (V[0].at[j + 1].set(wn[0]), V[1].at[j + 1].set(wn[1]))
        hfull = h.at[jnp.minimum(j + 1, m)].set(jnp.where(j + 1 <= m, hj1, 0.0))
        hfull = _apply_rotations_scanned(hfull, cs, sn, j, m)
        a_ = hfull[j]
        b_ = hfull[j + 1]
        denom = jnp.sqrt(a_ * a_ + b_ * b_)
        denom_safe = jnp.where(denom > 0.0, denom, 1.0)
        c_new = jnp.where(denom > 0.0, a_ / denom_safe, 1.0)
        s_new = jnp.where(denom > 0.0, b_ / denom_safe, 0.0)
        cs = cs.at[j].set(c_new)
        sn = sn.at[j].set(s_new)
        hfull = hfull.at[j].set(c_new * a_ + s_new * b_).at[j + 1].set(0.0)
        R = R.at[:, j].set(hfull[:m])
        gj = g[j]
        g = g.at[j].set(c_new * gj).at[j + 1].set(-s_new * gj)
        rnorm = jnp.abs(g[j + 1])
        return V, R, g, cs, sn, j + 1, its + 1, rnorm, x

    def cycle(state):
        x, its, rnorm, done = state
        r = _residual(x)
        beta = df_norm(r)
        inv = jnp.where(beta > 0.0, 1.0 / beta, 1.0)
        v0 = df_scale64(r, inv)
        Vh = jnp.zeros((m + 1,) + shape, dtype=f32).at[0].set(v0[0])
        Vl = jnp.zeros((m + 1,) + shape, dtype=f32).at[0].set(v0[1])
        R = jnp.zeros((m, m), dtype=jnp.float64)
        g = jnp.zeros(m + 1, dtype=jnp.float64).at[0].set(beta)
        cs = jnp.zeros(m, dtype=jnp.float64)
        sn = jnp.zeros(m, dtype=jnp.float64)

        def inner_cond(carry):
            *_, j, its_i, rnorm_i, _x = carry
            ok = (j < m) & (its_i < max_it)
            ok &= rnorm_i > jnp.maximum(tol, 0.0)
            ok &= rnorm_i <= div
            return ok

        def masked_step(carry):
            # One Arnoldi step gated on the loop predicate: when inactive
            # (converged/diverged/cycle full) every carry element is left
            # untouched, so a k-step trip reproduces the 1-step-per-trip
            # iterate sequence and iteration count EXACTLY — the batching
            # only amortizes this backend's per-trip sequencing cost.
            V, R, g, cs, sn, j, its_i, rnorm_i, x_i = carry
            active = (
                (j < m)
                & (its_i < max_it)
                & (rnorm_i > jnp.maximum(tol, 0.0))
                & (rnorm_i <= div)
            )
            vj = (V[0][j], V[1][j])
            w = P(A_df(vj))
            h = df_basis_dot(V, w)
            w = df_vec_sub(w, df_basis_comb(h, V))
            hj1 = df_norm(w)
            inv = jnp.where(hj1 > 0.0, 1.0 / hj1, 1.0)
            wn = df_scale64(w, inv)
            # dynamic reads clamp and OOB scatter rows drop (j+1 == m+1
            # only ever happens when inactive), so the masked writes are
            # in-bounds whenever they matter
            j1r = jnp.minimum(j + 1, m)
            V = (
                V[0].at[j + 1].set(jnp.where(active, wn[0], V[0][j1r])),
                V[1].at[j + 1].set(jnp.where(active, wn[1], V[1][j1r])),
            )
            hfull = h.at[j1r].set(jnp.where(j + 1 <= m, hj1, 0.0))
            hfull = _apply_rotations_scanned(hfull, cs, sn, j, m)
            a_ = hfull[j]
            b_ = hfull[j1r]
            denom = jnp.sqrt(a_ * a_ + b_ * b_)
            denom_safe = jnp.where(denom > 0.0, denom, 1.0)
            c_new = jnp.where(denom > 0.0, a_ / denom_safe, 1.0)
            s_new = jnp.where(denom > 0.0, b_ / denom_safe, 0.0)
            cs = jnp.where(active, cs.at[j].set(c_new), cs)
            sn = jnp.where(active, sn.at[j].set(s_new), sn)
            hfull = hfull.at[j].set(c_new * a_ + s_new * b_).at[j + 1].set(0.0)
            R = jnp.where(active, R.at[:, j].set(hfull[:m]), R)
            gj = g[j]
            g = jnp.where(
                active, g.at[j].set(c_new * gj).at[j + 1].set(-s_new * gj), g
            )
            step = active.astype(j.dtype)
            rnorm_i = jnp.where(active, jnp.abs(-s_new * gj), rnorm_i)
            return V, R, g, cs, sn, j + step, its_i + step, rnorm_i, x_i

        def batched_steps(carry):
            for _ in range(k_batch):
                carry = masked_step(carry)
            return carry

        carry = ((Vh, Vl), R, g, cs, sn, jnp.asarray(0), its, beta, x)
        V, R, g, cs, sn, j, its, rnorm, x = lax.while_loop(
            inner_cond,
            arnoldi_step if k_batch == 1 else batched_steps,
            carry,
        )
        col = jnp.arange(m)
        Rm = jnp.where((col[None, :] >= j) & (col[:, None] == col[None, :]), 1.0, R)
        Rm = jnp.where((col[None, :] >= j) & (col[:, None] != col[None, :]), 0.0, Rm)
        gm = jnp.where(col < j, g[:m], 0.0)
        y = jax.scipy.linalg.solve_triangular(Rm, gm, lower=False)
        Vm = (V[0][:m], V[1][:m])
        upd = df_basis_comb(y, Vm)
        from perphil_tpu.ops.dfvec import df_vec_add

        x = df_vec_add(x, upd)
        # PETSc returns KSP_DIVERGED_NANORINF on a non-finite residual;
        # without this guard a NaN makes the inner loop exit without
        # iterating while `done` stays False -> an unbounded on-device
        # outer loop. j == 0 is the same belt-and-braces:
        # an inner loop that made no progress can never set done.
        done = (
            (rnorm <= tol) | (its >= max_it) | (rnorm > div)
            | ~jnp.isfinite(rnorm) | (j == 0)
        )
        return x, its, rnorm, done

    def outer_cond(state):
        _, its, rnorm, done = state
        return ~done

    init_done = rnorm0 <= tol
    x, its, rnorm, _ = lax.while_loop(
        outer_cond, cycle, (x0_df, jnp.asarray(0), rnorm0, init_done)
    )
    return KrylovResult(x, its, rnorm, rnorm <= tol)


def gmres_tf(
    A_tf: Callable,
    b_tf,
    x0_tf=None,
    rtol: float = 1.0e-5,
    atol: float = 1.0e-50,
    max_it: int = 10000,
    restart: int = 30,
    dtol: float = DEFAULT_DTOL,
):
    """Restarted GMRES on TRIPLE-float vectors (``ops/tf32``, ~71-bit) —
    a MEASUREMENT INSTRUMENT, not a production mode.

    Same structure, stopping semantics, and f64 scalar recurrence as
    :func:`gmres_df`; only the vector arithmetic is wider. Measured
    verdict (docs/design.md §7): at the knife-edge cells more-than-f64
    precision UNDERSHOOTS PETSc's counts — 2D N=8 lands 38 (PETSc 40,
    df32 42) because PETSc's own f64 rounding DELAYS
    convergence in the stagnation tail, and a ~2^-71 trajectory tracks
    the (faster) exact one. This function is the experiment that
    established that; the production knife-edge mode is
    :func:`gmres_ef64` (f64-FAITHFUL arithmetic).
    """
    from perphil_tpu.ops.tf32 import (
        tf_add,
        tf_basis_comb,
        tf_basis_dot,
        tf_norm,
        tf_scale64,
        tf_sub,
    )

    m = int(restart)
    shape = b_tf[0].shape
    f32 = b_tf[0].dtype
    if x0_tf is None:
        z = jnp.zeros(shape, dtype=f32)
        x0_tf = (z, z, z)

    def _residual(x_tf):
        return tf_sub(b_tf, A_tf(x_tf))

    r0 = _residual(x0_tf)
    rnorm0 = tf_norm(r0)
    tol = jnp.maximum(rtol * rnorm0, atol)
    div = dtol * rnorm0

    def cycle(state):
        x, its, rnorm, done = state
        r = _residual(x)
        beta = tf_norm(r)
        inv = jnp.where(beta > 0.0, 1.0 / beta, 1.0)
        v0 = tf_scale64(r, inv)
        V = tuple(
            jnp.zeros((m + 1,) + shape, dtype=f32).at[0].set(c) for c in v0
        )
        R = jnp.zeros((m, m), dtype=jnp.float64)
        g = jnp.zeros(m + 1, dtype=jnp.float64).at[0].set(beta)
        cs = jnp.zeros(m, dtype=jnp.float64)
        sn = jnp.zeros(m, dtype=jnp.float64)

        def inner_cond(carry):
            *_, j, its_i, rnorm_i, _x = carry
            ok = (j < m) & (its_i < max_it)
            ok &= rnorm_i > jnp.maximum(tol, 0.0)
            ok &= rnorm_i <= div
            return ok

        def arnoldi_step(carry):
            V, R, g, cs, sn, j, its_i, rnorm_i, x_i = carry
            vj = tuple(c[j] for c in V)
            w = A_tf(vj)
            h = tf_basis_dot(V, w)  # (m+1,) f64
            w = tf_sub(w, tf_basis_comb(h, V))
            hj1 = tf_norm(w)
            inv = jnp.where(hj1 > 0.0, 1.0 / hj1, 1.0)
            wn = tf_scale64(w, inv)
            V = tuple(c.at[j + 1].set(wc) for c, wc in zip(V, wn))
            hfull = h.at[jnp.minimum(j + 1, m)].set(jnp.where(j + 1 <= m, hj1, 0.0))
            hfull = _apply_rotations_scanned(hfull, cs, sn, j, m)
            a_ = hfull[j]
            b_ = hfull[j + 1]
            denom = jnp.sqrt(a_ * a_ + b_ * b_)
            denom_safe = jnp.where(denom > 0.0, denom, 1.0)
            c_new = jnp.where(denom > 0.0, a_ / denom_safe, 1.0)
            s_new = jnp.where(denom > 0.0, b_ / denom_safe, 0.0)
            cs = cs.at[j].set(c_new)
            sn = sn.at[j].set(s_new)
            hfull = hfull.at[j].set(c_new * a_ + s_new * b_).at[j + 1].set(0.0)
            R = R.at[:, j].set(hfull[:m])
            gj = g[j]
            g = g.at[j].set(c_new * gj).at[j + 1].set(-s_new * gj)
            rnorm_i = jnp.abs(g[j + 1])
            return V, R, g, cs, sn, j + 1, its_i + 1, rnorm_i, x_i

        carry = (V, R, g, cs, sn, jnp.asarray(0), its, beta, x)
        V, R, g, cs, sn, j, its, rnorm, x = lax.while_loop(
            inner_cond, arnoldi_step, carry
        )
        col = jnp.arange(m)
        Rm = jnp.where((col[None, :] >= j) & (col[:, None] == col[None, :]), 1.0, R)
        Rm = jnp.where((col[None, :] >= j) & (col[:, None] != col[None, :]), 0.0, Rm)
        gm = jnp.where(col < j, g[:m], 0.0)
        y = jax.scipy.linalg.solve_triangular(Rm, gm, lower=False)
        Vm = tuple(c[:m] for c in V)
        x = tf_add(x, tf_basis_comb(y, Vm))
        done = (
            (rnorm <= tol) | (its >= max_it) | (rnorm > div)
            | ~jnp.isfinite(rnorm) | (j == 0)
        )
        return x, its, rnorm, done

    def outer_cond(state):
        _, its, rnorm, done = state
        return ~done

    init_done = rnorm0 <= tol
    x, its, rnorm, _ = lax.while_loop(
        outer_cond, cycle, (x0_tf, jnp.asarray(0), rnorm0, init_done)
    )
    return KrylovResult(x, its, rnorm, rnorm <= tol)


def gmres_ef64(
    A: Callable,
    b,
    x0=None,
    rtol: float = 1.0e-5,
    atol: float = 1.0e-50,
    max_it: int = 10000,
    restart: int = 30,
    dtol: float = DEFAULT_DTOL,
):
    """Restarted GMRES in f64 with pairwise halving-tree reductions — the
    df32 path's knife-edge parity mode.

    Why f64-faithful and not wider (docs/design.md §7, measured): at the
    knife-edge cells (2D N=8 -> 40, 3D nx=4 -> 27) the published PETSc
    count includes delay caused by PETSc's OWN f64 rounding — df32
    (~49-bit) overshoots (42/28), tf32 (~71-bit) undershoots (38), and
    only f64-grade per-op rounding lands the published number. Counts are
    robust to op ORDER within the f64 class (the 111-row CPU parity
    record spans XLA's reassociations), so this implementation uses
    pairwise halving-tree reductions
    (``experiments/f64_structure_probe.py`` pins both cells).

    ``A``, ``b``, ``x0`` are plain f64 (stacked-grid shaped), so this IS
    f64-faithful arithmetic by construction.
    """
    m = int(restart)
    shape = b.shape

    def _tree(p, keep_leading=0):
        lead = p.shape[:keep_leading]
        L = int(np.prod(p.shape[keep_leading:])) if p.ndim > keep_leading else 1
        p = p.reshape(lead + (L,))
        L2 = 1 << max(0, (L - 1).bit_length())
        if L2 != L:
            p = jnp.pad(p, [(0, 0)] * len(lead) + [(0, L2 - L)])
        while L2 > 1:
            half = L2 // 2
            p = p[..., :half] + p[..., half:]
            L2 = half
        return p[..., 0]

    def basis_dot(V, w):
        return _tree(V * w[None], keep_leading=1)

    def basis_comb(h, V):
        t = h.reshape((-1,) + (1,) * b.ndim) * V
        return _tree(jnp.moveaxis(t, 0, -1), keep_leading=b.ndim)

    def vnorm(v):
        return jnp.sqrt(_tree(v * v))

    if x0 is None:
        x0 = jnp.zeros_like(b)

    def _residual(x):
        return b - A(x)

    r0 = _residual(x0)
    rnorm0 = vnorm(r0)
    tol = jnp.maximum(rtol * rnorm0, atol)
    div = dtol * rnorm0

    def cycle(state):
        x, its, rnorm, done = state
        r = _residual(x)
        beta = vnorm(r)
        inv = jnp.where(beta > 0.0, 1.0 / beta, 1.0)
        v0 = r * inv
        V = jnp.zeros((m + 1,) + shape, dtype=b.dtype).at[0].set(v0)
        R = jnp.zeros((m, m), dtype=b.dtype)
        g = jnp.zeros(m + 1, dtype=b.dtype).at[0].set(beta)
        cs = jnp.zeros(m, dtype=b.dtype)
        sn = jnp.zeros(m, dtype=b.dtype)

        def inner_cond(carry):
            *_, j, its_i, rnorm_i, _x = carry
            ok = (j < m) & (its_i < max_it)
            ok &= rnorm_i > jnp.maximum(tol, 0.0)
            ok &= rnorm_i <= div
            return ok

        def arnoldi_step(carry):
            V, R, g, cs, sn, j, its_i, rnorm_i, x_i = carry
            w = A(V[j])
            h = basis_dot(V, w)
            w = w - basis_comb(h, V)
            hj1 = vnorm(w)
            inv = jnp.where(hj1 > 0.0, 1.0 / hj1, 1.0)
            V = V.at[j + 1].set(w * inv)
            hfull = h.at[jnp.minimum(j + 1, m)].set(
                jnp.where(j + 1 <= m, hj1, 0.0)
            )
            hfull = _apply_rotations_scanned(hfull, cs, sn, j, m)
            a_ = hfull[j]
            b_ = hfull[j + 1]
            denom = jnp.sqrt(a_ * a_ + b_ * b_)
            denom_safe = jnp.where(denom > 0.0, denom, 1.0)
            c_new = jnp.where(denom > 0.0, a_ / denom_safe, 1.0)
            s_new = jnp.where(denom > 0.0, b_ / denom_safe, 0.0)
            cs = cs.at[j].set(c_new)
            sn = sn.at[j].set(s_new)
            hfull = hfull.at[j].set(c_new * a_ + s_new * b_).at[j + 1].set(0.0)
            R = R.at[:, j].set(hfull[:m])
            gj = g[j]
            g = g.at[j].set(c_new * gj).at[j + 1].set(-s_new * gj)
            rnorm_i = jnp.abs(g[j + 1])
            return V, R, g, cs, sn, j + 1, its_i + 1, rnorm_i, x_i

        carry = (V, R, g, cs, sn, jnp.asarray(0), its, beta, x)
        V, R, g, cs, sn, j, its, rnorm, x = lax.while_loop(
            inner_cond, arnoldi_step, carry
        )
        col = jnp.arange(m)
        Rm = jnp.where(
            (col[None, :] >= j) & (col[:, None] == col[None, :]), 1.0, R
        )
        Rm = jnp.where(
            (col[None, :] >= j) & (col[:, None] != col[None, :]), 0.0, Rm
        )
        gm = jnp.where(col < j, g[:m], 0.0)
        y = jax.scipy.linalg.solve_triangular(Rm, gm, lower=False)
        x = x + basis_comb(y, V[:m])
        done = (
            (rnorm <= tol)
            | (its >= max_it)
            | (rnorm > div)
            | ~jnp.isfinite(rnorm)
            | (j == 0)
        )
        return x, its, rnorm, done

    init_done = rnorm0 <= tol
    x, its, rnorm, _ = lax.while_loop(
        lambda s: ~s[3], cycle, (x0, jnp.asarray(0), rnorm0, init_done)
    )
    return KrylovResult(x, its, rnorm, rnorm <= tol)


def cg_df(
    A_df: Callable,
    b_df,
    x0_df=None,
    rtol: float = 1.0e-8,
    atol: float = 1.0e-12,
    max_it: int = 10000,
    M_inv_df: Optional[Callable] = None,
    batch: Optional[int] = None,
    conv_norm: str = "unpreconditioned",
):
    """Preconditioned CG on double-float vectors (see :func:`cg`).

    ``batch`` (default :func:`default_krylov_batch`) fuses that many masked
    CG steps per while-loop trip — identical iterates/counts, k× less
    per-trip sequencing overhead (the dominant cost of the SS-GMRES+ILU
    inner block solves on this backend).

    ``conv_norm="preconditioned"`` tests convergence on ``||M⁻¹r||`` — the
    left-preconditioned norm :func:`gmres_df` uses — so a CG solve can be
    tolerance-matched as a drop-in for a preconditioned GMRES solve (the
    fieldsplit inner-block substitution in ``solvers/solver.py``); the
    default tests the true residual ``||r||``.
    """
    from perphil_tpu.ops.dfvec import (
        df_axpy64,
        df_dot,
        df_scale64,
        df_vec_sub,
    )

    P = M_inv_df or (lambda v: v)
    f32 = b_df[0].dtype
    k_batch = default_krylov_batch() if batch is None else max(1, int(batch))
    if x0_df is None:
        z = jnp.zeros(b_df[0].shape, dtype=f32)
        x0_df = (z, z)

    if conv_norm not in ("unpreconditioned", "preconditioned"):
        raise ValueError(f"Unsupported conv_norm: {conv_norm!r}")
    precond_norm = conv_norm == "preconditioned"

    def _conv_norm(r, z):
        v = z if precond_norm else r
        return jnp.sqrt(df_dot(v, v))

    r = df_vec_sub(b_df, A_df(x0_df))
    z = P(r)
    rnorm0 = _conv_norm(r, z)
    tol = jnp.maximum(rtol * rnorm0, atol)

    def cond(state):
        x, r, z, p, rz, its, rnorm = state
        return (rnorm > tol) & (its < max_it)

    def body(state):
        x, r, z, p, rz, its, rnorm = state
        Ap = A_df(p)
        alpha = rz / df_dot(p, Ap)
        x = df_axpy64(x, alpha, p)
        r = df_axpy64(r, -alpha, Ap)
        z = P(r)
        rz_new = df_dot(r, z)
        p_new = df_axpy64(z, rz_new / rz, p)
        rnorm = _conv_norm(r, z)
        return x, r, z, p_new, rz_new, its + 1, rnorm

    def masked_body(state):
        # One CG step gated on the loop predicate: a frozen (converged)
        # state passes through untouched, so k-step trips reproduce the
        # plain loop's iterates and counts exactly.
        x, r, z, p, rz, its, rnorm = state
        active = (rnorm > tol) & (its < max_it)

        def sel(new, old):
            return jax.tree_util.tree_map(
                lambda u, v: jnp.where(active, u, v), new, old
            )

        n = body(state)
        return (
            sel(n[0], x),
            sel(n[1], r),
            sel(n[2], z),
            sel(n[3], p),
            jnp.where(active, n[4], rz),
            its + active.astype(its.dtype),
            jnp.where(active, n[6], rnorm),
        )

    def batched_body(state):
        for _ in range(k_batch):
            state = masked_body(state)
        return state

    state = (x0_df, r, z, z, df_dot(r, z), jnp.asarray(0), rnorm0)
    x, r, z, p, rz, its, rnorm = lax.while_loop(
        cond, body if k_batch == 1 else batched_body, state
    )
    return x, its, rnorm


def cg(
    A: Op,
    b: Array,
    x0: Optional[Array] = None,
    rtol: float = 1.0e-8,
    atol: float = 1.0e-12,
    max_it: int = 10000,
    M_inv: Optional[Op] = None,
) -> Tuple[Array, Array, Array]:
    """Preconditioned conjugate gradients (for SPD operators).

    Convergence on the unpreconditioned residual 2-norm relative to the
    initial residual. Shape-agnostic: works on grid or flat arrays.
    Returns (x, iterations, residual_norm).
    """
    P = M_inv or _identity
    x0 = jnp.zeros_like(b) if x0 is None else x0

    def dot(u, v):
        return jnp.vdot(u, v)

    r = b - A(x0)
    z = P(r)
    rnorm0 = jnp.sqrt(dot(r, r)).real
    tol = jnp.maximum(rtol * rnorm0, atol)

    def cond(state):
        x, r, z, p, rz, its, rnorm = state
        return (rnorm > tol) & (its < max_it)

    def body(state):
        x, r, z, p, rz, its, rnorm = state
        Ap = A(p)
        alpha = rz / dot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = P(r)
        rz_new = dot(r, z)
        p = z + (rz_new / rz) * p
        rnorm = jnp.sqrt(dot(r, r)).real
        return x, r, z, p, rz_new, its + 1, rnorm

    state = (x0, r, z, z, dot(r, z), jnp.asarray(0), rnorm0)
    x, r, z, p, rz, its, rnorm = lax.while_loop(cond, body, state)
    return x, its, rnorm
