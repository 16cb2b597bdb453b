"""Double-float (two-float32) arithmetic: f64-quality compute from f32 ops.

A value is an unevaluated sum ``hi + lo`` of two float32s (~49-bit
mantissa, unit roundoff ~6e-15), with error-free transformations (Knuth
two-sum, Dekker split / two-product) implemented in native f32 ops.

Used by the mixed-precision direct solver (``ops/mixed.py``): f32
fast-diagonalization + double-float residuals inside iterative refinement
reach float64-level accuracy from float32 arithmetic. The solvers reach
this module only when a caller asks for it (``TPU_DIRECT_PARAMS``,
``PERPHIL_TPU_KSP_DTYPE=df32``, ``PERPHIL_TPU_EXACT_SOLVES=mixed``); the
default path is native float64 on every backend.

All functions operate elementwise on (hi, lo) array pairs and are
jit/shard-transparent.
"""

from __future__ import annotations

import itertools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

DF = Tuple[jnp.ndarray, jnp.ndarray]

# --- CPU-jit hazard (XLA:CPU) -----------------------------------------------
#
# XLA:CPU duplicates a producer expression into each consumer fusion, and
# LLVM then FMA-contracts single-use ``a*b +/- c`` patterns independently in
# each fusion. For an EFT that means e.g. ``fast_two_sum(p, e)``'s ``s`` and
# ``err`` outputs each re-derive ``p = a*b`` and contract it into their own
# adds, so ``p`` never exists as ONE rounded value and the error term
# collapses to f32-grade noise (measured: 5.8e-8 relative in df_scale under
# plain jit vs 6e-15 eager). ``lax.optimization_barrier`` does NOT help —
# XLA:CPU expands barriers away before fusion. No XLA flag disables the
# contraction selectively; ``--xla_backend_optimization_level=0`` does (it
# bypasses LLVM's DAG combiner), verified to restore bit-exact eager==jit.
#
# Default solves are unaffected: they run native f64 (x64). Any CPU
# *validation* of df32 numerics must compile with the options below.


class DoubleFloatUnsupported(RuntimeError):
    """The double-float stack was asked to run on a backend where its
    error-free transformations are not exact."""


def require_exact_eft() -> None:
    """Refuse the double-float solvers on XLA:GPU.

    XLA:GPU breaks the EFTs: on an H100 the df mixed direct solve at 3D
    128^3 stalls at a true-f64 relative residual of 2.8e-8 (f32 grade)
    instead of reaching ~1e-15, consistent with the low words lost to FMA
    contraction inside fusions as on XLA:CPU jit (see the hazard note
    below). A solver that would return such an answer as f64-grade raises
    instead. The native float64 path is the default on every backend.
    """
    if jax.default_backend() == "gpu":
        raise DoubleFloatUnsupported(
            "double-float (df32) arithmetic is not exact under XLA:GPU (its "
            "error-free transformations lose the low word); use the "
            "default native float64 solvers instead "
            "of TPU_DIRECT_PARAMS / fastdiag_mixed, PERPHIL_TPU_KSP_DTYPE="
            "df32 or PERPHIL_TPU_EXACT_SOLVES=mixed"
        )


def eft_safe_compiler_options() -> dict:
    """Compiler options under which CPU-jitted EFT code is bit-exact with
    eager semantics (see the hazard note above). Usage::

        fn = jax.jit(f).lower(*args).compile(
            compiler_options=eft_safe_compiler_options())

    Disables the LLVM backend optimization that licenses FMA contraction
    inside XLA:CPU fusions. Only CPU validation uses it.
    """
    return {"xla_backend_optimization_level": "0"}


def two_sum(a, b) -> DF:
    """Error-free a + b = s + e (Knuth)."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def fast_two_sum(a, b) -> DF:
    """Error-free a + b = s + e assuming |a| >= |b| (Dekker)."""
    s = a + b
    e = b - (s - a)
    return s, e


def split(a) -> DF:
    """Veltkamp split: a = hi + lo with both halves' significands short
    enough (<= 12 bits each for f32) that every cross product in
    ``two_prod`` is exactly representable in the working precision.

    Implemented by integer mantissa masking (round-to-nearest-short via
    add-then-truncate on the bit pattern) rather than Dekker's classic
    multiplicative splitter ``t = (2^12+1)*a; hi = t - (t - a)``. The
    multiplicative form depends on each intermediate being rounded
    separately, which LLVM's FMA contraction inside XLA:CPU fused loops is
    licensed to break (e.g. ``t - a`` contracts to ``fma(4097, a, -a)``,
    skipping the rounding of ``t``); the breakage is fusion-context
    dependent, so the same EFT gives different answers eager vs jit.
    With masked splitting there is no multiply to
    contract, and because the halves' products are exact,
    ``fma(x, y, z) == RN(x*y) + z`` wherever contraction does fire later in
    ``two_prod`` — a provable no-op. Bonus over Dekker: no overflow for
    |a| > 2^115.
    """
    a = jnp.asarray(a)
    if a.ndim == 0:
        # 0-d operands (trace-time constants and scalar recurrences) use
        # the multiplicative Dekker split; CPU validation of their numerics
        # compiles with eft_safe_compiler_options() (see hazard note above).
        splitter = a.dtype.type(134217729.0 if a.dtype == jnp.float64 else 4097.0)
        t = splitter * a
        hi = t - (t - a)
        return hi, a - hi
    if a.dtype == jnp.float64:  # CPU parity path under jax_enable_x64
        uint, round_bit, keep = jnp.uint64, 1 << 26, ~np.uint64((1 << 27) - 1)
    else:
        uint, round_bit, keep = jnp.uint32, 1 << 11, ~np.uint32((1 << 12) - 1)
    bits = jax.lax.bitcast_convert_type(a, uint)
    hi = jax.lax.bitcast_convert_type((bits + uint(round_bit)) & uint(keep), a.dtype)
    lo = a - hi
    return hi, lo


def two_prod(a, b) -> DF:
    """Error-free a * b = p + e (Dekker two-product, no FMA assumed)."""
    p = a * b
    a_hi, a_lo = split(a)
    b_hi, b_lo = split(b)
    e = ((a_hi * b_hi - p) + a_hi * b_lo + a_lo * b_hi) + a_lo * b_lo
    return p, e


def df_from_f64(x64) -> DF:
    """Split a float64 array into a double-float pair (IO boundary only)."""
    x64 = jnp.asarray(x64, dtype=jnp.float64)
    hi = x64.astype(jnp.float32)
    lo = (x64 - hi.astype(jnp.float64)).astype(jnp.float32)
    return hi, lo


def df_to_f64(x: DF):
    """Recombine into float64 (host-side verification only)."""
    return x[0].astype(jnp.float64) + x[1].astype(jnp.float64)


def df_add(x: DF, y: DF) -> DF:
    """Double-float addition (Dekker/Knuth, ~11 flops)."""
    s, e = two_sum(x[0], y[0])
    e = e + x[1] + y[1]
    return fast_two_sum(s, e)


def df_neg(x: DF) -> DF:
    return -x[0], -x[1]


def df_sub(x: DF, y: DF) -> DF:
    return df_add(x, df_neg(y))


def df_scale_f32(x: DF, w) -> DF:
    """Double-float times exact-ish f32 scalar/array w."""
    p, e = two_prod(x[0], w)
    e = e + x[1] * w
    return fast_two_sum(p, e)


def df_mul(x: DF, y: DF) -> DF:
    p, e = two_prod(x[0], y[0])
    e = e + x[0] * y[1] + x[1] * y[0]
    return fast_two_sum(p, e)


def df_axpy_wf64(acc: DF, w64: float, v: DF) -> DF:
    """acc += w * v with w given in f64 (split into a df constant)."""
    w_hi = np.float32(w64)
    w_lo = np.float32(w64 - float(w_hi))
    term = df_scale_f32(v, w_hi)
    if float(w_lo) != 0.0:
        # skip the correction entirely for f32-exact weights (common for
        # stencil constants like -1/4): it is a trace-time constant-zero
        # that would still cost a df_scale + df_add per grid point
        term = df_add(term, df_scale_f32(v, w_lo))
    return df_add(acc, term)


# ---------------------------------------------------------------------------
# double-float stencil application (the accurate residual matvec)
# ---------------------------------------------------------------------------


def _dyadic_terms(m: float, max_bits: int = 3, rel_tol: float = 0.0):
    """Greedy nearest-pow2 expansion of a dyadic rational into signed
    power-of-two terms (e.g. 3 -> [2, 1], 1.5 -> [1, 0.5], 1.75 ->
    [2, -0.25]). Returns the term list, or None if ``m`` needs more than
    ``max_bits`` terms. Each leading-pow2 subtraction is exact in f64
    (Sterbenz: the remainder stays within a factor 2 of the subtrahend),
    so a zero remainder certifies ``m == sum(terms)`` exactly. A nonzero
    ``rel_tol`` accepts (and discards) a remainder up to ``rel_tol * |m|``
    — the snap-to-nearest-dyadic mode for ratios a few assembly-rounding
    ulps off an exact dyadic."""
    import math

    terms = []
    x = float(m)
    for _ in range(max_bits):
        if x == 0.0:
            break
        p = math.copysign(2.0 ** math.floor(math.log2(abs(x))), x)
        if abs(x - 2.0 * p) < abs(x - p):  # nearest pow2, not floor
            p *= 2.0
        terms.append(p)
        x -= p
    if abs(x) > rel_tol * abs(m):
        return None
    return terms


def dyadic_factor(
    stencil: np.ndarray, max_bits: int = 3, noise_rel: float = 1e-14
):
    """Factor ``stencil == c * D + R`` (modulo dropped sub-noise taps):
    the factoring behind the fast stencil paths, covering every stencil
    the library produces.

    - ``D``: the dyadic pattern — each nonzero a signed dyadic rational
      with at most ``max_bits`` pow2 terms (``_dyadic_terms``), so every
      per-term tap product is EXACT in f32. P1 tet ratios {1, 1.5, 6, 12}
      and Q1 quad/hex ratios {1, 2, 4, 8, 16, 32, 64} all fit in 2 terms.
    - ``R``: the residual stencil absorbing assembly-rounding ulps — e.g.
      the 3D hex stiffness diagonal sums to 1 ulp off an exact 32x
      multiple of the off-diagonal, which used to force the whole stencil
      onto the general per-tap-EFT path. ``c*D + R`` reproduces each
      significant entry to < 1 ulp of its own magnitude (R entries are a
      few ulps of their tap, applied via the general split-EFT axpy).
    - Entries below ``noise_rel * max|stencil|`` are DROPPED: they are
      f64 cancellation noise from element-sum assembly (the P1 tet
      stiffness stencil carries ~6 taps at ~5e-18 relative), ~30 orders
      below the double-float unit roundoff — removing them perturbs the
      applied operator by less than one f64 ulp while halving the tet
      stiffness tap count.

    Returns ``(c, D, R, terms)`` — ``R`` is None when exactly zero and
    ``terms`` maps each active tap index to the verified pow2-term tuple
    of ``D[idx]`` (consumers apply these directly; no re-expansion) — or
    None when any significant tap is not within a few ulps of a
    ``max_bits``-dyadic multiple of ``c`` (anisotropic/general stencils
    -> per-tap-EFT path).
    """
    st = np.asarray(stencil, np.float64)
    amax = float(np.abs(st).max())
    if amax == 0.0:
        return None
    sig = np.abs(st) > noise_rel * amax
    if not sig.any():
        return None
    c = float(np.abs(st[sig]).min())
    D = np.zeros_like(st)
    R = np.zeros_like(st)
    terms_by_tap = {}
    for idx in np.ndindex(st.shape):
        v = float(st[idx])
        if v == 0.0 or not sig[idx]:
            continue
        m = v / c
        # snap to the nearest max_bits-dyadic within a few ulps (assembly
        # rounding); an exact dyadic passes with a zero remainder
        terms = _dyadic_terms(m, max_bits, rel_tol=4e-15)
        if terms is None:
            return None
        d = float(np.sum(np.asarray(terms, np.float64)))  # exact (dyadic)
        r = v - c * d  # |r| <= few ulps of |v| -> the f64 sub is exact-ish
        if abs(r) > 4e-15 * abs(v):
            return None
        D[idx] = d
        terms_by_tap[idx] = tuple(terms)
        if r != 0.0:
            R[idx] = r
    return c, D, (R if np.any(R) else None), terms_by_tap


def df_apply_stencil(x: DF, stencil: np.ndarray) -> DF:
    """Apply a constant 3^d stencil (float64 weights) to a double-float grid,
    keeping ~49-bit accuracy — the fast replacement for the emulated-f64
    stencil matvec in residual computations.

    Fast path (taken by every uniform-grid stencil in the library — Q1
    quad/hex AND P1 tri/tet, via ``dyadic_factor``): the weights factor as
    ``c * dyadic + residual``, each dyadic pow2-term product ``t * x`` is
    EXACT in f32, so the apply needs no per-tap two_prod — a two_sum
    accumulation cascade per term, one lo product per tap, plain-f32
    residual taps (ulp-grade weights), and ONE df scale by the factored-out
    ``c`` at the end. Far fewer ops than the per-tap-EFT general path,
    and slightly MORE accurate (9.0e-15 vs 1.2e-14
    worst-case relative on the hex K stencil) because the products carry no
    rounding at all. Also contraction-safe on XLA:CPU without compile-option
    games: the accumulation has no multiplies for LLVM to FMA-contract, and
    the final scale uses the masked split (see hazard note above)."""
    d = x[0].ndim
    shape = x[0].shape
    hi = jnp.pad(x[0], 1)
    lo = jnp.pad(x[1], 1)

    fac = dyadic_factor(np.asarray(stencil, np.float64))
    if fac is not None:
        c, D, R, terms_by_tap = fac
        s = jnp.zeros(shape, dtype=jnp.float32)
        e = jnp.zeros(shape, dtype=jnp.float32)
        for idx in itertools.product(range(3), repeat=d):
            m = float(D[idx])
            r = 0.0 if R is None else float(R[idx])
            if m == 0.0 and r == 0.0:
                continue
            slices = tuple(slice(k, k + n) for k, n in zip(idx, shape))
            hs = hi[slices]
            terms = terms_by_tap.get(idx, ())
            if len(terms) == 1 and r == 0.0:
                # pure-pow2 tap: keep the exact accumulation order of the
                # original pow2 fast path (bit-identical trajectories for
                # every pow2-exact stencil, incl. all published Q1 cells)
                p = jnp.float32(m) * hs  # exact: m is a signed pow2
                s, err = two_sum(s, p)
                e = e + (err + jnp.float32(m) * lo[slices])
            else:
                for t in terms:
                    p = jnp.float32(t) * hs  # exact: t is a signed pow2
                    s, err = two_sum(s, p)
                    e = e + err
                if m != 0.0:
                    # one lo product per tap with the full dyadic weight
                    # (its f32 rounding lands ~1e-21 relative)
                    e = e + jnp.float32(m) * lo[slices]
                if r != 0.0:
                    # assembly-rounding residual (ulps of the tap): a
                    # plain f32 product folded into the lo accumulator
                    # pre-divided by c so the final scale below applies
                    # uniformly
                    e = e + jnp.float32(r / c) * hs
            s, e = fast_two_sum(s, e)  # keep |e| <= ulp(s): costs ~nothing
        c_hi = np.float32(c)
        c_lo = np.float32(c - float(c_hi))
        p, err = two_prod(s, c_hi)
        err = err + (s * c_lo + e * c_hi)
        return fast_two_sum(p, err)

    acc = (jnp.zeros(shape, dtype=jnp.float32), jnp.zeros(shape, dtype=jnp.float32))
    for idx in itertools.product(range(3), repeat=d):
        w = float(stencil[idx])
        if w == 0.0:
            continue
        slices = tuple(slice(k, k + s) for k, s in zip(idx, shape))
        acc = df_axpy_wf64(acc, w, (hi[slices], lo[slices]))
    return acc
