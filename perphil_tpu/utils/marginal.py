"""Chained-marginal timing: the ONE implementation of (T(2K) - T(K)) / K.

Every execution pays a fixed cost (dispatch, host readback) regardless of
program size. Dividing a single K-trip chain by K therefore folds a
fixed/K phantom floor into every per-application figure; the MARGINAL
between a K-trip and a 2K-trip chain cancels the fixed cost exactly. Three
rules, all enforced here so callers cannot diverge:

1. **Size K from a dispatch-free estimate.** The pilot runs BOTH K and 2K
   and estimates the per-trip cost from their marginal — never from
   ``T(K)/K``, which is dispatch-inflated and under-chains fast stages by
   the ratio of dispatch to true cost (the round-3 small-N timing bug, and
   round 4's first roofline harness repeated it).
2. **The marginal window T(2K) - T(K) must dwarf dispatch jitter.** The
   loop grows K until the measured window reaches ``window`` seconds
   (default 0.25 s, ~100x the few-ms jitter), so a +-1 ms wobble between
   the two chains moves the figure <1%.
3. **A jitter-scale marginal is a failed measurement, not a number.**
   Callers get a ``MarginalTimingError`` when the window comes out
   non-positive OR stays sub-window at the K cap, instead of a silently
   clamped epsilon (which once turned jitter into a 1.8e10x "speedup").

Used by ``bench.py`` and ``experiments/levelsched_eval.py``; the profiling
CSV drivers implement the same doctrine with extra chunking machinery
(``profiling._solve_wall``).
"""

from __future__ import annotations

import time
from typing import Callable, Sequence

import numpy as np


class MarginalTimingError(RuntimeError):
    """The (T(2K)-T(K)) window came out non-positive: jitter exceeded the
    window and the measurement is invalid. Re-run; do not clamp."""


def chained_marginal(
    make_chain: Callable[[int], Callable],
    args: Sequence,
    k0: int,
    *,
    window: float = 0.25,
    best_of: int = 3,
    k_max: int = 200_000,
) -> float:
    """Per-application seconds of the chained computation ``make_chain``.

    ``make_chain(length)`` must return a jitted callable running ``length``
    DEPENDENT applications (each trip's input perturbed by the previous
    trip's output so nothing is cached, elided, or hoisted) ending in one
    scalar readback. ``chained_marginal`` warms each chain once, takes the
    best of ``best_of`` timed runs per length, and grows K geometrically
    (bounded 64x per step so one noisy pilot cannot explode the chain
    length) until the marginal window T(2K)-T(K) reaches ``window``
    seconds. Returns (T(2K)-T(K))/K at the final K.
    """

    def run(chain: Callable) -> float:
        s = float(chain(*args))  # warmup / compile
        assert np.isfinite(s), "chain produced a non-finite keep-alive sum"
        best = float("inf")
        for _ in range(best_of):
            t0 = time.perf_counter()
            s = float(chain(*args))
            best = min(best, time.perf_counter() - t0)
            assert np.isfinite(s)
        return best

    K = max(1, int(k0))
    while True:
        t1, t2 = run(make_chain(K)), run(make_chain(2 * K))
        gap = t2 - t1
        if gap >= 0.8 * window or K >= k_max:
            break
        per = gap / K
        if per > 0:
            target = int(np.ceil(window / per))
            K = min(k_max, max(8 * K, min(target, 64 * K)))
        else:  # jitter swamped the pilot window entirely: grow blind
            K = min(k_max, 8 * K)
    if gap <= 0:
        raise MarginalTimingError(
            f"non-positive marginal at K={K}: T(K)={t1:.4f}s >= T(2K)={t2:.4f}s "
            "(dispatch jitter exceeded the window; re-run)"
        )
    if gap < 0.8 * window and K >= k_max:
        # K maxed out before the window was reached: the gap is jitter-scale
        # and indistinguishable from noise — a tiny POSITIVE jitter here
        # would otherwise report a garbage per-trip figure.
        raise MarginalTimingError(
            f"marginal window unreachable: T(2K)-T(K)={gap:.4f}s < "
            f"{0.8 * window:.3f}s at the K cap ({k_max}); raise k_max or "
            "accept that the per-application cost is below measurement "
            "resolution"
        )
    return gap / K


def keepalive_feedback(out, carry):
    """Next-trip chain inputs as a negligible function of EVERY output leaf
    and of every carry leaf: per-leaf sums keep all outputs live against
    DCE, the full-array dependence through leaf 0 keeps the output
    materialized, and perturbing every carry leaf defeats loop-invariant
    hoisting of per-leaf subcomputations. The keep-alive sums add one fused
    reduction per output leaf, so tiny-stage figures are mild UPPER bounds.
    """
    import jax
    import jax.numpy as jnp

    lo = jax.tree_util.tree_leaves(out)
    cl, treedef = jax.tree_util.tree_flatten(carry)
    eps = jnp.float32(1e-30)
    s = sum(jnp.sum(leaf).astype(jnp.float32) for leaf in lo)
    new = []
    for i, c in enumerate(cl):
        c = c + eps * s.astype(c.dtype)
        if i == 0 and lo[0].shape == c.shape:
            c = c + eps * lo[0].astype(c.dtype)
        new.append(c)
    return jax.tree_util.tree_unflatten(treedef, new)


def fn_chain_maker(fn: Callable) -> Callable[[int], Callable]:
    """``make_chain`` for a pure function of arrays: ``length`` dependent
    applications inside one ``lax.scan`` with ``keepalive_feedback``
    wiring, reduced to one scalar."""
    import jax
    import jax.numpy as jnp

    def make(length: int) -> Callable:
        @jax.jit
        def chain(*a):
            def body(carry, _):
                out = fn(*carry)
                return keepalive_feedback(out, carry), None

            final, _ = jax.lax.scan(body, a, None, length=length)
            return jnp.sum(jax.tree_util.tree_leaves(final)[0])

        return chain

    return make
