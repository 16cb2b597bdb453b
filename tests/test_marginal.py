"""Unit tests for the shared chained-marginal timing protocol
(``perphil_tpu/utils/marginal.py``) — the one implementation of
(T(2K)-T(K))/K used by bench.py and the levelsched harness. The protocol's three rules (dispatch-free pilot sizing,
window growth, hard error on non-positive marginals) are each pinned
here with a simulated dispatch-dominated cost model (a fixed cost per
execution plus a per-trip cost), which is not reproducible on CPU."""

import pytest

from perphil_tpu.utils import marginal as marginal_mod
from perphil_tpu.utils.marginal import (
    MarginalTimingError,
    chained_marginal,
    fn_chain_maker,
    keepalive_feedback,
)


class _SimClock:
    """Deterministic stand-in for the ``time`` module inside marginal.py.

    The simulated-cost-model tests once used real ``time.sleep``, which
    made them flaky on a loaded single-core host (scheduler overshoot on a
    20 ms sleep can be several ms — the same jitter class the protocol
    exists to defeat). Chains advance this clock by their modeled cost;
    ``perf_counter`` reads it. Zero real waiting, zero load sensitivity.
    """

    def __init__(self):
        self.now = 0.0

    def perf_counter(self) -> float:
        return self.now

    def advance(self, dt: float) -> None:
        self.now += dt


@pytest.fixture
def sim_clock(monkeypatch):
    clock = _SimClock()
    monkeypatch.setattr(marginal_mod, "time", clock)
    return clock


def _fake_chain_maker(clock: _SimClock, dispatch: float, per_trip: float):
    """A make_chain whose chains cost dispatch + length*per_trip simulated
    seconds — a dispatch-dominated cost model in miniature."""

    def make(length):
        def chain():
            clock.advance(dispatch + length * per_trip)
            return 0.0

        return chain

    return make


def test_marginal_cancels_flat_dispatch(sim_clock):
    # dispatch is 100x the per-trip cost: naive T(K)/K at the pilot K
    # would read ~6x the true figure; the marginal must not.
    per = 2e-4
    t = chained_marginal(
        _fake_chain_maker(sim_clock, dispatch=0.02, per_trip=per),
        (),
        4,
        window=0.02,
        best_of=1,
    )
    assert t == pytest.approx(per, rel=1e-9)


def test_k_grows_until_window_reached(sim_clock):
    # per-trip so cheap that the pilot window is far below ``window``:
    # the loop must keep growing K instead of returning a jitter-scale
    # number.
    calls = []

    def make(length):
        calls.append(length)

        def chain():
            sim_clock.advance(0.001 + length * 1e-5)
            return 0.0

        return chain

    t = chained_marginal(make, (), 2, window=0.04, best_of=1)
    assert max(calls) >= 0.8 * 0.04 / 1e-5 / 2  # grew toward the target
    assert t == pytest.approx(1e-5, rel=1e-9)


def test_nonpositive_marginal_raises_not_clamps(sim_clock):
    # constant-time chains (pure jitter, no per-trip cost): the protocol
    # must refuse to report a number (a clamped epsilon once became a
    # 1.8e10x "speedup").
    with pytest.raises(MarginalTimingError):
        chained_marginal(
            _fake_chain_maker(sim_clock, dispatch=0.003, per_trip=0.0),
            (),
            1,
            window=0.05,
            best_of=1,
            k_max=4,
        )


def test_fn_chain_maker_end_to_end_cpu():
    # real jitted chains on CPU: the measured per-application figure of a
    # tiny matmul must be positive and far below the (already small) CPU
    # dispatch cost.
    import jax.numpy as jnp

    def f(x):
        return x @ x * 0.999

    x = jnp.eye(16, dtype=jnp.float32)
    t = chained_marginal(fn_chain_maker(f), (x,), 8, window=0.01, best_of=2)
    assert 0 < t < 0.01


def test_keepalive_feedback_preserves_structure():
    import jax.numpy as jnp

    out = {"a": jnp.ones((3,)), "b": jnp.zeros((2, 2))}
    carry = (jnp.ones((3,)), jnp.full((2, 2), 2.0))
    new = keepalive_feedback(out, carry)
    assert isinstance(new, tuple) and len(new) == 2
    assert new[0].shape == (3,) and new[1].shape == (2, 2)
    # the perturbation is negligible, not structural
    assert jnp.allclose(new[0], carry[0]) and jnp.allclose(new[1], carry[1])
