"""Krylov solver unit tests: correctness against scipy on small systems and
PETSc-compatible iteration semantics."""

import jax.numpy as jnp
import numpy as np

from perphil_tpu.ops.krylov import cg, gmres


def _random_spd(n, seed=0):
    rng = np.random.default_rng(seed)
    Q = rng.standard_normal((n, n))
    return Q @ Q.T + n * np.eye(n)


def test_gmres_solves_spd():
    A = _random_spd(40)
    b = np.random.default_rng(1).standard_normal(40)
    res = gmres(lambda x: jnp.asarray(A) @ x, jnp.asarray(b), rtol=1e-12, max_it=500)
    assert bool(res.converged)
    assert np.linalg.norm(A @ np.asarray(res.x) - b) / np.linalg.norm(b) < 1e-10


def test_gmres_nonsymmetric_with_restart():
    rng = np.random.default_rng(2)
    n = 60
    A = np.eye(n) + 0.3 * rng.standard_normal((n, n)) / np.sqrt(n)
    b = rng.standard_normal(n)
    res = gmres(lambda x: jnp.asarray(A) @ x, jnp.asarray(b), rtol=1e-10, restart=10, max_it=1000)
    assert bool(res.converged)
    assert np.linalg.norm(A @ np.asarray(res.x) - b) / np.linalg.norm(b) < 1e-8


def test_gmres_zero_rhs():
    A = _random_spd(10)
    res = gmres(lambda x: jnp.asarray(A) @ x, jnp.zeros(10), rtol=1e-8)
    assert int(res.iterations) == 0
    assert np.allclose(np.asarray(res.x), 0.0)


def test_gmres_left_preconditioning():
    A = _random_spd(50, seed=3)
    d = np.diag(A)
    b = np.random.default_rng(4).standard_normal(50)
    res_pc = gmres(
        lambda x: jnp.asarray(A) @ x,
        jnp.asarray(b),
        rtol=1e-10,
        M_inv=lambda r: r / jnp.asarray(d),
    )
    assert bool(res_pc.converged)
    assert np.linalg.norm(A @ np.asarray(res_pc.x) - b) / np.linalg.norm(b) < 1e-8


def test_cg_matches_direct():
    A = _random_spd(30, seed=5)
    b = np.random.default_rng(6).standard_normal(30)
    x, its, rnorm = cg(lambda x: jnp.asarray(A) @ x, jnp.asarray(b), rtol=1e-12, max_it=500)
    assert np.linalg.norm(A @ np.asarray(x) - b) / np.linalg.norm(b) < 1e-10
    assert int(its) > 0


def test_cg_grid_shaped():
    # shape-agnostic: operate directly on 2D grids
    def op(u):
        return 4 * u  # trivially SPD

    b = jnp.ones((5, 5))
    x, its, _ = cg(op, b, rtol=1e-14)
    assert np.allclose(np.asarray(x), 0.25)


def test_cgs2_preserves_iteration_counts():
    """CGS2 (opt-in reorthogonalization) spans the same Krylov space: identical
    iteration counts in clean (CPU f64) arithmetic."""
    A = _random_spd(60, seed=7)
    b = np.random.default_rng(8).standard_normal(60)
    r1 = gmres(lambda x: jnp.asarray(A) @ x, jnp.asarray(b), rtol=1e-10,
               reorthogonalize=False)
    r2 = gmres(lambda x: jnp.asarray(A) @ x, jnp.asarray(b), rtol=1e-10,
               reorthogonalize=True)
    assert int(r1.iterations) == int(r2.iterations)
    assert np.allclose(np.asarray(r1.x), np.asarray(r2.x), atol=1e-8)


def test_gmres_terminates_on_nan():
    """A non-finite residual must terminate the solve (PETSc's
    KSP_DIVERGED_NANORINF), not spin the outer restart loop forever on
    the device."""
    from perphil_tpu.ops.df32 import df_from_f64
    from perphil_tpu.ops.krylov import gmres_df

    b = jnp.ones(8)
    res = gmres(lambda v: v * jnp.nan, b, rtol=1e-10, max_it=50)
    assert not bool(res.converged)

    res_df = gmres_df(
        lambda v: (v[0] * jnp.float32(jnp.nan), v[1]),
        df_from_f64(b),
        rtol=1e-10,
        max_it=50,
    )
    assert not bool(res_df.converged)
