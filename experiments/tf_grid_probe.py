"""Does f64-GRID rounding of the tf trajectory reproduce PETSc's counts?

Round-4/5 finding (supersedes the tf32 'more precision' premise): at the
two knife-edge cells the plain-GMRES trajectory is in a stagnation regime
where PETSc's own f64 rounding DELAYS convergence — counts measured on
CPU (deterministic EFTs), production parameters (rtol 1e-8, atol 1e-12):

    native f64        : 40 (2D N=8)   / 27 (3D nx=4)   <- PETSc-exact
    df32 (~49-bit)    : 42            / ...             (+ drift)
    tf32 (~71-bit)    : 38            / ...             (- drift!)

More-accurate-than-f64 arithmetic lands BELOW the published count, so
matching PETSc requires f64-FAITHFUL arithmetic: compute each op in tf
(error ~2^-71, far below f64 ulp) and round the result to the nearest
f64-representable value. This probe validates that route at the XLA level
on CPU, where true f64 provides the rounding oracle
(round = tf_from_f64(tf_to_f64(x))), at two granularities:

  - fine:   round after every vector op (residual sub, CGS sub, scale)
  - coarse: round once per composite stage (matvec result, post-CGS w,
            normalized v, updated x) — fewer in-kernel rounding sites

Scalars already run in f64 here.

Run: JAX_PLATFORMS=cpu python experiments/tf_grid_probe.py
"""

from __future__ import annotations

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
from jax import lax


def oracle_round(x):
    """Round a tf triple to the f64 grid via true f64 (CPU oracle)."""
    from perphil_tpu.ops.tf32 import tf_from_f64, tf_to_f64

    return tf_from_f64(tf_to_f64(x))


def gmres_tf_grid(
    A_tf,
    b_tf,
    x0_tf,
    rtol,
    atol,
    max_it,
    restart,
    granularity: str,
    rounder=oracle_round,
):
    """gmres_tf with f64-grid rounding at the chosen granularity."""
    import jax.scipy.linalg as jsl

    from perphil_tpu.ops.krylov import (
        DEFAULT_DTOL,
        KrylovResult,
        _apply_rotations_scanned,
    )
    from perphil_tpu.ops.tf32 import (
        tf_add,
        tf_basis_comb,
        tf_basis_dot,
        tf_norm,
        tf_scale64,
        tf_sub,
    )

    R64 = rounder
    fine = granularity == "fine"

    m = int(restart)
    shape = b_tf[0].shape
    f32 = b_tf[0].dtype

    def _residual(x_tf):
        ax = A_tf(x_tf)
        if fine:
            ax = R64(ax)
        return R64(tf_sub(b_tf, ax))

    r0 = _residual(x0_tf)
    rnorm0 = tf_norm(r0)
    tol = jnp.maximum(rtol * rnorm0, atol)
    div = DEFAULT_DTOL * rnorm0

    def cycle(state):
        x, its, rnorm, done = state
        r = _residual(x)
        beta = tf_norm(r)
        inv = jnp.where(beta > 0.0, 1.0 / beta, 1.0)
        v0 = R64(tf_scale64(r, inv))
        V = tuple(
            jnp.zeros((m + 1,) + shape, dtype=f32).at[0].set(c) for c in v0
        )
        Rm_ = jnp.zeros((m, m), dtype=jnp.float64)
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
            V, Rm, g, cs, sn, j, its_i, rnorm_i, x_i = carry
            vj = tuple(c[j] for c in V)
            w = A_tf(vj)
            if fine:
                w = R64(w)
            h = tf_basis_dot(V, w)
            comb = tf_basis_comb(h, V)
            if fine:
                comb = R64(comb)
            w = R64(tf_sub(w, comb))
            hj1 = tf_norm(w)
            inv = jnp.where(hj1 > 0.0, 1.0 / hj1, 1.0)
            wn = R64(tf_scale64(w, inv))
            V = tuple(c.at[j + 1].set(wc) for c, wc in zip(V, wn))
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
            Rm = Rm.at[:, j].set(hfull[:m])
            gj = g[j]
            g = g.at[j].set(c_new * gj).at[j + 1].set(-s_new * gj)
            rnorm_i = jnp.abs(g[j + 1])
            return V, Rm, g, cs, sn, j + 1, its_i + 1, rnorm_i, x_i

        carry = (V, Rm_, g, cs, sn, jnp.asarray(0), its, beta, x)
        V, Rm, g, cs, sn, j, its, rnorm, x = lax.while_loop(
            inner_cond, arnoldi_step, carry
        )
        col = jnp.arange(m)
        Rt = jnp.where(
            (col[None, :] >= j) & (col[:, None] == col[None, :]), 1.0, Rm
        )
        Rt = jnp.where(
            (col[None, :] >= j) & (col[:, None] != col[None, :]), 0.0, Rt
        )
        gm = jnp.where(col < j, g[:m], 0.0)
        y = jsl.solve_triangular(Rt, gm, lower=False)
        Vm = tuple(c[:m] for c in V)
        x = R64(tf_add(x, tf_basis_comb(y, Vm)))
        done = (
            (rnorm <= tol)
            | (its >= max_it)
            | (rnorm > div)
            | ~jnp.isfinite(rnorm)
            | (j == 0)
        )
        return x, its, rnorm, done

    def outer_cond(state):
        return ~state[3]

    init_done = rnorm0 <= tol
    x, its, rnorm, _ = lax.while_loop(
        outer_cond, cycle, (x0_tf, jnp.asarray(0), rnorm0, init_done)
    )
    return KrylovResult(x, its, rnorm, rnorm <= tol)


def build_cell_2d(N):
    from perphil_tpu.forms import create_function_spaces, mixed_space
    from perphil_tpu.mesh import create_mesh
    from perphil_tpu.models.dpp import DPPParameters
    from perphil_tpu.ops.assembly import DirichletBC, DPPOperator
    from perphil_tpu.utils.manufactured_solutions import exact_expressions

    params = DPPParameters()
    mesh = create_mesh(N, N)
    _, V = create_function_spaces(mesh)
    W = mixed_space(V)
    _, p1e, _, p2e = exact_expressions(mesh, params)
    op = DPPOperator(W, params)
    g1 = jnp.asarray(DirichletBC(W.sub(0), p1e).grid_values(mesh))
    g2 = jnp.asarray(DirichletBC(W.sub(1), p2e).grid_values(mesh))
    return op, g1, g2


def build_cell_3d(nx):
    from perphil_tpu.forms import create_function_spaces, mixed_space
    from perphil_tpu.mesh import create_cube_mesh
    from perphil_tpu.models.dpp import DPPParameters
    from perphil_tpu.ops.assembly import DirichletBC, DPPOperator
    from perphil_tpu.utils.manufactured_solutions import exact_expressions_3d

    params = DPPParameters()
    mesh = create_cube_mesh(nx, nx, nx)
    _, V = create_function_spaces(mesh)
    W = mixed_space(V)
    _, q1e, _, q2e = exact_expressions_3d(mesh, params)
    op = DPPOperator(W, params)
    g1 = jnp.asarray(DirichletBC(W.sub(0), q1e).grid_values(mesh))
    g2 = jnp.asarray(DirichletBC(W.sub(1), q2e).grid_values(mesh))
    return op, g1, g2


def run_cell(label, op, g1, g2, expected, rounder=oracle_round):
    from perphil_tpu.ops.tf32 import tf_from_f64

    g1t, g2t = tf_from_f64(g1), tf_from_f64(g2)
    b1, b2 = op.lifted_rhs_tf(g1t, g2t)
    b = tuple(jnp.stack([a, c]) for a, c in zip(b1, b2))
    bdry = jnp.asarray(op._mask_arrays[0])
    x0 = tuple(
        jnp.stack([jnp.where(bdry, a, 0.0), jnp.where(bdry, c, 0.0)])
        for a, c in zip(g1t, g2t)
    )
    mv_tf = op.stacked_matvec_tf()
    print(f"--- {label} (PETSc: {expected}) ---")
    results = {}
    for gran in ("coarse", "fine"):
        res = gmres_tf_grid(
            mv_tf, b, x0, 1.0e-8, 1.0e-12, 50000, 30, gran, rounder
        )
        its = int(res.iterations)
        ok = "OK " if its == expected else "DRIFT"
        print(f"  grid-{gran:6s}  its={its:4d}  {ok}")
        results[gran] = its
    return results


def main():
    op, g1, g2 = build_cell_2d(8)
    run_cell("2D N=8 plain GMRES", op, g1, g2, 40)
    op3, h1, h2 = build_cell_3d(4)
    run_cell("3D nx=4 plain GMRES", op3, h1, h2, 27)


if __name__ == "__main__":
    main()
