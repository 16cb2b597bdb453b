"""On-device level-scheduled parity-ILU GMRES: the committed evaluation.

Can the 3D ordering-parity GMRES+ILU rows (cell-RCM numbering, FE fill
pattern — host C++ CSR kernels in production, ``csrc/csr_solver.cpp``)
move onto the chip at equal-or-better wall-clock? This harness answers it:
the L/U factors' level schedules are computed on the host and the ENTIRE
solve runs as XLA ops (``lax.fori_loop`` over levels, padded-ELL gathers,
f64).

Findings so far (CPU x64 XLA): the counts are EXACT on the XLA engine,
6/8/15 at nx=4/8/16 — they depend only on the linear maps, not the
execution engine. Its wall-clock is set by per-level-step latency: the
schedule needs ~10*nx dependent gather+scatter steps per trisolve x 2
trisolves x its. Its time on the GPU is not measured yet; ``device`` mode
takes it with the chained-marginal protocol (``utils/marginal.py``).

Usage: python -m perphil_tpu.experiments.levelsched_eval [cpu|device] nx...
"""
import sys

import numpy as np
import jax
import jax.numpy as jnp

from perphil_tpu.experiments.ordering_study import _setup, _perm
from perphil_tpu.ops import ordering as od
from perphil_tpu.ops.krylov import gmres

REF = {4: 6, 8: 8, 16: 15, 32: 26, 40: 33}


def build(nx):
    mesh, params, sysm, A, b, x0 = _setup(nx, 3, False)
    nv = A.shape[0] // 2
    A = od.tighten_pattern(A, sysm, mesh, params)
    perm = _perm("cell-rcm-parity", mesh, A, nv)
    Ap = A[perm][:, perm].tocsr()
    bp = (b - A @ x0)[perm]  # Newton-step formulation
    F, diagptr = od.host_ilu0(Ap)
    return Ap, bp, F


def ell(csr, rows_mask):
    """Padded ELL (cols, vals) of csr restricted per row by rows_mask(cols, i)."""
    n = csr.shape[0]
    indptr, indices, data = csr.indptr, csr.indices, csr.data
    sel_cols, sel_vals = [], []
    width = 0
    for i in range(n):
        c = indices[indptr[i]:indptr[i + 1]]
        v = data[indptr[i]:indptr[i + 1]]
        keep = rows_mask(c, i)
        sel_cols.append(c[keep])
        sel_vals.append(v[keep])
        width = max(width, keep.sum())
    cols = np.full((n, width), n, dtype=np.int32)  # sentinel n -> 0 pad
    vals = np.zeros((n, width))
    for i, (c, v) in enumerate(zip(sel_cols, sel_vals)):
        cols[i, : len(c)] = c
        vals[i, : len(c)] = v
    return cols, vals


def levels_of(cols, lower=True):
    n = cols.shape[0]
    level = np.zeros(n, dtype=np.int64)
    order = range(n) if lower else range(n - 1, -1, -1)
    for i in order:
        c = cols[i]
        c = c[c < n]
        dep = c[c < i] if lower else c[c > i]
        level[i] = (level[dep].max() + 1) if dep.size else 0
    depth = int(level.max()) + 1
    width = int(np.bincount(level).max())
    table = np.full((depth, width), n, dtype=np.int32)
    fill = np.zeros(depth, dtype=np.int64)
    for i in range(n):
        l = level[i]
        table[l, fill[l]] = i
        fill[l] += 1
    return table


def run(nx, mode="cpu"):
    Ap, bp, F = build(nx)
    n = Ap.shape[0]
    Acols, Avals = ell(Ap, lambda c, i: np.ones_like(c, bool))
    # L: strictly lower of F (unit diag); U: upper incl diag
    Lcols, Lvals = ell(F, lambda c, i: c < i)
    Ucols, Uvals = ell(F, lambda c, i: c > i)
    dinv = 1.0 / F.diagonal()
    Ltab = levels_of(Acols, lower=True)   # FE pattern = F pattern
    Utab = levels_of(Acols, lower=False)

    Acols, Lcols, Ucols = (jnp.asarray(x) for x in (Acols, Lcols, Ucols))
    Avals, Lvals, Uvals = (jnp.asarray(x) for x in (Avals, Lvals, Uvals))
    Ltab_, Utab_ = jnp.asarray(Ltab), jnp.asarray(Utab)
    dinv_ = jnp.asarray(dinv)

    # pad entries carry ZERO vals, so gathers just clip the sentinel
    Acols = jnp.minimum(Acols, n - 1)
    Lcols = jnp.minimum(Lcols, n - 1)
    Ucols = jnp.minimum(Ucols, n - 1)

    def mv(x):
        return (Avals * x[Acols]).sum(-1)

    def tri(tab, cols, vals, v, unit, diag_inv):
        def body(l, x):
            rows = tab[l]                       # (W,), sentinel n -> drop
            r = jnp.minimum(rows, n - 1)
            s = (vals[r] * x[cols[r]]).sum(-1)
            xn = v[r] - s
            if not unit:
                xn = xn * diag_inv[r]
            return x.at[rows].set(xn, mode="drop")
        return jax.lax.fori_loop(0, tab.shape[0], body, jnp.zeros_like(v))

    def pc(r):
        y = tri(Ltab_, Lcols, Lvals, r, True, dinv_)
        return tri(Utab_, Ucols, Uvals, y, False, dinv_)

    bj = jnp.asarray(bp)

    solve = jax.jit(lambda b: gmres(mv, b, rtol=1e-8, atol=1e-12, restart=30,
                                    max_it=2000, M_inv=pc, reorthogonalize=False))
    res = solve(bj)
    its = int(res.iterations)
    ref = REF.get(nx, "n/a")
    print(f"nx={nx}: its={its} (ref {ref}) conv={bool(res.converged)}", flush=True)
    if mode == "device":
        # chained marginal timing (shared protocol, utils/marginal.py)
        from perphil_tpu.utils.marginal import chained_marginal

        def make(K):
            @jax.jit
            def chain(b):
                def body(c, _):
                    r = gmres(mv, c, rtol=1e-8, atol=1e-12, restart=30,
                              max_it=2000, M_inv=pc, reorthogonalize=False)
                    return c + 1e-30 * r.x, None
                f, _ = jax.lax.scan(body, b, None, length=K)
                return jnp.sum(f)
            return chain

        t = chained_marginal(make, (bj,), 3)
        print(f"nx={nx}: per-solve marginal {t*1e3:.1f} ms", flush=True)


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    mode = argv[0] if argv else "cpu"
    if mode not in ("cpu", "device"):
        raise SystemExit(
            f"usage: python -m perphil_tpu.experiments.levelsched_eval "
            f"cpu|device [nx ...] (got mode={mode!r})"
        )
    if mode == "cpu":
        jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    for nx in [int(a) for a in argv[1:]] or [4, 8]:
        run(nx, mode)


if __name__ == "__main__":
    main()
