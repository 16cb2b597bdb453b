"""On-device Lanczos extremal-eigenvalue estimation.

The JAX replacement for ARPACK (scipy ``svds``/``eigsh``) used by the
reference's sparse condition-number path
(``/root/reference/src/perphil/solvers/conditioning.py:156-209``). All the
matrices perphil analyzes (BC-eliminated monolithic DPP and its diagonal
blocks) are symmetric positive definite, so singular values coincide with
eigenvalues and the condition number is ``lam_max(A) / lam_min(A)``.

``lam_max`` comes from Lanczos on ``A``; ``lam_min`` from Lanczos on ``A^{-1}``
(inverse iteration), where the inverse application is the library's exact
fast-diagonalization direct solver — the same trick ARPACK's shift-invert
mode uses, but with an O(n^(1+1/d)) tensor solve instead of sparse LU.

Full reorthogonalization is used (the basis is a (k, n) matrix so the
projections are tall matmuls), making Ritz convergence robust
at the modest k (<= ~100) these spectra need.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

Array = jnp.ndarray


def lanczos_extreme(
    matvec: Callable[[Array], Array],
    n: int,
    num_iters: int = 100,
    seed: int = 0,
    dtype=jnp.float64,
) -> Tuple[float, float]:
    """Run k-step Lanczos with full reorthogonalization on a symmetric
    operator; return (largest, smallest) Ritz values.

    :param matvec: symmetric operator on flat vectors of length n.
    :param num_iters: Krylov dimension (k); also the basis memory (k+1, n).
    """
    k = int(min(num_iters, n))
    rng = np.random.default_rng(seed)
    v0 = rng.standard_normal(n)
    v0 = jnp.asarray(v0 / np.linalg.norm(v0), dtype=dtype)

    def body(carry, _):
        V, AV, j, done, scale_max = carry
        v = V[j]
        w_raw = matvec(v)
        AV = AV.at[j].set(jnp.where(done, 0.0, w_raw))
        # full reorthogonalization (unused basis rows are zero); the
        # resulting basis stays orthonormal even across tight eigenvalue
        # clusters (BC identity rows give multiplicity ~#boundary nodes).
        w = w_raw - V.T @ (V @ w_raw)
        w = w - V.T @ (V @ w)
        beta = jnp.linalg.norm(w)
        scale_max = jnp.maximum(scale_max, jnp.linalg.norm(w_raw))
        done = done | (beta <= 1e-10 * scale_max)
        V = V.at[j + 1].set(jnp.where(done, 0.0, w / jnp.where(beta > 0, beta, 1.0)))
        return (V, AV, j + 1, done, scale_max), None

    V = jnp.zeros((k + 1, n), dtype=dtype).at[0].set(v0)
    AV = jnp.zeros((k, n), dtype=dtype)
    init = (V, AV, jnp.asarray(0), jnp.asarray(False), jnp.asarray(0.0, dtype=dtype))
    (V, AV, *_), _ = jax.lax.scan(body, init, None, length=k)

    # Rayleigh-Ritz on the explicit projection H = V A V^T. Unlike the
    # three-term tridiagonal (which the reorthogonalization invalidates),
    # Ritz values of H are provably inside [lam_min(A), lam_max(A)] for an
    # orthonormal basis — no spurious extremes.
    Vn = np.asarray(V[:k])
    AVn = np.asarray(AV)
    row_ok = np.linalg.norm(Vn, axis=1) > 0.5
    m = int(row_ok.sum())
    if m == 0:
        return float("nan"), float("nan")
    H = Vn[row_ok] @ AVn[row_ok].T
    H = 0.5 * (H + H.T)
    ritz = np.linalg.eigvalsh(H)
    return float(ritz[-1]), float(ritz[0])


def spd_extremal_eigenvalues(
    matvec: Callable[[Array], Array],
    n: int,
    inv_apply: Optional[Callable[[Array], Array]] = None,
    num_iters: int = 100,
    seed: int = 0,
) -> Tuple[float, float]:
    """Extremal eigenvalues of an SPD operator.

    ``lam_max`` from Lanczos on A. ``lam_min`` from Lanczos on A^{-1} when an
    inverse application is available (fast and accurate); otherwise the
    smallest Ritz value of A (slower to converge — increase num_iters).
    """
    lam_max, lam_min_direct = lanczos_extreme(matvec, n, num_iters, seed)
    if inv_apply is None:
        return lam_max, lam_min_direct
    inv_max, _ = lanczos_extreme(inv_apply, n, num_iters, seed + 1)
    return lam_max, 1.0 / inv_max
