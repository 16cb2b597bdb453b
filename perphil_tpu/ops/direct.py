"""Exact fast direct solvers via tensor-product fast diagonalization.

The JAX replacement for MUMPS sparse LU
(``pc_factor_mat_solver_type: mumps`` at
``/root/reference/src/perphil/solvers/parameters.py:4-9``).

On uniform quad/hex meshes the interior (Dirichlet-eliminated) Q1 operators
are tensor products of 1D tridiagonal stiffness/mass pairs:

    K_d = sum_i  K1_i  (x)  prod_{j != i} M1_j,      M_d = prod_i M1_i

The generalized eigenproblem ``K1 S = M1 S diag(lam)`` (host-side scipy eigh,
sizes <= a few thousand) simultaneously diagonalizes every block, so a solve
is d small dense matmuls per direction plus a diagonal
scaling. This is *exact to roundoff* like LU, but O(n^(1+1/d)) instead of
superlinear fill-in, needs no factorization memory, and batches perfectly.

The monolithic 2-field DPP matrix shares one eigenbasis across both fields,
decoupling into independent 2x2 systems per mode — a closed-form direct
solve of the full coupled system (the reference needs MUMPS for this,
``solver.py:66-71``).

For simplicial meshes (non-tensor consistent mass), the same machinery built
from the lumped-mass proxy becomes a spectrally-equivalent preconditioner;
``solvers.solver`` wraps it in tightly-converged CG to play the "exact block
solve" role (documented MUMPS substitution, SURVEY §2.3).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property, lru_cache
from typing import Tuple

import jax.numpy as jnp
import numpy as np
import scipy.linalg

from perphil_tpu.config import default_dtype
from perphil_tpu.mesh.structured import StructuredMesh
from perphil_tpu.models.dpp.parameters import DPPParameters


@lru_cache(maxsize=None)
def _interior_eig_1d(n_cells: int, h: float, lumped: bool) -> Tuple[np.ndarray, np.ndarray]:
    """Generalized eigenpairs of the interior 1D (K, M) pair.

    Returns (S, lam) with S^T M S = I and K S = M S diag(lam).
    ``lumped=True`` replaces the consistent M1 by the lumped diag(h) —
    the tensor proxy used on simplicial meshes.
    """
    m = n_cells - 1
    if m < 1:
        raise ValueError("Fast diagonalization needs at least one interior node")
    K = (np.diag(np.full(m, 2.0)) - np.diag(np.ones(m - 1), 1) - np.diag(np.ones(m - 1), -1)) / h
    if lumped:
        M = np.eye(m) * h
    else:
        M = (np.diag(np.full(m, 4.0)) + np.diag(np.ones(m - 1), 1) + np.diag(np.ones(m - 1), -1)) * (h / 6.0)
    lam, S = scipy.linalg.eigh(K, M)  # scipy normalizes S^T M S = I
    return np.ascontiguousarray(S), np.ascontiguousarray(lam)


def _transform(f: jnp.ndarray, mats, transpose: bool) -> jnp.ndarray:
    """Apply per-axis matrices (S or S^T) to a grid tensor.

    ``mats`` are coordinate-ordered (x first); grid axes are reversed
    (slowest first), so axis ``a`` of the grid uses ``mats[d-1-a]``.

    ``precision=HIGHEST`` matters in float32: GPU matmuls otherwise may run
    in TF32 (about three decimal digits), which would stall mixed-precision
    refinement.
    """
    import jax

    d = f.ndim
    out = f
    for ax in range(d):
        S = mats[d - 1 - ax]
        Sj = jnp.asarray(S.T if transpose else S, dtype=f.dtype)
        out = jnp.moveaxis(
            jnp.tensordot(Sj, out, axes=([1], [ax]), precision=jax.lax.Precision.HIGHEST),
            0,
            ax,
        )
    return out


@dataclass(frozen=True)
class FastDiagFieldSolver:
    """Exact interior solve of one block ``(k/mu) K + (beta/mu) M`` on a
    tensor-product mesh (plays the role of the per-block LU in
    ``FIELDSPLIT_LU_PARAMS``, reference ``parameters.py:30-37``)."""

    mesh: StructuredMesh
    k: float
    beta: float
    mu: float
    lumped: bool = False

    def __post_init__(self):
        if not (self.mesh.is_tensor_product or self.lumped):
            raise ValueError(
                "Exact fast diagonalization needs quad/hex cells; "
                "use lumped=True for the simplicial proxy preconditioner"
            )

    @cached_property
    def _eig(self):
        lumped = self.lumped
        return tuple(
            _interior_eig_1d(n, hi, lumped) for n, hi in zip(self.mesh.cells, self.mesh.h)
        )

    @cached_property
    def _mode_scale(self) -> np.ndarray:
        lams = [lam for (_, lam) in self._eig]
        d = len(lams)
        lam_sum = np.zeros(tuple(len(l) for l in reversed(lams)))
        for ax in range(d):
            shape = [1] * d
            shape[ax] = len(lams[d - 1 - ax])
            lam_sum = lam_sum + lams[d - 1 - ax].reshape(shape)
        return (self.k / self.mu) * lam_sum + (self.beta / self.mu)

    def solve_interior(self, f: jnp.ndarray) -> jnp.ndarray:
        """Solve on the interior grid (shape: cells-1 per dim, reversed)."""
        mats = [S for (S, _) in self._eig]
        fhat = _transform(f, mats, transpose=True)
        fhat = fhat / jnp.asarray(self._mode_scale, dtype=f.dtype)
        return _transform(fhat, mats, transpose=False)

    def solve(self, b: jnp.ndarray) -> jnp.ndarray:
        """Solve the BC-eliminated block system on the full node grid:
        boundary entries (and any phantom padding beyond the node grid)
        pass through as identity rows, interior solved exactly."""
        inner = tuple(slice(1, n - 1) for n in self.mesh.node_shape)
        z_int = self.solve_interior(b[inner])
        return b.at[inner].set(z_int)


@dataclass(frozen=True)
class FastDiagDPPSolver:
    """Exact direct solve of the monolithic 2-field DPP system on a
    tensor-product mesh — the MUMPS replacement for
    ``LINEAR_SOLVER_PARAMS`` (reference ``parameters.py:4-9``).

    Both diagonal blocks and the mass coupling share the tensor eigenbasis,
    so after forward transforms the system decouples into per-mode 2x2
    solves:

        [[ (k1 lam + beta)/mu,      -beta/mu      ] [u1]   [f1]
         [      -beta/mu,       (k2 lam + beta)/mu]] [u2] = [f2]
    """

    mesh: StructuredMesh
    params: DPPParameters

    def __post_init__(self):
        if not self.mesh.is_tensor_product:
            raise ValueError("Exact fast diagonalization needs quad/hex cells")

    @cached_property
    def _eig(self):
        return tuple(
            _interior_eig_1d(n, hi, False) for n, hi in zip(self.mesh.cells, self.mesh.h)
        )

    @cached_property
    def _mode_data(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        lams = [lam for (_, lam) in self._eig]
        d = len(lams)
        lam_sum = np.zeros(tuple(len(l) for l in reversed(lams)))
        for ax in range(d):
            shape = [1] * d
            shape[ax] = len(lams[d - 1 - ax])
            lam_sum = lam_sum + lams[d - 1 - ax].reshape(shape)
        p = self.params
        a11 = (p.k1 * lam_sum + p.beta) / p.mu
        a22 = (p.k2 * lam_sum + p.beta) / p.mu
        a12 = -p.beta / p.mu
        det = a11 * a22 - a12 * a12
        return a11, a22, det

    def solve_interior(
        self, f1: jnp.ndarray, f2: jnp.ndarray
    ) -> Tuple[jnp.ndarray, jnp.ndarray]:
        mats = [S for (S, _) in self._eig]
        a11, a22, det = (jnp.asarray(m, dtype=f1.dtype) for m in self._mode_data)
        a12 = -self.params.beta / self.params.mu
        f1h = _transform(f1, mats, transpose=True)
        f2h = _transform(f2, mats, transpose=True)
        u1h = (a22 * f1h - a12 * f2h) / det
        u2h = (a11 * f2h - a12 * f1h) / det
        return (
            _transform(u1h, mats, transpose=False),
            _transform(u2h, mats, transpose=False),
        )

    def solve(
        self, b1: jnp.ndarray, b2: jnp.ndarray
    ) -> Tuple[jnp.ndarray, jnp.ndarray]:
        inner = tuple(slice(1, n - 1) for n in self.mesh.node_shape)
        z1i, z2i = self.solve_interior(b1[inner], b2[inner])
        return b1.at[inner].set(z1i), b2.at[inner].set(z2i)
