"""Precision floor for the dense block-inverse parity-ILU apply.

The on-device plan for the 3D ordering-parity GMRES+ILU rows (VERDICT r4
item 1) restructures the sequential CSR trisolve as a block recurrence over
the RCM band: per field and factor, the band is covered by ~n/B dense BxB
blocks (B >= bandwidth+1), the diagonal blocks are INVERTED on the host, and
the apply becomes one dense matvec per block, no unstructured gathers.
Inter-field couplings (L21, U12) stay sparse matvecs.

This probe answers the two questions that decide the device design:

1. Does the restructured apply (block recurrence + dense inverses) preserve
   the published iteration counts in f64?  (Arithmetic-order robustness —
   levelsched_eval found counts engine-independent in f64.)
2. What precision do the dense inverse matvecs need: f32 (4 B/entry
   streamed) or df32 (8 B/entry, two-f32)?

Usage: python experiments/blockinv_precision_probe.py [nx ...]
"""

import sys

import numpy as np
import scipy.linalg as sla
import scipy.sparse as sp

sys.path.insert(0, "/root/repo")
import jax

jax.config.update("jax_platforms", "cpu")

from perphil_tpu.experiments.ordering_study import _perm, _setup  # noqa: E402
from perphil_tpu.ops import ordering as od  # noqa: E402

REF = {4: 6, 8: 8, 12: 12, 16: 15, 20: 17, 24: 20, 32: 26, 36: 29, 40: 33}


def build(nx):
    mesh, params, sysm, A, b, x0 = _setup(nx, 3, False)
    nv = A.shape[0] // 2
    A = od.tighten_pattern(A, sysm, mesh, params)
    perm = _perm("cell-rcm-parity", mesh, A, nv)
    Ap = A[perm][:, perm].tocsr()
    bp = (b - A @ x0)[perm]
    F, diag = od.host_ilu0(Ap)
    return Ap, bp, F, diag, nv


def band_blocks(M, B, unit_lower):
    """Dense (inv_diag_blocks, coupling_blocks) covering a banded
    triangular factor. unit_lower: strictly-lower M with implied unit diag
    (forward); else upper incl diag (backward)."""
    n = M.shape[0]
    nb = -(-n // B)
    invs, coups = [], []
    Md = M.tocsc()
    for k in range(nb):
        lo, hi = k * B, min((k + 1) * B, n)
        D = Md[lo:hi, lo:hi].toarray()
        if unit_lower:
            D = D + np.eye(hi - lo)
            C = Md[lo:hi, max(0, lo - B) : lo].toarray() if k else None
        else:
            C = (
                Md[lo:hi, hi : min(hi + B, n)].toarray()
                if hi < n
                else None
            )
        invs.append(sla.solve_triangular(D, np.eye(hi - lo), lower=unit_lower))
        coups.append(C)
    return invs, coups


def mk_apply(F, diag, nv, B, mode):
    """Block-inverse U^-1 L^-1 with dense matvecs at the given precision.
    mode: f64 | f32 | df32 (ideal two-f32 entries, f64 accumulate)."""
    n = F.shape[0]
    ind = np.arange(n)
    rows = np.repeat(ind, np.diff(F.indptr))
    # copy() the index arrays: eliminate_zeros() rewrites indices/indptr in
    # place, which would corrupt F (shared arrays) for the next build
    L = sp.csr_matrix(
        (F.data * (F.indices < rows), F.indices.copy(), F.indptr.copy()),
        shape=F.shape,
    )
    L.eliminate_zeros()
    U = sp.csr_matrix(
        (F.data * (F.indices >= rows), F.indices.copy(), F.indptr.copy()),
        shape=F.shape,
    )
    U.eliminate_zeros()
    L11, L21, L22 = L[:nv, :nv], L[nv:, :nv], L[nv:, nv:]
    U11, U12, U22 = U[:nv, :nv], U[:nv, nv:], U[nv:, nv:]

    def prep(mats):
        if mode == "f64":
            return [None if m is None else m for m in mats]
        if mode == "f32":
            return [None if m is None else m.astype(np.float32) for m in mats]
        out = []
        for m in mats:  # df32: hi+lo round trip through two f32 words
            if m is None:
                out.append(None)
                continue
            hi = m.astype(np.float32).astype(np.float64)
            lo = (m - hi).astype(np.float32).astype(np.float64)
            out.append(hi + lo)
        return out

    solvers = {}
    for name, M, low in (
        ("L1", L11, True), ("L2", L22, True),
        ("U1", U11, False), ("U2", U22, False),
    ):
        invs, coups = band_blocks(M, B, low)
        solvers[name] = (prep(invs), prep(coups), low)

    def tri(name, r):
        invs, coups, low = solvers[name]
        nb = len(invs)
        x = np.zeros_like(r)
        order = range(nb) if low else range(nb - 1, -1, -1)
        for k in order:
            lo_i, hi_i = k * B, min((k + 1) * B, r.shape[0])
            rhs = r[lo_i:hi_i].copy()
            C = coups[k]
            if C is not None:
                if low:
                    prev = x[max(0, lo_i - B) : lo_i]
                else:
                    prev = x[hi_i : min(hi_i + B, r.shape[0])]
                rhs = rhs - _mv(C, prev, mode)
            x[lo_i:hi_i] = _mv(invs[k], rhs, mode)
        return x

    def apply_(r):
        y1 = tri("L1", r[:nv])
        y2 = tri("L2", r[nv:] - L21 @ y1)
        x2 = tri("U2", y2)
        x1 = tri("U1", y1 - U12 @ x2)
        return np.concatenate([x1, x2])

    return apply_


def _mv(M, v, mode):
    if mode == "f32":
        return (M @ v.astype(np.float32)).astype(np.float64)
    return M @ v


def main():
    sizes = [int(a) for a in sys.argv[1:]] or sorted(REF)
    for nx in sizes:
        Ap, bp, F, diag, nv = build(nx)
        coo = sp.tril(Ap[:nv, :nv], k=-1).tocoo()
        bw = int((coo.row - coo.col).max())
        B = max(256, int(np.ceil((bw + 1) / 256) * 256))
        line = [f"nx={nx:3d} bw={bw:5d} B={B:5d}"]
        its_ref = od.host_gmres(
            lambda v: Ap @ v, bp,
            pc=lambda v: od.host_ilu_apply(F, diag, v),
        )
        line.append(f"seq={its_ref}({'OK' if its_ref == REF[nx] else 'XX'})")
        for mode in ("f64", "f32", "df32"):
            pc = mk_apply(F, diag, nv, B, mode)
            its = od.host_gmres(lambda v: Ap @ v, bp, pc=pc)
            line.append(
                f"{mode}={its}({'OK' if its == REF[nx] else 'XX'})"
            )
        print(" ".join(line), flush=True)


if __name__ == "__main__":
    main()
