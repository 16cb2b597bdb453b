"""Dense-band block trisolve (ops/bandsolve.py) — the on-device
ordering-parity ILU apply.

Count parity of the apply precisions is pinned by the precision study in
``experiments/blockinv_precision_probe.py``; these tests cover the
construction/apply algebra on CPU.
"""

import numpy as np
import pytest
import scipy.sparse as sp

import jax.numpy as jnp

from perphil_tpu.ops import ordering as od
from perphil_tpu.ops.bandsolve import (
    BandParityILU,
    apply_varying_stencil,
    band_block_size,
    build_band_parity_ilu,
    coupling_stencil_vals,
    split_monolithic_factor,
    tri_apply,
    _block_coo,
    _build_blocks_device,
)


def _parity_system(nx=4):
    from perphil_tpu.experiments.ordering_study import _perm, _setup

    mesh, params, sysm, A, b, x0 = _setup(nx, 3, False)
    nv = A.shape[0] // 2
    A = od.tighten_pattern(A, sysm, mesh, params)
    perm = _perm("cell-rcm-parity", mesh, A, nv)
    Ap = A[perm][:, perm].tocsr()
    Ap.sort_indices()
    F, diag = od.host_ilu0(Ap)
    shape = tuple(int(c) + 1 for c in mesh.cells)[::-1]
    return Ap, perm, F, diag, nv, shape, b - A @ x0


def _random_banded_unit_lower(n, bw, seed=0):
    rng = np.random.default_rng(seed)
    rows, cols, vals = [], [], []
    for i in range(n):
        for j in range(max(0, i - bw), i):
            if rng.random() < 0.3:
                rows.append(i)
                cols.append(j)
                vals.append(rng.standard_normal() * 0.1)
    return sp.csr_matrix((vals, (rows, cols)), shape=(n, n))


def test_tri_apply_matches_scipy_forward():
    n, bw = 600, 90
    N = _random_banded_unit_lower(n, bw)
    B = band_block_size(bw)
    d_idx, d_vals, c_idx, c_vals, nb = _block_coo(N, B, lower=True)
    P = _build_blocks_device(
        jnp.asarray(d_idx), jnp.asarray(d_vals),
        jnp.asarray(c_idx), jnp.asarray(c_vals),
        nb=nb, B=B, lower=True, unit=True,
    )
    r = np.random.default_rng(1).standard_normal(n)
    rp = np.zeros(nb * B)
    rp[:n] = r
    y = np.asarray(
        tri_apply(P, jnp.asarray(rp, jnp.float32), lower=True, pad=B - bw)
    )
    ref = sp.linalg.spsolve_triangular(
        (N + sp.eye(n)).tocsr(), r, lower=True, unit_diagonal=True
    )
    assert np.abs(y[:n] - ref).max() / np.abs(ref).max() < 1e-5


def test_tri_apply_matches_scipy_backward():
    n, bw = 500, 70
    U = _random_banded_unit_lower(n, bw, seed=3).T.tocsr()  # strictly upper
    U = (U + 2.0 * sp.eye(n)).tocsr()  # well-conditioned diagonal
    B = band_block_size(bw)
    d_idx, d_vals, c_idx, c_vals, nb = _block_coo(U, B, lower=False)
    P = _build_blocks_device(
        jnp.asarray(d_idx), jnp.asarray(d_vals),
        jnp.asarray(c_idx), jnp.asarray(c_vals),
        nb=nb, B=B, lower=False, unit=False,
    )
    r = np.random.default_rng(2).standard_normal(n)
    rp = np.zeros(nb * B)
    rp[:n] = r
    y = np.asarray(
        tri_apply(P, jnp.asarray(rp, jnp.float32), lower=False, pad=B - bw)
    )
    ref = sp.linalg.spsolve_triangular(U, r, lower=False)
    assert np.abs(y[:n] - ref).max() / np.abs(ref).max() < 1e-5


def test_split_monolithic_factor_does_not_corrupt_input():
    Ap, perm, F, diag, nv, shape, r0 = _parity_system(4)
    before = (F.data.copy(), F.indices.copy(), F.indptr.copy())
    split_monolithic_factor(F, nv)
    split_monolithic_factor(F, nv)  # second call sees pristine arrays
    assert np.array_equal(F.data, before[0])
    assert np.array_equal(F.indices, before[1])
    assert np.array_equal(F.indptr, before[2])


def test_coupling_stencil_matches_spmv():
    Ap, perm, F, diag, nv, shape, r0 = _parity_system(4)
    _, L21, _, _, U12, _ = split_monolithic_factor(F, nv)
    vperm = perm[:nv].astype(np.int64)
    ivperm = np.empty_like(vperm)
    ivperm[vperm] = np.arange(nv)
    rng = np.random.default_rng(0)
    for M in (L21, U12):
        vals = coupling_stencil_vals(M, vperm, shape)
        xp = rng.standard_normal(nv)  # permuted-space input
        ref = M @ xp  # permuted-space output
        xn = xp[ivperm].reshape(shape)  # natural grid
        yn = np.asarray(
            apply_varying_stencil(jnp.asarray(xn, jnp.float32), jnp.asarray(vals))
        )
        got = yn.ravel()[vperm]
        scale = max(np.abs(ref).max(), 1e-30)
        assert np.abs(got - ref).max() / scale < 1e-5


def test_apply_nat_matches_host_ilu_apply():
    Ap, perm, F, diag, nv, shape, r0 = _parity_system(4)
    pc = build_band_parity_ilu(Ap, perm, nv, shape, F)
    iperm = np.empty_like(perm)
    iperm[perm] = np.arange(len(perm))
    r = np.random.default_rng(5).standard_normal(2 * nv)
    ref = od.host_ilu_apply(F, diag, r[perm])[iperm]
    z1, z2 = pc.apply_nat(
        jnp.asarray(r[:nv].reshape(shape), jnp.float32),
        jnp.asarray(r[nv:].reshape(shape), jnp.float32),
    )
    got = np.concatenate([np.asarray(z1).ravel(), np.asarray(z2).ravel()])
    assert np.abs(got - ref).max() / np.abs(ref).max() < 2e-6


def test_apply_nat_df_correction_reaches_df_grade():
    """One defect-correction pass must beat plain f32 by orders of
    magnitude (df-grade apply: the property that pins the knife-edge
    iteration counts on hardware). Eager CPU execution — XLA:CPU fusion
    would corrupt the two-f32 EFTs (CLAUDE.md)."""
    Ap, perm, F, diag, nv, shape, r0 = _parity_system(4)
    pc32 = build_band_parity_ilu(Ap, perm, nv, shape, F)
    pcdf = build_band_parity_ilu(Ap, perm, nv, shape, F, with_correction=True)
    iperm = np.empty_like(perm)
    iperm[perm] = np.arange(len(perm))
    r = np.random.default_rng(7).standard_normal(2 * nv)
    ref = od.host_ilu_apply(F, diag, r[perm])[iperm]

    rh = jnp.asarray(
        np.stack([r[:nv].reshape(shape), r[nv:].reshape(shape)]), jnp.float32
    )
    rl = jnp.asarray(
        np.stack([r[:nv].reshape(shape), r[nv:].reshape(shape)]) - np.asarray(rh),
        jnp.float32,
    )
    scale = np.abs(ref).max()

    zh, zl = pc32.apply_nat_df((rh, rl))
    err32 = np.abs(
        (np.asarray(zh, np.float64) + np.asarray(zl, np.float64)).reshape(2, -1)
        - np.stack([ref[:nv], ref[nv:]])
    ).max() / scale

    zh, zl = pcdf.apply_nat_df((rh, rl))
    errdf = np.abs(
        (np.asarray(zh, np.float64) + np.asarray(zl, np.float64)).reshape(2, -1)
        - np.stack([ref[:nv], ref[nv:]])
    ).max() / scale

    assert errdf < 1e-11
    assert errdf < err32 * 1e-3


def test_block_coo_rejects_wide_band():
    N = _random_banded_unit_lower(600, 300)
    with pytest.raises(ValueError):
        _block_coo(N, 256, lower=True)


def test_engine_option_routing(monkeypatch):
    """pc_band_execution selects the engine (cache-safe: part of the
    frozen options key); the forcing env, when set non-auto, wins."""
    from perphil_tpu.forms.spaces import create_function_spaces, mixed_space
    from perphil_tpu.mesh.structured import create_cube_mesh
    from perphil_tpu.models.dpp.parameters import DPPParameters
    from perphil_tpu.solvers.solver import _build_linear_solver, _freeze

    monkeypatch.delenv("PERPHIL_TPU_BAND_ILU", raising=False)
    mesh = create_cube_mesh(4, 4, 4, hexahedral=False)
    _, V = create_function_spaces(mesh)
    W = mixed_space(V)
    params = DPPParameters()
    base = {
        "ksp_type": "gmres",
        "pc_type": "ilu",
        "pc_factor_mat_ordering_type": "rcm",
        "ksp_rtol": 1e-8,
        "ksp_atol": 1e-12,
    }
    host = _build_linear_solver(
        W, params, _freeze({**base, "pc_band_execution": "host"})
    )
    assert getattr(host, "_host_only", False)
    dev = _build_linear_solver(
        W, params,
        _freeze({**base, "pc_band_execution": "device",
                 "pc_band_defect_correct": False}),
    )
    assert not getattr(dev, "_host_only", False)
    # forcing env beats the option
    monkeypatch.setenv("PERPHIL_TPU_BAND_ILU", "0")
    forced = _build_linear_solver(
        W, params,
        _freeze({**base, "pc_band_execution": "device", "_cachebust": 1}),
    )
    assert getattr(forced, "_host_only", False)
