"""Explicit halo-exchange stencil application via shard_map + ppermute.

``parallel.sharding`` relies on XLA's SPMD partitioner to derive halo
exchanges automatically from the shifted-slice stencils — the recommended
default. This module provides the *explicit* formulation: fields live as
per-device blocks inside ``jax.shard_map``, neighbor planes move between
devices with ``jax.lax.ppermute``, and the stencil is applied locally. It is the
direct analogue of PETSc's VecScatter ghost updates (SURVEY §2.2), kept as
the escape hatch for when manual communication scheduling (overlap)
should beat the partitioner's choices.

Supports sharding along any prefix of the grid axes (slabs on 1 axis,
pencils on 2, blocks on 3). Corner/edge halos for the full 3^d stencil
arrive via the classic dimension-by-dimension exchange: each axis exchange
runs on the array already extended along previous axes, so diagonal
neighbors propagate in d hops without explicit corner messages.

``dryrun_multichip`` (__graft_entry__.py) checks this path against the
GSPMD-derived matvec on every run; ``benchmark_vs_gspmd`` times both on
the current mesh (on CPU virtual devices this measures dispatch overhead
only — interconnect numbers require real devices).
"""

from __future__ import annotations

import time
from functools import partial
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from perphil_tpu.ops.assembly import DPPOperator
from perphil_tpu.ops.stencil import apply_stencil


def _exchange(z, axis_name: str, grid_axis: int, n_shards: int):
    """Extend a local block by one neighbor plane on each side of
    ``grid_axis``, moved between devices. Edge shards receive zeros — exactly the
    zero-Dirichlet-column semantics of the eliminated operator."""
    fwd = [(i, i + 1) for i in range(n_shards - 1)]
    bwd = [(i + 1, i) for i in range(n_shards - 1)]
    lo = jax.lax.slice_in_dim(z, 0, 1, axis=grid_axis)
    hi = jax.lax.slice_in_dim(z, z.shape[grid_axis] - 1, z.shape[grid_axis], axis=grid_axis)
    up = jax.lax.ppermute(hi, axis_name, fwd)  # my top plane -> next shard
    dn = jax.lax.ppermute(lo, axis_name, bwd)  # my bottom plane -> previous
    return jnp.concatenate([up, z, dn], axis=grid_axis)


def shard_map_stacked_matvec(op: DPPOperator, dmesh: Mesh) -> Callable:
    """BC-eliminated monolithic matvec on stacked fields (2, *grid) with
    explicit halo exchange along every device-mesh axis (mesh axis k shards
    grid axis k). Result equals ``op.stacked_matvec()`` up to float
    reassociation."""
    axes = dmesh.axis_names
    shard_sizes = dmesh.devices.shape
    K_st, M_st = op._stencils
    p = op.params
    bdry, _ = op._mask_arrays
    gshape = op.grid_shape
    d = len(gshape)
    if len(axes) > d:
        raise ValueError(f"{len(axes)}-axis mesh cannot shard a {d}-D grid")
    for k, (ax, s) in enumerate(zip(axes, shard_sizes)):
        if gshape[k] % s:
            raise ValueError(
                f"Grid axis {k} (size {gshape[k]}) not divisible by mesh "
                f"axis {ax!r} (size {s})"
            )

    bdry_j = jnp.asarray(bdry)
    sharded = list(axes) + [None] * (d - len(axes))
    spec_x = P(None, *sharded)
    spec_m = P(*sharded)

    @partial(jax.shard_map, mesh=dmesh, in_specs=(spec_x, spec_m), out_specs=spec_x)
    def mv(x_local, bdry_local):
        # mask boundary columns before the exchange (halos of masked values
        # are then correct for the eliminated operator)
        ze = jnp.where(bdry_local[None], 0.0, x_local)
        for k, ax in enumerate(axes):
            ze = _exchange(ze, ax, 1 + k, shard_sizes[k])

        inner = tuple([slice(None)] + [
            slice(1, -1) if k < len(axes) else slice(None) for k in range(d)
        ])

        def stencil_local(u):
            return u[inner[1:]]

        k1, k2, beta, mu = p.k1, p.k2, p.beta, p.mu
        Kz1 = apply_stencil(ze[0], K_st)[inner[1:]]
        Kz2 = apply_stencil(ze[1], K_st)[inner[1:]]
        Md = apply_stencil(ze[0] - ze[1], M_st)[inner[1:]]
        y1 = (k1 / mu) * Kz1 + (beta / mu) * Md
        y2 = (k2 / mu) * Kz2 - (beta / mu) * Md
        y = jnp.stack([y1, y2])
        return jnp.where(bdry_local[None], x_local, y)

    def apply(x):
        xs = jax.device_put(x, NamedSharding(dmesh, spec_x))
        ms = jax.device_put(bdry_j, NamedSharding(dmesh, spec_m))
        return mv(xs, ms)

    return apply


def benchmark_vs_gspmd(op: DPPOperator, dmesh: Mesh, reps: int = 50) -> dict:
    """Time the explicit-halo matvec against the GSPMD-partitioned one on
    the same mesh. Returns per-call seconds for both plus the max abs
    difference (correctness check rides along)."""
    from perphil_tpu.parallel.sharding import field_spec

    x = jnp.ones((2, *op.grid_shape), dtype=jnp.float64)
    explicit = shard_map_stacked_matvec(op, dmesh)
    gspmd_fn = jax.jit(
        op.stacked_matvec(),
        in_shardings=NamedSharding(dmesh, field_spec(dmesh, len(op.grid_shape))),
    )
    xs = jax.device_put(x, NamedSharding(dmesh, field_spec(dmesh, len(op.grid_shape))))

    ye = jax.block_until_ready(explicit(x))
    yg = jax.block_until_ready(gspmd_fn(xs))
    diff = float(jnp.max(jnp.abs(ye - yg)))

    def _time(fn, arg):
        fn(arg)  # warm
        t0 = time.perf_counter()
        out = None
        for _ in range(reps):
            out = fn(arg)
        jax.block_until_ready(out)
        return (time.perf_counter() - t0) / reps

    return {
        "explicit_halo_s": _time(explicit, x),
        "gspmd_s": _time(gspmd_fn, xs),
        "max_abs_diff": diff,
        "mesh": dict(zip(dmesh.axis_names, dmesh.devices.shape)),
    }
