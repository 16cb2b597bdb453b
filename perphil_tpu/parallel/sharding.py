"""Multi-device sharding of DPP solves over a JAX device mesh.

The reference scales by MPI domain decomposition through Firedrake/DMPlex
and PETSc's distributed Mat/Vec (SURVEY §2.2): partitioned meshes, halo
exchange per SpMV, allreduce per Krylov dot product. The JAX equivalent
is declarative SPMD:

  - a ``jax.sharding.Mesh`` over the devices,
  - fields laid out as stacked grids ``(2, nz, ny, nx)`` sharded along
    grid axes with ``NamedSharding``,
  - the *same* compiled solver functions as single-chip: XLA's SPMD
    partitioner turns the stencil's shifted slices into halo exchanges
    (collective-permutes between devices) and Krylov dot products into
    psums.

There is no separate "distributed solver": placement of the boundary-value
inputs decides the partitioning, which is what makes this design idiomatic
for XLA (compare: PETSc needs a parallel matrix type, MPI communicators and
ghost updates threaded through every object).

Axis convention: mesh axes are named after grid axes, outermost first —
("z", "y") in 3D, ("y",) or ("y", "x") in 2D. The field-stacking axis and
the innermost (x, lane) axis stay replicated/unsharded.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from perphil_tpu.forms.spaces import Function, MixedFunctionSpace
from perphil_tpu.mesh.structured import StructuredMesh


def device_mesh(
    axis_sizes: Sequence[int],
    axis_names: Optional[Sequence[str]] = None,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Build a device mesh, e.g. ``device_mesh([4, 2])`` -> axes ("z","y").

    Devices follow ``jax.devices()`` order; the GPUs of one host are joined
    all to all, so no topology-aware ordering applies. On CPU the virtual
    devices stand in.
    """
    devices = list(devices if devices is not None else jax.devices())
    n = int(np.prod(axis_sizes))
    if n > len(devices):
        raise ValueError(f"Need {n} devices, have {len(devices)}")
    if axis_names is None:
        d = len(axis_sizes)
        # outermost grid axes first: a 2-axis device mesh partitions (z, y)
        # of a 3D grid / (y, x) of a 2D grid — pass names explicitly for 2D
        axis_names = ("z", "y", "x")[:d] if d <= 3 else tuple(f"d{i}" for i in range(d))
    dev_array = np.array(devices[:n]).reshape(tuple(axis_sizes))
    return Mesh(dev_array, tuple(axis_names))


def field_spec(dmesh: Mesh, grid_ndim: int, stacked: bool = True) -> P:
    """PartitionSpec for a (stacked) field grid: mesh axes map onto the
    outermost grid axes; the stacking axis and remaining inner axes are
    replicated. E.g. 3D grid on a ("z","y") mesh ->
    P(None, "z", "y", None) for (2, nz, ny, nx) arrays."""
    names = list(dmesh.axis_names)
    spec = names[:grid_ndim] + [None] * (grid_ndim - len(names))
    if stacked:
        return P(None, *spec)
    return P(*spec)


def _check_divisible(shape: Tuple[int, ...], dmesh: Mesh, offset: int) -> None:
    sizes = dict(zip(dmesh.axis_names, dmesh.devices.shape))
    for ax, name in enumerate(dmesh.axis_names):
        dim = offset + ax
        if dim < len(shape) and shape[dim] % sizes[name] != 0:
            raise ValueError(
                f"Grid axis {dim} (size {shape[dim]}) is not divisible by "
                f"device-mesh axis {name!r} (size {sizes[name]}). Choose N "
                f"with (N+1) divisible by the mesh axis (e.g. N=15, 31, 63) "
                f"— GSPMD silently replicates uneven shardings."
            )


def _place(x, dmesh: Mesh, spec: P):
    """device_put on a single-process mesh; global-array assembly when the
    mesh spans multiple processes (device_put cannot reach non-addressable
    devices)."""
    if jax.process_count() > 1:
        from perphil_tpu.parallel.distributed import make_global

        return make_global(x, dmesh, spec)
    return jax.device_put(x, NamedSharding(dmesh, spec))


def shard_stacked(x, dmesh: Mesh):
    """Place a stacked field array (2, *grid) on the device mesh."""
    _check_divisible(x.shape, dmesh, 1)
    return _place(x, dmesh, field_spec(dmesh, x.ndim - 1))


def shard_grid(x, dmesh: Mesh):
    """Place a bare field grid on the device mesh."""
    _check_divisible(x.shape, dmesh, 0)
    return _place(x, dmesh, field_spec(dmesh, x.ndim, stacked=False))


def mesh_padding(node_shape: Tuple[int, ...], dmesh: Mesh) -> Tuple[int, ...]:
    """Phantom padding per grid axis making each sharded axis divisible by
    its device-mesh axis (GSPMD rejects uneven shardings; node grids are
    N+1 and rarely divisible)."""
    sizes = dict(zip(dmesh.axis_names, dmesh.devices.shape))
    pad = []
    for ax, n in enumerate(node_shape):
        if ax < len(dmesh.axis_names):
            s = sizes[dmesh.axis_names[ax]]
            pad.append((-n) % s)
        else:
            pad.append(0)
    return tuple(pad)


def sharded_solve_dpp(
    W: MixedFunctionSpace,
    model_params,
    bcs,
    dmesh: Mesh,
    solver_parameters: dict = {},
):
    """``solve_dpp`` with boundary data placed on a device mesh: the cached
    compiled solver partitions across devices via XLA SPMD (halo exchange +
    psum inserted automatically). Results match single-device bit-for-bit
    up to reduction reordering.

    Arbitrary mesh sizes are supported: node grids are phantom-padded
    (identity rows, zero data — mathematically inert) to divisibility.
    """
    import jax.numpy as jnp

    from perphil_tpu.ops.assembly import bc_values_per_field
    from perphil_tpu.solvers.options import apply_prefix_overrides
    from perphil_tpu.solvers.solver import (
        Solution,
        _build_linear_solver,
        _freeze,
        _validate_mixed,
    )

    _validate_mixed(W)
    # same options-prefix override surface as solve_dpp: a set_options("dpp",
    # ...) / PERPHIL_TPU_OPTIONS override must not silently change behavior
    # between single-device and sharded runs
    solver_parameters = apply_prefix_overrides(solver_parameters, "dpp")
    g1, g2 = bc_values_per_field(W, bcs)
    # DoFs live on the (possibly p-refined) lattice — pad/crop THAT grid
    dof_shape = W.spaces[0].dof_mesh.node_shape
    # normalize: a divisible lattice shares the unpadded builder cache entry
    # (padding=() and padding=(0,0[,0]) would otherwise compile twice)
    padding = mesh_padding(dof_shape, dmesh)
    if not any(padding):
        padding = ()
    if any(padding):
        pads = [(0, p) for p in padding]
        g1 = jnp.pad(g1, pads)
        g2 = jnp.pad(g2, pads)
    g1 = shard_grid(g1, dmesh)
    g2 = shard_grid(g2, dmesh)
    if W.spaces[0].degree > 1 and not W.mesh.is_tensor_product:
        from perphil_tpu.solvers.solver import _build_simplex_p2_linear_solver

        # the P2 simplex preonly+lu path is host scipy-splu with no SPMD
        # partitioning: refuse it for EVERY sharded call (even a divisible
        # lattice where padding==()), before the builder's padding-gated
        # backstop can let it through
        if str(solver_parameters.get("ksp_type", "preonly")) == "preonly":
            raise NotImplementedError(
                "P2 simplex preonly+lu is a host sparse-direct path "
                "(scipy splu) with no SPMD partitioning; sharded P2 "
                "simplex solves support ksp_type=gmres with "
                "pc_type none/jacobi"
            )

        # P2 simplex lattices phantom-pad through the boundary-mask
        # machinery (identity phantom rows, P2SimplexDPPOperator.padding)
        builder = _build_simplex_p2_linear_solver
    elif W.spaces[0].degree > 1:
        from perphil_tpu.solvers.solver import _build_tensor_linear_solver

        # degree-p lattices phantom-pad exactly like Q1: the padded 1D
        # factor matrices carry inert identity blocks, so trajectories
        # match the unpadded solve (TensorDPPOperator.padding)
        builder = _build_tensor_linear_solver
    else:
        builder = _build_linear_solver
    # omit padding entirely on divisible lattices: lru_cache keys on the
    # positional args as passed, so only the 3-arg form shares solve_dpp's
    # compiled-solver cache entry
    if any(padding):
        solver = builder(W, model_params, _freeze(solver_parameters), padding)
    else:
        solver = builder(W, model_params, _freeze(solver_parameters))
    z1, z2, its, rnorm = solver(g1, g2)
    if any(padding):
        crop = tuple(slice(0, n) for n in dof_shape)
        if jax.process_count() > 1:
            # non-addressable global arrays can't be sliced on the host;
            # crop inside a jitted program (XLA repartitions the result)
            z1, z2 = jax.jit(lambda a, b: (a[crop], b[crop]))(z1, z2)
        else:
            z1, z2 = z1[crop], z2[crop]
    if jax.process_count() > 1:
        from perphil_tpu.parallel.distributed import replicate_scalar

        return Solution(
            Function(W, (z1, z2)),
            int(replicate_scalar(its, dmesh)),
            replicate_scalar(rnorm, dmesh),
        )
    return Solution(Function(W, (z1, z2)), int(its), float(rnorm))


def sharded_solve_dpp_nonlinear(
    W: MixedFunctionSpace,
    model_params,
    bcs,
    dmesh: Mesh,
    solver_parameters: dict = {},
):
    """``solve_dpp_nonlinear`` with boundary data placed on a device mesh.

    The Picard drivers (snes_type ngs / nrichardson / block_gs) are plain
    stencil+elementwise programs, so XLA SPMD partitions the SAME compiled
    sweeper across devices (halo exchange per sweep, psum per residual
    norm) — iteration trajectories match the single-device solve exactly.

    Node grids must be device-divisible: phantom padding is NOT supported
    here because padded phantom nodes would participate in the pointwise
    Gauss-Seidel sweeps and change the Picard trajectory (unlike the
    linear solvers, where phantom rows are inert identity equations).
    Choose N with (N+1) divisible by each mesh axis (15, 31, 63, ...).
    """
    from perphil_tpu.ops.assembly import bc_values_per_field
    from perphil_tpu.solvers.options import apply_prefix_overrides
    from perphil_tpu.solvers.solver import (
        Solution,
        _build_nonlinear_solver,
        _freeze,
        _validate_mixed,
    )

    _validate_mixed(W)
    solver_parameters = apply_prefix_overrides(solver_parameters, "dpp_nonlinear")
    snes = str(solver_parameters.get("snes_type", "ngs"))
    if snes == "ksponly":
        # one linear solve: route through the sharded linear entry, which
        # handles phantom padding; mirror solve_dpp_nonlinear's reporting
        # (its == 1, residual = true nonlinear function norm)
        ksp_opts = {
            k: v for k, v in solver_parameters.items() if not k.startswith("snes_")
        }
        sol = sharded_solve_dpp(W, model_params, bcs, dmesh, ksp_opts)
        return Solution(sol.solution, 1, sol.residual_error)
    if W.spaces[0].degree > 1:
        raise NotImplementedError(
            "sharded Picard/NGS drivers are degree-1 (matching "
            "solve_dpp_nonlinear); use snes_type='ksponly' for Qp systems"
        )
    g1, g2 = bc_values_per_field(W, bcs)
    dof_shape = W.spaces[0].dof_mesh.node_shape
    padding = mesh_padding(dof_shape, dmesh)
    if any(padding):
        raise NotImplementedError(
            f"sharded nonlinear solves need device-divisible node grids "
            f"(got {dof_shape} on {dict(zip(dmesh.axis_names, dmesh.devices.shape))}): "
            "phantom nodes would enter the pointwise-GS sweeps and change "
            "the Picard trajectory"
        )
    g1 = shard_grid(g1, dmesh)
    g2 = shard_grid(g2, dmesh)
    solver = _build_nonlinear_solver(W, model_params, _freeze(solver_parameters))
    z1, z2, its, fnorm = solver(g1, g2)
    if jax.process_count() > 1:
        from perphil_tpu.parallel.distributed import replicate_scalar

        return Solution(
            Function(W, (z1, z2)),
            int(replicate_scalar(its, dmesh)),
            replicate_scalar(fnorm, dmesh),
        )
    return Solution(Function(W, (z1, z2)), int(its), float(fnorm))
