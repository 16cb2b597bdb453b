"""Multi-host (multi-process) runtime initialization and global arrays.

The reference scales across nodes with MPI: ``mpiexec -n P`` launches P
ranks, DMPlex partitions the mesh, and PETSc's VecScatter/allreduce move
data (SURVEY §2.2; reference ``petsc_profiling.py:126-137`` reads
``COMM_WORLD`` size). The JAX equivalent is its multi-controller
runtime: every host runs the same program, ``jax.distributed.initialize``
wires the hosts into one cluster, and a single global ``Mesh`` spans all
devices — after which the SPMD story is *identical* to single-host: the
compiled solver sees global arrays and XLA inserts the collectives.

Environment contract (mirrors how MPI launchers export rank/size):

  PERPHIL_COORDINATOR     host:port of process 0 (default 127.0.0.1:12421)
  PERPHIL_NUM_PROCESSES   world size P
  PERPHIL_PROCESS_ID      this process's rank in [0, P)

Standard JAX variables (JAX_COORDINATOR_ADDRESS, JAX_NUM_PROCESSES,
JAX_PROCESS_ID) take precedence when set. With none of them set,
``PERPHIL_AUTO_DISTRIBUTED=1`` lets ``jax.distributed.initialize()``
discover the cluster itself, which works only where a cluster manager
(e.g. SLURM) describes it; elsewhere pass the three values explicitly.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def is_initialized() -> bool:
    """True when the multi-controller runtime is already up."""
    try:
        from jax._src import distributed

        return distributed.global_state.client is not None
    except Exception:
        return jax.process_count() > 1


def initialize_from_env(local_device_count: Optional[int] = None) -> bool:
    """Bring up ``jax.distributed`` from the environment contract above.

    Returns True when a multi-process runtime was (or already is) active,
    False for ordinary single-process runs. Safe to call unconditionally
    and more than once.
    """
    if is_initialized():
        return jax.process_count() > 1

    num = os.environ.get("JAX_NUM_PROCESSES") or os.environ.get("PERPHIL_NUM_PROCESSES")
    pid = os.environ.get("JAX_PROCESS_ID") or os.environ.get("PERPHIL_PROCESS_ID")
    coord = (
        os.environ.get("JAX_COORDINATOR_ADDRESS")
        or os.environ.get("PERPHIL_COORDINATOR")
        or "127.0.0.1:12421"
    )
    if (num is None) != (pid is None):
        # One of world-size/rank set without the other is a broken launcher,
        # not a single-process run: continuing would compute P independent
        # full-size replicas (and hang the properly-configured ranks at the
        # coordinator). Fail loudly instead.
        raise RuntimeError(
            "Partial multi-process configuration: set BOTH "
            "PERPHIL_NUM_PROCESSES/JAX_NUM_PROCESSES and "
            "PERPHIL_PROCESS_ID/JAX_PROCESS_ID (or neither) — got "
            f"num_processes={num!r}, process_id={pid!r}"
        )
    if num is None:
        # Under a cluster manager jax.distributed.initialize() discovers
        # the cluster itself. IMPORTANT: do not touch jax.default_backend()
        # (or any other backend-initializing API) before initialize() — JAX
        # requires distributed init to happen first, so gate only on the
        # env flag and let initialize() itself fail on non-pod hosts.
        if os.environ.get("PERPHIL_AUTO_DISTRIBUTED"):
            try:
                jax.distributed.initialize()
            except Exception:
                return False  # not a pod slice / no metadata server
            return jax.process_count() > 1
        return False

    kwargs = {}
    if local_device_count is not None:
        kwargs["local_device_ids"] = list(range(local_device_count))
    jax.distributed.initialize(
        coordinator_address=coord,
        num_processes=int(num),
        process_id=int(pid),
        **kwargs,
    )
    return jax.process_count() > 1


def global_device_mesh(
    axis_sizes: Sequence[int],
    axis_names: Optional[Sequence[str]] = None,
) -> Mesh:
    """A device mesh spanning ALL processes' devices (``jax.devices()`` is
    global in a multi-controller run). Same axis conventions as
    :func:`perphil_tpu.parallel.sharding.device_mesh`."""
    from perphil_tpu.parallel.sharding import device_mesh

    return device_mesh(axis_sizes, axis_names, devices=jax.devices())


def make_global(x, dmesh: Mesh, spec: P):
    """Place a host-replicated numpy/jax array on a (possibly multi-process)
    device mesh. ``jax.device_put`` only reaches addressable devices;
    ``make_array_from_callback`` assembles a global array from per-shard
    callbacks, which works identically for 1 and P processes (every process
    holds the full ``x`` here — boundary data is O(surface), cheap to
    replicate, exactly like the reference's replicated BC lists)."""
    x = np.asarray(x)
    sharding = NamedSharding(dmesh, spec)
    return jax.make_array_from_callback(x.shape, sharding, lambda idx: x[idx])


def replicate_scalar(x, dmesh: Mesh) -> float:
    """Host float from a (possibly non-addressable) global scalar."""
    if getattr(x, "is_fully_addressable", True):
        return float(x)
    return float(jax.jit(lambda v: v, out_shardings=NamedSharding(dmesh, P()))(x))
