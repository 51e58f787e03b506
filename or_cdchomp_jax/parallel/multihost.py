"""Multi-host execution: process initialization, meshes, host sharding.

The reference is a single process with no distributed communication of
any kind (SURVEY.md §2.5).  This build's scale axis is the problem
batch: this module provides the pieces to run one BatchSolver across
several processes, each with its own devices (or a multi-process CPU
test rig):

 - :func:`initialize` — `jax.distributed` bring-up (idempotent).
 - :func:`pod_mesh` — a 1-d or (hosts, local) 2-d mesh over all global
   devices, batch axis over the devices of a host and across hosts.
 - :func:`host_local_batch` — per-host slice of a global problem batch
   for `jax.make_array_from_process_local_data`-style distribution.
 - :func:`all_hosts_best` — best-of-batch reduction across the global
   batch (a cross-host argmin via jit on the sharded pytree).

All collectives are XLA-inserted from shardings (`psum`/`all_gather`
per the platform's standard mesh partitioning; no hand-written
NCCL/MPI analogue).
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """Bring up jax.distributed (no-op when already initialized or when
    running single-process).

    Pass the three arguments explicitly (coordinator_address as
    ``host:port``); nothing here detects a cluster.
    """
    if coordinator_address is None and num_processes is None:
        return  # single process — nothing to do
    # NB: must not touch jax.process_count()/jax.devices() here — any
    # backend query would initialize XLA and make distributed bring-up
    # impossible; check the distributed client state directly instead
    from jax._src import distributed as _dist
    if getattr(_dist.global_state, "client", None) is not None:
        return  # already initialized
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id)


def pod_mesh(axis: str = "dp", hosts_axis: Optional[str] = None) -> Mesh:
    """Mesh over all global devices.

    With ``hosts_axis=None`` (default): a flat 1-d mesh ``(axis,)`` —
    the problem batch is the only parallel axis, XLA routes the
    convergence/cost reductions over ICI then DCN automatically.

    With ``hosts_axis='hosts'``: a (process_count, local_device_count)
    mesh for explicit host-level sharding (e.g. per-host scenes).
    """
    devs = np.asarray(jax.devices())
    if hosts_axis is None:
        return Mesh(devs.reshape(-1), (axis,))
    nproc = jax.process_count()
    local = len(devs) // nproc
    return Mesh(devs.reshape(nproc, local), (hosts_axis, axis))


def host_local_batch(global_batch: int) -> tuple:
    """(start, size) of this host's slice of a global problem batch,
    splitting as evenly as possible (first hosts get the remainder)."""
    n, rank = jax.process_count(), jax.process_index()
    base, rem = divmod(global_batch, n)
    size = base + (1 if rank < rem else 0)
    start = rank * base + min(rank, rem)
    return start, size


def make_global_problems(probs_local, mesh: Mesh, axis="dp"):
    """Assemble a globally-sharded problem pytree from per-host local
    shards (each host passes only its own rows).

    ``axis`` may be a single mesh-axis name or a tuple — e.g.
    ``("hosts", "dp")`` shards the problem batch over both axes of a
    2-d :func:`pod_mesh` (host-major, matching host_local_batch's
    row split).

    Single-process: equivalent to ``jax.device_put`` with the batch
    sharded over the mesh.
    """
    sharding = NamedSharding(mesh, P(axis))
    if jax.process_count() == 1:
        return jax.device_put(probs_local, sharding)
    return jax.tree.map(
        lambda x: jax.make_array_from_process_local_data(
            sharding, np.asarray(x)), probs_local)


def all_hosts_best(probs, final_costs):
    """Global best-of-batch under any sharding: jit the argmin so XLA
    inserts the cross-host reduction; the result is replicated."""
    from or_cdchomp_jax.parallel.batch import best_of_batch

    return jax.jit(best_of_batch)(probs, final_costs)
