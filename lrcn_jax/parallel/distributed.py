"""Multi-host (multi-process) runtime helpers.

The reference is a single process on one GPU — there is no distributed
communication backend at all (SURVEY.md §2/§5).  In this framework the
backend IS JAX/XLA: processes join a coordination service, every process
sees the global mesh, and GSPMD compiles collectives that XLA hands to
NCCL (NVLink within a host, the network across hosts).  These helpers wrap the two host-side jobs
that remain:

- joining the cluster (``initialize``), and
- turning per-host input shards into global device arrays
  (``host_local_batch``) so the sharded train step (parallel/train.py)
  is identical single-host and multi-host.
"""

from __future__ import annotations

import os
from typing import Any

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

# The single-process decision must NOT touch backend-initializing APIs
# (jax.process_count() initializes XLA, after which
# jax.distributed.initialize() always raises "must be called before any
# JAX computations") — so it is made from the environment alone.
_COORDINATOR_ENV_VARS = (
    "JAX_COORDINATOR_ADDRESS",        # jax-native
    "COORDINATOR_ADDRESS",
)


def _cluster_environment() -> bool:
    """True when env vars describe a MULTI-process cluster.

    Presence alone is not enough: single-node setups legitimately set
    e.g. ``SLURM_JOB_NUM_NODES=1`` or ``OMPI_COMM_WORLD_SIZE=1``, and
    must stay single-process.
    """
    if any(v in os.environ for v in _COORDINATOR_ENV_VARS):
        return True
    for count_var in ("SLURM_JOB_NUM_NODES", "OMPI_COMM_WORLD_SIZE"):
        try:
            if int(os.environ.get(count_var, "1")) > 1:
                return True
        except ValueError:
            pass
    return False


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """Join the JAX coordination service (multi-host startup).

    A no-op when every argument is None and no cluster environment
    variable is set (single-process case) — decided from the environment
    alone, so call sites can run this unconditionally and BEFORE any other
    JAX use.  In a cluster environment, initialization errors propagate
    (silently falling back to single-process on a cluster would train on 1/Nth
    of the data while looking healthy).

    Caveat: environments whose cluster identity lives ONLY behind a
    metadata server (no env vars at all) are not auto-detected by the
    no-arg path; pass coordinator_address/num_processes/process_id
    explicitly there.
    """
    if (coordinator_address is None and num_processes is None
            and process_id is None):
        if not _cluster_environment():
            return  # no cluster environment: stay single-process
        jax.distributed.initialize()
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes, process_id=process_id)


def host_local_batch(mesh: Mesh, batch_shard: Any,
                     spec: P = P("data")) -> Any:
    """Assemble global arrays from THIS process's slice of the batch.

    Each host loads only its own rows (1/process_count of the global
    batch); this stitches them into sharded global arrays without any
    host-side gather.  Single-process it degenerates to a device_put.
    """
    def one(x):
        x = np.asarray(x)
        sharding = NamedSharding(mesh, spec)
        if jax.process_count() == 1:
            return jax.device_put(x, sharding)
        return jax.make_array_from_process_local_data(sharding, x)
    return jax.tree.map(one, batch_shard)


def gather_to_host(tree: Any) -> Any:
    """Materialize a (possibly multi-process-sharded) pytree as host numpy.

    COLLECTIVE whenever any leaf spans processes: every process must call
    it (the cross-process piece is an all-gather over NVLink or the network).  Leaves
    this process can already see in full — fully-addressable arrays, and
    replicated arrays whose local shard IS the value — are plain device
    reads.  Single-process it degenerates to ``jax.tree.map(np.asarray)``.
    """
    def one(x):
        if not isinstance(x, jax.Array):
            return np.asarray(x)
        if x.is_fully_addressable:
            return np.asarray(x)
        if x.is_fully_replicated:
            return np.asarray(x.addressable_data(0))
        from jax.experimental import multihost_utils
        return np.asarray(multihost_utils.process_allgather(x, tiled=True))
    return jax.tree.map(one, tree)


def shared_seed(seed: int | None) -> int | None:
    """A shuffle seed every process agrees on.

    Seeded runs already agree (the same flag value reaches every
    process).  UNSEEDED multi-process runs must not each draw their own
    entropy: the shuffle order would silently diverge across processes
    and each would train on a different batch stream while the
    collectives still "work" — the classic wrong-but-healthy-looking
    failure.  Process 0 draws the entropy and broadcasts it.
    Single-process, ``None`` stays ``None`` (preserving the reference's
    unseeded behavior, lrcn.jl --seed <= 0).
    """
    if seed is not None or jax.process_count() == 1:
        return seed
    import secrets

    from jax.experimental import multihost_utils
    # 31 bits: survives the default x64-disabled int32 world unchanged
    local = np.int32(secrets.randbits(31))
    return int(multihost_utils.broadcast_one_to_all(local))


def is_primary() -> bool:
    """True on the process that owns cluster-wide side effects (writing
    checkpoints, metrics files): process 0, or any single-process run."""
    return jax.process_index() == 0


def barrier(name: str) -> None:
    """Block until every process reaches this point (single-process: no-op).

    ``name`` must be identical on all processes at the same barrier."""
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils
        multihost_utils.sync_global_devices(name)
