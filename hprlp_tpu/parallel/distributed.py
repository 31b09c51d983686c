"""Multi-host bring-up for sharded solves (SURVEY §5.8 — no reference
counterpart; the reference is single-GPU with no communication backend at
all).

Usage on each host (GPU hosts or a CPU fleet):

    import hprlp_tpu.parallel.distributed as dist
    dist.initialize(coordinator_address="host0:1234",
                    num_processes=N, process_id=i)
    params = Parameters(mesh_shape=dist.global_device_count())
    res = solve_problem(problem, params)   # mesh spans ALL hosts

`jax.distributed.initialize` wires the processes together; after it,
`jax.devices()` returns the GLOBAL device list, so parallel.sharded's
make_mesh/shard_problem span hosts transparently — the row-block GSPMD
partition's collectives then run within and across hosts (XLA picks the
transport).

Every process must call solve with the SAME problem data: LP vectors are
small, so full replication of the host-side numpy data is the right
trade (the big object, A's buckets, is uploaded shard-wise — each process
materialises only its addressable shards via global_put)."""

from __future__ import annotations

import jax
import numpy as np


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               local_device_ids=None) -> None:
    """Initialise the JAX distributed runtime (idempotent).

    Pass the arguments explicitly (coordinator "host:port", total process
    count, this process's id): nothing on a plain GPU or CPU host tells
    JAX of a cluster, so a bare call fails unless the backend is already
    up (then it is a no-op).

    NOTE: must run before ANY other JAX call — even jax.devices() or
    jax.process_count() bring the backend up, after which distributed
    init is impossible (this function then becomes a warned no-op)."""
    # Cross-process CPU collectives need the gloo implementation selected
    # BEFORE the backend comes up (multi-process CPU fleets / tests).
    try:
        jax.config.update("jax_cpu_collectives_implementation", "gloo")
    except Exception:
        pass
    kw = {}
    if coordinator_address is not None:
        kw["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kw["num_processes"] = num_processes
    if process_id is not None:
        kw["process_id"] = process_id
    if local_device_ids is not None:
        kw["local_device_ids"] = local_device_ids
    try:
        jax.distributed.initialize(**kw)
    except RuntimeError as e:
        msg = str(e).lower()
        # Single-process runs (tests, one-host slices) need no init; a
        # backend already brought up in-process also cannot (and need
        # not) be re-wired.
        if ("already initialized" in msg
                or "must be called before" in msg):
            if kw:
                import sys
                print("[distributed] initialize() ignored: the XLA "
                      "backend is already up in this process; call it "
                      "before any other JAX use", file=sys.stderr)
            return
        raise


def global_device_count() -> int:
    return len(jax.devices())


def is_multihost() -> bool:
    return jax.process_count() > 1


def global_put(arr: np.ndarray, sharding) -> jax.Array:
    """Create a GLOBAL sharded array from replicated host data.

    Single-process: plain device_put.  Multi-host: every process holds
    the same full `arr` and materialises only its addressable shards
    (jax.make_array_from_callback), which is what device_put cannot do
    across processes."""
    if jax.process_count() == 1:
        return jax.device_put(arr, sharding)
    arr = np.asarray(arr)
    return jax.make_array_from_callback(
        arr.shape, sharding, lambda idx: arr[idx])


def host_fetch(arr) -> np.ndarray:
    """Fetch a device array to host numpy, multi-process safe: arrays
    whose shards span other processes are allgathered first (fetching a
    non-addressable array raises under jax.distributed)."""
    if (jax.process_count() > 1
            and hasattr(arr, "is_fully_addressable")
            and not arr.is_fully_addressable
            and not arr.sharding.is_fully_replicated):
        from jax.experimental import multihost_utils

        return np.asarray(multihost_utils.process_allgather(arr,
                                                            tiled=True))
    return np.asarray(jax.device_get(arr))
