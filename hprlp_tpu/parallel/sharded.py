"""Multi-device sharding of the HPR-LP solve (no reference counterpart —
the reference is single-GPU, SURVEY.md §2.9/§5.8).

Design (GSPMD): the bucketed-ELL matrices A and A^T are partitioned along
their ROW axis over a 1-D device mesh ('d'); iterate vectors are replicated.
Every SpMV then computes a row block per device, and XLA inserts the
all-gather that re-replicates the result for the next elementwise step —
XLA hands the collectives to NCCL on GPUs and overlaps them where it can.  Reductions
(dots/norms) become psums automatically.

Row-block partition is the natural layout for HPR-LP: one SpMV consumes the
full opposite-space vector, so per-iteration communication is exactly one
all-gather of y (m floats) and one of x (n floats), while the O(nnz) gather
+multiply+reduce work is split N ways.

Requirements: every ELL bucket's row count must be divisible by the mesh
size — build the device problem with row_multiple = 8 * n_devices (see
build_device_problem).
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.device_problem import LpDevice
from ..ops.sparse import EllBucket, EllMatrix
from .distributed import global_put


def make_mesh(n_devices: int | None = None, axis: str = "d") -> Mesh:
    """1-D mesh over the first n_devices devices.  A flat mesh fits cards
    that are joined all to all (NVLink): every pair of devices talks at
    the same rate, so the mesh follows the algorithm alone."""
    devs = jax.devices()
    if n_devices is not None:
        if len(devs) < n_devices:
            raise ValueError(
                f"requested {n_devices} devices, only {len(devs)} available")
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


def _shard_ell(A: EllMatrix, mesh: Mesh, axis: str) -> EllMatrix:
    """Place each bucket row-sharded over the mesh."""
    row_sharding = NamedSharding(mesh, P(axis, None))
    n = mesh.devices.size
    buckets = []
    for b in A.buckets:
        if b.vals.shape[0] % n != 0:
            raise ValueError(
                f"bucket rows {b.vals.shape[0]} not divisible by mesh size "
                f"{n}; build the problem with row_multiple=8*n_devices")
        buckets.append(EllBucket(
            vals=global_put(b.vals, row_sharding),
            cols=global_put(b.cols, row_sharding),
            valid=global_put(b.valid, row_sharding),
            row_start=b.row_start, width=b.width))
    return dataclasses.replace(A, buckets=tuple(buckets))


def shard_problem(lp: LpDevice, mesh: Mesh, axis: str = "d") -> LpDevice:
    """Row-shard A and A^T over the mesh; replicate the bound/cost vectors.

    The returned LpDevice runs through the SAME jitted solver code
    (scale_problem, power_method, run_chunk) — XLA's SPMD partitioner
    propagates the shardings and inserts collectives.
    """
    rep = NamedSharding(mesh, P())
    return LpDevice(
        A=_shard_ell(lp.A, mesh, axis),
        AT=_shard_ell(lp.AT, mesh, axis),
        AL=global_put(lp.AL, rep),
        AU=global_put(lp.AU, rep),
        c=global_put(lp.c, rep),
        l=global_put(lp.l, rep),
        u=global_put(lp.u, rep),
    )
