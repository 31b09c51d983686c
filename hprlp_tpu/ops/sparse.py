"""Sparse-matrix format and products (bucketed ELL).

Role parity with the reference's CSR + cuSPARSE SpMV + warp-bucketed fused
kernels (reference: src/preprocess.cu:17-39 row buckets,
src/cuda_kernels/HPR_cuda_kernels.cu:297-427 fused row kernels), expressed
in plain XLA:

  * Rows are grouped into buckets by power-of-two nnz width.  The problem's
    row space is PERMUTED so each bucket owns a contiguous row range; a
    bucket is then a dense (R, W) pair of (vals, cols) tiles with a validity
    mask.  SpMV = gather + multiply + row-reduce per bucket, concatenated —
    static shapes, no scatter, no dynamic control flow, fully fusable by
    XLA (the same memory pattern as the reference's row-length-bucketed
    CSR kernels).
  * A and A^T are stored separately (the reference also materialises A^T,
    src/preprocess.cu:80-90); the column space of A is the (permuted, padded)
    row space of A^T and vice versa.
  * Dummy padding rows/cols are REAL problem entities (free constraint rows,
    variables fixed at zero), so every downstream computation is oblivious
    to padding.  See ell_build.build_device_problem.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class EllBucket:
    vals: jax.Array  # (R, W) matrix values, zero-padded
    cols: jax.Array  # (R, W) int32 column positions (padded col space), 0-padded
    valid: jax.Array  # (R, W) bool, True on real nonzeros
    row_start: int = dataclasses.field(metadata=dict(static=True))
    width: int = dataclasses.field(metadata=dict(static=True))

    @property
    def nrows(self) -> int:
        return self.vals.shape[0]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class EllMatrix:
    """Bucketed-ELL sparse matrix over padded row/col index spaces.

    `backend` selects the SpMV/SpMM lowering (autotuned per matrix at solve
    start, parity: the reference's fused-kernel autotuner,
    src/main_iterate.cu:517-595):
      - "gather": per-bucket gather + row-reduce (the default);
      - "dense":  one matrix product against the densified matrix (`dense`
        must be attached) — wins on small, dense-ish matrices.
    Changing the backend retraces dependent jits (it is static metadata).
    """

    buckets: Tuple[EllBucket, ...]
    nrows: int = dataclasses.field(metadata=dict(static=True))
    ncols: int = dataclasses.field(metadata=dict(static=True))
    backend: str = dataclasses.field(default="gather",
                                     metadata=dict(static=True))
    dense: jax.Array | None = None  # (nrows, ncols) when backend == "dense"

    @property
    def dtype(self):
        return self.buckets[0].vals.dtype

    @property
    def nnz(self) -> int:
        return sum(int(b.vals.size) for b in self.buckets)


def densify(A: EllMatrix) -> jax.Array:
    """(nrows, ncols) dense matrix from the buckets (device-side)."""
    D = jnp.zeros((A.nrows, A.ncols), A.dtype)
    for b in A.buckets:
        R, W = b.vals.shape
        rows = b.row_start + jax.lax.broadcasted_iota(jnp.int32, (R, W), 0)
        vals = jnp.where(b.valid, b.vals, 0.0)
        D = D.at[rows, b.cols].add(vals)
    return D


def to_coo(A: EllMatrix):
    """Host-side (padded-position) COO of the live entries, row-major."""
    parts = []
    for b in A.buckets:
        r, k = np.nonzero(np.asarray(b.valid))
        parts.append((b.row_start + r, np.asarray(b.cols)[r, k],
                      np.asarray(b.vals)[r, k]))
    if not parts:
        return (np.zeros(0, np.int64),) * 2 + (np.zeros(0),)
    return (np.concatenate([p[0] for p in parts]).astype(np.int64),
            np.concatenate([p[1] for p in parts]).astype(np.int64),
            np.concatenate([p[2] for p in parts]).astype(np.float64))


def with_backend(A: EllMatrix, backend: str) -> EllMatrix:
    """Return A configured for the given SpMV backend."""
    if backend == A.backend:
        return A
    if backend == "dense":
        return dataclasses.replace(A, backend="dense", dense=densify(A))
    if backend != "gather":
        raise ValueError(f"unknown SpMV backend {backend!r}")
    return dataclasses.replace(A, backend="gather", dense=None)


def spmv(A: EllMatrix, x: jax.Array) -> jax.Array:
    """y = A @ x.  x: (ncols,) -> y: (nrows,).

    gather backend: each bucket is a dense gather+reduce; buckets cover
    contiguous row ranges in order, so concatenation reassembles y.
    """
    if A.backend == "dense":
        # HIGHEST: full-f32 products — a TF32 default would degrade the
        # iterates and fail the autotuner's merit check anyway.
        return jnp.dot(A.dense, x, preferred_element_type=x.dtype,
                       precision=jax.lax.Precision.HIGHEST)
    parts = [jnp.sum(b.vals * x[b.cols], axis=1) for b in A.buckets]
    return parts[0] if len(parts) == 1 else jnp.concatenate(parts)


def spmm(A: EllMatrix, X: jax.Array) -> jax.Array:
    """Y = A @ X for batched solves.  X: (ncols, B) -> Y: (nrows, B).

    Replacement for the reference's cuSPARSE SpMM batched path
    (reference: src/batched_solver.cu:428-477).  Both contractions ask for
    HIGHEST precision: XLA may lower the per-bucket einsum to a batched
    GEMM, which on GPUs defaults to TF32 for float32 operands.
    """
    if A.backend == "dense":
        return jnp.dot(A.dense, X, preferred_element_type=X.dtype,
                       precision=jax.lax.Precision.HIGHEST)
    parts = [
        jnp.einsum("rw,rwb->rb", b.vals, X[b.cols],
                   preferred_element_type=X.dtype,
                   precision=jax.lax.Precision.HIGHEST)
        for b in A.buckets
    ]
    return parts[0] if len(parts) == 1 else jnp.concatenate(parts, axis=0)


def row_inf_norms(A: EllMatrix) -> jax.Array:
    """Per-row max |a_ij| (padding is zero so it never wins)."""
    return jnp.concatenate([jnp.max(jnp.abs(b.vals), axis=1) for b in A.buckets])


def row_one_norms(A: EllMatrix) -> jax.Array:
    """Per-row sum |a_ij|."""
    return jnp.concatenate([jnp.sum(jnp.abs(b.vals), axis=1) for b in A.buckets])


def row_counts(A: EllMatrix) -> jax.Array:
    """Per-row number of structural nonzeros."""
    return jnp.concatenate(
        [jnp.sum(b.valid, axis=1).astype(jnp.int32) for b in A.buckets])


def scale_rows(A: EllMatrix, s: jax.Array) -> EllMatrix:
    """Return A with row i multiplied by s[i].  s: (nrows,).
    Any attached dense copy is dropped (it would go stale)."""
    buckets = tuple(
        dataclasses.replace(
            b, vals=b.vals * s[b.row_start:b.row_start + b.nrows, None])
        for b in A.buckets)
    return dataclasses.replace(A, buckets=buckets, backend="gather",
                               dense=None)


def scale_cols(A: EllMatrix, s: jax.Array) -> EllMatrix:
    """Return A with column j multiplied by s[j].  s: (ncols,).
    Any attached dense copy is dropped (it would go stale)."""
    buckets = tuple(
        dataclasses.replace(b, vals=b.vals * s[b.cols]) for b in A.buckets)
    return dataclasses.replace(A, buckets=buckets, backend="gather",
                               dense=None)


def row_masked_mean(A: EllMatrix, per_entry_fn) -> jax.Array:
    """Per-row mean of per_entry_fn(vals, cols) over valid entries; 0 for
    empty rows (reference: src/scaling.cu:5-31 Curtis-Reid row update)."""
    outs = []
    for b in A.buckets:
        t = jnp.where(b.valid, per_entry_fn(b.vals, b.cols), 0.0)
        cnt = jnp.sum(b.valid, axis=1).astype(t.dtype)
        outs.append(jnp.where(cnt > 0, jnp.sum(t, axis=1) / jnp.maximum(cnt, 1), 0.0))
    return jnp.concatenate(outs) if len(outs) > 1 else outs[0]


# ---------------------------------------------------------------------------
# Host-side construction
# ---------------------------------------------------------------------------

def plan_entry_total(entry, row_multiple: int) -> int:
    """Padded position count of a (width, rows) plan entry."""
    return -(-max(len(entry[1]), 1) // row_multiple) * row_multiple


def plan_buckets(nnz_per_row: np.ndarray, min_width: int,
                 min_bucket_rows: int) -> list[tuple[int, np.ndarray]]:
    """Assign each row a power-of-two ELL width and group rows by width.

    Groups smaller than min_bucket_rows are merged into the next wider
    group (analogous in spirit to the reference's short/medium row split,
    src/preprocess.cu:17-39, generalised to geometric widths).
    Returns [(width, row_indices)] with widths ascending; row order within
    a bucket preserves original order.
    """
    nnz_per_row = np.asarray(nnz_per_row)
    widths = np.maximum(min_width,
                        np.exp2(np.ceil(np.log2(np.maximum(nnz_per_row, 1)))).astype(np.int64))
    uniq = np.unique(widths)
    groups = [(int(w), np.nonzero(widths == w)[0]) for w in uniq]
    # Merge small groups upward.
    merged: list[tuple[int, np.ndarray]] = []
    carry = None
    for i, (w, rows) in enumerate(groups):
        if carry is not None:
            rows = np.sort(np.concatenate([carry, rows]))
            carry = None
        if len(rows) < min_bucket_rows and i + 1 < len(groups):
            carry = rows
        else:
            merged.append((w, rows))
    if carry is not None:
        # Everything was small: single bucket at the largest width seen.
        if merged:
            w, rows = merged[-1]
            merged[-1] = (w, np.sort(np.concatenate([rows, carry])))
        else:
            merged = [(int(uniq[-1]), carry)]
    return merged


def build_ell_from_csr(indptr: np.ndarray, indices: np.ndarray,
                       data: np.ndarray, bucket_plan, col_pos: np.ndarray,
                       nrows_padded: int, ncols_padded: int,
                       row_multiple: int, dtype) -> tuple[EllMatrix, np.ndarray]:
    """Build an EllMatrix from host CSR arrays.

    bucket_plan: output of plan_buckets over this matrix's rows.
    col_pos: map original column id -> padded column position.
    Returns (matrix, row_pos) where row_pos maps original row id -> padded
    row position.  Bucket row counts are padded to row_multiple; a final
    all-dummy bucket absorbs the remaining padding up to nrows_padded.
    """
    indptr = np.asarray(indptr)
    indices = np.asarray(indices)
    data = np.asarray(data)
    n_orig = len(indptr) - 1
    row_pos = np.full(n_orig, -1, dtype=np.int64)

    host: list[tuple[np.ndarray, np.ndarray, np.ndarray]] = []
    meta: list[tuple[int, int]] = []  # (row_start, width)
    cursor = 0
    for entry in bucket_plan:
        w, rows = entry
        r_real = len(rows)
        r_total = plan_entry_total(entry, row_multiple)
        vals = np.zeros((r_total, w), dtype=dtype)
        cols = np.zeros((r_total, w), dtype=np.int32)
        valid = np.zeros((r_total, w), dtype=bool)
        if r_real:
            row_pos[rows] = cursor + np.arange(r_real)
            if data.size:
                starts = indptr[rows]
                counts = indptr[rows + 1] - starts
                offs = np.arange(w)
                mask = offs[None, :] < counts[:, None]
                idx = np.where(mask, starts[:, None] + offs[None, :], 0)
                vals[:r_real] = np.where(mask, data[idx], 0.0)
                cols[:r_real] = np.where(mask, col_pos[indices[idx]], 0)
                valid[:r_real] = mask
        host.append((vals, cols, valid))
        meta.append((cursor, int(w)))
        cursor += r_total

    if cursor > nrows_padded:
        raise ValueError(f"bucket padding overflow: {cursor} > {nrows_padded}")
    if cursor < nrows_padded:
        pad = nrows_padded - cursor
        w = 4
        host.append((np.zeros((pad, w), dtype=dtype),
                     np.zeros((pad, w), dtype=np.int32),
                     np.zeros((pad, w), dtype=bool)))
        meta.append((cursor, w))

    # ONE batched transfer for every bucket array: a per-array
    # device_put pays its fixed overhead hundreds of times at scale.
    dev = jax.device_put(host)
    buckets = [EllBucket(vals=v, cols=c, valid=mk, row_start=rs, width=w)
               for (v, c, mk), (rs, w) in zip(dev, meta)]
    mat = EllMatrix(buckets=tuple(buckets), nrows=nrows_padded,
                    ncols=ncols_padded)
    return mat, row_pos


def padded_size(real_rows_after_bucket_pad: int, vec_multiple: int) -> int:
    return -(-max(real_rows_after_bucket_pad, 1) // vec_multiple) * vec_multiple


def bucketed_row_total(bucket_plan, row_multiple: int) -> int:
    return sum(plan_entry_total(e, row_multiple) for e in bucket_plan)
