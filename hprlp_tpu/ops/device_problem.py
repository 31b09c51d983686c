"""Device-resident LP problem: padded, permuted, bucketed.

The analogue of the reference's copy_lpinfo_to_device + allocate_memory
(reference: src/preprocess.cu:66-256): the CSR problem is re-laid-out for
the device once at model-upload time.

Padding rows are free constraints (AL=-inf, AU=+inf): their dual iterate is
identically zero.  Padding columns are variables fixed at zero (l=u=0, c=0):
their primal iterate and dual residual are identically zero.  Hence the
padded problem is equivalent to the original and no masks are needed in the
hot loop.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from .. import constants
from ..problem import LpProblem
from .sparse import (EllMatrix, build_ell_from_csr, bucketed_row_total,
                     padded_size, plan_buckets, plan_entry_total)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class LpDevice:
    """Padded LP data on device (parity: LP_info_gpu, include/structs.h:243-252)."""

    A: EllMatrix
    AT: EllMatrix
    AL: jax.Array  # (m_pad,)
    AU: jax.Array
    c: jax.Array  # (n_pad,)
    l: jax.Array
    u: jax.Array

    @property
    def m(self) -> int:
        return self.A.nrows

    @property
    def n(self) -> int:
        return self.A.ncols


@dataclasses.dataclass(frozen=True)
class HostMaps:
    """Host-side bookkeeping to translate between original and padded spaces."""

    row_pos: np.ndarray  # (m_orig,) -> padded row index
    col_pos: np.ndarray  # (n_orig,) -> padded col index
    m_orig: int
    n_orig: int
    obj_constant: float
    objective_sense: int


def build_device_problem(problem: LpProblem, dtype=jnp.float32,
                         row_multiple: int = 8,
                         vec_multiple: int = constants.VECTOR_PAD_MULTIPLE,
                         min_width: int = constants.MIN_ELL_WIDTH,
                         min_bucket_rows: int = constants.MIN_BUCKET_ROWS,
                         ) -> tuple[LpDevice, HostMaps]:
    """Lay out an LpProblem for the device: CSR, then the row/column
    bucket plans, then the gather-ELL buckets of A and A^T.

    row_multiple also controls shardability: pass n_devices*8 (or more) to
    make every bucket's row count divisible by the mesh size.
    """
    A = problem.A.tocsr()
    A.sum_duplicates()
    AT = A.T.tocsr()
    AT.sum_duplicates()
    m, n = A.shape

    plan_A = plan_buckets(np.diff(A.indptr), min_width, min_bucket_rows)
    plan_AT = plan_buckets(np.diff(AT.indptr), min_width, min_bucket_rows)

    m_pad = padded_size(bucketed_row_total(plan_A, row_multiple), vec_multiple)
    n_pad = padded_size(bucketed_row_total(plan_AT, row_multiple), vec_multiple)

    # Column positions come from the OTHER matrix's bucket plan.
    row_pos = _positions_from_plan(plan_A, m, row_multiple)
    col_pos = _positions_from_plan(plan_AT, n, row_multiple)

    np_dtype = np.dtype(dtype)
    A_ell, row_pos2 = build_ell_from_csr(
        A.indptr, A.indices, A.data, plan_A, col_pos, m_pad, n_pad,
        row_multiple, np_dtype)
    AT_ell, col_pos2 = build_ell_from_csr(
        AT.indptr, AT.indices, AT.data, plan_AT, row_pos, n_pad, m_pad,
        row_multiple, np_dtype)
    assert np.array_equal(row_pos, row_pos2)
    assert np.array_equal(col_pos, col_pos2)

    def scatter_vec(vals, pos, size, fill):
        out = np.full(size, fill, dtype=np.float64)
        out[pos] = vals
        return jnp.asarray(out.astype(np_dtype))

    AL = scatter_vec(problem.AL, row_pos, m_pad, -np.inf)
    AU = scatter_vec(problem.AU, row_pos, m_pad, np.inf)
    c = scatter_vec(problem.c, col_pos, n_pad, 0.0)
    l = scatter_vec(problem.l, col_pos, n_pad, 0.0)
    u = scatter_vec(problem.u, col_pos, n_pad, 0.0)

    dev = LpDevice(A=A_ell, AT=AT_ell, AL=AL, AU=AU, c=c, l=l, u=u)
    maps = HostMaps(row_pos=row_pos, col_pos=col_pos, m_orig=m, n_orig=n,
                    obj_constant=float(problem.obj_constant),
                    objective_sense=problem.objective_sense)
    return dev, maps


def _positions_from_plan(plan, n_orig: int, row_multiple: int) -> np.ndarray:
    pos = np.full(n_orig, -1, dtype=np.int64)
    cursor = 0
    for entry in plan:
        rows = entry[1]
        pos[rows] = cursor + np.arange(len(rows))
        cursor += plan_entry_total(entry, row_multiple)
    return pos


def to_dense(A: EllMatrix) -> np.ndarray:
    """Densify (testing only)."""
    out = np.zeros((A.nrows, A.ncols))
    for b in A.buckets:
        vals = np.asarray(b.vals)
        cols = np.asarray(b.cols)
        valid = np.asarray(b.valid)
        for r in range(vals.shape[0]):
            for k in range(vals.shape[1]):
                if valid[r, k]:
                    out[b.row_start + r, cols[r, k]] += vals[r, k]
    return out
