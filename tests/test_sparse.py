"""Unit tests for the bucketed-ELL sparse format."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp

from hprlp_tpu.ops.device_problem import build_device_problem, to_dense
from hprlp_tpu.ops.sparse import (plan_buckets, row_counts, row_inf_norms,
                                  row_one_norms, scale_cols, scale_rows,
                                  spmm, spmv)
from hprlp_tpu.problem import LpProblem

from conftest import random_lp


def _random_csr(seed, m=50, n=70, density=0.15):
    rng = np.random.default_rng(seed)
    return sp.random(m, n, density=density, random_state=rng,
                     data_rvs=lambda k: rng.normal(size=k)).tocsr()


def _lp_of(A):
    m, n = A.shape
    return LpProblem.from_arrays(A, -np.ones(m), np.ones(m),
                                 np.zeros(n), np.ones(n), np.ones(n))


def test_plan_buckets_covers_all_rows():
    nnz = np.array([0, 1, 3, 5, 17, 100, 4, 4, 2])
    plan = plan_buckets(nnz, min_width=4, min_bucket_rows=2)
    all_rows = np.sort(np.concatenate([rows for _, rows in plan]))
    assert np.array_equal(all_rows, np.arange(len(nnz)))
    for w, rows in plan:
        assert np.all(nnz[rows] <= w)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_build_roundtrip_dense(seed):
    A = _random_csr(seed, m=30, n=40)
    lp, maps = build_device_problem(_lp_of(A), dtype=jnp.float64,
                                    vec_multiple=8)
    D = to_dense(lp.A)
    DT = to_dense(lp.AT)
    # Padded dense equals original at the (row_pos, col_pos) submatrix.
    ref = A.toarray()
    np.testing.assert_allclose(D[np.ix_(maps.row_pos, maps.col_pos)], ref)
    np.testing.assert_allclose(DT[np.ix_(maps.col_pos, maps.row_pos)], ref.T)
    # And zero everywhere rows/cols are padding.
    mask_r = np.ones(lp.m, bool)
    mask_r[maps.row_pos] = False
    assert np.all(D[mask_r] == 0)


@pytest.mark.parametrize("seed", [3, 4])
def test_spmv_matches_scipy(seed):
    A = _random_csr(seed, m=123, n=87, density=0.2)
    lp, maps = build_device_problem(_lp_of(A), dtype=jnp.float64,
                                    vec_multiple=8)
    rng = np.random.default_rng(seed)
    x = rng.normal(size=A.shape[1])
    x_pad = np.zeros(lp.n)
    x_pad[maps.col_pos] = x
    y = np.asarray(spmv(lp.A, jnp.asarray(x_pad)))
    np.testing.assert_allclose(y[maps.row_pos], A @ x, rtol=1e-12, atol=1e-12)

    yv = rng.normal(size=A.shape[0])
    y_pad = np.zeros(lp.m)
    y_pad[maps.row_pos] = yv
    z = np.asarray(spmv(lp.AT, jnp.asarray(y_pad)))
    np.testing.assert_allclose(z[maps.col_pos], A.T @ yv, rtol=1e-12,
                               atol=1e-12)


def test_spmm_matches_scipy():
    A = _random_csr(7, m=40, n=30)
    lp, maps = build_device_problem(_lp_of(A), dtype=jnp.float64,
                                    vec_multiple=8)
    rng = np.random.default_rng(7)
    X = rng.normal(size=(A.shape[1], 5))
    X_pad = np.zeros((lp.n, 5))
    X_pad[maps.col_pos] = X
    Y = np.asarray(spmm(lp.A, jnp.asarray(X_pad)))
    np.testing.assert_allclose(Y[maps.row_pos], A @ X, rtol=1e-12, atol=1e-12)


def test_row_norms_and_counts():
    A = _random_csr(9, m=25, n=25)
    lp, maps = build_device_problem(_lp_of(A), dtype=jnp.float64,
                                    vec_multiple=8)
    inf_n = np.asarray(row_inf_norms(lp.A))[maps.row_pos]
    one_n = np.asarray(row_one_norms(lp.A))[maps.row_pos]
    cnt = np.asarray(row_counts(lp.A))[maps.row_pos]
    ref = np.abs(A.toarray())
    np.testing.assert_allclose(inf_n, ref.max(axis=1), rtol=1e-12)
    np.testing.assert_allclose(one_n, ref.sum(axis=1), rtol=1e-12)
    np.testing.assert_array_equal(cnt, (ref > 0).sum(axis=1))


def test_scaling_ops():
    A = _random_csr(11, m=20, n=20)
    lp, maps = build_device_problem(_lp_of(A), dtype=jnp.float64,
                                    vec_multiple=8)
    rng = np.random.default_rng(11)
    r = jnp.asarray(rng.uniform(0.5, 2.0, lp.m))
    c = jnp.asarray(rng.uniform(0.5, 2.0, lp.n))
    S = to_dense(scale_cols(scale_rows(lp.A, r), c))
    ref = np.diag(np.asarray(r)) @ to_dense(lp.A) @ np.diag(np.asarray(c))
    np.testing.assert_allclose(S, ref, rtol=1e-12, atol=1e-12)


def _structured_csr(kind, seed):
    """Sparse matrices whose shapes stress the bucket plan."""
    rng = np.random.default_rng(seed)
    normal = lambda k: rng.normal(size=k)  # noqa: E731
    if kind == "uniform":
        return sp.random(96, 120, density=0.1, random_state=rng,
                         data_rvs=normal).tocsr()
    if kind == "skewed":
        # Zipf-like row lengths: most rows short, a few hundreds wide.
        m, n = 200, 600
        deg = np.minimum(rng.zipf(1.7, m) * 2, n)
        rows = np.repeat(np.arange(m), deg)
        cols = rng.integers(0, n, size=len(rows))
        A = sp.coo_matrix((normal(len(rows)), (rows, cols)),
                          shape=(m, n)).tocsr()
        A.sum_duplicates()
        return A
    if kind == "empty_rows_cols":
        D = sp.random(80, 90, density=0.15, random_state=rng,
                      data_rvs=normal).toarray()
        D[::7, :] = 0.0
        D[:, ::5] = 0.0
        return sp.csr_matrix(D)
    if kind == "dense_linking_column":
        D = sp.random(150, 60, density=0.05, random_state=rng,
                      data_rvs=normal).toarray()
        D[:, 17] = normal(150)
        return sp.csr_matrix(D)
    if kind == "m_much_less_than_n":
        return sp.random(6, 700, density=0.2, random_state=rng,
                         data_rvs=normal).tocsr()
    if kind == "n_much_less_than_m":
        return sp.random(700, 6, density=0.3, random_state=rng,
                         data_rvs=normal).tocsr()
    raise ValueError(kind)


STRUCTURES = ["uniform", "skewed", "empty_rows_cols", "dense_linking_column",
              "m_much_less_than_n", "n_much_less_than_m"]
# f32 sums of a few hundred terms stay near 1e-7 relative; f64 near 1e-16.
GATHER_RTOL = {"float32": 1e-5, "float64": 1e-12}


def _rel(a, b):
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("kind", STRUCTURES)
def test_gather_spmv_matches_scipy(kind, dtype):
    """Gather spmv of A and A^T through the padded/permuted layout equals
    scipy's CSR product in f64."""
    A = _structured_csr(kind, 3)
    lp, maps = build_device_problem(_lp_of(A), dtype=jnp.dtype(dtype))
    assert lp.A.backend == lp.AT.backend == "gather"
    rng = np.random.default_rng(1)
    x = rng.normal(size=A.shape[1])
    y = rng.normal(size=A.shape[0])
    xp = np.zeros(lp.n)
    xp[maps.col_pos] = x
    yp = np.zeros(lp.m)
    yp[maps.row_pos] = y
    Ax = np.asarray(spmv(lp.A, jnp.asarray(xp, dtype)), np.float64)
    ATy = np.asarray(spmv(lp.AT, jnp.asarray(yp, dtype)), np.float64)
    assert _rel(Ax[maps.row_pos], A @ x) <= GATHER_RTOL[dtype]
    assert _rel(ATy[maps.col_pos], A.T @ y) <= GATHER_RTOL[dtype]
    # Padding rows/columns stay exactly zero.
    pad_r = np.ones(lp.m, bool)
    pad_r[maps.row_pos] = False
    assert np.all(Ax[pad_r] == 0.0)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("kind", STRUCTURES)
def test_gather_spmm_matches_scipy(kind, dtype):
    """Batched gather SpMM (the batched solver's product) equals scipy."""
    A = _structured_csr(kind, 4)
    lp, maps = build_device_problem(_lp_of(A), dtype=jnp.dtype(dtype))
    rng = np.random.default_rng(2)
    B = 5
    X = rng.normal(size=(A.shape[1], B))
    Xp = np.zeros((lp.n, B))
    Xp[maps.col_pos] = X
    Y = np.asarray(spmm(lp.A, jnp.asarray(Xp, dtype)), np.float64)
    assert Y.shape == (lp.m, B)
    assert _rel(Y[maps.row_pos], A @ X) <= GATHER_RTOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("op", ["spmv", "spmm"])
def test_dense_backend_highest_precision_matches_host(op, dtype):
    """The dense backend (a full-precision matrix product) agrees with the
    host f64 product and with the gather backend."""
    from hprlp_tpu.ops.sparse import with_backend

    A = _structured_csr("uniform", 5)
    lp, maps = build_device_problem(_lp_of(A), dtype=jnp.dtype(dtype))
    Ad = with_backend(lp.A, "dense")
    assert Ad.backend == "dense" and Ad.dense.shape == (lp.m, lp.n)
    rng = np.random.default_rng(6)
    shape = (A.shape[1],) if op == "spmv" else (A.shape[1], 4)
    X = rng.normal(size=shape)
    Xp = np.zeros((lp.n,) + shape[1:])
    Xp[maps.col_pos] = X
    f = spmv if op == "spmv" else spmm
    got = np.asarray(f(Ad, jnp.asarray(Xp, dtype)), np.float64)
    assert _rel(got[maps.row_pos], A @ X) <= GATHER_RTOL[dtype]
    gathered = np.asarray(f(lp.A, jnp.asarray(Xp, dtype)), np.float64)
    assert _rel(got, gathered) <= GATHER_RTOL[dtype]
    assert with_backend(Ad, "gather").dense is None


def test_with_backend_rejects_unknown():
    A = _structured_csr("uniform", 7)
    lp, _ = build_device_problem(_lp_of(A))
    with pytest.raises(ValueError, match="unknown SpMV backend"):
        from hprlp_tpu.ops.sparse import with_backend

        with_backend(lp.A, "csr")
