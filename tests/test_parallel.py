"""Multi-device sharding tests on the virtual 8-device CPU mesh.

Validates the GSPMD row-block partition of A/A^T (single-LP path) and the
batch-axis sharding (batched path) produce the same results as
single-device runs.  On cards, `python chip_smoke.py --four-cards` runs
the same path at full size; these tests pin the numerics.
"""

import numpy as np
import pytest
import scipy.sparse as sp

import jax

from hprlp_tpu import Parameters, solve_batched
from hprlp_tpu.ops.device_problem import build_device_problem
from hprlp_tpu.parallel.sharded import make_mesh, shard_problem
from hprlp_tpu.solver.loop import solve_problem
from tests.conftest import random_lp

NDEV = 8

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < NDEV, reason="needs 8 virtual devices")


class TestShardedSingleLp:
    def test_sharded_solve_matches_single_device(self):
        prob = random_lp(21, m=60, n=80, density=0.2)
        p1 = Parameters(verbose=False, stop_tol=1e-6, use_presolve=False)
        r1 = solve_problem(prob, p1)
        p8 = Parameters(verbose=False, stop_tol=1e-6, use_presolve=False,
                        mesh_shape=NDEV)
        r8 = solve_problem(prob, p8)
        assert r1.status == r8.status == "OPTIMAL"
        assert r8.primal_obj == pytest.approx(r1.primal_obj, rel=1e-5,
                                              abs=1e-5)
        np.testing.assert_allclose(r8.x, r1.x, atol=1e-4)

    def test_shard_problem_layout(self):
        prob = random_lp(22, m=40, n=50, density=0.3)
        lp, _ = build_device_problem(prob, row_multiple=8 * NDEV,
                                     vec_multiple=256 * NDEV)
        mesh = make_mesh(NDEV)
        sharded = shard_problem(lp, mesh)
        for b in sharded.A.buckets + sharded.AT.buckets:
            assert b.vals.shape[0] % NDEV == 0
            # Sharded along rows over the mesh.
            assert len(b.vals.sharding.device_set) == NDEV
        # Vectors replicated.
        assert sharded.c.sharding.is_fully_replicated

    def test_indivisible_bucket_raises(self):
        prob = random_lp(23, m=20, n=30)
        lp, _ = build_device_problem(prob)  # default row_multiple=8
        mesh = make_mesh(NDEV)
        # Buckets padded to 8 may not divide 8 evenly in all cases; the
        # guard must catch any mismatch rather than mis-shard.
        try:
            shard_problem(lp, mesh)
        except ValueError as e:
            assert "row_multiple" in str(e)


@pytest.mark.parametrize("n_dev", [2, 4, 8])
def test_gspmd_mesh_solve_matches_single_device(n_dev):
    """The row-block GSPMD path with gather buckets (the multi-device
    path) solves like one device, and every bucket spans the mesh."""
    prob = random_lp(30 + n_dev, m=72, n=96, density=0.15)
    kw = dict(verbose=False, stop_tol=1e-6, use_presolve=False)
    r1 = solve_problem(prob, Parameters(**kw))
    rn = solve_problem(prob, Parameters(mesh_shape=n_dev, **kw))
    assert r1.status == rn.status == "OPTIMAL"
    assert rn.spmv_backend == "gather"
    assert rn.primal_obj == pytest.approx(r1.primal_obj, rel=1e-5,
                                          abs=1e-5)
    np.testing.assert_allclose(rn.x, r1.x, atol=1e-4)
    lp, _ = build_device_problem(prob, row_multiple=8 * n_dev,
                                 vec_multiple=256 * n_dev)
    sharded = shard_problem(lp, make_mesh(n_dev))
    for b in sharded.A.buckets + sharded.AT.buckets:
        assert len(b.vals.sharding.device_set) == n_dev


class TestShardedBatched:
    def test_batched_mesh_matches_single(self):
        rng = np.random.default_rng(9)
        m, n, B = 12, 18, NDEV * 2
        A = sp.random(m, n, density=0.4, random_state=rng,
                      data_rvs=lambda k: rng.normal(size=k)).tocsr()
        x0 = rng.uniform(-1, 1, size=(n, B))
        Ax = A @ x0
        args = (A, rng.normal(size=(n, B)), Ax - 1.0, Ax + 1.0,
                x0 - 2.0, x0 + 2.0)
        r1 = solve_batched(*args, params=Parameters(verbose=False))
        r8 = solve_batched(*args,
                           params=Parameters(verbose=False, mesh_shape=NDEV))
        assert list(r1.status) == list(r8.status)
        np.testing.assert_allclose(r8.primal_obj, r1.primal_obj, rtol=1e-5,
                                   atol=1e-6)

    def test_batched_indivisible_batch_raises(self):
        A = np.eye(2)
        with pytest.raises(ValueError):
            solve_batched(A, np.ones((2, 3)), -np.ones((2, 3)),
                          np.ones((2, 3)), np.zeros((2, 3)),
                          np.ones((2, 3)),
                          params=Parameters(verbose=False, mesh_shape=NDEV))


class TestDistributed:
    """Multi-host bring-up helpers (parallel/distributed.py); the
    single-process semantics are exercised here, the multi-process
    branch uses jax.make_array_from_callback with identical sharding
    layouts (validated per-shard below)."""

    def test_global_put_matches_device_put(self):
        import jax.numpy as jnp
        from jax.sharding import NamedSharding, PartitionSpec as P

        from hprlp_tpu.parallel.distributed import (global_device_count,
                                                    global_put,
                                                    initialize,
                                                    is_multihost)

        initialize()  # no-op single-process
        assert not is_multihost()
        assert global_device_count() >= NDEV
        mesh = make_mesh(NDEV)
        sh = NamedSharding(mesh, P("d"))
        a = np.arange(NDEV * 16, dtype=np.float32)
        g = global_put(a, sh)
        np.testing.assert_array_equal(np.asarray(g), a)
        assert len(g.sharding.device_set) == NDEV

    def test_make_array_callback_branch(self):
        # Drive the multi-process code path directly (the callback-based
        # constructor works single-process too and must produce the same
        # global array).
        import jax
        from jax.sharding import NamedSharding, PartitionSpec as P

        mesh = make_mesh(NDEV)
        sh = NamedSharding(mesh, P("d", None))
        a = np.random.default_rng(0).normal(size=(NDEV * 8, 16))
        g = jax.make_array_from_callback(a.shape, sh, lambda idx: a[idx])
        np.testing.assert_array_equal(np.asarray(g), a)
