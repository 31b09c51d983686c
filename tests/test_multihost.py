"""REAL multi-process (multi-host-shaped) validation: two OS processes
joined via jax.distributed, each owning 2 virtual CPU devices, solving
the same LP over the 4-device global mesh (parallel/distributed.py +
shard_problem).  This exercises exactly the code path a multi-host GPU
cluster uses — process-spanning mesh, make_array_from_callback shard
materialisation, cross-process collectives — on CPU transport."""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = r"""
import json, sys
import numpy as np

coordinator, pid, n_proc = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])

import hprlp_tpu.parallel.distributed as dist
dist.initialize(coordinator_address=coordinator, num_processes=n_proc,
                process_id=pid)   # sets gloo CPU collectives itself

import jax
assert jax.process_count() == n_proc, jax.process_count()
assert len(jax.devices()) == 2 * n_proc, len(jax.devices())

import scipy.sparse as sp
from hprlp_tpu.problem import LpProblem
from hprlp_tpu.params import Parameters
from hprlp_tpu.solver.loop import solve_problem

rng = np.random.default_rng(17)
m, n = 48, 64
A = sp.random(m, n, density=0.25, random_state=rng,
              data_rvs=lambda k: rng.normal(size=k)).tocsr()
x0 = rng.uniform(-1, 1, n)
Ax = A @ x0
prob = LpProblem.from_arrays(A, Ax - 1, Ax + 1, x0 - 2, x0 + 2,
                             rng.normal(size=n))
res = solve_problem(prob, Parameters(verbose=False, stop_tol=1e-6,
                                     use_presolve=False,
                                     mesh_shape=2 * n_proc,
                                     precision="f64"))
print("RESULT " + json.dumps({"pid": pid, "status": res.status,
                              "obj": res.primal_obj,
                              "iter": res.iter}), flush=True)
"""


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.skipif(os.environ.get("HPRLP_SKIP_MULTIHOST") == "1",
                    reason="multihost test disabled")
@pytest.mark.parametrize("n_proc", [2, 4])
def test_multi_process_distributed_solve(tmp_path, n_proc):
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    port = _free_port()
    coord = f"localhost:{port}"
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    env.pop("JAX_NUM_PROCESSES", None)

    procs = [subprocess.Popen(
        [sys.executable, str(script), coord, str(i), str(n_proc)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for i in range(n_proc)]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=420)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("multi-process solve timed out")
        assert p.returncode == 0, err[-2000:]
        outs.append(out)

    results = []
    for out in outs:
        lines = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
        assert lines, out[-2000:]
        results.append(json.loads(lines[-1][len("RESULT "):]))

    assert all(r["status"] == "OPTIMAL" for r in results), results
    # Every process runs the same SPMD program: identical results.
    for r in results[1:]:
        assert r["obj"] == pytest.approx(results[0]["obj"], rel=1e-9)
        assert r["iter"] == results[0]["iter"]

    # And the multi-process objective matches a plain single-process solve.
    import scipy.sparse as sp

    from hprlp_tpu.params import Parameters
    from hprlp_tpu.problem import LpProblem
    from hprlp_tpu.solver.loop import solve_problem

    rng = np.random.default_rng(17)
    m, n = 48, 64
    A = sp.random(m, n, density=0.25, random_state=rng,
                  data_rvs=lambda k: rng.normal(size=k)).tocsr()
    x0 = rng.uniform(-1, 1, n)
    Ax = A @ x0
    prob = LpProblem.from_arrays(A, Ax - 1, Ax + 1, x0 - 2, x0 + 2,
                                 rng.normal(size=n))
    ref = solve_problem(prob, Parameters(verbose=False, stop_tol=1e-6,
                                         use_presolve=False,
                                         precision="f64"))
    assert results[0]["obj"] == pytest.approx(ref.primal_obj, rel=1e-4,
                                              abs=1e-4)
