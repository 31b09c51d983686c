"""Benchmark suite runner.

Runs the benchmark configurations that are reproducible without external
datasets (no network) and writes one JSON report
with the reference's milestone metric schema (status, iter, time,
iter4/6/8, time4/6/8 — reference: include/structs.h:44-65).

Usage:
    python benchmarks/run.py [--quick] [--out report.json]

Runs on one GPU and exits non-zero on any other platform.  Each config
runs in a child process of its own; the parent never touches JAX, so only
one process at a time holds the card.

Configs:
  demo            data/model.mps, default settings
  assignment      n x n assignment LP relaxation (structured, sparse)
  box_qp_like     random box-constrained LP with interior (dense-ish)
  sparse_large    random sparse LP in the HBM-resident regime
  batched_256     256 scenario LPs sharing one A (per-member restart/sigma)
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import scipy.sparse as sp

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir))

from hprlp_tpu import Model, Parameters, solve_batched  # noqa: E402
from hprlp_tpu.problem import LpProblem  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))


def demo_problem():
    return Model.from_mps(os.path.join(HERE, os.pardir, "data",
                                       "model.mps")).problem


def assignment_problem(n=64, seed=0):
    """LP relaxation of an n x n assignment problem: doubly stochastic
    polytope; optimum = min-cost matching value."""
    rng = np.random.default_rng(seed)
    cost = rng.uniform(0.0, 1.0, (n, n))
    rows, cols, vals = [], [], []
    for i in range(n):          # row-sum constraints
        for j in range(n):
            rows.append(i)
            cols.append(i * n + j)
            vals.append(1.0)
    for j in range(n):          # col-sum constraints
        for i in range(n):
            rows.append(n + j)
            cols.append(i * n + j)
            vals.append(1.0)
    A = sp.coo_matrix((vals, (rows, cols)), shape=(2 * n, n * n)).tocsr()
    ones = np.ones(2 * n)
    return LpProblem.from_arrays(A, ones, ones, np.zeros(n * n),
                                 np.ones(n * n), cost.ravel(),
                                 name=f"assignment{n}")


def random_lp(m, n, nnz_per_row, seed=0, name=""):
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(m), nnz_per_row)
    cols = rng.integers(0, n, size=m * nnz_per_row)
    vals = rng.normal(size=m * nnz_per_row)
    A = sp.coo_matrix((vals, (rows, cols)), shape=(m, n)).tocsr()
    A.sum_duplicates()
    x_feas = rng.uniform(-1.0, 1.0, n)
    Ax = A @ x_feas
    return LpProblem.from_arrays(A, Ax - 1.0, Ax + 1.0, x_feas - 2.0,
                                 x_feas + 2.0, rng.normal(size=n),
                                 name=name or f"random{m}x{n}")


def banded_lp(m, n, nnz_per_row, halfwidth, seed=0, name=""):
    """Random LP with BANDED structure: row i's columns lie within
    +-halfwidth of its diagonal position.  Giant real-world LPs
    (network/staircase models) have this kind of locality, which keeps
    the SpMV's x gathers close together."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(m), nnz_per_row)
    center = (rows * (n / m)).astype(np.int64)
    cols = (center + rng.integers(-halfwidth, halfwidth + 1,
                                  size=m * nnz_per_row)) % n
    vals = rng.normal(size=m * nnz_per_row)
    A = sp.coo_matrix((vals, (rows, cols)), shape=(m, n)).tocsr()
    A.sum_duplicates()
    x_feas = rng.uniform(-1.0, 1.0, n)
    Ax = A @ x_feas
    return LpProblem.from_arrays(A, Ax - 1.0, Ax + 1.0, x_feas - 2.0,
                                 x_feas + 2.0, rng.normal(size=n),
                                 name=name or f"banded{m}x{n}")


def transportation_lp(ns, nd, seed=0, name=""):
    """Balanced transportation LP (Netlib family stand-in): equality
    supply/demand rows, x >= 0.  Optimum verifiable with scipy at small
    sizes (tests/test_structured.py); at benchmark scale the interest is
    the bipartite incidence structure (2 nnz/col, dense rows)."""
    rng = np.random.default_rng(seed)
    supply = rng.uniform(1.0, 3.0, ns)
    demand = rng.uniform(1.0, 3.0, nd)
    demand *= supply.sum() / demand.sum()
    k = np.arange(ns * nd)
    rows = np.concatenate([k // nd, ns + (k % nd)])
    cols = np.concatenate([k, k])
    A = sp.coo_matrix((np.ones(2 * ns * nd), (rows, cols)),
                      shape=(ns + nd, ns * nd)).tocsr()
    b = np.concatenate([supply, demand])
    return LpProblem.from_arrays(
        A, b, b, np.zeros(ns * nd), np.full(ns * nd, np.inf),
        rng.uniform(1.0, 10.0, ns * nd), name=name or f"transport{ns}x{nd}")


def staircase_lp(T, nx, seed=0, name=""):
    """Multiperiod production staircase (Mittelmann multiperiod family
    stand-in): period-coupled rows, block-banded A."""
    rng = np.random.default_rng(seed)
    n = T * nx
    demand = rng.uniform(0.5, 1.5, T) * nx / 4
    t_of = np.repeat(np.arange(T), nx)
    rows = np.concatenate([t_of, (t_of + 1)[t_of + 1 < T]])
    cols = np.concatenate([np.arange(n), np.arange(n)[t_of + 1 < T]])
    vals = np.concatenate([np.ones(n), np.full((t_of + 1 < T).sum(), 0.3)])
    A = sp.coo_matrix((vals, (rows, cols)), shape=(T, n)).tocsr()
    return LpProblem.from_arrays(
        A, demand, np.full(T, np.inf), np.zeros(n), np.full(n, 10.0),
        rng.uniform(1.0, 2.0, n), name=name or f"staircase{T}x{nx}")


def multicommodity_lp(side, K, seed=0, name=""):
    """K-commodity min-cost flow on a side x side directed grid (right +
    down arcs): per-commodity flow-conservation equalities + shared arc
    capacity rows — the classic degenerate-network family the random box
    LPs don't exercise."""
    rng = np.random.default_rng(seed)
    V = side * side
    r, c = np.divmod(np.arange(V), side)
    # Arcs: right (c < side-1) and down (r < side-1).
    right_tail = np.nonzero(c < side - 1)[0]
    down_tail = np.nonzero(r < side - 1)[0]
    tails = np.concatenate([right_tail, down_tail])
    heads = np.concatenate([right_tail + 1, down_tail + side])
    nA = len(tails)

    # Node-arc incidence (+1 leaves tail, -1 enters head).
    a_idx = np.arange(nA)
    inc_rows = np.concatenate([tails, heads])
    inc_cols = np.concatenate([a_idx, a_idx])
    inc_vals = np.concatenate([np.ones(nA), -np.ones(nA)])

    # Per-commodity: source up-left of sink so a right/down path exists.
    d_k = rng.uniform(0.5, 2.0, K)
    src_r = rng.integers(0, side // 2, K)
    src_c = rng.integers(0, side // 2, K)
    dst_r = rng.integers(side // 2, side, K)
    dst_c = rng.integers(side // 2, side, K)
    src = src_r * side + src_c
    dst = dst_r * side + dst_c

    rows, cols, vals = [], [], []
    AL, AU = [], []
    for k in range(K):
        rows.append(k * V + inc_rows)
        cols.append(k * nA + inc_cols)
        vals.append(inc_vals)
        b = np.zeros(V)
        b[src[k]] = d_k[k]
        b[dst[k]] = -d_k[k]
        AL.append(b)
        AU.append(b)
    # Shared capacities: sum_k x_a <= cap (generous => feasible).
    cap_rows = K * V + np.tile(a_idx, K)
    rows.append(cap_rows)
    cols.append(np.arange(K * nA))
    vals.append(np.ones(K * nA))
    AL.append(np.full(nA, -np.inf))
    AU.append(np.full(nA, float(d_k.sum())))

    A = sp.coo_matrix(
        (np.concatenate(vals),
         (np.concatenate(rows), np.concatenate(cols))),
        shape=(K * V + nA, K * nA)).tocsr()
    cost = np.tile(rng.uniform(1.0, 5.0, nA), K)
    n = K * nA
    return LpProblem.from_arrays(
        A, np.concatenate(AL), np.concatenate(AU), np.zeros(n),
        np.full(n, np.inf), cost, name=name or f"multicom{side}x{K}")


def run_single(problem, tol, time_limit, max_iter=500_000,
               precision="auto"):
    p = Parameters(verbose=False, stop_tol=tol, time_limit=time_limit,
                   max_iter=max_iter, precision=precision)
    t0 = time.perf_counter()
    res = Model(problem).solve(p)
    wall = time.perf_counter() - t0
    # Per-config bandwidth accounting: iterations/s, the IDEAL (padding-
    # free) bytes per iteration at our dtype, and their share of the
    # card's peak bandwidth — a conservative lower bound of the true
    # share; bench.py counts the actual bucket bytes.
    from bench import model_bytes_per_iter, peak_hbm_bytes_per_s

    import jax

    kind = jax.devices()[0].device_kind
    its_per_sec = res.iter / res.time if res.time > 0 else 0.0
    itemsize = 8 if (precision == "f64"
                     or (precision in ("auto", "mixed")
                         and tol < 1e-5)) else 4
    bpi = model_bytes_per_iter(problem.nnz, problem.m, problem.n,
                               itemsize)
    return {
        "host_cpus": os.cpu_count(),
        "m": problem.m, "n": problem.n, "nnz": problem.nnz,
        "status": res.status, "iter": res.iter, "solve_time": res.time,
        "wall_time": wall, "primal_obj": res.primal_obj,
        "kkt": res.residuals,
        "setup_time": res.setup_time, "scaling_time": res.scaling_time,
        "power_time": res.power_time, "autotune_time": res.autotune_time,
        "presolve_time": res.presolve_time,
        "restarts": res.restarts, "stall_recoveries": res.stall_recoveries,
        "spmv_backend": res.spmv_backend,
        "iter4": res.iter4, "time4": res.time4,
        "iter6": res.iter6, "time6": res.time6,
        "iter8": res.iter8, "time8": res.time8,
        "its_per_sec": its_per_sec,
        "bytes_per_iter_model": bpi,
        "share_of_peak_bandwidth_model":
            bpi * its_per_sec / peak_hbm_bytes_per_s(kind),
    }


def batched_problem(m, n, B, seed):
    """(A, C, AL, AU, l, u) of B random box LPs sharing one sparse A."""
    rng = np.random.default_rng(seed)
    A = sp.random(m, n, density=min(0.3, 20.0 / n), random_state=rng,
                  data_rvs=lambda k: rng.normal(size=k)).tocsr()
    x0 = rng.uniform(-1, 1, size=(n, B))
    Ax = A @ x0
    return (A, rng.normal(size=(n, B)), Ax - 1.0, Ax + 1.0, x0 - 2.0,
            x0 + 2.0)


def run_batched(m, n, B, seed, tol, time_limit):
    t0 = time.perf_counter()
    out = solve_batched(*batched_problem(m, n, B, seed),
                        params=Parameters(verbose=False, stop_tol=tol,
                                          time_limit=time_limit))
    wall = time.perf_counter() - t0
    st = list(out.status)
    # Full phase breakdown (reference batched results carry time/setup/
    # solve/power, include/structs.h:86-89).
    return {
        "m": m, "n": n, "batch": B,
        "optimal": sum(s == "OPTIMAL" for s in st),
        "statuses": sorted(set(st)),
        "max_iter": int(np.max(out.iter)),
        "mean_iter": float(np.mean(out.iter)),
        "time": out.time, "setup_time": out.setup_time,
        "power_time": out.power_time,
        "solve_time": out.solve_time, "wall_time": wall,
        "max_kkt": float(np.max(out.residuals)),
        "mean_kkt": float(np.mean(out.residuals)),
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="small sizes, 1e-4 only")
    ap.add_argument("--huge", action="store_true",
                    help="add the 10M-nnz HBM-scale config (slow setup)")
    ap.add_argument("--giant", action="store_true",
                    help="add the 100M+-nnz single-card configs "
                         "(minutes of setup)")
    ap.add_argument("--out", default=os.path.join(HERE, "report.json"))
    ap.add_argument("--time-limit", type=float, default=600.0)
    ap.add_argument("--only", default="",
                    help="run only configs whose name contains this "
                         "substring (still requires the gating flag, "
                         "e.g. --giant --only giant)")
    ap.add_argument("--no-isolate", action="store_true",
                    help="run every config in THIS process instead of "
                         "one subprocess per config (isolation keeps a "
                         "crash in one config from losing the others; "
                         "the on-disk compile cache keeps per-config "
                         "startup cheap)")
    args = ap.parse_args()

    if args.giant or args.huge:
        # Benchmark entry point owns the process: allocator tuning is
        # justified here (explicit opt-in; see hprlp_tpu/_malloc.py).
        from hprlp_tpu._malloc import tune_malloc

        tune_malloc(thp=True)

    tl = args.time_limit
    report = {"timestamp": time.time(), "configs": {}}
    isolate = not args.no_isolate and not os.environ.get(
        "HPRLP_RUN_CHILD")
    if not isolate:
        # This process runs the configs: it must own a GPU, and its
        # report names the card.
        from bench import card_name_and_power_limit, require_gpu

        kind, count = require_gpu()
        report["device"] = {"platform": "gpu", "kind": kind,
                            "count": count,
                            "name_power_limit": card_name_and_power_limit()}

    def run_in_subprocess(name):
        """Re-invoke this script for exactly `name` and merge its
        report (config-level crash isolation; see --no-isolate)."""
        import subprocess
        import tempfile

        with tempfile.NamedTemporaryFile(suffix=".json",
                                         delete=False) as f:
            tmp = f.name
        cmd = [sys.executable, os.path.abspath(__file__),
               "--only", name, "--out", tmp,
               "--time-limit", str(args.time_limit)]
        for flag in ("quick", "huge", "giant"):
            if getattr(args, flag):
                cmd.append(f"--{flag}")
        env = dict(os.environ, HPRLP_RUN_CHILD="1")
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, env=env)
        try:
            with open(tmp) as f:
                child_report = json.load(f)
            child = child_report["configs"]
        except Exception:
            child_report, child = {}, {}
        finally:
            try:
                os.unlink(tmp)
            except OSError:
                pass
        if name in child:
            report["configs"][name] = child[name]
            report.setdefault("device", child_report.get("device"))
        else:
            report["configs"][name] = {
                "error": f"subprocess exited rc={proc.returncode} "
                         f"without a result",
                "config_wall": time.perf_counter() - t0,
            }
            print(f"[{name}] {json.dumps(report['configs'][name])}")

    def record(name, fn):
        if args.only and args.only not in name:
            return
        if isolate:
            run_in_subprocess(name)
            return
        t0 = time.perf_counter()
        try:
            out = fn()
        except Exception as e:  # keep the suite running
            out = {"error": f"{type(e).__name__}: {e}"}
        out["config_wall"] = time.perf_counter() - t0
        report["configs"][name] = out
        print(f"[{name}] {json.dumps(out, default=float)[:200]}")

    record("demo_1e-4", lambda: run_single(demo_problem(), 1e-4, tl))
    record("assignment64_1e-4",
           lambda: run_single(assignment_problem(64), 1e-4, tl))
    if not args.quick:
        record("assignment64_1e-8_f64",
               lambda: run_single(assignment_problem(64), 1e-8, tl,
                                  precision="f64"))
        record("assignment64_1e-8_mixed",
               lambda: run_single(assignment_problem(64), 1e-8, tl,
                                  precision="mixed"))
        # Structured mid-size 1e-8 (m=256, n=16384).  NOT the random box
        # LP: random_lp instances plateau at ~1e-6..1e-7 KKT for HPR-class
        # methods regardless of precision.
        record("assignment128_1e-8_mixed",
               lambda: run_single(assignment_problem(128), 1e-8, tl,
                                  precision="mixed"))
        # Structured families (Netlib/Mittelmann family stand-ins) at
        # 1e-4 AND 1e-8.
        record("transport_1e-4",
               lambda: run_single(transportation_lp(256, 384, 7), 1e-4, tl))
        record("transport_1e-8",
               lambda: run_single(transportation_lp(256, 384, 7), 1e-8, tl))
        record("staircase_1e-4",
               lambda: run_single(staircase_lp(512, 64, 8), 1e-4, tl))
        record("staircase_1e-8",
               lambda: run_single(staircase_lp(512, 64, 8), 1e-8, tl))
        record("multicommodity_1e-4",
               lambda: run_single(multicommodity_lp(32, 8, 9), 1e-4, tl))
        record("multicommodity_1e-8",
               lambda: run_single(multicommodity_lp(32, 8, 9), 1e-8, tl))
        record("random_mid_1e-4",
               lambda: run_single(random_lp(8192, 16384, 20, 1), 1e-4, tl))
        record("sparse_large_1e-4",
               lambda: run_single(random_lp(65536, 131072, 20, 2), 1e-4, tl))
        record("batched_256",
               lambda: run_batched(128, 256, 256, 3, 1e-4, tl))
        if args.huge:
            # Mittelmann-class nnz stand-in: exercises presolve, the
            # ingest and the gather SpMV at the 10M-nnz regime.
            record("sparse_huge_1e-4",
                   lambda: run_single(random_lp(262144, 524288, 40, 4),
                                      1e-4, tl))
        if args.giant:
            # >100M-nnz giant LPs on ONE card (the reference's own
            # ceiling is one GPU's memory with int32 nnz,
            # include/structs.h:17-19).
            record("banded_giant_1e-4",
                   lambda: run_single(
                       banded_lp(1572864, 3145728, 72, 16384, 5),
                       1e-4, tl))
            record("uniform_giant_1e-4",
                   lambda: run_single(
                       random_lp(786432, 1572864, 128, 6),
                       1e-4, tl))
    else:
        record("batched_64",
               lambda: run_batched(64, 96, 64, 3, 1e-4, tl))

    with open(args.out, "w") as f:
        json.dump(report, f, indent=2, default=float)
    print(f"report written to {args.out}")


if __name__ == "__main__":
    main()
