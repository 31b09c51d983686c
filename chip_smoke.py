"""Smoke test of the solver on one NVIDIA GPU, through the user entry points.

    python chip_smoke.py               # phases 0-6 on one card
    python chip_smoke.py --four-cards  # only the 4-card mesh phase

Phases (each one raises on failure; nothing is caught and carried past):
  0. before JAX touches the card: print the card's name and power limit,
     rebuild native/ from source, solve data/model.mps through the CLI;
  1. device check: JAX's first device must be a GPU with a known peak;
  2. gather SpMV/SpMM of a 10.5M-nnz LP and the dense matvec/SpMM against
     host float64 references, each SpMV timed on the card;
  3. hp.solve of that LP at 1e-4, KKT certified on the host in f64;
  4. Model.solve of a transportation LP at 1e-8 (native f64 route),
     certified and checked against HiGHS;
  5. solve_batched of 256 LPs sharing one A, four certified by HiGHS;
  6. solve_mps("data/model.mps").
The last line of stdout is one JSON object {"ok": true, "device": {...}}.
Any failure exits non-zero before it is printed.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import scipy.sparse as sp

REPO = os.path.dirname(os.path.abspath(__file__))
DEMO_MPS = os.path.join(REPO, "data", "model.mps")
DEMO_OBJ = -26.4

# The 10.5M-nnz LP (benchmarks/run.py sparse_huge): 262144 x 524288,
# 40 nonzeros per row.
BIG_LP = dict(m=262144, n=524288, nnz_per_row=40, seed=4)

# Tolerances, each with its reason:
# - gather SpMV/SpMM in f32: one f32 rounding per product and per add of a
#   ~40-term row sum gives ~1e-7 relative; 1e-5 leaves margin and still
#   catches any wrong index or value.
# - gather SpMV/SpMM in f64: the same sums in f64 sit near 1e-16; 1e-12
#   proves the card ran native f64 and not a lower precision.
# - dense matvec/SpMM in f32 at HIGHEST: full f32 products of 8192-term
#   sums land near 1e-7; TF32 inputs (10-bit mantissa) would read ~1e-3,
#   so 1e-6 proves the precision request reached the card.
SPMV_RTOL = {"float32": 1e-5, "float64": 1e-12}
DENSE_RTOL = 1e-6
# - objectives of solves stopped at a 1e-4 relative KKT error agree with
#   the exact optimum to about that order; 1e-3 leaves a 10x margin.
OBJ_RTOL_1E4 = 1e-3
# - the 1e-8 solve is held to 1e-6 of HiGHS: its relative gap and
#   infeasibilities are below 1e-8, HiGHS's own tolerances near 1e-7.
OBJ_RTOL_1E8 = 1e-6


class SmokeFailure(AssertionError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def say(msg):
    print(msg, flush=True)


def require_gpu_device():
    """(device_kind, device count) of JAX's devices; exits with code 2
    (and prints no result) unless the first device is a GPU."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: JAX found no GPU (first device: "
              f"{dev.platform}, {dev.device_kind})", file=sys.stderr)
        sys.exit(2)
    return dev.device_kind, len(jax.devices())


def certify_kkt(problem, x, y, z, tol):
    """Relative KKT error of (x, y, z) in the original space, recomputed
    on the host in f64 (LpProblem.kkt_error, the reference's stopping
    measure).  Raises unless it is finite and below tol."""
    check(x is not None and y is not None and z is not None,
          "solve returned no solution vectors")
    kkt = problem.kkt_error(np.asarray(x, np.float64),
                            np.asarray(y, np.float64),
                            np.asarray(z, np.float64))["kkt"]
    check(np.isfinite(kkt) and kkt < tol,
          f"host-f64 KKT {kkt:.3e} not below {tol:.0e}")
    return kkt


def rel_err(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


def highs_objective(problem):
    """Optimal objective of an LpProblem by scipy's HiGHS."""
    from scipy.optimize import linprog

    A = problem.A.tocsr()
    eq = problem.AL == problem.AU
    up = ~eq & np.isfinite(problem.AU)
    lo = ~eq & np.isfinite(problem.AL)
    A_ub = sp.vstack([A[up], -A[lo]]).tocsr()
    b_ub = np.concatenate([problem.AU[up], -problem.AL[lo]])
    bounds = [(None if np.isinf(a) else a, None if np.isinf(b) else b)
              for a, b in zip(problem.l, problem.u)]
    r = linprog(problem.c,
                A_ub=A_ub if A_ub.shape[0] else None,
                b_ub=b_ub if A_ub.shape[0] else None,
                A_eq=A[eq] if eq.any() else None,
                b_eq=problem.AL[eq] if eq.any() else None,
                bounds=bounds, method="highs")
    check(r.status == 0, f"HiGHS failed: {r.message}")
    return float(r.fun) + problem.obj_constant


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------

def phase0_before_jax():
    from bench import card_name_and_power_limit

    say(card_name_and_power_limit())
    t0 = time.perf_counter()
    build = subprocess.run(["make", "-C", os.path.join(REPO, "native"),
                            "clean", "all"], capture_output=True, text=True)
    check(build.returncode == 0,
          f"native build failed:\n{build.stdout[-2000:]}"
          f"{build.stderr[-2000:]}")
    say(f"[phase 0] native/ rebuilt from source in "
        f"{time.perf_counter() - t0:.1f} s")

    from hprlp_tpu.cli import main as cli_main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(["-i", DEMO_MPS, "--quiet"])
    line = buf.getvalue().strip().splitlines()[-1]
    say(f"[phase 0] cli: {line}")
    check(rc == 0 and "status=OPTIMAL" in line, f"CLI failed (rc={rc})")
    obj = float(line.split("obj=")[1].split()[0])
    check(abs(obj - DEMO_OBJ) <= OBJ_RTOL_1E4 * abs(DEMO_OBJ),
          f"CLI objective {obj} != {DEMO_OBJ}")


def phase1_device():
    from bench import peak_hbm_bytes_per_s

    kind, count = require_gpu_device()
    peak = peak_hbm_bytes_per_s(kind)
    say(f"[phase 1] platform=gpu device_kind={kind!r} count={count} "
        f"peak={peak / 1e12:.2f} TB/s")
    return kind, count, peak


def big_lp():
    from benchmarks.run import random_lp

    return random_lp(BIG_LP["m"], BIG_LP["n"], BIG_LP["nnz_per_row"],
                     BIG_LP["seed"])


def _per_call_seconds(step, x0, reps=20, rounds=5):
    """Median over `rounds` of one jitted loop of `reps` data-dependent
    calls of step (x -> x), each round ended by block_until_ready."""
    import jax

    loop = jax.jit(lambda x: jax.lax.fori_loop(
        0, reps, lambda i, v: step(v), x))
    jax.block_until_ready(loop(x0))  # compile + warm
    times = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        jax.block_until_ready(loop(x0))
        times.append(time.perf_counter() - t0)
    return statistics.median(times) / reps


def phase2_spmv(problem, peak, sizes=None):
    """Gather SpMV/SpMM of `problem` and the dense matvec/SpMM against
    host f64; prints each SpMV's time and bandwidth shares."""
    import jax
    import jax.numpy as jnp

    from bench import gather_spmv_bytes
    from hprlp_tpu.ops.device_problem import build_device_problem
    from hprlp_tpu.ops.sparse import EllMatrix, spmm, spmv

    jax.config.update("jax_enable_x64", True)
    dense_m, dense_n, batch = sizes or (4096, 8192, 64)
    rng = np.random.default_rng(0)
    A = problem.A.tocsr()
    x = rng.normal(size=problem.n)
    y = rng.normal(size=problem.m)
    X = rng.normal(size=(problem.n, batch))
    ref_Ax, ref_ATy, ref_AX = A @ x, A.T @ y, A @ X

    # Device copy bandwidth in the same process: x -> x + 1 over 1 GiB
    # (one read and one write per element).
    n_copy = 1 << 28
    t_copy = _per_call_seconds(lambda v: v + 1.0,
                               jnp.zeros(n_copy, jnp.float32))
    copy_bw = 2 * 4 * n_copy / t_copy
    say(f"[phase 2] device copy: {copy_bw / 1e12:.3f} TB/s "
        f"({copy_bw / peak:.1%} of peak)")

    for dtype in (jnp.float32, jnp.float64):
        name = jnp.dtype(dtype).name
        lp, maps = build_device_problem(problem, dtype=dtype)
        xp = np.zeros(lp.n)
        xp[maps.col_pos] = x
        yp = np.zeros(lp.m)
        yp[maps.row_pos] = y
        Xp = np.zeros((lp.n, batch))
        Xp[maps.col_pos] = X
        xd, yd = jnp.asarray(xp, dtype), jnp.asarray(yp, dtype)
        checks = (
            ("spmv(A)", spmv(lp.A, xd)[maps.row_pos], ref_Ax),
            ("spmv(AT)", spmv(lp.AT, yd)[maps.col_pos], ref_ATy),
            (f"spmm(A, B={batch})",
             spmm(lp.A, jnp.asarray(Xp, dtype))[maps.row_pos], ref_AX),
        )
        for label, got, ref in checks:
            err = rel_err(np.asarray(got), ref)
            say(f"[phase 2] {name} {label}: rel L2 err {err:.2e} "
                f"(limit {SPMV_RTOL[name]:.0e})")
            check(err <= SPMV_RTOL[name], f"{name} {label} err {err:.2e}")
        itemsize = jnp.dtype(dtype).itemsize
        for label, M, v in (("spmv(A)", lp.A, xd), ("spmv(AT)", lp.AT, yd)):
            # Feed the sum of the whole output back into the next input,
            # so the loop can neither hoist the product nor trim it.
            t = _per_call_seconds(
                lambda u, M=M, v=v: u + 1e-30 * jnp.sum(spmv(M, v * u[0])),
                jnp.ones(1, dtype))
            bw = gather_spmv_bytes(M, itemsize) / t
            say(f"[phase 2] {name} {label} (nnz={problem.nnz}): "
                f"{t * 1e6:.1f} us, {bw / 1e12:.3f} TB/s = "
                f"{bw / peak:.1%} of peak, {bw / copy_bw:.1%} of copy")
        del lp, xd, yd

    D = rng.normal(size=(dense_m, dense_n)).astype(np.float32)
    Dd = EllMatrix(buckets=(), nrows=dense_m, ncols=dense_n,
                   backend="dense", dense=jnp.asarray(D))
    v = rng.normal(size=dense_n).astype(np.float32)
    V = rng.normal(size=(dense_n, batch)).astype(np.float32)
    D64 = D.astype(np.float64)
    for label, got, ref in (
            ("dense matvec", spmv(Dd, jnp.asarray(v)), D64 @ v),
            (f"dense SpMM B={batch}", spmm(Dd, jnp.asarray(V)), D64 @ V)):
        err = rel_err(np.asarray(got), ref)
        say(f"[phase 2] f32 {label} {dense_m}x{dense_n}: rel L2 err "
            f"{err:.2e} (limit {DENSE_RTOL:.0e})")
        check(err <= DENSE_RTOL, f"{label} err {err:.2e} (TF32?)")


def phase3_solve(problem, tol=1e-4):
    import jax

    import hprlp_tpu as hp

    t0 = time.perf_counter()
    res = hp.solve(problem.A, problem.AL, problem.AU, problem.l, problem.u,
                   problem.c, hp.Parameters(verbose=False, stop_tol=tol))
    wall = time.perf_counter() - t0
    stats = jax.devices()[0].memory_stats() or {}
    say(f"[phase 3] hp.solve m={problem.m} n={problem.n} "
        f"nnz={problem.nnz}: status={res.status} iter={res.iter} "
        f"backend={res.spmv_backend} presolve={res.presolve_time:.2f}s "
        f"setup={res.setup_time:.2f}s scaling={res.scaling_time:.2f}s "
        f"autotune={res.autotune_time:.2f}s power={res.power_time:.2f}s "
        f"solve={res.time:.2f}s wall={wall:.2f}s "
        f"peak_bytes_in_use={stats.get('peak_bytes_in_use')} "
        f"loop_compiles={res.loop_compiles}")
    check(res.status == "OPTIMAL", f"status {res.status}")
    kkt = certify_kkt(problem, res.x, res.y, res.z, tol)
    say(f"[phase 3] host-f64 KKT {kkt:.3e} < {tol:.0e}")
    check(res.loop_compiles == 0,
          f"{res.loop_compiles} compiles inside the iteration loop")
    return res


def phase4_f64(problem, tol=1e-8):
    import hprlp_tpu as hp

    res = hp.Model(problem).solve(hp.Parameters(verbose=False,
                                                stop_tol=tol))
    say(f"[phase 4] {problem.name} m={problem.m} n={problem.n} at {tol:.0e}"
        f": status={res.status} iter={res.iter} solve={res.time:.2f}s")
    check(res.status == "OPTIMAL", f"status {res.status}")
    kkt = certify_kkt(problem, res.x, res.y, res.z, tol)
    ref = highs_objective(problem)
    err = abs(res.primal_obj - ref) / max(1.0, abs(ref))
    say(f"[phase 4] host-f64 KKT {kkt:.3e}; objective {res.primal_obj:.12e}"
        f" vs HiGHS {ref:.12e} (rel {err:.1e}, limit {OBJ_RTOL_1E8:.0e})")
    check(err <= OBJ_RTOL_1E8, f"objective off HiGHS by {err:.2e}")


def phase5_batched(size=(128, 256, 256, 3), tol=1e-4, members=4):
    import hprlp_tpu as hp
    from benchmarks.run import batched_problem
    from hprlp_tpu.problem import LpProblem

    A, C, AL, AU, l, u = batched_problem(*size)
    out = hp.solve_batched(A, C, AL, AU, l, u,
                           params=hp.Parameters(verbose=False,
                                                stop_tol=tol))
    B = C.shape[1]
    n_opt = sum(s == "OPTIMAL" for s in out.status)
    say(f"[phase 5] solve_batched B={B}: {n_opt}/{B} OPTIMAL, max iter "
        f"{int(np.max(out.iter))}, solve={out.solve_time:.2f}s")
    check(n_opt == B, f"only {n_opt}/{B} members OPTIMAL")
    for j in np.linspace(0, B - 1, members).astype(int):
        prob = LpProblem.from_arrays(A, AL[:, j], AU[:, j], l[:, j],
                                     u[:, j], C[:, j])
        ref = highs_objective(prob)
        err = abs(out.primal_obj[j] - ref) / max(1.0, abs(ref))
        say(f"[phase 5] member {j}: objective {out.primal_obj[j]:.8e} vs "
            f"HiGHS {ref:.8e} (rel {err:.1e}, limit {OBJ_RTOL_1E4:.0e})")
        check(err <= OBJ_RTOL_1E4, f"member {j} off HiGHS by {err:.2e}")


def phase6_mps():
    import hprlp_tpu as hp

    res = hp.solve_mps(DEMO_MPS, hp.Parameters(verbose=False))
    say(f"[phase 6] solve_mps(data/model.mps): status={res.status} "
        f"obj={res.primal_obj:.8f}")
    check(res.status == "OPTIMAL", f"status {res.status}")
    check(abs(res.primal_obj - DEMO_OBJ) <= OBJ_RTOL_1E4 * abs(DEMO_OBJ),
          f"objective {res.primal_obj}")


def four_card_phase(problem, n_dev=4, tol=1e-4):
    """The mesh path on n_dev cards against card 0 alone, one process."""
    import jax
    import jax.numpy as jnp

    import hprlp_tpu as hp
    from hprlp_tpu.ops.device_problem import build_device_problem
    from hprlp_tpu.parallel.sharded import make_mesh, shard_problem

    check(len(jax.devices()) >= n_dev,
          f"{len(jax.devices())} devices, need {n_dev}")
    # The layout solve_problem builds for mesh_shape=n_dev: every bucket
    # of A and A^T must span n_dev distinct devices.
    lp, _ = build_device_problem(problem, dtype=jnp.float32,
                                 row_multiple=8 * n_dev,
                                 vec_multiple=256 * n_dev)
    lp = shard_problem(lp, make_mesh(n_dev))
    for M in (lp.A, lp.AT):
        for b in M.buckets:
            devs = b.vals.sharding.device_set
            check(len(devs) == n_dev,
                  f"bucket on {len(devs)} devices, expected {n_dev}")
    say(f"[mesh] A and AT buckets each span {n_dev} distinct devices")
    del lp

    objs = {}
    for label, mesh in ((f"mesh_shape={n_dev}", n_dev), ("card 0", None)):
        t0 = time.perf_counter()
        res = hp.Model(problem).solve(hp.Parameters(
            verbose=False, stop_tol=tol, mesh_shape=mesh))
        kkt = certify_kkt(problem, res.x, res.y, res.z, tol) \
            if res.status == "OPTIMAL" else float("nan")
        say(f"[mesh] {label}: status={res.status} iter={res.iter} "
            f"solve={res.time:.2f}s wall={time.perf_counter() - t0:.2f}s "
            f"host-f64 KKT {kkt:.3e} obj={res.primal_obj:.10e}")
        check(res.status == "OPTIMAL", f"{label}: status {res.status}")
        objs[label] = res.primal_obj
    a, b = objs.values()
    err = abs(a - b) / max(1.0, abs(b))
    say(f"[mesh] objectives agree to {err:.1e} (limit {tol:.0e})")
    check(err <= tol, f"mesh vs single-card objective off by {err:.2e}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-card mesh phase")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()

    if args.four_cards:
        from bench import card_name_and_power_limit

        say(card_name_and_power_limit())
        kind, count = require_gpu_device()
        four_card_phase(big_lp())
    else:
        phase0_before_jax()
        kind, count, peak = phase1_device()
        problem = big_lp()
        phase2_spmv(problem, peak)
        phase3_solve(problem)
        del problem
        from benchmarks.run import transportation_lp

        phase4_f64(transportation_lp(256, 384, 7))
        phase5_batched()
        phase6_mps()
    say(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": kind,
                                             "count": count}}), flush=True)


if __name__ == "__main__":
    main()
