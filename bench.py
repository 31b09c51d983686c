"""Benchmark: steady-state HPR-LP iterations/second on one GPU.

Usage: python bench.py   (exits non-zero unless JAX's first device is a GPU)

The workload is a fixed synthetic LP (seeded, ~20 nnz/row) solved through
the production path: standard ingest (ops/device_problem) -> device
scaling -> gather-ELL backend -> power method -> the device-resident
superchunk (N_CHUNKS jitted 150-iteration chunks with on-device
restart/sigma and stopping per dispatch), i.e. what a quiet solve()
executes in its loop (reference hot loop parity: src/HPRLP.cu:178-310;
solver/loop.py).  Timing ends each superchunk in block_until_ready, so
the per-iteration time includes the host dispatch amortised over
N_CHUNKS * CHUNK_ITERS iterations, like a real solve.

Prints one JSON line naming the device (platform, device_kind, count) and
the card's power limit, with the iteration rate, the bytes each iteration
moves (from the gather buckets' shapes) and their share of the card's
peak bandwidth.  vs_reference_peak compares against the reference's hot
loop (two f64 CSR SpMVs + the fused updates' vector traffic) at the same
card's PEAK bandwidth — an upper bound of what the reference could reach
here, not a measurement of it.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import scipy.sparse as sp

M = int(os.environ.get("HPRLP_BENCH_M", 65536))
N = int(os.environ.get("HPRLP_BENCH_N", 131072))
NNZ_PER_ROW, SEED = 20, 0
CHUNK_ITERS = 150
N_CHUNKS = int(os.environ.get("HPRLP_BENCH_CHUNKS", 128))
REPEATS = 3

# Peak device-memory bandwidth in bytes/s, keyed by jax device_kind.
# Source: NVIDIA H100 Tensor Core GPU data sheet (H100 SXM 3.35 TB/s,
# H100 PCIe 2.0 TB/s, H100 NVL 3.9 TB/s).  A kind not listed is an error:
# no peak is assumed for an unknown device.
PEAK_HBM_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
    "NVIDIA H100 PCIe": 2.0e12,
    "NVIDIA H100 NVL": 3.9e12,
}


def peak_hbm_bytes_per_s(device_kind: str) -> float:
    if device_kind not in PEAK_HBM_BYTES_PER_S:
        raise KeyError(f"no peak bandwidth on record for device kind "
                       f"{device_kind!r}; add it to PEAK_HBM_BYTES_PER_S "
                       f"with its source")
    return PEAK_HBM_BYTES_PER_S[device_kind]


def card_name_and_power_limit() -> str:
    """`name, power.limit` of the cards as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip()


def require_gpu():
    """(device_kind, device count); exits non-zero on any platform other
    than a GPU, so no CPU number is ever reported as a device number."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"no GPU: JAX's first device is {dev.platform!r} "
              f"({dev.device_kind})", file=sys.stderr)
        sys.exit(2)
    return dev.device_kind, len(jax.devices())


def gather_spmv_bytes(A, itemsize: int) -> int:
    """Bytes one gather-backend SpMV of A moves, from the bucket shapes
    (padding included): per slot its value, i32 column index and the
    gathered x entry; per row the y write."""
    b = 0
    for bk in A.buckets:
        R, W = bk.vals.shape
        b += R * W * (2 * itemsize + 4) + R * itemsize
    return b


def vector_bytes_per_iter(m: int, n: int, itemsize: int) -> int:
    """Elementwise halves of one iteration (solver/chunk.py): reads {x,
    ATy, c, l, u, last_x} + writes {x, x_hat} = 8 n-vectors; reads {y,
    Ax, AL, AU, last_y} + writes {y, y_hat} = 7 m-vectors."""
    return (8 * n + 7 * m) * itemsize


def model_bytes_per_iter(nnz: int, m: int, n: int, itemsize: int) -> int:
    """IDEAL (padding-free) per-iteration traffic of the hot loop at the
    given element size: two CSR-like SpMVs (value + i32 col index +
    gathered x per nonzero, one y write and row pointer per row) and the
    elementwise halves' vector traffic.  At itemsize 8 this is the
    reference hot loop's traffic (HPR_cuda_kernels.cu:297-427)."""
    spmv = 2 * (nnz * (2 * itemsize + 4) + (m + n) * itemsize)
    return spmv + vector_bytes_per_iter(m, n, itemsize)


def make_problem():
    from hprlp_tpu.problem import LpProblem

    rng = np.random.default_rng(SEED)
    rows = np.repeat(np.arange(M), NNZ_PER_ROW)
    cols = rng.integers(0, N, size=M * NNZ_PER_ROW)
    vals = rng.normal(size=M * NNZ_PER_ROW)
    A = sp.coo_matrix((vals, (rows, cols)), shape=(M, N)).tocsr()
    A.sum_duplicates()
    x_feas = rng.uniform(-1.0, 1.0, N)
    Ax = A @ x_feas
    return LpProblem.from_arrays(
        A, Ax - 1.0, Ax + 1.0, x_feas - 2.0, x_feas + 2.0,
        rng.normal(size=N))


def main():
    kind, count = require_gpu()
    power = card_name_and_power_limit()
    peak = peak_hbm_bytes_per_s(kind)

    import jax
    import jax.numpy as jnp

    from hprlp_tpu.ops.device_problem import build_device_problem
    from hprlp_tpu.solver.chunk import init_state, initial_metrics
    from hprlp_tpu.solver.device_loop import init_restart_dev, run_superchunk
    from hprlp_tpu.solver.power_iteration import power_method
    from hprlp_tpu.solver.scaling import scale_problem

    t_start = time.perf_counter()

    def phase(name, t0):
        print(f"[bench] {name}: {time.perf_counter() - t0:.1f} s "
              f"(t+{time.perf_counter() - t_start:.1f})", file=sys.stderr,
              flush=True)

    t0 = time.perf_counter()
    problem = make_problem()
    lp_raw, _maps = build_device_problem(problem)
    lp, scal = scale_problem(lp_raw)
    del lp_raw
    jax.block_until_ready(lp.c)
    phase("ingest+scaling", t0)

    dtype = lp.c.dtype
    t0 = time.perf_counter()
    lam = jnp.asarray(max(float(power_method(lp)) * 1.01, 1e-12), dtype)
    phase("power_method", t0)

    state = init_state(lp)
    sigma = jnp.asarray(1.0, dtype)
    rd = init_restart_dev(1.0, dtype)
    m_prev = initial_metrics(lp, scal, state)
    obj_c = jnp.asarray(0.0, dtype)
    best_pt = {"x_bar": state.x_bar, "y_bar": state.y_bar, "sigma": sigma}

    def superchunk(state, rd, sigma, lam, m_prev, it, best_pt):
        # stop_tol=0 so the synthetic LP never converges mid-dispatch and
        # every superchunk runs all N_CHUNKS; stall_patience=0 measures
        # the raw steady-state iteration cost.
        out = run_superchunk(lp, scal, state, rd, sigma, lam, m_prev,
                             it, obj_c, 0.0, N_CHUNKS, CHUNK_ITERS, 0,
                             best_pt)
        jax.block_until_ready(out)
        return out

    t0 = time.perf_counter()
    it = 0
    state, rd, sigma, lam, m_prev, _st, k_done, best_pt = superchunk(
        state, rd, sigma, lam, m_prev, it, best_pt)
    it += int(k_done) * CHUNK_ITERS
    phase("superchunk compile+warmup", t0)

    done = 0
    t_timed = time.perf_counter()
    for _ in range(REPEATS):
        state, rd, sigma, lam, m_prev, _st, k_done, best_pt = superchunk(
            state, rd, sigma, lam, m_prev, it, best_pt)
        done += int(k_done) * CHUNK_ITERS
        it += int(k_done) * CHUNK_ITERS
    its_per_sec = done / (time.perf_counter() - t_timed)

    itemsize = jnp.dtype(dtype).itemsize
    bytes_per_iter = (gather_spmv_bytes(lp.A, itemsize)
                      + gather_spmv_bytes(lp.AT, itemsize)
                      + vector_bytes_per_iter(lp.m, lp.n, itemsize))
    ref_its = peak / model_bytes_per_iter(problem.nnz, M, N, 8)
    print(json.dumps({
        "metric": (f"hpr_iterations_per_sec[m={M},n={N},"
                   f"nnz={problem.nnz},backend={lp.A.backend}]"),
        "value": its_per_sec,
        "unit": "iter/s",
        "bytes_per_iter": int(bytes_per_iter),
        "achieved_bytes_per_s": bytes_per_iter * its_per_sec,
        "share_of_peak_bandwidth": bytes_per_iter * its_per_sec / peak,
        "reference_its_per_sec_at_peak": ref_its,
        "vs_reference_peak": its_per_sec / ref_its,
        "platform": "gpu", "device_kind": kind, "device_count": count,
        "card_name_power_limit": power,
    }), flush=True)


if __name__ == "__main__":
    main()
