"""SpMV backend autotuner.

Behavioural parity with the reference's custom-update autotuner
(reference: src/main_iterate.cu:517-595): benchmark the backend
combinations for {A, A^T} on the REAL matrix by timing full iteration
chunks, require a candidate to be >= 5% faster than the baseline AND to
reproduce the baseline residual metrics within 1% (the reference's merit
eligibility check, :185-203), keep the fastest.  The probe runs on a
throwaway copy of the state, so the solve is unaffected (the reference
snapshots/restores device state, :74-151 — our chunks are functional, so
nothing to restore).
"""

from __future__ import annotations

import time
from typing import Callable

import jax
import jax.numpy as jnp

from ..ops.device_problem import LpDevice
from ..ops.sparse import with_backend

# A dense candidate is considered only when the dense matrix is at most
# this many bytes (both A and A^T are materialised while probing).  The
# batched path uses the larger DENSE_BYTES_LIMIT_BATCHED; the rationale
# for the two budgets lives with the constants (hprlp_tpu/constants.py).
from ..constants import DENSE_BYTES_LIMIT_SINGLE as DENSE_BYTES_LIMIT
SPEEDUP_MIN = 1.05  # reference: >= 5% faster to switch
MERIT_RTOL = 0.01   # reference: within 1% of baseline merit
# Below this nnz the probe compiles cost more than any possible win.
AUTOTUNE_MIN_NNZ = 10_000


def _time_chunk(run, lp, args, n_rep: int = 2) -> tuple[float, dict]:
    state, metrics = run(lp, *args)  # compile + warm
    jax.block_until_ready(metrics)
    best = float("inf")
    for _ in range(n_rep):
        t0 = time.perf_counter()
        state, metrics = run(lp, *args)
        jax.block_until_ready(metrics)
        best = min(best, time.perf_counter() - t0)
    return best, {k: float(v) for k, v in jax.device_get(metrics).items()}


def _merit_close(a: dict, b: dict) -> bool:
    for k in ("nrm_Rp", "nrm_Rd"):
        ref = abs(b[k])
        if abs(a[k] - b[k]) > MERIT_RTOL * max(ref, 1e-30):
            return False
    return True


def autotune_backends(run: Callable, lp: LpDevice, probe_args,
                      verbose: bool = False) -> LpDevice:
    """Pick the fastest (A, A^T) backend pair for the chunk runner `run`.

    run(lp, *probe_args) -> (state, metrics) must be the jitted chunk.
    Returns lp reconfigured with the winning backends.  Candidates are
    the gather baseline, dense, and the two mixed dense/gather pairs; a
    dense candidate needs the dense matrix within DENSE_BYTES_LIMIT.  A
    probe that fails to build or run is an error of the solve, not a
    reason to skip the candidate.
    """
    log = print if verbose else (lambda *a, **k: None)
    if lp.A.nnz < AUTOTUNE_MIN_NNZ:
        return lp
    dense_ok = (lp.A.nrows * lp.A.ncols * jnp.dtype(lp.c.dtype).itemsize
                <= DENSE_BYTES_LIMIT)
    if not dense_ok:
        return lp
    candidates = [("dense", "dense"), ("dense", "gather"),
                  ("gather", "dense")]

    base_time, base_metrics = _time_chunk(run, lp, probe_args)
    log(f"[autotune] gather/gather: {base_time * 1e3:.2f} ms")
    best = lp
    best_time = base_time
    for a_b, at_b in candidates:
        cand = LpDevice(A=with_backend(lp.A, a_b),
                        AT=with_backend(lp.AT, at_b),
                        AL=lp.AL, AU=lp.AU, c=lp.c, l=lp.l, u=lp.u)
        t, m = _time_chunk(run, cand, probe_args)
        ok = _merit_close(m, base_metrics)
        log(f"[autotune] {a_b}/{at_b}: {t * 1e3:.2f} ms"
            f"{'' if ok else '  (merit mismatch, rejected)'}")
        if ok and t * SPEEDUP_MIN < best_time:
            best, best_time = cand, t
    if best is not lp:
        log(f"[autotune] selected A={best.A.backend} AT={best.AT.backend}")
    return best
