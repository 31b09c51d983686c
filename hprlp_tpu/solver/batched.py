"""Batched shared-A solver: B LPs with the same sparse A, different vectors.

Redesign of the reference batched path (reference:
src/batched_solver.cu:939-1092 solve_batched): the per-batch dense data
C/AL/AU/l/u are (n_pad, B)/(m_pad, B) device matrices; SpMV becomes SpMM
over the batch axis (ops/sparse.spmm — the cuSPARSE SpMM analogue,
batched_solver.cu:428-477); per-batch sigma / Halpern factors / restart
state are (B,) vectors (reference per-batch kernels :122-323 and host
restart state BatchedRestartHost :103-120); converged members are frozen
with an active mask (reference :1026-1033).

Differences from the single-LP path, matching the reference:
  * presolve is not applied (reference :953-955);
  * scaling runs on A only (CR/Ruiz/PC), b/c scaling per batch member
    (reference :975-992);
  * one shared lambda_max from the scaled A (reference :994-1001).

The whole iteration stretch between checkpoints is one jitted chunk, as in
the single-LP path (no host work per iteration; the reference syncs every
iteration, :1073).
"""

from __future__ import annotations

import dataclasses
import math
import time

import jax
import jax.numpy as jnp
import numpy as np

from ..backend import platform
from ..ops.device_problem import build_device_problem
from ..ops.sparse import spmm
from ..params import Parameters
from ..problem import LpProblem
from ..results import BatchedResults
from .loop import resolve_dtype
from .power_iteration import power_method
from .scaling import conceptual_b, scale_matrix


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class BatchedLpDevice:
    """Shared scaled A/AT + per-batch dense vectors (parity:
    HPRLP_batched_workspace, reference: src/batched_solver.cu:479-532)."""

    A: object  # EllMatrix (m_pad rows)
    AT: object  # EllMatrix (n_pad rows)
    AL: jax.Array  # (m_pad, B)
    AU: jax.Array
    c: jax.Array  # (n_pad, B)
    l: jax.Array
    u: jax.Array


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class BatchedState:
    x: jax.Array  # (n_pad, B)
    y: jax.Array  # (m_pad, B)
    last_x: jax.Array
    last_y: jax.Array
    x_bar: jax.Array
    y_bar: jax.Array
    z_bar: jax.Array
    y_obj: jax.Array
    inner: jax.Array  # (B,) int32


def _bfactors(inner, dtype):
    f1 = (1.0 / (inner.astype(dtype) + 2.0)).astype(dtype)
    return f1, 1.0 - f1


def _bx_half(lp, x, y, last_x, sigma, f1, f2):
    ATy = spmm(lp.AT, y)
    z_tmp = x + sigma * (ATy - lp.c)
    x_bar = jnp.clip(z_tmp, lp.l, lp.u)
    x_hat = 2.0 * x_bar - x
    return f2 * x_hat + f1 * last_x, x_hat, x_bar, z_tmp


def _by_half(lp, y, x_hat, last_y, lam_sigma, f1, f2):
    Ax = spmm(lp.A, x_hat)
    v = Ax - lam_sigma * y
    d = jnp.maximum(lp.AL - v, jnp.minimum(lp.AU - v, 0.0))
    y_bar = d / lam_sigma
    y_hat = 2.0 * y_bar - y
    return f2 * y_hat + f1 * last_y, y_bar, v + d


def _bgap_parts(lp, dx, dy):
    A_dx = spmm(lp.A, dx)
    return (jnp.sum(A_dx * dy, axis=0), jnp.sum(dy * dy, axis=0),
            jnp.sum(dx * dx, axis=0))


def _bmetrics(lp, row_norm, col_norm, x_bar, y_bar, z_bar, y_obj, dx, dy,
              last_x, last_y):
    """Per-batch residual ingredients; every value is a (B,) vector
    (parity: compute_residuals batched, reference:
    src/batched_solver.cu:578-623)."""
    Ax_bar = spmm(lp.A, x_bar)
    Rp = (jnp.maximum(lp.AL - Ax_bar, jnp.minimum(lp.AU - Ax_bar, 0.0))
          * row_norm[:, None])
    ATy_bar = spmm(lp.AT, y_bar)
    Rd = (lp.c - ATy_bar - z_bar) * col_norm[:, None]
    gap_dot, gap_dy2, gap_dx2 = _bgap_parts(lp, dx, dy)
    viol = jnp.where(x_bar < lp.l, lp.l - x_bar,
                     jnp.where(x_bar > lp.u, x_bar - lp.u, 0.0))
    nrm = lambda M: jnp.sqrt(jnp.sum(M * M, axis=0))
    return {
        "dot_c_xbar": jnp.sum(lp.c * x_bar, axis=0),
        "dot_yobj_ybar": jnp.sum(y_obj * y_bar, axis=0),
        "dot_xbar_zbar": jnp.sum(x_bar * z_bar, axis=0),
        "nrm_Rd": nrm(Rd),
        "nrm_Rp": nrm(Rp),
        "gap_dot": gap_dot,
        "gap_dy2": gap_dy2,
        "gap_dx2": gap_dx2,
        "move_x": nrm(x_bar - last_x),
        "move_y": nrm(y_bar - last_y),
        "nrm_lu_viol": nrm(viol / col_norm[:, None]),
    }


@jax.jit
def run_batched_chunk(lp: BatchedLpDevice, row_norm, col_norm,
                      state: BatchedState, sigma, lambda_max, restart_flag,
                      active, n_iters):
    """n_iters HPR iterations over all batch members + residual check.

    sigma: (B,); restart_flag: (B,) bool; active: (B,) bool — frozen
    members keep their state (reference active-mask kernels,
    src/batched_solver.cu:122-323).
    """
    dtype = lp.c.dtype
    sigma = sigma.astype(dtype)[None, :]
    lam_sigma = (lambda_max.astype(dtype) * sigma)
    act = active[None, :]

    rf = restart_flag[None, :]
    x = jnp.where(rf, state.x_bar, state.x)
    y = jnp.where(rf, state.y_bar, state.y)
    last_x = jnp.where(rf, state.x_bar, state.last_x)
    last_y = jnp.where(rf, state.y_bar, state.last_y)
    inner = jnp.where(restart_flag, 0, state.inner)

    def freeze(new, old):
        return jnp.where(act, new, old)

    # First iteration (check-style, for the post-restart gap).
    f1, f2 = _bfactors(inner, dtype)
    x1, x_hat, x_bar1, _ = _bx_half(lp, x, y, last_x, sigma, f1, f2)
    y1, y_bar1, _ = _by_half(lp, y, x_hat, last_y, lam_sigma, f1, f2)
    fs_dot, fs_dy2, fs_dx2 = _bgap_parts(lp, x - x_bar1, y - y_bar1)
    x1, y1 = freeze(x1, x), freeze(y1, y)
    inner = jnp.where(active, inner + 1, inner)

    def body(_, carry):
        x, y, inner = carry
        f1, f2 = _bfactors(inner, dtype)
        x_new, x_hat, _, _ = _bx_half(lp, x, y, last_x, sigma, f1, f2)
        y_new, _, _ = _by_half(lp, y, x_hat, last_y, lam_sigma, f1, f2)
        return (freeze(x_new, x), freeze(y_new, y),
                jnp.where(active, inner + 1, inner))

    x2, y2, inner = jax.lax.fori_loop(1, n_iters - 1, body, (x1, y1, inner))

    # Final iteration (check-style) + per-batch residuals.
    f1, f2 = _bfactors(inner, dtype)
    x_f, x_hat, x_bar, z_tmp = _bx_half(lp, x2, y2, last_x, sigma, f1, f2)
    z_bar = (x_bar - z_tmp) / sigma
    y_f, y_bar, y_obj = _by_half(lp, y2, x_hat, last_y, lam_sigma, f1, f2)

    x_f, y_f = freeze(x_f, x2), freeze(y_f, y2)
    x_bar = freeze(x_bar, state.x_bar)
    y_bar = freeze(y_bar, state.y_bar)
    z_bar = freeze(z_bar, state.z_bar)
    y_obj = freeze(y_obj, state.y_obj)
    inner = jnp.where(active, inner + 1, inner)
    dx = x2 - x_bar
    dy = y2 - y_bar

    metrics = _bmetrics(lp, row_norm, col_norm, x_bar, y_bar, z_bar, y_obj,
                        dx, dy, last_x, last_y)
    metrics["fs_dot"] = fs_dot
    metrics["fs_dy2"] = fs_dy2
    metrics["fs_dx2"] = fs_dx2

    new_state = BatchedState(x=x_f, y=y_f, last_x=last_x, last_y=last_y,
                             x_bar=x_bar, y_bar=y_bar, z_bar=z_bar,
                             y_obj=y_obj, inner=inner)
    return new_state, metrics


@jax.jit
def _initial_bmetrics(lp: BatchedLpDevice, row_norm, col_norm,
                      state: BatchedState):
    zn = jnp.zeros_like(state.x)
    zm = jnp.zeros_like(state.y)
    m = _bmetrics(lp, row_norm, col_norm, state.x_bar, state.y_bar,
                  state.z_bar, state.y_obj, zn, zm, state.last_x,
                  state.last_y)
    B = state.inner.shape[0]
    z = jnp.zeros(B, state.x.dtype)
    m["fs_dot"] = z
    m["fs_dy2"] = z
    m["fs_dx2"] = z
    return m


def solve_batched(A, C, AL, AU, l, u, obj_constants=None,
                  params: Parameters | None = None) -> BatchedResults:
    """Solve B LPs sharing the sparse matrix A.

    C, l, u: (n, B); AL, AU: (m, B); obj_constants: (B,) or None.
    Returns BatchedResults with column-major-layout solutions (parity:
    reference bindings solve_batched, bindings/python/hprlp/solver.py:335,
    src/batched_solver.cu:939).
    """
    params = params or Parameters()
    params.validate()
    dtype = resolve_dtype(params)
    log = print if params.verbose else (lambda *a, **k: None)

    from ..problem import _normalize_inf

    C = np.asarray(C, np.float64)
    AL = _normalize_inf(np.asarray(AL, np.float64))
    AU = _normalize_inf(np.asarray(AU, np.float64))
    l = _normalize_inf(np.asarray(l, np.float64))
    u = _normalize_inf(np.asarray(u, np.float64))
    if C.ndim != 2:
        raise ValueError("C must be (n, batch)")
    n, B = C.shape
    m = AL.shape[0]
    for name, arr, shape in (("AL", AL, (m, B)), ("AU", AU, (m, B)),
                             ("l", l, (n, B)), ("u", u, (n, B))):
        if arr.shape != shape:
            raise ValueError(f"{name} has shape {arr.shape}, expected {shape}")
    if np.any(AL > AU) or np.any(l > u):
        raise ValueError("infeasible bounds: AL > AU or l > u in some member")
    obj_constants = (np.zeros(B) if obj_constants is None
                    else np.asarray(obj_constants, np.float64))

    out = BatchedResults(m=m, n=n, batch_size=B)
    t_setup = time.perf_counter()

    # Shared-A layout: reuse the single-LP ELL builder with neutral vectors.
    base = LpProblem.from_arrays(A, AL[:, 0], AU[:, 0], l[:, 0], u[:, 0],
                                 C[:, 0])
    lp0, maps = build_device_problem(base, dtype=dtype)
    m_pad, n_pad = lp0.m, lp0.n

    # Scale A once (CR/Ruiz/PC only; reference forces bc off for the shared
    # pass, src/batched_solver.cu:975-981).
    A_s, AT_s, row_norm_d, col_norm_d = jax.jit(
        scale_matrix, static_argnames=("use_cr", "use_ruiz", "use_pc"))(
        lp0.A, lp0.AT, params.use_CR_scaling, params.use_Ruiz_scaling,
        params.use_Pock_Chambolle_scaling)

    # Batched SpMM backend: a dense matrix product amortises the matrix
    # read over the batch columns, so it usually wins whenever the dense
    # matrix fits; its budget is larger than the single-LP autotuner's
    # (both budgets are documented in hprlp_tpu/constants.py).  With
    # spmv_backend="auto" a timed probe decides below (batched autotune,
    # reference protocol parity: src/main_iterate.cu:517-595).
    from ..constants import DENSE_BYTES_LIMIT_BATCHED as BATCHED_DENSE_BYTES
    from ..ops.sparse import with_backend

    want = params.spmv_backend
    dense_ok = (m_pad * n_pad * jnp.dtype(dtype).itemsize
                <= BATCHED_DENSE_BYTES)
    if want == "dense" and dense_ok:
        A_s = with_backend(A_s, "dense")
        AT_s = with_backend(AT_s, "dense")
    row_norm = np.asarray(jax.device_get(row_norm_d), np.float64)
    col_norm = np.asarray(jax.device_get(col_norm_d), np.float64)

    # Per-member vector scaling on host (reference :810-864): row/col norms
    # then per-member b/c scales.
    def scatter(arr_2d, pos, size, fill):
        out_h = np.full((size, B), fill)
        out_h[pos, :] = arr_2d
        return out_h

    AL_p = scatter(AL, maps.row_pos, m_pad, -np.inf)
    AU_p = scatter(AU, maps.row_pos, m_pad, np.inf)
    C_p = scatter(C, maps.col_pos, n_pad, 0.0)
    l_p = scatter(l, maps.col_pos, n_pad, 0.0)
    u_p = scatter(u, maps.col_pos, n_pad, 0.0)

    def bnorm(ALm, AUm):
        return np.linalg.norm(
            np.maximum(np.where(np.isinf(ALm), 0.0, np.abs(ALm)),
                       np.where(np.isinf(AUm), 0.0, np.abs(AUm))), axis=0)

    # Original-space residual denominators come from the PRE-scaling
    # vectors (parity: single-LP scale_problem and the reference's batched
    # path, src/batched_solver.cu:817-819).
    norm_b_org = 1.0 + bnorm(AL_p, AU_p)
    norm_c_org = 1.0 + np.linalg.norm(C_p, axis=0)

    AL_p /= row_norm[:, None]
    AU_p /= row_norm[:, None]
    C_p /= col_norm[:, None]
    l_p *= col_norm[:, None]
    u_p *= col_norm[:, None]

    if params.use_bc_scaling:
        b_scale = 1.0 + bnorm(AL_p, AU_p)
        c_scale = 1.0 + np.linalg.norm(C_p, axis=0)
        AL_p /= b_scale
        AU_p /= b_scale
        l_p /= b_scale
        u_p /= b_scale
        C_p /= c_scale
    else:
        b_scale = np.ones(B)
        c_scale = np.ones(B)
    norm_b = bnorm(AL_p, AU_p)
    norm_c = np.linalg.norm(C_p, axis=0)

    lp = BatchedLpDevice(
        A=A_s, AT=AT_s,
        AL=jnp.asarray(AL_p.astype(np.dtype(dtype))),
        AU=jnp.asarray(AU_p.astype(np.dtype(dtype))),
        c=jnp.asarray(C_p.astype(np.dtype(dtype))),
        l=jnp.asarray(l_p.astype(np.dtype(dtype))),
        u=jnp.asarray(u_p.astype(np.dtype(dtype))))
    if params.mesh_shape:
        # Data-parallel scenario batching: shard the batch axis over the
        # mesh, replicate the shared A/A^T (SURVEY §2.9 row 1).  Per-member host state stays host-side; the chunk
        # runs SPMD with no cross-member communication.
        from jax.sharding import NamedSharding, PartitionSpec as P

        from ..parallel.sharded import make_mesh

        if B % params.mesh_shape:
            raise ValueError(
                f"batch size {B} not divisible by mesh size "
                f"{params.mesh_shape}")
        mesh = make_mesh(params.mesh_shape)
        bsh = NamedSharding(mesh, P(None, "d"))
        rep = NamedSharding(mesh, P())
        lp = BatchedLpDevice(
            A=jax.device_put(lp.A, rep), AT=jax.device_put(lp.AT, rep),
            AL=jax.device_put(lp.AL, bsh), AU=jax.device_put(lp.AU, bsh),
            c=jax.device_put(lp.c, bsh), l=jax.device_put(lp.l, bsh),
            u=jax.device_put(lp.u, bsh))
    jax.block_until_ready(lp.c)
    out.setup_time = time.perf_counter() - t_setup
    log(f"Batched setup time = {out.setup_time:.2f} seconds (B={B})")

    t_pm = time.perf_counter()
    lam_shared = max(float(power_method(
        dataclasses.replace(lp0, A=A_s, AT=AT_s))) * 1.01, 1e-12)
    out.power_time = time.perf_counter() - t_pm

    sigma = np.where((norm_b > 1e-8) & (norm_c > 1e-8),
                     norm_b / np.maximum(norm_c, 1e-300), 1.0)
    lam = np.full(B, lam_shared)

    zn = jnp.zeros((n_pad, B), dtype)
    zm = jnp.zeros((m_pad, B), dtype)
    state = BatchedState(x=zn, y=zm, last_x=zn, last_y=zm, x_bar=zn,
                         y_bar=zm, z_bar=zn, y_obj=zm,
                         inner=jnp.zeros(B, jnp.int32))

    # Batched backend autotune (reference protocol: >= 5% speedup + merit
    # within 1%, src/main_iterate.cu:517-595) between the gather SpMM and
    # the dense SpMM on the real matrix.  A probe failure propagates.
    if (want == "auto" and dense_ok and platform() == "gpu"
            and params.mesh_shape is None and lp.A.nnz >= 10_000):
        probe = (jnp.asarray(sigma, dtype), jnp.asarray(lam, dtype),
                 jnp.zeros(B, bool), jnp.ones(B, bool),
                 jnp.asarray(20, jnp.int32))

        def time_cand(cand):
            st, mm = run_batched_chunk(cand, row_norm_d, col_norm_d,
                                       state, *probe)
            jax.block_until_ready(mm)
            best = float("inf")
            for _ in range(2):
                t0 = time.perf_counter()
                st, mm = run_batched_chunk(cand, row_norm_d, col_norm_d,
                                           state, *probe)
                jax.block_until_ready(mm)
                best = min(best, time.perf_counter() - t0)
            return best, np.asarray(jax.device_get(mm["nrm_Rp"]))

        t_g, rp_g = time_cand(lp)
        dense_lp = dataclasses.replace(
            lp, A=with_backend(lp.A, "dense"),
            AT=with_backend(lp.AT, "dense"))
        t_d, rp_d = time_cand(dense_lp)
        merit_ok = np.allclose(rp_d, rp_g, rtol=0.01, atol=1e-30)
        log(f"[autotune] batched gather: {t_g * 1e3:.2f} ms, "
            f"dense: {t_d * 1e3:.2f} ms"
            f"{'' if merit_ok else ' (merit mismatch)'}")
        if merit_ok and t_d * 1.05 < t_g:
            lp = dense_lp

    # Device-resident superchunk driver (solver/batched_device_loop.py):
    # per-member restart/sigma/stopping decisions all run inside jit; one
    # dispatch advances up to n_chunks * check_iter iterations for every
    # live member (round-1 gap: a host round-trip per checkpoint).
    from .batched_device_loop import (init_batched_restart_dev,
                                      run_batched_superchunk)

    status = np.array(["CONTINUE"] * B, object)
    iters = np.zeros(B, np.int64)
    final_kkt = np.full(B, np.inf)
    final_gap = np.full(B, np.inf)
    final_pobj = np.zeros(B)

    metrics_prev = _initial_bmetrics(lp, row_norm_d, col_norm_d, state)
    rd = init_batched_restart_dev(jnp.asarray(sigma, dtype), dtype)
    sigma_d = jnp.asarray(sigma, dtype)
    lam_d = jnp.asarray(lam, dtype)
    active_d = jnp.ones(B, bool)
    b_scale_d = jnp.asarray(b_scale, dtype)
    c_scale_d = jnp.asarray(c_scale, dtype)
    nb_d = jnp.asarray(norm_b_org, dtype)
    nc_d = jnp.asarray(norm_c_org, dtype)
    oc_d = jnp.asarray(obj_constants, dtype)
    obj_scale = b_scale * c_scale
    check = params.check_iter

    def derive(m_k, at_it):
        pobj = obj_scale * m_k["dot_c_xbar"] + obj_constants
        dobj = obj_scale * (m_k["dot_yobj_ybar"]
                            + m_k["dot_xbar_zbar"]) + obj_constants
        rel_gap = np.abs(pobj - dobj) / (1.0 + np.abs(pobj) + np.abs(dobj))
        err_Rd = c_scale * m_k["nrm_Rd"] / norm_c_org
        err_Rp = b_scale * m_k["nrm_Rp"] / norm_b_org
        if at_it == 0:
            err_Rp = np.maximum(err_Rp, b_scale * m_k["nrm_lu_viol"])
        kkt = np.maximum(np.maximum(err_Rd, err_Rp), rel_gap)
        return pobj, rel_gap, kkt

    def finish(active_h):
        out.solve_time = elapsed()
        out.time = out.setup_time + out.solve_time
        out.iter = iters
        out.residuals = final_kkt
        out.gap = final_gap
        out.primal_obj = final_pobj
        out.status = list(status)
        # Un-scale solutions (reference :887-935).
        x_s = np.asarray(jax.device_get(state.x_bar), np.float64)
        y_s = np.asarray(jax.device_get(state.y_bar), np.float64)
        z_s = np.asarray(jax.device_get(state.z_bar), np.float64)
        x = (b_scale[None, :] * x_s / col_norm[:, None])[maps.col_pos, :]
        y = (c_scale[None, :] * y_s / row_norm[:, None])[maps.row_pos, :]
        z = (c_scale[None, :] * z_s * col_norm[:, None])[maps.col_pos, :]
        out.x = np.asfortranarray(x)
        out.y = np.asfortranarray(y)
        out.z = np.asfortranarray(z)
        return out

    # Compile the quiet-dispatch superchunk variant OUTSIDE the algorithm
    # clock and dispatch that executable in the loop (mirror of
    # solver/loop.py: the reference's loop contains no compilation; power
    # method and autotune above are likewise setup).  Quiet solves use one
    # big dispatch size: the device loop exits when every member
    # converges, so a full-size dispatch never overshoots.
    n_quiet = 1 if params.verbose else 32
    n_quiet = max(1, min(n_quiet, (params.max_iter + check - 1) // check))
    quiet_superchunk = run_batched_superchunk.lower(
        lp, row_norm_d, col_norm_d, state, rd, sigma_d, lam_d, active_d,
        metrics_prev, 0, b_scale_d, c_scale_d, nb_d, nc_d, oc_d,
        params.stop_tol, n_quiet, check).compile()

    # --- algorithm clock: iteration work only from here on ---
    t_alg = time.perf_counter()
    elapsed = lambda: time.perf_counter() - t_alg

    # Iteration-0 bookkeeping.
    m0 = {k: np.asarray(jax.device_get(v), np.float64)
          for k, v in metrics_prev.items()}
    pobj, rel_gap, kkt = derive(m0, 0)
    done0 = kkt < params.stop_tol
    status[done0] = "OPTIMAL"
    final_kkt[:] = kkt
    final_gap[:] = rel_gap
    final_pobj[:] = pobj
    active_h = ~done0
    active_d = jnp.asarray(active_h)
    log(f"iter {0:6d}  active {int(active_h.sum()):4d}/{B}  "
        f"max_kkt {np.nanmax(kkt):.2e}  time {elapsed():.2f}s")
    it = 0

    while active_h.any():
        if it >= params.max_iter:
            status[active_h] = "ITER_LIMIT"
            return finish(active_h)
        if elapsed() > params.time_limit:
            status[active_h] = "TIME_LIMIT"
            return finish(active_h)

        n_chunks = max(1, min(n_quiet,
                              (params.max_iter - it + check - 1) // check))
        args = (lp, row_norm_d, col_norm_d, state, rd, sigma_d, lam_d,
                active_d, metrics_prev, it, b_scale_d, c_scale_d, nb_d,
                nc_d, oc_d, params.stop_tol)
        if n_chunks == n_quiet:
            outs = quiet_superchunk(*args)
        else:
            outs = run_batched_superchunk(*args, n_chunks, check)
        (state, rd, sigma_d, lam_d, active_d, metrics_prev, stacked,
         k_done) = outs
        k_done = int(k_done)
        stacked = {k: np.asarray(v, np.float64)
                   for k, v in jax.device_get(stacked).items()}

        for k in range(k_done):
            it += check
            was_active = stacked["active"][k] > 0.5
            m_k = {key: stacked[key][k] for key in stacked}
            pobj, rel_gap, kkt = derive(m_k, it)
            final_kkt = np.where(was_active, kkt, final_kkt)
            final_gap = np.where(was_active, rel_gap, final_gap)
            final_pobj = np.where(was_active, pobj, final_pobj)
            iters = np.where(was_active, it, iters)
            newly_opt = was_active & (kkt < params.stop_tol)
            status[newly_opt] = "OPTIMAL"
            active_h = was_active & ~newly_opt
            if params.verbose and it % params.check_iter == 0:
                log(f"iter {it:6d}  active {int(active_h.sum()):4d}/{B}  "
                    f"max_kkt {np.nanmax(kkt):.2e}  time {elapsed():.2f}s")

        # Reconcile with the device's own freeze decisions.  The device
        # stop test runs in the solve dtype while the host recomputes kkt
        # in f64 from the same metrics; a member landing within rounding
        # of stop_tol can pass one test and fail the other.  The device
        # decision is authoritative (it is the one that freezes
        # iteration) — without this, a device-frozen/host-active member
        # wedges the dispatch loop in no-op superchunks until time_limit.
        dev_active = np.asarray(jax.device_get(active_d), bool)
        frozen_by_device = active_h & ~dev_active
        status[frozen_by_device] = "OPTIMAL"
        active_h &= dev_active
        # And push host-side freezes back to the device so both views
        # agree on the next dispatch.
        if not np.array_equal(dev_active, active_h):
            active_d = jnp.asarray(active_h)

    log(f"iter {it:6d}  all {B} members converged  time {elapsed():.2f}s")
    return finish(active_h)
