"""Host orchestration of the solve (parity: HPRLP_main_solve,
reference: src/HPRLP.cu:116-310, restart/sigma logic src/main_iterate.cu:
312-420).

The host only sees ~15 scalars per chunk boundary; all vector work happens
inside the jitted chunk (chunk.py).  Chunk boundaries reproduce the
reference's schedule: every check_iter iterations (restart + stopping) plus
the log-spaced print steps (utils.cu:100-102 step()).
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
from ..params import Parameters
from ..problem import LpProblem
from ..results import Results
from .chunk import init_state, initial_metrics, run_chunk, unscale_solution
from .power_iteration import power_method
from .scaling import scale_problem

# Backend compiles so far in this process (the loop reports how many ran
# inside its own window as Results.loop_compiles).
_backend_compiles = [0]


def _count_backend_compile(event: str, duration: float, **kw) -> None:
    if event == "/jax/core/compile/backend_compile_duration":
        _backend_compiles[0] += 1


jax.monitoring.register_event_duration_secs_listener(_count_backend_compile)


@dataclasses.dataclass
class Residuals:
    """Parity: HPRLP_residuals (reference: include/structs.h:255-263)."""

    err_Rp: float = math.inf
    err_Rd: float = math.inf
    primal_obj: float = 0.0
    dual_obj: float = 0.0
    rel_gap: float = math.inf
    kkt: float = math.inf


def _print_step(it: int) -> int:
    """Log-spaced print cadence (reference: src/utils.cu:100-102)."""
    if it <= 0:
        return 10
    return max(10, 10 ** int(math.floor(math.log10(it))) // 10)




def _derive_residuals(metrics: dict, scal_host: dict, obj_constant: float,
                      is_iter0: bool) -> Residuals:
    obj_scale = scal_host["b_scale"] * scal_host["c_scale"]
    r = Residuals()
    r.primal_obj = obj_scale * metrics["dot_c_xbar"] + obj_constant
    r.dual_obj = obj_scale * (metrics["dot_yobj_ybar"]
                              + metrics["dot_xbar_zbar"]) + obj_constant
    r.rel_gap = abs(r.primal_obj - r.dual_obj) / (
        1.0 + abs(r.primal_obj) + abs(r.dual_obj))
    r.err_Rd = scal_host["c_scale"] * metrics["nrm_Rd"] / scal_host["norm_c_org"]
    r.err_Rp = scal_host["b_scale"] * metrics["nrm_Rp"] / scal_host["norm_b_org"]
    if is_iter0:
        r.err_Rp = max(r.err_Rp, scal_host["b_scale"] * metrics["nrm_lu_viol"])
    r.kkt = max(r.err_Rd, r.err_Rp, r.rel_gap)
    return r


def resolve_dtype(params: Parameters):
    """The solve dtype for params.precision on this platform.  Flips the
    process-global x64 flag to match (solve_problem restores it)."""
    if params.precision == "f64" or (params.precision != "f32"
                                     and platform() == "cpu"):
        if not jax.config.jax_enable_x64:
            jax.config.update("jax_enable_x64", True)
        return jnp.float64
    # f32, or auto on a GPU (at stop_tol >= 1e-5: _route_precision sends
    # tighter single-LP auto solves to the refinement driver).  Leaving
    # x64 on would make index and scalar types 64-bit in the f32 jits.
    if jax.config.jax_enable_x64 and platform() != "cpu":
        jax.config.update("jax_enable_x64", False)
    return jnp.float32


def _route_precision(params: Parameters, platform_name: str) -> str:
    """Resolve precision="auto" to a concrete mode for this platform:
    f32 is the fast mode on a GPU, reliable to ~1e-4..1e-6 KKT, so auto
    solves below 1e-5 go to the refinement driver (refine.py) with native
    f64 stages.  Stage 0 is exactly a direct f64 solve; instances whose
    direct solve stalls hand over to zoomed residual stages, and the true
    KKT is certified in host f64.  On the CPU auto is plain f64.
    precision="f64" (direct) and "mixed" (f32 stages) remain available
    explicitly."""
    if params.precision == "auto" and platform_name == "gpu" \
            and params.stop_tol < 1e-5:
        return "mixed"
    return params.precision


def solve_problem(problem: LpProblem, params: Parameters | None = None,
                  _device_data=None, x0=None, y0=None,
                  sigma0=None) -> Results:
    """Full solve: upload -> scale -> power method -> HPR loop -> unscale.

    Parity: solve() + HPRLP_main_solve() (reference: src/HPRLP.cu:116-310,
    :493-524) minus presolve (handled by the caller / presolve package).

    x0/y0: optional warm-start primal/dual points in the ORIGINAL space
    (a capability the reference lacks; SURVEY §7 design stance — the
    functional chunk design makes it free).

    The jax_enable_x64 flag is solve-scoped: resolve_dtype may flip the
    process-global flag to match the requested precision, and it is
    restored on return so unrelated user JAX code keeps its semantics.
    """
    params = params or Parameters()
    params.validate()
    precision = _route_precision(params, platform())
    if precision != params.precision:
        # The resolved precision must reach resolve_dtype (a dead local
        # here would silently leave "auto" -> f32 on the GPU).
        import copy

        was_auto = params.precision == "auto"
        params = copy.copy(params)
        params.precision = precision
        if precision == "mixed" and was_auto:
            # Auto-routed refinement runs f64 stages (see
            # _route_precision); explicit precision="mixed" keeps the
            # classic f32 stages.
            params.refine_stage_precision = "f64"
    if precision == "mixed" and _device_data is None:
        from .refine import solve_refined

        return solve_refined(problem, params, x0=x0, y0=y0)

    prior_x64 = bool(jax.config.jax_enable_x64)
    try:
        return _solve_problem_impl(problem, params, _device_data, x0, y0,
                                   sigma0)
    finally:
        if bool(jax.config.jax_enable_x64) != prior_x64:
            jax.config.update("jax_enable_x64", prior_x64)


def _solve_problem_impl(problem: LpProblem, params: Parameters | None,
                        _device_data, x0, y0, sigma0=None) -> Results:
    params = params or Parameters()
    params.validate()
    dtype = resolve_dtype(params)
    log = print if params.verbose else (lambda *a, **k: None)

    out = Results()

    t_setup = time.perf_counter()
    if _device_data is not None:
        lp_raw, maps = _device_data
    elif params.mesh_shape:
        # Multi-device: row-block-shard A/A^T over a 1-D mesh (GSPMD);
        # the same jitted chunks then run SPMD with XLA collectives.
        from ..parallel.sharded import make_mesh, shard_problem

        n_dev = params.mesh_shape
        lp_raw, maps = build_device_problem(
            problem, dtype=dtype, row_multiple=8 * n_dev,
            vec_multiple=256 * n_dev)
        lp_raw = shard_problem(lp_raw, make_mesh(n_dev))
    else:
        lp_raw, maps = build_device_problem(problem, dtype=dtype)
    jax.block_until_ready(lp_raw.c)
    out.setup_time = time.perf_counter() - t_setup
    log(f"Setup (layout and upload) time = {out.setup_time:.2f} seconds")

    t_scale = time.perf_counter()
    lp, scal = scale_problem(lp_raw,
                             use_cr=params.use_CR_scaling,
                             use_ruiz=params.use_Ruiz_scaling,
                             use_pc=params.use_Pock_Chambolle_scaling,
                             use_bc=params.use_bc_scaling)
    # The unscaled device matrices are dead from here on; dropping the
    # local reference lets JAX free them (gigabytes at 100M nnz — the
    # caller keeps its own reference when it passed _device_data in).
    del lp_raw
    out.scaling_time = time.perf_counter() - t_scale
    scal_host = {k: float(getattr(scal, k)) for k in
                 ("b_scale", "c_scale", "norm_b", "norm_c",
                  "norm_b_org", "norm_c_org")}
    log(f"Scaling time = {out.scaling_time:.2f} seconds")

    if sigma0 is not None:
        # Warm restart: resume sigma adaptation from a prior solve of the
        # SAME problem (the scaling pipeline is deterministic, so scaled
        # sigmas transfer between solves).
        sigma = float(sigma0)
    elif scal_host["norm_b"] > 1e-8 and scal_host["norm_c"] > 1e-8:
        sigma = scal_host["norm_b"] / scal_host["norm_c"]
    else:
        sigma = 1.0

    state = init_state(lp)
    if x0 is not None or y0 is not None:
        # Map warm-start points into the padded, scaled space (inverse of
        # unscale_solution: x_scaled = x * col_norm / b_scale).
        if x0 is not None:
            xp = np.zeros(lp.n)
            xp[maps.col_pos] = np.asarray(x0, np.float64)
            xs = jnp.asarray(xp, dtype) * scal.col_norm / scal.b_scale
            state = dataclasses.replace(state, x=xs, last_x=xs, x_bar=xs)
        if y0 is not None:
            yp = np.zeros(lp.m)
            yp[maps.row_pos] = np.asarray(y0, np.float64)
            ys = jnp.asarray(yp, dtype) * scal.row_norm / scal.c_scale
            state = dataclasses.replace(state, y=ys, last_y=ys, y_bar=ys)

    # SpMV backend selection BEFORE the power method, so the power
    # iterations also run on the fast backend (reference autotuner
    # analogue, src/main_iterate.cu:517-595).
    t_tune = time.perf_counter()
    if params.spmv_backend == "auto":
        from .autotune import autotune_backends

        # Probes run 20 iterations, not a full check_iter chunk: n_iters
        # is a traced argument, so the SAME compiled chunk serves probes
        # and production, and 20 iterations rank backends just as well
        # (a full-length gather probe costs seconds on large problems).
        # lambda_max is a placeholder during probing (merit comparison
        # only — all candidates see the same value).
        probe_args = (scal, state, jnp.asarray(sigma, dtype),
                      jnp.asarray(4.0, dtype), jnp.asarray(False),
                      jnp.asarray(min(20, params.check_iter), jnp.int32))
        lp = autotune_backends(run_chunk, lp, probe_args,
                               verbose=params.autotune_verbose)
    elif params.spmv_backend == "dense":
        from ..ops.sparse import with_backend

        lp = dataclasses.replace(lp, A=with_backend(lp.A, "dense"),
                                 AT=with_backend(lp.AT, "dense"))
    out.autotune_time = time.perf_counter() - t_tune

    t_pm = time.perf_counter()
    # Floor guards the degenerate all-zero-A case (zero-constraint LPs):
    # lambda_max = 0 would make the y-update divide 0/0.
    lambda_max = max(float(power_method(lp)) * 1.01, 1e-12)
    out.power_time = time.perf_counter() - t_pm
    log(f"ESTIMATING MAXIMUM EIGENVALUE time = {out.power_time:.2f} seconds")

    from .device_loop import init_restart_dev, run_superchunk

    obj_constant = maps.obj_constant
    obj_c_dev = jnp.asarray(obj_constant, dtype)
    rd = init_restart_dev(sigma, dtype)
    sigma_dev = jnp.asarray(sigma, dtype)
    lam_dev = jnp.asarray(lambda_max, dtype)
    check = params.check_iter

    metrics_prev = initial_metrics(lp, scal, state)
    # Stall-recovery best point, threaded across dispatches (always
    # constructed here so every dispatch shares ONE compiled trace).
    best_pt = {"x_bar": state.x_bar, "y_bar": state.y_bar,
               "sigma": sigma_dev}

    # Compile the production superchunk variant OUTSIDE the algorithm
    # clock and dispatch that executable in the loop: the reference's loop
    # contains no compilation (CUDA graphs are captured in setup,
    # src/HPRLP.cu:99-114), so ours belongs to setup too.  Quiet solves
    # use the maximum dispatch size: the device loop exits AT the first
    # converged checkpoint (on-device stopping), so a full-size dispatch
    # never overshoots convergence, and 128 chunks amortise each
    # dispatch's host round-trip over 19200 iterations.  Verbose solves
    # use single chunks for per-checkpoint printing.  Only a final
    # dispatch shortened by max_iter goes through the jit (and compiles).
    stall = int(params.stall_recovery or 0)
    n_main = max(1, min(1 if params.verbose else 128,
                        (params.max_iter + check - 1) // check))
    main_superchunk = run_superchunk.lower(
        lp, scal, state, rd, sigma_dev, lam_dev, metrics_prev, 0,
        obj_c_dev, params.stop_tol, n_main, check, stall, best_pt).compile()

    # --- algorithm clock starts here, AFTER backend autotune, the power
    # method and superchunk compilation (reference: src/HPRLP.cu:141-167
    # setup vs :178 loop — probe/compile time belongs to setup, not the
    # per-iteration story) ---
    t_alg = time.perf_counter()
    elapsed = lambda: time.perf_counter() - t_alg
    compiles_at_start = _backend_compiles[0]

    first = {1e-4: True, 1e-6: True, 1e-8: True}
    it = 0
    log(" iter     errRp        errRd         p_obj            d_obj"
        "          gap         sigma       time")

    def host_res(m_host, at_it):
        return _derive_residuals(m_host, scal_host, obj_constant, at_it == 0)

    def finish(status, at_it, res, sigma_val, restarts):
        out.status = status
        out.spmv_backend = lp.A.backend
        out.iter = at_it
        out.gap = res.rel_gap
        out.residuals = res.kkt
        out.primal_obj = res.primal_obj
        out.dual_obj = res.dual_obj
        out.time = elapsed()
        out.loop_compiles = _backend_compiles[0] - compiles_at_start
        out.restarts = restarts
        out.stall_recoveries = stall_events
        out.sigma_final = float(sigma_val)
        if out.time4 == 0.0 and first[1e-4]:
            out.iter4, out.time4 = out.iter, out.time
        if out.time6 == 0.0 and first[1e-6]:
            out.iter6, out.time6 = out.iter, out.time
        if out.time8 == 0.0 and first[1e-8]:
            out.iter8, out.time8 = out.iter, out.time
        from ..parallel.distributed import host_fetch

        x_s, y_s, z_s = (host_fetch(v)
                         for v in unscale_solution(scal, state))
        out.x = np.asarray(x_s, np.float64)[maps.col_pos]
        out.y = np.asarray(y_s, np.float64)[maps.row_pos]
        out.z = np.asarray(z_s, np.float64)[maps.col_pos]
        log(f"\n=== Solution Summary ===\nStatus: {out.status}\n"
            f"Iterations: {out.iter}\nTime: {out.time:.2f} seconds\n"
            f"Primal Objective: {out.primal_obj:.12e}\n"
            f"Residual: {out.residuals:.2e}\n")
        return out

    def milestones(res, at_it, at_time):
        for tol, (attr_i, attr_t) in ((1e-4, ("iter4", "time4")),
                                      (1e-6, ("iter6", "time6")),
                                      (1e-8, ("iter8", "time8"))):
            if first[tol] and res.kkt < tol:
                setattr(out, attr_i, at_it)
                setattr(out, attr_t, at_time)
                first[tol] = False
                log(f"Residual < {tol:.0e} at iter = {at_it}")

    # Iteration-0 bookkeeping.
    stall_events = 0
    m0 = {k: float(v) for k, v in jax.device_get(metrics_prev).items()}
    res = host_res(m0, 0)
    log(f"{0:5d}    {res.err_Rp:.2e}    {res.err_Rd:.2e}    "
        f"{res.primal_obj:+.6e}    {res.dual_obj:+.6e}    "
        f"{res.rel_gap:.2e}    {sigma:.2e}      {elapsed():.2f}")
    milestones(res, 0, elapsed())
    if res.kkt < params.stop_tol:
        return finish("OPTIMAL", 0, res, sigma, 0)

    restarts = 0
    best_kkt = res.kkt
    best_kkt_it = 0
    while True:
        # Time-limit granularity is one dispatch (<= 19200 iterations),
        # checked between dispatches.
        n_chunks = max(1, min(n_main,
                              (params.max_iter - it + check - 1) // check))

        t_disp = time.perf_counter()
        if n_chunks == n_main:
            outs = main_superchunk(lp, scal, state, rd, sigma_dev, lam_dev,
                                   metrics_prev, it, obj_c_dev,
                                   params.stop_tol, stall, best_pt)
        else:
            outs = run_superchunk(lp, scal, state, rd, sigma_dev, lam_dev,
                                  metrics_prev, it, obj_c_dev,
                                  params.stop_tol, n_chunks, check, stall,
                                  best_pt)
        (state, rd, sigma_dev, lam_dev, metrics_prev, stacked, k_done,
         best_pt) = outs
        k_done = int(k_done)
        stacked = {k: np.asarray(v, np.float64)
                   for k, v in jax.device_get(stacked).items()}
        t_done = time.perf_counter()

        for k in range(k_done):
            it += check
            # Time attribution within the dispatch: linear interpolation.
            t_k = (t_disp - t_alg) + (t_done - t_disp) * (k + 1) / k_done
            m_k = {key: stacked[key][k] for key in stacked}
            res = host_res(m_k, it)
            sigma = float(stacked["sigma"][k])
            restarts += int(stacked["flag"][k])
            stall_events += int(stacked["stall"][k])
            milestones(res, it, t_k)
            if params.verbose and (it % _print_step(it) == 0
                                   or res.kkt < params.stop_tol):
                log(f"{it:5d}    {res.err_Rp:.2e}    {res.err_Rd:.2e}    "
                    f"{res.primal_obj:+.6e}    {res.dual_obj:+.6e}    "
                    f"{res.rel_gap:.2e}    {sigma:.2e}      {t_k:.2f}")

        # Stopping uses the LAST chunk's state (what `state` holds).
        if res.kkt < params.stop_tol:
            return finish("OPTIMAL", it, res, sigma, restarts)
        if it >= params.max_iter:
            return finish("ITER_LIMIT", it, res, sigma, restarts)
        if elapsed() > params.time_limit:
            return finish("TIME_LIMIT", it, res, sigma, restarts)
        if params.stall_window is not None:
            # Opt-in stall detection (used by the mixed-precision
            # refinement driver: f32 plateaus below its round-off floor
            # should hand over to the next refinement stage, not burn
            # iterations until ITER_LIMIT).
            if res.kkt < 0.9 * best_kkt:
                best_kkt, best_kkt_it = res.kkt, it
            elif it - best_kkt_it > params.stall_window:
                return finish("STALLED", it, res, sigma, restarts)
