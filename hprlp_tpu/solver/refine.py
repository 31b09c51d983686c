"""Refined solve (precision="mixed"): zoomed residual stages in f32 or f64,
f64 host stitching, and for f32 stages a warm-started f64 tail.

f32 iterations are the fast mode on a GPU but plateau at their round-off
floor; precision="auto" below 1e-5 runs this driver with native f64
stages.  The scheme with f32 stages:

1. Solve in f32 with stall detection (the f32 iterates plateau at their
   round-off floor, typically 1e-5..1e-6 true KKT).
2. Zoomed refinement stages: re-solve
       min  c'd   s.t.  zeta(AL - Ax0) <= A d <= zeta(AU - Ax0),
                        zeta(l - x0)  <=  d  <= zeta(u - x0)
   in f32 and stitch x += d/zeta, (y, z) = (yd, zd) in f64 (the cost is
   UNSCALED, so the sub's duals are original-scale duals; with the
   two-sided form the textbook reduced-cost objective drops the
   non-constant y0'Ad term and regresses the objective — measured).
   Each stage improves the true f64-measured KKT ~10-30x until the f32
   measurement floor binds (~1e-6).
3. If the target is below what stages can certify, finish with an
   f64 solve WARM-STARTED at the refined point: the tail typically needs
   a few hundred iterations, so its slower per-iteration cost is
   amortised away.

No reference counterpart: the reference solves in f64 end-to-end
(src/HPRLP.cu).  SURVEY §7.2 hard part 1.
"""

from __future__ import annotations

import copy
import time

import numpy as np

from ..params import Parameters
from ..problem import LpProblem
from ..results import Results

# f32 stages cannot certify much below this; below it the f64 tail runs.
F32_CERT_FLOOR = 3e-7


def _project_duals(problem: LpProblem, A, y, z):
    """Clamp multipliers on infinite bounds (they send the dual objective
    to -inf; the reference's postsolve validator projects the same way,
    src/pslp_integration.cpp:499-580).  The y-residue is absorbed into z
    to preserve stationarity c - A'y - z."""
    y_proj = y.copy()
    y_proj[np.isinf(problem.AL) & (y_proj > 0)] = 0.0
    y_proj[np.isinf(problem.AU) & (y_proj < 0)] = 0.0
    if not np.array_equal(y_proj, y):
        z = z + A.T @ (y - y_proj)
        y = y_proj
    z = z.copy()
    z[np.isinf(problem.l) & (z > 0)] = 0.0
    z[np.isinf(problem.u) & (z < 0)] = 0.0
    return y, z


def solve_refined(problem: LpProblem, params: Parameters,
                  x0=None, y0=None) -> Results:
    from .loop import solve_problem

    import os as _os
    import sys as _sys

    target = params.stop_tol
    t_start = time.perf_counter()
    # HPRLP_REFINE_LOG=1: stage lines even on quiet solves (stderr) —
    # quiet mode is much faster (128-chunk dispatches), so this is how
    # stage progressions are watched in practice.
    if params.verbose:
        log = print
    elif _os.environ.get("HPRLP_REFINE_LOG"):
        log = lambda *a, **k: print(*a, file=_sys.stderr, flush=True, **k)
    else:
        log = lambda *a, **k: None

    f64_stages = params.refine_stage_precision == "f64"
    stage_params = copy.copy(params)
    stage_params.precision = "f64" if f64_stages else "f32"
    stage_params.use_presolve = False  # applied upstream by the caller
    if f64_stages:
        # f64 stages aim straight at the target: well-behaved instances
        # finish in stage 0 exactly like a direct f64 solve; degenerate
        # ones plateau and hand over to a zoomed stage.  The stall window must outlast the slow marginal
        # new-bests observed on the transport plateau (~15k iterations
        # apart at 0.7x steps).
        stage_params.stop_tol = target
        if stage_params.stall_window is None:
            stage_params.stall_window = max(9000, 60 * params.check_iter)
        stage_params.max_iter = min(params.max_iter, 75_000)
    else:
        stage_params.stop_tol = max(params.refine_stage_tol, target)
        # A stage that plateaus at its f32 round-off floor should hand
        # over to the next refinement stage, not run to ITER_LIMIT.
        if stage_params.stall_window is None:
            stage_params.stall_window = max(3000, 20 * params.check_iter)

    A = problem.A
    x = np.zeros(problem.n)
    y = np.zeros(problem.m)
    z = np.zeros(problem.n)

    out = Results()
    best = None  # (kkt, x, y, z, metrics)
    total_iter = 0
    # Algorithm clock: sum of the stages'/tail's own solve clocks (each
    # excludes setup/scaling/autotune/power/compile, reference parity
    # src/HPRLP.cu:141-178).  Wall time still governs the time budget;
    # out.time reports this clock so refined solves stay comparable to
    # direct ones (a stage's setup+compile was inflating solve_time 0.3
    # -> 16 s on assignment128).
    alg_time = 0.0
    restarts = 0
    retries = 0  # consecutive regressed f64 stages (zoom damping)
    last_sub_sigma = 0.0
    first = {1e-4: True, 1e-6: True, 1e-8: True}
    res = None

    def note_milestones(kkt, t_now):
        for tol, (ai, at) in ((1e-4, ("iter4", "time4")),
                              (1e-6, ("iter6", "time6")),
                              (1e-8, ("iter8", "time8"))):
            if first[tol] and kkt < tol:
                setattr(out, ai, total_iter)
                setattr(out, at, t_now)
                first[tol] = False

    for stage in range(max(1, params.refine_max_stages)):
        budget = params.time_limit - (time.perf_counter() - t_start)
        if budget <= 0:
            break
        stage_params.time_limit = budget

        if stage == 0:
            res = solve_problem(problem, stage_params, x0=x0, y0=y0)
            if res.x is None:
                return res  # ERROR surface unchanged
            x, y, z = res.x, res.y, res.z
            sigma_main = res.sigma_final  # same problem/scaling as the tail
            zoom = 1.0
        else:
            kkt_prev = best[0]
            # retries > 0: a previous stage at full zoom REGRESSED — the
            # incumbent was restored below; damp the zoom exponent
            # (sqrt, then 4th root) so the gentler sub stays solvable
            # (measured: staircase stage 2 at zoom 4.5e6 regressed
            # 2.2e-8 -> 8.5e-8 where stage 1's ~100x-per-stage gain
            # pattern suggests zoom ~2e3 suffices).
            zoom = min(params.refine_zoom_cap,
                       max(1.0, (0.1 / max(kkt_prev, 1e-300))
                           ** (0.5 ** retries)))
            Ax = A @ x
            # NOTE (round-5 negative result, do not retry): a Gleixner-
            # style primal-DUAL sub (cost = zoom * (c - A'y - z), stitch
            # y += y_s/zoom) regressed immediately (transport stage 1:
            # 1e-5 -> 5.2e-6 stall vs 7.2e-8 with this form) — the
            # stitched duals lose the sign/complementarity structure the
            # box-support dual objective needs.  Same conclusion as the
            # round-2 measurement that rejected the textbook reduced-
            # cost objective for the f32 stages.
            sub = LpProblem.from_arrays(
                A,
                zoom * (problem.AL - Ax), zoom * (problem.AU - Ax),
                zoom * (problem.l - x), zoom * (problem.u - x),
                problem.c)
            # f64 stages warm-start the sub's DUAL at the incumbent y:
            # the sub shares the parent's dual geometry (cost unchanged),
            # and on degenerate instances a cold dual may never re-form
            # (measured: the multicommodity stage-1 sub stalls at
            # gap 0.3 cold vs 2.4e-3 y-warm — and stages compound, so a
            # mediocre warm stage still divides the true KKT by ~zoom).
            # Retries must change something MATERIAL: the scaling
            # pipeline normalises the zoom away, so a re-zoomed sub
            # alone re-solves bit-identically (measured: multicommodity
            # stages 2-4 at zooms 2.7e5/5.2e2/23 returned the same
            # kkt to 16 digits).  Retry 1 resumes the regressed sub's
            # ADAPTED sigma; retry 2 goes cold-dual.
            y0_stage = y if f64_stages else None
            sig0 = None
            if f64_stages and retries == 1 and last_sub_sigma:
                sig0 = last_sub_sigma
            elif f64_stages and retries >= 2:
                y0_stage = None
            res = solve_problem(sub, stage_params, y0=y0_stage,
                                sigma0=sig0)
            last_sub_sigma = res.sigma_final
            if res.x is None or res.status == "ERROR":
                break
            x = np.clip(x + res.x / zoom, problem.l, problem.u)
            # Cost unscaled => the sub's duals are original-scale duals.
            y, z = res.y, res.z
        # Reuse the tuned backend for later stages (same matrix).
        if res.spmv_backend and stage_params.spmv_backend == "auto":
            stage_params.spmv_backend = res.spmv_backend
        total_iter += res.iter
        restarts += res.restarts
        alg_time += res.time
        out.loop_compiles += res.loop_compiles
        out.setup_time += res.setup_time
        out.scaling_time += res.scaling_time
        out.power_time += res.power_time
        out.autotune_time += res.autotune_time

        if f64_stages:
            # Host-exact dual repair: at optimality stationarity defines
            # z given y (z = c - A'y); recomputing it in host f64 zeroes
            # err_Rd at the cost of an O(err_Rd) complementarity shift
            # that the gap term absorbs.  Measured need: the wholesale-
            # replaced sub duals' stationarity error (~7e-8 on
            # transport_1e-8) was the binding KKT component after the
            # zoom stages had driven Rp to 5e-10 and the gap to 1.2e-8.
            z = problem.c - A.T @ y
        y, z = _project_duals(problem, A, y, z)
        metrics = problem.kkt_error(x, y, z)
        kkt = metrics["kkt"]
        log(f"[refine] stage {stage}: zoom={zoom:.1e} "
            f"stage_iter={res.iter} kkt={kkt:.3e} "
            f"(Rp={metrics['err_Rp']:.1e} Rd={metrics['err_Rd']:.1e} "
            f"gap={metrics['rel_gap']:.1e})")
        note_milestones(kkt, alg_time)

        # f64 stages taper more gently near the dual floor — keep
        # zooming while a stage still buys >= 10% (the f32 stages keep
        # the stricter 2x bar: their stages are much costlier relative
        # to progress).
        stall_factor = 0.9 if f64_stages else 0.5
        stalled = (best is not None and stage > 0
                   and kkt > stall_factor * best[0])
        if best is None or kkt < best[0]:
            best = (kkt, x.copy(), y.copy(), z.copy(), metrics)
            retries = 0
        if kkt < target:
            break
        if stalled and f64_stages and retries < 2:
            # Restore the incumbent (the regressed point must not seed
            # the next sub's residuals) and retry at a damped zoom.
            retries += 1
            _, x, y, z, _ = best
            x, y, z = x.copy(), y.copy(), z.copy()
            continue
        if stalled:
            break
        if not f64_stages and best[0] < F32_CERT_FLOOR:
            break  # below what f32 stages can certify; tail decides

    if best is None:
        # Time budget expired before the first stage finished.
        out.status = "TIME_LIMIT" if res is None else res.status
        out.time = alg_time
        if res is not None and res.x is not None:
            out.x, out.y, out.z = res.x, res.y, res.z
            out.iter = res.iter
            out.residuals = res.residuals
            out.primal_obj = res.primal_obj
            out.dual_obj = res.dual_obj
            out.gap = res.gap
        return out

    def terminal_status(last_status):
        """Status when the TARGET tolerance was not met: a stage's own
        OPTIMAL (it only certifies the stage tolerance) must not leak to
        the caller as OPTIMAL-at-target."""
        if time.perf_counter() - t_start >= params.time_limit:
            return "TIME_LIMIT"
        if last_status in ("OPTIMAL", "STALLED"):
            return "STALLED"
        return last_status  # ITER_LIMIT / TIME_LIMIT / ERROR

    kkt, x, y, z, metrics = best
    status = "OPTIMAL" if kkt < target else terminal_status(res.status)

    if kkt >= target and not f64_stages:
        # f64 tail.  Attempt 1 warm-starts at the refined point with the
        # stage's sigma — on well-behaved instances the tail then needs a
        # few hundred iterations.  On DEGENERATE instances the warm start
        # is actively harmful (measured on the assignment-128 LP: warm
        # tail stalls at 6.5e-8 for 500k iterations while a cold f64
        # solve converges in 1350), so the warm attempt runs with stall
        # detection and a stalled/failed tail falls back to a COLD f64
        # solve.  The two attempts share compiled programs (same shapes).
        tail_params = copy.copy(params)
        tail_params.precision = "f64"
        tail_params.use_presolve = False
        # A PRODUCTIVE warm tail converges within a few hundred
        # iterations; a tail that has made no new best for 10 checkpoints
        # is the degenerate-stall case and should fall back to cold.
        tail_params.stall_window = max(1500, 10 * params.check_iter)
        # Reuse the stage's tuned backend instead of re-probing.
        if stage_params.spmv_backend != "auto":
            tail_params.spmv_backend = stage_params.spmv_backend
        for attempt, (xw, yw) in enumerate(((x, y), (None, None))):
            budget = params.time_limit - (time.perf_counter() - t_start)
            if budget <= 0:
                break
            tail_params.time_limit = budget
            if attempt == 1:
                tail_params.stall_window = None
            log(f"[refine] f64 tail ({'warm' if attempt == 0 else 'cold'})"
                f" from kkt={kkt:.3e}")
            res_t = solve_problem(problem, tail_params, x0=xw, y0=yw,
                                  sigma0=sigma_main or None)
            if res_t.x is None:
                break
            total_iter += res_t.iter
            restarts += res_t.restarts
            alg_time += res_t.time
            out.loop_compiles += res_t.loop_compiles
            yt, zt = _project_duals(problem, A, res_t.y, res_t.z)
            mt = problem.kkt_error(res_t.x, yt, zt)
            note_milestones(mt["kkt"], alg_time)
            if mt["kkt"] < kkt:
                kkt, x, y, z, metrics = (mt["kkt"], res_t.x, yt, zt, mt)
            status = ("OPTIMAL" if kkt < target
                      else terminal_status(res_t.status))
            if kkt < target:
                break

    out.status = status
    out.iter = total_iter
    out.time = alg_time
    out.x, out.y, out.z = x, y, z
    out.primal_obj = metrics["primal_obj"]
    out.dual_obj = metrics["dual_obj"]
    out.gap = metrics["rel_gap"]
    out.residuals = kkt
    out.spmv_backend = res.spmv_backend if res is not None else ""
    out.restarts = restarts
    if res is not None:
        out.setup_time = res.setup_time
        out.scaling_time = res.scaling_time
        out.power_time = res.power_time
        out.autotune_time = res.autotune_time
    return out
