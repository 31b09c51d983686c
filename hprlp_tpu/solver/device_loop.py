"""Device-resident restart/sigma control: many chunks per dispatch.

The reference keeps restart decisions on the host (src/main_iterate.cu:
324-404) with a device sync every check_iter iterations.  Here the whole
decision loop — M-norm merit with lambda self-correction, the
sufficient/necessary/long restart conditions, sigma re-estimation — runs
inside jit as a lax.scan over iteration chunks, so ONE dispatch advances
K * check_iter iterations (SURVEY §7.2 hard part 4: "host-free restart
decisions inside jit").  The host receives the stacked per-chunk scalars
afterwards for stopping/milestone bookkeeping and dispatches the next
super-chunk, so a checkpoint costs no host round-trip.

Semantics mirror solver/loop.py's host implementation exactly (same
conditions, same ordering: decide from the PREVIOUS chunk's metrics, then
iterate).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp

from .chunk import run_chunk

METRIC_KEYS = ("dot_c_xbar", "dot_yobj_ybar", "dot_xbar_zbar", "nrm_Rd",
               "nrm_Rp", "gap_dot", "gap_dy2", "gap_dx2", "move_x",
               "move_y", "nrm_lu_viol", "fs_dot", "fs_dy2", "fs_dx2")


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class RestartDev:
    """Device mirror of loop.RestartInfo (reference: HPRLP_restart,
    include/structs.h:215-228) plus the stall-recovery tracker (an
    addition with no reference counterpart, src/main_iterate.cu:367-404)."""

    first_restart: jax.Array  # bool
    last_gap: jax.Array
    current_gap: jax.Array
    save_gap: jax.Array
    best_gap: jax.Array
    best_sigma: jax.Array
    inner: jax.Array          # float (compared against 0.2 * it)
    times: jax.Array          # int32 restart count
    # Stall-recovery tracker (see run_superchunk): best KKT error seen at
    # any chunk boundary, checkpoints since it improved by >=3%, and the
    # number of recovery interventions fired (drives the sigma ladder).
    best_kkt: jax.Array       # float
    since_best: jax.Array     # int32 checkpoints
    stalls: jax.Array         # int32 interventions


def init_restart_dev(sigma, dtype) -> RestartDev:
    inf = jnp.asarray(jnp.inf, dtype)
    return RestartDev(
        first_restart=jnp.asarray(True),
        last_gap=inf, current_gap=inf, save_gap=inf, best_gap=inf,
        best_sigma=jnp.asarray(sigma, dtype),
        inner=jnp.asarray(0.0, dtype),
        times=jnp.asarray(0, jnp.int32),
        best_kkt=inf,
        since_best=jnp.asarray(0, jnp.int32),
        stalls=jnp.asarray(0, jnp.int32))


def _m_norm_dev(sigma, lam, dot, dy2, dx2):
    """jnp port of loop._m_norm (lambda self-correction included)."""
    dot2 = 2.0 * dot
    w = sigma * lam * dy2 + dx2 / sigma + dot2
    neg = w < 0
    lam_fix = jnp.where(neg & (sigma * dy2 > 0),
                        -(dot2 + dx2 / sigma)
                        / jnp.maximum(sigma * dy2, 1e-300) * 1.05, lam)
    norm = jnp.where(neg,
                     jnp.sqrt(jnp.maximum(-(dot2 + dx2 / sigma) * 0.05, 0.0)),
                     jnp.sqrt(jnp.maximum(w, 0.0)))
    return norm, lam_fix


def _residuals_core(m, b_scale, c_scale, norm_b_org, norm_c_org,
                    obj_constant, is_iter0):
    """Original-space KKT residual pieces.  Elementwise, so it serves both
    the single-LP path (scalars) and the batched path ((B,) vectors)."""
    obj_scale = b_scale * c_scale
    p_obj = obj_scale * m["dot_c_xbar"] + obj_constant
    d_obj = obj_scale * (m["dot_yobj_ybar"] + m["dot_xbar_zbar"]) + obj_constant
    rel_gap = jnp.abs(p_obj - d_obj) / (1.0 + jnp.abs(p_obj) + jnp.abs(d_obj))
    err_Rd = c_scale * m["nrm_Rd"] / norm_c_org
    err_Rp = b_scale * m["nrm_Rp"] / norm_b_org
    err_Rp = jnp.where(is_iter0,
                       jnp.maximum(err_Rp, b_scale * m["nrm_lu_viol"]),
                       err_Rp)
    return err_Rp, err_Rd, rel_gap


def _residuals_dev(m, scal, obj_constant, is_iter0):
    return _residuals_core(m, scal.b_scale, scal.c_scale, scal.norm_b_org,
                           scal.norm_c_org, obj_constant, is_iter0)


def _sigma_chain(m_prev, lam, current_gap, best_gap, best_sigma, err_Rp,
                 err_Rd, rel_gap, sigma, flag, dtype):
    """update_sigma (reference :367-404), shared by the single-LP and
    batched decision logic (elementwise: scalars or (B,) vectors).

    The exp/log chain runs in f32: sigma is a step-size heuristic, and
    f32 accuracy is ample for it.
    """
    f32 = jnp.float32
    pm, dm = m_prev["move_x"], m_prev["move_y"]
    ok = (pm > 1e-16) & (dm > 1e-16) & (pm < 1e12) & (dm < 1e12)
    ratio = ((pm / jnp.maximum(dm, 1e-300)) / jnp.sqrt(lam)).astype(f32)
    fact = jnp.exp((-0.05 * (current_gap
                             / jnp.maximum(best_gap, 1e-300))).astype(f32))
    temp1 = jnp.maximum(jnp.minimum(err_Rd, err_Rp),
                        jnp.minimum(rel_gap, current_gap))
    sigma_cand = jnp.exp(
        fact * jnp.log(jnp.maximum(ratio, 1e-30))
        + (1 - fact) * jnp.log(jnp.maximum(best_sigma.astype(f32), 1e-30)))
    ratio_inf = jnp.where(err_Rp > 0, err_Rd / jnp.maximum(err_Rp, 1e-300),
                          1.0).astype(f32)
    kappa = jnp.where(
        temp1 > 9e-10, jnp.asarray(1.0, f32),
        jnp.where(temp1 > 5e-10,
                  jnp.clip(jnp.sqrt(ratio_inf), 1e-2, 100.0),
                  jnp.clip(ratio_inf, 1e-2, 100.0)))
    # Degenerate movement: the reference resets sigma = 1.0
    # (main_iterate.cu:400-402), which is unreachable in practice in its
    # f64 build.  In f32 a vertex-pinned primal iterate makes move_x == 0
    # EXACTLY at every restart, and the 1.0-reset then destroys the
    # adapted sigma for the rest of the solve (observed: gap oscillating
    # at 1e-4 forever on the assignment LP).  Falling back to best_sigma
    # (the sigma at the best merit gap so far) keeps the adaptation.
    return jnp.where(flag,
                     jnp.where(ok, (kappa * sigma_cand).astype(dtype),
                               best_sigma.astype(dtype)),
                     sigma)


def _decide_and_update(rd: RestartDev, sigma, lam, m_prev, scal,
                       obj_constant, it, check_iter, dtype):
    """Port of check_restart + update_sigma (loop.py / reference
    main_iterate.cu:324-404), branch-free."""
    err_Rp, err_Rd, rel_gap = _residuals_dev(m_prev, scal, obj_constant,
                                             it == 0)
    cg, lam = jax.lax.cond(
        it > 0,
        lambda: _m_norm_dev(sigma, lam, m_prev["gap_dot"],
                            m_prev["gap_dy2"], m_prev["gap_dx2"]),
        lambda: (rd.current_gap, lam))

    # First restart (">=": the boundary may have been coarsened).
    fr = rd.first_restart & (it >= check_iter)
    est = jnp.logical_not(rd.first_restart)
    cg_est = jnp.where(cg < 0, 1e-6, cg)
    sufficient = est & (cg_est <= 0.2 * rd.last_gap)
    necessary = est & (cg_est <= 0.6 * rd.last_gap) & (cg_est > rd.save_gap)
    long_r = est & (rd.inner >= 0.2 * it)
    flag = fr | sufficient | necessary | long_r

    better = est & (rd.best_gap > cg_est)
    best_gap = jnp.where(fr, cg, jnp.where(better, cg_est, rd.best_gap))
    best_sigma = jnp.where(fr | better, sigma, rd.best_sigma)
    save_gap = jnp.where(est, cg_est, rd.save_gap)
    current_gap = jnp.where(est, cg_est, cg)

    sigma_new = _sigma_chain(m_prev, lam, current_gap, best_gap, best_sigma,
                             err_Rp, err_Rd, rel_gap, sigma, flag, dtype)

    rd_new = RestartDev(
        first_restart=rd.first_restart & jnp.logical_not(fr),
        last_gap=rd.last_gap,  # set after the chunk from fs_* parts
        current_gap=current_gap,
        save_gap=jnp.where(flag, jnp.asarray(jnp.inf, dtype), save_gap),
        best_gap=best_gap,
        best_sigma=best_sigma,
        inner=jnp.where(flag, jnp.asarray(0.0, dtype), rd.inner),
        times=rd.times + flag.astype(jnp.int32),
        best_kkt=rd.best_kkt, since_best=rd.since_best, stalls=rd.stalls)
    return rd_new, sigma_new, lam, flag


@functools.partial(jax.jit,
                   static_argnames=("n_chunks", "check_iter"))
def run_superchunk(lp, scal, state, rd: RestartDev, sigma, lambda_max,
                   metrics_prev, it0, obj_constant, stop_tol,
                   n_chunks: int, check_iter: int, stall_patience=0,
                   best=None):
    """Advance up to n_chunks * check_iter iterations with on-device
    restarts AND on-device stopping: the loop exits at the first chunk
    boundary whose relative KKT error is below stop_tol, so the returned
    state is exactly the first converged checkpoint (iterating past
    convergence can destabilise sigma).

    stall_patience (traced int, 0 = disabled): STALL RECOVERY, with no
    reference counterpart (src/main_iterate.cu:367-404): degenerate
    structured LPs (staircase/transport families at 1e-8) can land in a
    restart limit cycle when near-threshold restart decisions flip under
    rounding noise.  When the best KKT error has
    not improved by >=3% for `stall_patience` consecutive checkpoints,
    restore the candidate point to the BEST-KKT boundary seen so far
    (x_bar/y_bar kept on device) and force a restart from it with the
    sigma recorded at that boundary scaled by a BOUNDED alternating
    ladder (4^0, 4^-1, 4^+1, 4^-2, 4^+2, repeating) — the fresh restart
    timing knocks the trajectory off the cycle, the sigma sweep breaks
    re-entry, and because every intervention re-starts from the best
    point (a multi-start around the incumbent), interventions can never
    compound into divergence (an unbounded ladder measured kkt 8e-6 ->
    82 on transport_1e-8).  Dormant on converging solves: any 3%
    improvement re-arms the counter.

    best: the stall-recovery best-point dict returned by the previous
    dispatch (None initialises it from `state` — the best point must be
    threaded BETWEEN dispatches or recovery would restore to the
    dispatch-initial boundary instead of the global best).

    metrics_prev: the metrics dict from the previous chunk boundary (or
    initial_metrics at it0 == 0).  Returns (state, rd, sigma, lambda_max,
    m_last, stacked, k_done, best): stacked[k] holds the k-th chunk's
    metric values plus sigma/flag/stall for the host's milestone/print
    bookkeeping; only the first k_done entries are valid.
    """
    dtype = lp.c.dtype
    sigma = jnp.asarray(sigma, dtype)
    lambda_max = jnp.asarray(lambda_max, dtype)
    stop_tol = jnp.asarray(stop_tol, dtype)
    stall_patience = jnp.asarray(stall_patience, jnp.int32)
    buf = {k: jnp.zeros(n_chunks, dtype) for k in METRIC_KEYS}
    buf["sigma"] = jnp.zeros(n_chunks, dtype)
    buf["flag"] = jnp.zeros(n_chunks, jnp.int32)
    buf["stall"] = jnp.zeros(n_chunks, jnp.int32)

    def cond(carry):
        _, _, _, _, _, _, k, _, _, done = carry
        return (k < n_chunks) & jnp.logical_not(done)

    def body(carry):
        state, rd, sigma, lam, m_prev, it, k, buf, best, _ = carry
        rd, sigma, lam, flag = _decide_and_update(
            rd, sigma, lam, m_prev, scal, obj_constant, it, check_iter,
            dtype)
        # Stall recovery (docstring above): restore the bars to the
        # best-KKT boundary and force a restart from them with the
        # bounded sigma ladder.  Applied AFTER the normal decision so the
        # oracle-tested _decide_and_update semantics are untouched when
        # dormant.
        stall = (stall_patience > 0) & (rd.since_best >= stall_patience)
        j = rd.stalls % 5
        rung = ((j + 1) // 2) * (1 - 2 * (j % 2))  # 0,-1,+1,-2,+2
        sigma_rec = best["sigma"] * jnp.exp2(
            (2 * rung).astype(jnp.float32)).astype(dtype)
        sigma = jnp.where(stall, sigma_rec, sigma)
        state = dataclasses.replace(
            state,
            x_bar=jnp.where(stall, best["x_bar"], state.x_bar),
            y_bar=jnp.where(stall, best["y_bar"], state.y_bar))
        rd = dataclasses.replace(
            rd,
            save_gap=jnp.where(stall, jnp.asarray(jnp.inf, dtype),
                               rd.save_gap),
            inner=jnp.where(stall, jnp.asarray(0.0, dtype), rd.inner),
            times=rd.times + (stall & jnp.logical_not(flag)).astype(
                jnp.int32),
            stalls=rd.stalls + stall.astype(jnp.int32),
            since_best=jnp.where(stall, 0, rd.since_best))
        flag = flag | stall
        state, m = run_chunk(lp, scal, state, sigma, lam, flag,
                             jnp.asarray(check_iter, jnp.int32))
        lg, lam = jax.lax.cond(
            flag,
            lambda: _m_norm_dev(sigma, lam, m["fs_dot"], m["fs_dy2"],
                                m["fs_dx2"]),
            lambda: (rd.last_gap, lam))
        rd = dataclasses.replace(rd, last_gap=lg,
                                 inner=rd.inner + check_iter)
        it = it + check_iter
        buf = dict(buf)
        for key in METRIC_KEYS:
            buf[key] = buf[key].at[k].set(m[key].astype(dtype))
        buf["sigma"] = buf["sigma"].at[k].set(sigma)
        buf["flag"] = buf["flag"].at[k].set(flag.astype(jnp.int32))
        buf["stall"] = buf["stall"].at[k].set(stall.astype(jnp.int32))
        # Device-side stopping on the NEW boundary's relative KKT error
        # (same formula the host uses).
        err_Rp, err_Rd, rel_gap = _residuals_dev(m, scal, obj_constant,
                                                 False)
        kkt = jnp.maximum(jnp.maximum(err_Rp, err_Rd), rel_gap)
        # Stall tracker update on the NEW boundary: >=3% relative
        # improvement over the best KKT seen re-arms the patience
        # counter; ANY improvement refreshes the stored best point.
        improved = kkt < 0.97 * rd.best_kkt
        better = kkt < rd.best_kkt
        best2 = {
            "x_bar": jnp.where(better, state.x_bar, best["x_bar"]),
            "y_bar": jnp.where(better, state.y_bar, best["y_bar"]),
            "sigma": jnp.where(better, sigma, best["sigma"]),
        }
        rd = dataclasses.replace(
            rd, best_kkt=jnp.minimum(rd.best_kkt, kkt),
            since_best=jnp.where(improved, 0, rd.since_best + 1))
        return (state, rd, sigma, lam, m, it, k + 1, buf, best2,
                kkt < stop_tol)

    if best is None:
        best = {"x_bar": state.x_bar, "y_bar": state.y_bar,
                "sigma": sigma}
    init = (state, rd, sigma, lambda_max, metrics_prev,
            jnp.asarray(it0, jnp.int32), jnp.asarray(0, jnp.int32), buf,
            best, jnp.asarray(False))
    state, rd, sigma, lambda_max, m_last, _, k_done, buf, best, _ = \
        jax.lax.while_loop(cond, body, init)
    return state, rd, sigma, lambda_max, m_last, buf, k_done, best
