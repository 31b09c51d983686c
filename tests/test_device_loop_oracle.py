"""Property test: the device-resident restart/sigma decision logic
(solver/device_loop._decide_and_update, branch-free jnp) must match a
sequential host-side transcription of the reference semantics
(reference: src/main_iterate.cu:324-404 check_restart/update_sigma,
:486-515 compute_weighted_norm) over random metric sequences.

The host oracle below is the readable, branchy version of the state
machine; the device version is the riskiest ported logic in the solver
so it gets an explicit equivalence check here.
"""

from __future__ import annotations

import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest

from hprlp_tpu.solver.device_loop import (RestartDev, _decide_and_update,
                                          _m_norm_dev, init_restart_dev)
from hprlp_tpu.solver.scaling import ScalingInfo

CHECK = 150


# ---------------------------------------------------------------------------
# Host oracle: sequential transcription of the reference state machine.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class HostRestart:
    first_restart: bool = True
    last_gap: float = math.inf
    current_gap: float = math.inf
    save_gap: float = math.inf
    best_gap: float = math.inf
    best_sigma: float = 1.0
    inner: float = 0.0
    times: int = 0


def host_m_norm(sigma, lam, dot, dy2, dx2):
    """Reference: src/main_iterate.cu:486-515 with the negative-norm
    lambda_max self-correction (:507-511)."""
    dot2 = 2.0 * dot
    w = sigma * lam * dy2 + dx2 / sigma + dot2
    if w < 0:
        if sigma * dy2 > 0:
            lam = -(dot2 + dx2 / sigma) / (sigma * dy2) * 1.05
        return math.sqrt(max(-(dot2 + dx2 / sigma) * 0.05, 0.0)), lam
    return math.sqrt(w), lam


def host_residuals(m, scal, obj_constant, is_iter0):
    """Reference: src/main_iterate.cu:229-309 original-space errors."""
    obj_scale = scal["b_scale"] * scal["c_scale"]
    p_obj = obj_scale * m["dot_c_xbar"] + obj_constant
    d_obj = obj_scale * (m["dot_yobj_ybar"] + m["dot_xbar_zbar"]) + obj_constant
    rel_gap = abs(p_obj - d_obj) / (1.0 + abs(p_obj) + abs(d_obj))
    err_Rd = scal["c_scale"] * m["nrm_Rd"] / scal["norm_c_org"]
    err_Rp = scal["b_scale"] * m["nrm_Rp"] / scal["norm_b_org"]
    if is_iter0:
        err_Rp = max(err_Rp, scal["b_scale"] * m["nrm_lu_viol"])
    return err_Rp, err_Rd, rel_gap


def host_decide(ri: HostRestart, sigma, lam, m_prev, scal, obj_constant,
                it):
    """check_restart + update_sigma, sequential (reference:
    src/main_iterate.cu:324-404).  Returns (sigma, lam, flag)."""
    err_Rp, err_Rd, rel_gap = host_residuals(m_prev, scal, obj_constant,
                                             it == 0)
    if it > 0:
        cg, lam = host_m_norm(sigma, lam, m_prev["gap_dot"],
                              m_prev["gap_dy2"], m_prev["gap_dx2"])
    else:
        cg = ri.current_gap

    flag = False
    if ri.first_restart:
        ri.current_gap = cg
        if it >= CHECK:
            ri.first_restart = False
            flag = True
            ri.best_gap = cg
            ri.best_sigma = sigma
    else:
        if cg < 0:
            cg = 1e-6
        ri.current_gap = cg
        if cg <= 0.2 * ri.last_gap:
            flag = True
        if cg <= 0.6 * ri.last_gap and cg > ri.save_gap:
            flag = True
        if ri.inner >= 0.2 * it:
            flag = True
        if ri.best_gap > cg:
            ri.best_gap = cg
            ri.best_sigma = sigma
        ri.save_gap = cg

    if flag:
        pm, dm = m_prev["move_x"], m_prev["move_y"]
        if 1e-16 < pm < 1e12 and 1e-16 < dm < 1e12:
            ratio = (pm / dm) / math.sqrt(lam)
            fact = math.exp(-0.05 * (ri.current_gap / ri.best_gap))
            temp1 = max(min(err_Rd, err_Rp), min(rel_gap, ri.current_gap))
            sigma_cand = math.exp(fact * math.log(ratio)
                                  + (1 - fact) * math.log(ri.best_sigma))
            if temp1 > 9e-10:
                kappa = 1.0
            elif temp1 > 5e-10:
                r_inf = err_Rd / err_Rp if err_Rp > 0 else 1.0
                kappa = max(min(math.sqrt(r_inf), 100.0), 1e-2)
            else:
                r_inf = err_Rd / err_Rp if err_Rp > 0 else 1.0
                kappa = max(min(r_inf, 100.0), 1e-2)
            sigma = kappa * sigma_cand
        else:
            # Degenerate movement keeps the best-merit sigma (deviation
            # from the reference's 1.0-reset; see device_loop.py).
            sigma = ri.best_sigma
        ri.save_gap = math.inf
        ri.inner = 0.0
        ri.times += 1
    return sigma, lam, flag


# ---------------------------------------------------------------------------
# Random metric sequences.
# ---------------------------------------------------------------------------

def random_metrics(rng, decaying_scale, tiny_residuals=False):
    """A plausible chunk-boundary metrics dict (all host floats)."""
    s = decaying_scale
    res_scale = 1e-10 if tiny_residuals else s
    dy2 = float(rng.lognormal(0, 1)) * s * s
    dx2 = float(rng.lognormal(0, 1)) * s * s
    # gap_dot occasionally strongly negative to exercise the negative-norm
    # lambda self-correction branch.
    sign = -1.0 if rng.random() < 0.3 else 1.0
    dot = sign * float(rng.lognormal(0, 1)) * s * s * (
        3.0 if sign < 0 else 0.3)
    return {
        "dot_c_xbar": float(rng.normal(0, 1)),
        "dot_yobj_ybar": float(rng.normal(0, 1)),
        "dot_xbar_zbar": float(rng.normal(0, 1)),
        "nrm_Rd": float(rng.lognormal(0, 1)) * res_scale,
        "nrm_Rp": float(rng.lognormal(0, 1)) * res_scale,
        "gap_dot": dot,
        "gap_dy2": dy2,
        "gap_dx2": dx2,
        # move_x occasionally EXACTLY zero: a vertex-pinned f32 primal
        # iterate produces this at every restart (degenerate-sigma branch).
        "move_x": (0.0 if rng.random() < 0.15
                   else float(rng.lognormal(0, 2)) * s),
        "move_y": float(rng.lognormal(0, 2)) * s,
        "nrm_lu_viol": float(rng.lognormal(0, 1)) * res_scale,
        "fs_dot": dot * 0.5,
        "fs_dy2": dy2 * 0.8,
        "fs_dx2": dx2 * 0.8,
    }


SCAL_HOST = {"b_scale": 1.37, "c_scale": 0.71, "norm_b_org": 5.3,
             "norm_c_org": 2.9}


def make_scal(dtype):
    z = jnp.zeros(4, dtype)
    return ScalingInfo(
        row_norm=z, col_norm=z,
        b_scale=jnp.asarray(SCAL_HOST["b_scale"], dtype),
        c_scale=jnp.asarray(SCAL_HOST["c_scale"], dtype),
        norm_b=jnp.asarray(1.0, dtype), norm_c=jnp.asarray(1.0, dtype),
        norm_b_org=jnp.asarray(SCAL_HOST["norm_b_org"], dtype),
        norm_c_org=jnp.asarray(SCAL_HOST["norm_c_org"], dtype))


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("tiny", [False, True])
def test_device_decide_matches_host_oracle(seed, tiny):
    """Drive both state machines over 40 chunk boundaries and compare
    sigma, the restart flag, and every RestartDev field at each step.
    `tiny` drives residuals below the 9e-10/5e-10 kappa thresholds."""
    rng = np.random.default_rng(seed)
    dtype = jnp.float64
    obj_c = 0.25
    sigma0 = float(rng.lognormal(0, 0.5))
    lam0 = float(rng.lognormal(1, 0.5))

    scal = make_scal(dtype)
    rd = init_restart_dev(sigma0, dtype)
    hr = HostRestart(best_sigma=sigma0)

    sigma_d = jnp.asarray(sigma0, dtype)
    lam_d = jnp.asarray(lam0, dtype)
    sigma_h, lam_h = sigma0, lam0

    m_prev = random_metrics(rng, 1.0, tiny)
    it = 0
    for step in range(40):
        m_dev = {k: jnp.asarray(v, dtype) for k, v in m_prev.items()}
        rd, sigma_d, lam_d, flag_d = _decide_and_update(
            rd, sigma_d, lam_d, m_dev, scal, obj_c, it, CHECK, dtype)
        sigma_h, lam_h, flag_h = host_decide(
            hr, sigma_h, lam_h, m_prev, SCAL_HOST, obj_c, it)

        assert bool(flag_d) == flag_h, f"step {step}: flag mismatch"
        # sigma runs its exp/log chain in f32 on device — compare loosely.
        assert sigma_h == pytest.approx(float(sigma_d), rel=2e-3), \
            f"step {step}"
        assert lam_h == pytest.approx(float(lam_d), rel=1e-6)

        # Simulate the chunk: next boundary's metrics; post-chunk last_gap.
        scale = math.exp(-0.05 * step)
        m_next = random_metrics(rng, scale, tiny)
        if flag_h:
            lg_h, lam_h = host_m_norm(sigma_h, lam_h, m_next["fs_dot"],
                                      m_next["fs_dy2"], m_next["fs_dx2"])
            lg_d, lam_d = _m_norm_dev(sigma_d, lam_d,
                                      jnp.asarray(m_next["fs_dot"], dtype),
                                      jnp.asarray(m_next["fs_dy2"], dtype),
                                      jnp.asarray(m_next["fs_dx2"], dtype))
        else:
            lg_h, lg_d = hr.last_gap, rd.last_gap
        hr.last_gap = lg_h
        hr.inner += CHECK
        rd = dataclasses.replace(rd, last_gap=jnp.asarray(lg_d, dtype),
                                 inner=rd.inner + CHECK)

        def close(a, b):
            if math.isinf(b):
                return math.isinf(float(a))
            return float(a) == pytest.approx(b, rel=2e-3, abs=1e-300)

        assert close(rd.last_gap, hr.last_gap), f"step {step}: last_gap"
        assert close(rd.current_gap, hr.current_gap), f"step {step}"
        assert close(rd.save_gap, hr.save_gap), f"step {step}: save_gap"
        assert close(rd.best_gap, hr.best_gap), f"step {step}: best_gap"
        assert close(rd.best_sigma, hr.best_sigma), f"step {step}"
        assert bool(rd.first_restart) == hr.first_restart
        assert int(rd.times) == hr.times, f"step {step}: times"

        m_prev = m_next
        it += CHECK


# ---------------------------------------------------------------------------
# Batched decision logic must match the single-LP logic MEMBER-WISE.
# (Round-2 review: the batched copies had drifted from two single-path
# fixes — the best_sigma fallback on degenerate movement and the
# restart-gated lambda update.  The implementations now share
# device_loop._m_norm_dev/_residuals_core/_sigma_chain; this test pins
# the remaining vectorised glue to the scalar path.)
# ---------------------------------------------------------------------------

def test_batched_decide_matches_single_memberwise():
    from hprlp_tpu.solver.batched_device_loop import (
        _bdecide, init_batched_restart_dev)
    from hprlp_tpu.solver.device_loop import _decide_and_update

    B = 5
    dtype = jnp.float64
    rngs = [np.random.default_rng(100 + i) for i in range(B)]
    tiny = [False, True, False, True, False]
    obj_c = np.linspace(-0.5, 0.5, B)
    sigma0 = np.array([float(r.lognormal(0, 0.5)) for r in rngs])
    lam0 = np.array([float(r.lognormal(1, 0.5)) for r in rngs])

    scal = make_scal(dtype)
    b_scale = jnp.full(B, SCAL_HOST["b_scale"], dtype)
    c_scale = jnp.full(B, SCAL_HOST["c_scale"], dtype)
    nb = jnp.full(B, SCAL_HOST["norm_b_org"], dtype)
    nc = jnp.full(B, SCAL_HOST["norm_c_org"], dtype)

    # Batched state
    brd = init_batched_restart_dev(jnp.asarray(sigma0, dtype), dtype)
    bsig = jnp.asarray(sigma0, dtype)
    blam = jnp.asarray(lam0, dtype)
    active = jnp.ones(B, bool)
    # Per-member single-path state
    rds = [init_restart_dev(sigma0[i], dtype) for i in range(B)]
    sigs = [jnp.asarray(sigma0[i], dtype) for i in range(B)]
    lams = [jnp.asarray(lam0[i], dtype) for i in range(B)]

    metrics = [random_metrics(rngs[i], 1.0, tiny[i]) for i in range(B)]
    it = 0
    for step in range(40):
        m_b = {k: jnp.asarray([metrics[i][k] for i in range(B)], dtype)
               for k in metrics[0]}
        brd, bsig, blam, bflag, _ = _bdecide(
            brd, bsig, blam, active, m_b, b_scale, c_scale, nb, nc,
            jnp.asarray(obj_c, dtype), it, CHECK, dtype)

        scale = math.exp(-0.05 * step)
        m_next = [random_metrics(rngs[i], scale, tiny[i]) for i in range(B)]
        mn_b = {k: jnp.asarray([m_next[i][k] for i in range(B)], dtype)
                for k in m_next[0]}
        # Post-chunk bookkeeping exactly as run_batched_superchunk.body.
        lg, lam_fix = _m_norm_dev(bsig, blam, mn_b["fs_dot"],
                                  mn_b["fs_dy2"], mn_b["fs_dx2"])
        blam = jnp.where(bflag, lam_fix, blam)
        brd = dataclasses.replace(
            brd, last_gap=jnp.where(bflag, lg, brd.last_gap),
            inner=brd.inner + float(CHECK))

        for i in range(B):
            m_d = {k: jnp.asarray(v, dtype) for k, v in metrics[i].items()}
            scal_i = dataclasses.replace(
                scal, b_scale=b_scale[i], c_scale=c_scale[i],
                norm_b_org=nb[i], norm_c_org=nc[i])
            rds[i], sigs[i], lams[i], flag_i = _decide_and_update(
                rds[i], sigs[i], lams[i], m_d, scal_i, obj_c[i], it,
                CHECK, dtype)
            assert bool(bflag[i]) == bool(flag_i), f"step {step} member {i}"
            np.testing.assert_allclose(float(bsig[i]), float(sigs[i]),
                                       rtol=1e-12, err_msg=f"{step}/{i}")
            mn_d = {k: jnp.asarray(v, dtype)
                    for k, v in m_next[i].items()}
            lg_i, lamfix_i = _m_norm_dev(sigs[i], lams[i], mn_d["fs_dot"],
                                         mn_d["fs_dy2"], mn_d["fs_dx2"])
            if bool(flag_i):
                lams[i] = lamfix_i
                rds[i] = dataclasses.replace(rds[i], last_gap=lg_i)
            rds[i] = dataclasses.replace(rds[i],
                                         inner=rds[i].inner + float(CHECK))
            np.testing.assert_allclose(float(blam[i]), float(lams[i]),
                                       rtol=1e-12, err_msg=f"{step}/{i}")
            for fld in ("last_gap", "current_gap", "save_gap", "best_gap",
                        "best_sigma"):
                a = float(getattr(brd, fld)[i])
                b = float(getattr(rds[i], fld))
                if math.isinf(b):
                    assert math.isinf(a), f"{step}/{i}: {fld}"
                else:
                    np.testing.assert_allclose(a, b, rtol=1e-12,
                                               err_msg=f"{step}/{i}: {fld}")
            assert int(brd.times[i]) == int(rds[i].times)

        metrics = m_next
        it += CHECK
