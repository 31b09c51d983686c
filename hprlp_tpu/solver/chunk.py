"""The jit-compiled hot path: Halpern Peaceman-Rachford iteration chunks.

Replacement for the reference's CUDA-Graph-captured iteration
pair + batched device reductions (reference: src/HPRLP.cu:99-114 graph
capture, src/cuda_kernels/HPR_cuda_kernels.cu:203-295 zx/y update kernels,
src/main_iterate.cu:229-309 compute_residuals): the whole stretch of
iterations between two residual checks is ONE jitted function containing a
lax.fori_loop, so there is no host round-trip at all inside a chunk, and
exactly one device->host fetch of a dozen scalars per chunk boundary
(parity with the reference's single 10-slot fetch, utils.cu:53-69).

One HPR iteration (reference kernels :229-295):
    x/z half:  ATy   = A^T y
               z_tmp = x + sigma (ATy - c)
               x_bar = clip(z_tmp, l, u)          [z_bar = (x_bar - z_tmp)/sigma]
               x_hat = 2 x_bar - x
               x     = fact2 x_hat + fact1 last_x
    y half:    Ax    = A x_hat
               v     = Ax - lambda*sigma*y
               d     = max(AL - v, min(AU - v, 0))
               y_bar = d / (lambda*sigma)         [y_obj = v + d]
               y_hat = 2 y_bar - y
               y     = fact2 y_hat + fact1 last_y
    fact1 = 1/(k+2), fact2 = 1 - fact1, k = iterations since restart
    (reference: HPR_cuda_kernels.cu:192-200 advance_halpern_factors).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp

from ..ops.device_problem import LpDevice
from ..ops.sparse import spmv
from .scaling import ScalingInfo

# Full-precision reductions: on GPUs an f32 dot may otherwise run in TF32.
_dot = functools.partial(jnp.dot, precision=jax.lax.Precision.HIGHEST)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SolverState:
    """Device iterate state (parity: HPRLP_workspace_gpu vector fields,
    include/structs.h:127-152)."""

    x: jax.Array  # (n,)
    y: jax.Array  # (m,)
    last_x: jax.Array  # Halpern anchor (point at last restart)
    last_y: jax.Array
    # Candidate solution from the last check step (PR midpoints).
    x_bar: jax.Array
    y_bar: jax.Array
    z_bar: jax.Array
    y_obj: jax.Array  # v + d: dual-objective support vector
    inner: jax.Array  # int32 scalar: iterations since last restart


def init_state(lp: LpDevice) -> SolverState:
    dtype = lp.c.dtype
    zn = jnp.zeros(lp.n, dtype)
    zm = jnp.zeros(lp.m, dtype)
    return SolverState(x=zn, y=zm, last_x=zn, last_y=zm, x_bar=zn, y_bar=zm,
                       z_bar=zn, y_obj=zm, inner=jnp.asarray(0, jnp.int32))


def _halpern_factors(inner, dtype):
    fact1 = (1.0 / (inner.astype(dtype) + 2.0)).astype(dtype)
    return fact1, 1.0 - fact1


def _x_half(lp, x, y, last_x, sigma, fact1, fact2):
    ATy = spmv(lp.AT, y)
    z_tmp = x + sigma * (ATy - lp.c)
    x_bar = jnp.clip(z_tmp, lp.l, lp.u)
    x_hat = 2.0 * x_bar - x
    x_new = fact2 * x_hat + fact1 * last_x
    return x_new, x_hat, x_bar, z_tmp


def _y_half(lp, y, x_hat, last_y, lam_sigma, fact1, fact2):
    Ax = spmv(lp.A, x_hat)
    v = Ax - lam_sigma * y
    d = jnp.maximum(lp.AL - v, jnp.minimum(lp.AU - v, 0.0))
    y_bar = d / lam_sigma
    y_hat = 2.0 * y_bar - y
    y_new = fact2 * y_hat + fact1 * last_y
    return y_new, y_bar, v + d


def _fixed_point_gap_parts(lp, dx, dy):
    """Components of the M-weighted fixed-point residual
    sigma*lambda*||dy||^2 + ||dx||^2/sigma + 2<A dx, dy>  (reference:
    src/main_iterate.cu:486-515).  Returned raw so the host can apply the
    lambda_max negative-norm self-correction (:507-511)."""
    A_dx = spmv(lp.A, dx)
    return _dot(A_dx, dy), _dot(dy, dy), _dot(dx, dx)


def _residual_metrics(lp: LpDevice, scal: ScalingInfo, x_bar, y_bar, z_bar,
                      y_obj, dx, dy, last_x, last_y):
    """Original-space KKT residual ingredients (reference:
    src/main_iterate.cu:229-309 and residual kernels
    HPR_cuda_kernels.cu:160-189)."""
    Ax_bar = spmv(lp.A, x_bar)
    Rp = jnp.maximum(lp.AL - Ax_bar, jnp.minimum(lp.AU - Ax_bar, 0.0)) * scal.row_norm
    ATy_bar = spmv(lp.AT, y_bar)
    Rd = (lp.c - ATy_bar - z_bar) * scal.col_norm
    gap_dot, gap_dy2, gap_dx2 = _fixed_point_gap_parts(lp, dx, dy)
    # Bound violation of x_bar in original space (used at iteration 0 only,
    # reference: main_iterate.cu:264-289, kernel :174-180).
    viol = jnp.where(x_bar < lp.l, lp.l - x_bar,
                     jnp.where(x_bar > lp.u, x_bar - lp.u, 0.0))
    return {
        "dot_c_xbar": _dot(lp.c, x_bar),
        "dot_yobj_ybar": _dot(y_obj, y_bar),
        "dot_xbar_zbar": _dot(x_bar, z_bar),
        "nrm_Rd": jnp.linalg.norm(Rd),
        "nrm_Rp": jnp.linalg.norm(Rp),
        "gap_dot": gap_dot,
        "gap_dy2": gap_dy2,
        "gap_dx2": gap_dx2,
        "move_x": jnp.linalg.norm(x_bar - last_x),
        "move_y": jnp.linalg.norm(y_bar - last_y),
        "nrm_lu_viol": jnp.linalg.norm(viol / scal.col_norm),
    }


@jax.jit
def run_chunk(lp: LpDevice, scal: ScalingInfo, state: SolverState,
              sigma, lambda_max, restart_flag, n_iters):
    """Run n_iters (>= 2) HPR iterations and a residual check.

    restart_flag: bool scalar — apply the pending restart (anchor <- bars,
    iterate <- bars, inner <- 0; reference: src/main_iterate.cu:312-322)
    before iterating.  The first iteration's fixed-point gap components are
    returned so the host can set restart_info.last_gap exactly as the
    reference does after a restart (src/HPRLP.cu:305-307).

    Returns (new_state, metrics_dict_of_scalars).
    """
    dtype = lp.c.dtype
    sigma = jnp.asarray(sigma, dtype)
    lambda_max = jnp.asarray(lambda_max, dtype)
    lam_sigma = lambda_max * sigma

    x = jnp.where(restart_flag, state.x_bar, state.x)
    y = jnp.where(restart_flag, state.y_bar, state.y)
    last_x = jnp.where(restart_flag, state.x_bar, state.last_x)
    last_y = jnp.where(restart_flag, state.y_bar, state.last_y)
    inner = jnp.where(restart_flag, 0, state.inner)

    # --- first iteration (check-style: also produces bars for the
    # post-restart gap measurement) ---
    fact1, fact2 = _halpern_factors(inner, dtype)
    x1, x_hat, x_bar1, _ = _x_half(lp, x, y, last_x, sigma, fact1,
                                   fact2)
    y1, y_bar1, _ = _y_half(lp, y, x_hat, last_y, lam_sigma, fact1,
                            fact2)
    fs_dot, fs_dy2, fs_dx2 = _fixed_point_gap_parts(
        lp, x - x_bar1, y - y_bar1)
    inner = inner + 1

    # --- middle iterations: pure normal updates, zero host
    # involvement ---
    def body(_, carry):
        x, y, inner = carry
        f1, f2 = _halpern_factors(inner, dtype)
        x_new, x_hat, _, _ = _x_half(lp, x, y, last_x, sigma, f1, f2)
        y_new, _, _ = _y_half(lp, y, x_hat, last_y, lam_sigma, f1, f2)
        return x_new, y_new, inner + 1

    x2, y2, inner = jax.lax.fori_loop(1, n_iters - 1, body,
                                      (x1, y1, inner))

    # --- final iteration (check-style) ---
    f1, f2 = _halpern_factors(inner, dtype)
    x_f, x_hat, x_bar, z_tmp = _x_half(lp, x2, y2, last_x, sigma, f1,
                                       f2)
    z_bar = (x_bar - z_tmp) / sigma
    y_f, y_bar, y_obj = _y_half(lp, y2, x_hat, last_y, lam_sigma, f1,
                                f2)
    inner = inner + 1

    dx = x2 - x_bar
    dy = y2 - y_bar

    metrics = _residual_metrics(lp, scal, x_bar, y_bar, z_bar, y_obj, dx, dy,
                                last_x, last_y)
    metrics["fs_dot"] = fs_dot
    metrics["fs_dy2"] = fs_dy2
    metrics["fs_dx2"] = fs_dx2

    new_state = SolverState(x=x_f, y=y_f, last_x=last_x, last_y=last_y,
                            x_bar=x_bar, y_bar=y_bar, z_bar=z_bar,
                            y_obj=y_obj, inner=inner)
    return new_state, metrics


@jax.jit
def initial_metrics(lp: LpDevice, scal: ScalingInfo, state: SolverState):
    """Residual metrics of the initial (all-zero) bars — the reference
    computes residuals at iteration 0 before any update (src/HPRLP.cu:
    178-196 with iter=0)."""
    zn = jnp.zeros_like(state.x)
    zm = jnp.zeros_like(state.y)
    m = _residual_metrics(lp, scal, state.x_bar, state.y_bar, state.z_bar,
                          state.y_obj, zn, zm, state.last_x, state.last_y)
    m["fs_dot"] = jnp.asarray(0.0, zn.dtype)
    m["fs_dy2"] = jnp.asarray(0.0, zn.dtype)
    m["fs_dx2"] = jnp.asarray(0.0, zn.dtype)
    return m


@jax.jit
def unscale_solution(scal: ScalingInfo, state: SolverState):
    """Map the scaled bars back to the original space (reference:
    src/utils.cu:143-200 collect_solution):
        x = b_scale * x_bar / col_norm
        y = c_scale * y_bar / row_norm
        z = c_scale * z_bar * col_norm
    """
    x = scal.b_scale * state.x_bar / scal.col_norm
    y = scal.c_scale * state.y_bar / scal.row_norm
    z = scal.c_scale * state.z_bar * scal.col_norm
    return x, y, z
