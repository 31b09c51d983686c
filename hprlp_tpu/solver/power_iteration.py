"""Power method for lambda_max(A A^T).

Behavioural parity with the reference (reference: src/power_iteration.cu:
20-119, called with max_iter=5000, tol=1e-4, and a 1.01 safety factor at
src/HPRLP.cu:86): normal random start (+1e-8), alternating A^T / A SpMVs,
convergence test every 10 iterations via ||z - lambda q||.  Runs as a single
jitted lax.while_loop on device.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..constants import (POWER_METHOD_CHECK_EVERY, POWER_METHOD_MAX_ITER,
                         POWER_METHOD_SEED, POWER_METHOD_TOL)
from ..ops.device_problem import LpDevice
from ..ops.sparse import spmv


@functools.partial(jax.jit, static_argnames=("max_iter",))
def power_method(lp: LpDevice, tol: float = POWER_METHOD_TOL,
                 max_iter: int = POWER_METHOD_MAX_ITER,
                 seed: int = POWER_METHOD_SEED) -> jax.Array:
    """Estimate lambda_max(A A^T) of the (scaled) matrix.  Returns the raw
    estimate; the caller applies the 1.01 safety factor."""
    m = lp.A.nrows
    dtype = lp.c.dtype
    key = jax.random.PRNGKey(seed)
    z0 = jax.random.normal(key, (m,), dtype) + 1e-8
    eps = jnp.finfo(dtype).eps
    # Full precision: on GPUs an f32 dot may otherwise run in TF32.
    dot = functools.partial(jnp.dot, precision=jax.lax.Precision.HIGHEST)

    def cond(carry):
        i, _, _, _, done = carry
        return jnp.logical_and(i <= max_iter, jnp.logical_not(done))

    def body(carry):
        i, z, lam, err, _ = carry
        q = z * jax.lax.rsqrt(dot(z, z) + eps)
        z_new = spmv(lp.A, spmv(lp.AT, q))
        check = (i % POWER_METHOD_CHECK_EVERY) == 0
        lam_new = jnp.where(check, dot(q, z_new), lam)
        err_new = jnp.where(check,
                            jnp.linalg.norm(z_new - lam_new * q), err)
        done = jnp.logical_and(check, err_new < tol)
        return i + 1, z_new, lam_new, err_new, done

    init = (jnp.asarray(1, jnp.int32), z0, jnp.asarray(1.0, dtype),
            jnp.asarray(jnp.inf, dtype), jnp.asarray(False))
    _, _, lam, _, _ = jax.lax.while_loop(cond, body, init)
    return lam
