"""On-device scaling pipeline: Curtis-Reid -> Ruiz -> Pock-Chambolle -> b/c.

Behavioural parity with the reference scaling (reference: src/scaling.cu:
88-216, apply_curtis_reid_scaling :40-83), including its quirks:
  * row/col equilibration factors are the SQRT of the row inf-norm (Ruiz) or
    row 1-norm (Pock-Chambolle), clamped to 1 when < 1e-15
    (src/cuda_kernels/HPR_cuda_kernels.cu:91-120);
  * within each Ruiz/PC pass the column norms are measured BEFORE the row
    scaling of that pass is applied (src/scaling.cu:127-135 ordering);
  * Curtis-Reid runs 20 fixed alternating log-least-squares updates on the
    ORIGINAL values, then applies exp-clamped factors (:48-67);
  * norm_b_org / norm_c_org are 1 + ||.||_2 of the pre-scaling conceptual
    b = max(|AL|,|AU|) (inf->0) and c (:114-117);
  * b/c scaling divides AL,AU,l,u by b_scale = 1+||b||, c by c_scale = 1+||c||
    (:185-201).

Everything is jit-compiled jnp on the bucketed-ELL matrices; under a device
mesh the same code runs sharded (SPMD) without modification.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp

from ..constants import CURTIS_REID_ITERS, RUIZ_ITERS
from ..ops.device_problem import LpDevice
from ..ops.sparse import (row_inf_norms, row_masked_mean, row_one_norms,
                          scale_cols, scale_rows)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ScalingInfo:
    """Parity: Scaling_info (reference: include/structs.h:266-277)."""

    row_norm: jax.Array  # (m_pad,) accumulated row divisors of A
    col_norm: jax.Array  # (n_pad,)
    b_scale: jax.Array  # scalars
    c_scale: jax.Array
    norm_b: jax.Array
    norm_c: jax.Array
    norm_b_org: jax.Array
    norm_c_org: jax.Array


def conceptual_b(AL: jax.Array, AU: jax.Array) -> jax.Array:
    """max(|AL|, |AU|) with infinities mapped to 0 (reference:
    src/cuda_kernels/HPR_cuda_kernels.cu:34-43)."""
    a = jnp.where(jnp.isinf(AL), 0.0, jnp.abs(AL))
    b = jnp.where(jnp.isinf(AU), 0.0, jnp.abs(AU))
    return jnp.maximum(a, b)


def _sqrt_clamped(norms: jax.Array) -> jax.Array:
    s = jnp.sqrt(norms)
    return jnp.where(s < 1e-15, 1.0, s)


def scale_matrix(A, AT, use_cr: bool = True, use_ruiz: bool = True,
                 use_pc: bool = True):
    """Matrix-only scaling passes (CR -> Ruiz -> PC).

    Returns (A_scaled, AT_scaled, row_norm, col_norm) where the accumulated
    divisors satisfy A_scaled = diag(1/row_norm) A diag(1/col_norm).  The
    vector transformations are pure functions of these totals:
        AL/AU -> /row_norm,  c -> /col_norm,  l/u -> *col_norm
    (equivalent to the reference's per-pass interleaving, src/scaling.cu).
    The batched solver scales A once this way and the per-member dense
    vectors on the host (reference: src/batched_solver.cu:810-864).
    """
    dtype = A.dtype
    m, n = A.nrows, A.ncols
    row_norm = jnp.ones(m, dtype)
    col_norm = jnp.ones(n, dtype)

    if use_cr:
        # 20 alternating log-least-squares sweeps on the original values.
        def cr_step(_, carry):
            t1, t2 = carry
            t1 = row_masked_mean(
                A, lambda v, cols: -jnp.log(jnp.maximum(jnp.abs(v), 1e-300))
                - t2[cols])
            t2 = row_masked_mean(
                AT, lambda v, cols: -jnp.log(jnp.maximum(jnp.abs(v), 1e-300))
                - t1[cols])
            return t1, t2

        t1, t2 = jax.lax.fori_loop(
            0, CURTIS_REID_ITERS, cr_step,
            (jnp.zeros(m, dtype), jnp.zeros(n, dtype)))
        t1 = jnp.clip(jnp.exp(t1), 1e-30, 1e30)
        t2 = jnp.clip(jnp.exp(t2), 1e-30, 1e30)
        # CR multiplies A by the factors, so the accumulated divisors shrink.
        row_norm = row_norm / t1
        col_norm = col_norm / t2
        A = scale_cols(scale_rows(A, t1), t2)
        AT = scale_cols(scale_rows(AT, t2), t1)

    if use_ruiz:
        def ruiz_step(_, carry):
            A, AT, row_norm, col_norm = carry
            t1 = _sqrt_clamped(row_inf_norms(A))
            row_norm = row_norm * t1
            # Column norms measured before the row scaling is applied
            # (reference ordering, src/scaling.cu:127-144).
            t2 = _sqrt_clamped(row_inf_norms(AT))
            col_norm = col_norm * t2
            A = scale_cols(scale_rows(A, 1.0 / t1), 1.0 / t2)
            AT = scale_cols(scale_rows(AT, 1.0 / t2), 1.0 / t1)
            return A, AT, row_norm, col_norm

        A, AT, row_norm, col_norm = jax.lax.fori_loop(
            0, RUIZ_ITERS, ruiz_step, (A, AT, row_norm, col_norm))

    if use_pc:
        t1 = _sqrt_clamped(row_one_norms(A))
        row_norm = row_norm * t1
        t2 = _sqrt_clamped(row_one_norms(AT))
        col_norm = col_norm * t2
        A = scale_cols(scale_rows(A, 1.0 / t1), 1.0 / t2)
        AT = scale_cols(scale_rows(AT, 1.0 / t2), 1.0 / t1)

    return A, AT, row_norm, col_norm


# One jit per enabled matrix pass: staging lowers the peak of live
# intermediate buffers against a single fused CR + Ruiz + PC program.
# The batched path still traces scale_matrix as one program (shared-A
# batched matrices are far below this regime).
_cr_jit = jax.jit(lambda A, AT: scale_matrix(A, AT, True, False, False))
_ruiz_jit = jax.jit(lambda A, AT: scale_matrix(A, AT, False, True, False))
_pc_jit = jax.jit(lambda A, AT: scale_matrix(A, AT, False, False, True))


@functools.partial(jax.jit, static_argnames=("use_bc",))
def _scale_vectors(lp: LpDevice, A, AT, row_norm, col_norm,
                   use_bc: bool) -> tuple[LpDevice, ScalingInfo]:
    AL, AU, c, l, u = lp.AL, lp.AU, lp.c, lp.l, lp.u
    dtype = c.dtype

    norm_b_org = 1.0 + jnp.linalg.norm(conceptual_b(AL, AU))
    norm_c_org = 1.0 + jnp.linalg.norm(c)

    AL = AL / row_norm
    AU = AU / row_norm
    c = c / col_norm
    l = l * col_norm
    u = u * col_norm

    if use_bc:
        b_scale = 1.0 + jnp.linalg.norm(conceptual_b(AL, AU))
        c_scale = 1.0 + jnp.linalg.norm(c)
        AL = AL / b_scale
        AU = AU / b_scale
        l = l / b_scale
        u = u / b_scale
        c = c / c_scale
    else:
        b_scale = jnp.asarray(1.0, dtype)
        c_scale = jnp.asarray(1.0, dtype)

    norm_b = jnp.linalg.norm(conceptual_b(AL, AU))
    norm_c = jnp.linalg.norm(c)

    scaled = LpDevice(A=A, AT=AT, AL=AL, AU=AU, c=c, l=l, u=u)
    info = ScalingInfo(row_norm=row_norm, col_norm=col_norm,
                       b_scale=jnp.asarray(b_scale, dtype),
                       c_scale=jnp.asarray(c_scale, dtype),
                       norm_b=norm_b, norm_c=norm_c,
                       norm_b_org=jnp.asarray(norm_b_org, dtype),
                       norm_c_org=jnp.asarray(norm_c_org, dtype))
    return scaled, info


def scale_problem(lp: LpDevice, use_cr: bool = True, use_ruiz: bool = True,
                  use_pc: bool = True, use_bc: bool = True
                  ) -> tuple[LpDevice, ScalingInfo]:
    """Full scaling pipeline: staged jits (see note above _cr_jit) with
    the accumulated row/col divisors multiplied across stages (the
    per-stage internal accumulation order matches the fused reference
    pipeline; the cross-stage product only reassociates the final
    multiply)."""
    A, AT = lp.A, lp.AT
    dtype = lp.c.dtype
    row_norm = jnp.ones(A.nrows, dtype)
    col_norm = jnp.ones(A.ncols, dtype)
    for enabled, stage in ((use_cr, _cr_jit), (use_ruiz, _ruiz_jit),
                           (use_pc, _pc_jit)):
        if not enabled:
            continue
        A, AT, rn, cn = stage(A, AT)
        row_norm = row_norm * rn
        col_norm = col_norm * cn
    return _scale_vectors(lp, A, AT, row_norm, col_norm, use_bc)
