"""Solve results.

API parity with the reference HPRLP_results / HPRLP_batched_results
(reference: include/structs.h:44-90).  Milestone metrics time4/6/8 and
iter4/6/8 follow the reference's semantics (src/HPRLP.cu:220-253): first
iteration/time at which the relative KKT error drops below 1e-4/1e-6/1e-8,
backfilled with the final iter/time if never reached.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class Results:
    status: str = "ERROR"
    iter: int = 0
    time: float = 0.0
    primal_obj: float = 0.0
    dual_obj: float = 0.0
    residuals: float = float("inf")
    gap: float = float("inf")

    # Milestones (0.0 / 0 means "backfilled with final" per reference).
    time4: float = 0.0
    time6: float = 0.0
    time8: float = 0.0
    iter4: int = 0
    iter6: int = 0
    iter8: int = 0

    # Solution vectors in the ORIGINAL problem space.
    x: Optional[np.ndarray] = None
    y: Optional[np.ndarray] = None
    z: Optional[np.ndarray] = None

    # Timing breakdown (reference prints these; batched results store them,
    # include/structs.h:86-89).
    setup_time: float = 0.0
    scaling_time: float = 0.0
    power_time: float = 0.0
    autotune_time: float = 0.0
    # Host presolve wall (the reference reports PSLP time on stdout only).
    presolve_time: float = 0.0

    # Restart statistics (reference HPRLP_restart counters).
    restarts: int = 0
    # Stall-recovery interventions fired (no reference counterpart,
    # Parameters.stall_recovery; always 0 on converging solves).
    stall_recoveries: int = 0

    # SpMV backend the solve ran on (gather / dense) — autotune
    # outcome, useful for asserting the fast path was kept (e.g. under a
    # device mesh).
    spmv_backend: str = ""

    # XLA backend compiles that ran inside the iteration loop (the
    # reference's loop compiles nothing; 0 is expected here too).
    loop_compiles: int = 0

    # Final sigma in the SCALED space (no reference counterpart: enables
    # warm restarts to resume sigma adaptation via solve_problem(sigma0=...)
    # instead of re-deriving it from ||b||/||c||).
    sigma_final: float = 0.0


    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        for k in ("x", "y", "z"):
            if d[k] is not None:
                d[k] = np.asarray(d[k])
        return d


@dataclasses.dataclass
class BatchedResults:
    """Results of a batched shared-A solve (reference: structs.h:68-90).

    x/z have shape (n, batch), y has shape (m, batch) — column-major layout
    parity with the reference (batched_solver.cu:887-935).
    """

    m: int = 0
    n: int = 0
    batch_size: int = 0
    x: Optional[np.ndarray] = None
    y: Optional[np.ndarray] = None
    z: Optional[np.ndarray] = None
    primal_obj: Optional[np.ndarray] = None
    residuals: Optional[np.ndarray] = None
    gap: Optional[np.ndarray] = None
    iter: Optional[np.ndarray] = None
    status: Optional[list] = None

    time: float = 0.0
    setup_time: float = 0.0
    solve_time: float = 0.0
    power_time: float = 0.0

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)
