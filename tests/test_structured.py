"""Structured-instance robustness: Netlib/Mittelmann-class problem
FAMILIES (transportation, staircase/multiperiod, assignment relaxation)
generated with verifiable optima — stand-ins for the real suites, which
need a network to fetch."""

import numpy as np
import pytest
import scipy.sparse as sp
from scipy.optimize import linprog

import hprlp_tpu as hp
from hprlp_tpu.params import Parameters


def transportation(ns, nd, seed=0):
    """min sum c_ij x_ij s.t. supply rows == s_i, demand cols == d_j."""
    rng = np.random.default_rng(seed)
    supply = rng.uniform(1.0, 3.0, ns)
    demand = rng.uniform(1.0, 3.0, nd)
    demand *= supply.sum() / demand.sum()
    cost = rng.uniform(1.0, 10.0, (ns, nd))
    n = ns * nd
    rows, cols, vals = [], [], []
    for i in range(ns):
        for j in range(nd):
            k = i * nd + j
            rows += [i, ns + j]
            cols += [k, k]
            vals += [1.0, 1.0]
    A = sp.coo_matrix((vals, (rows, cols)), shape=(ns + nd, n)).tocsr()
    b = np.concatenate([supply, demand])
    return (A, b, b, np.zeros(n), np.full(n, np.inf), cost.ravel())


def staircase(T, nx, seed=0):
    """Multiperiod production: x_t >= 0, inventory balance couples
    consecutive periods (classic staircase structure)."""
    rng = np.random.default_rng(seed)
    n = T * nx
    demand = rng.uniform(0.5, 1.5, T)
    cost = rng.uniform(1.0, 2.0, n)
    rows, cols, vals = [], [], []
    # Period t: sum_t(x) - inv_slack... encode: sum of period-t vars plus
    # carry from t-1 >= demand_t (carry = 30% of previous period output).
    for t in range(T):
        for k in range(nx):
            rows.append(t)
            cols.append(t * nx + k)
            vals.append(1.0)
            if t + 1 < T:
                rows.append(t + 1)
                cols.append(t * nx + k)
                vals.append(0.3)
    A = sp.coo_matrix((vals, (rows, cols)), shape=(T, n)).tocsr()
    return (A, demand, np.full(T, np.inf), np.zeros(n),
            np.full(n, 10.0), cost)


def _reference_opt(A, AL, AU, l, u, c):
    ub_rows = np.isfinite(AU)
    lb_rows = np.isfinite(AL)
    A_ub = sp.vstack([A[ub_rows], -A[lb_rows]])
    b_ub = np.concatenate([AU[ub_rows], -AL[lb_rows]])
    res = linprog(c, A_ub=A_ub, b_ub=b_ub,
                  bounds=list(zip(l, np.where(np.isinf(u), None, u))),
                  method="highs")
    return res


@pytest.mark.parametrize("ns,nd", [(8, 12), (15, 20)])
def test_transportation(ns, nd):
    A, AL, AU, l, u, c = transportation(ns, nd)
    # Equality rows: AL == AU == b.
    ref = _reference_opt(A, AL, AU, l, u, c)
    assert ref.status == 0
    res = hp.solve(A, AL, AU, l, u, c,
                   parameters=Parameters(verbose=False, stop_tol=1e-7))
    assert res.status == "OPTIMAL"
    assert res.primal_obj == pytest.approx(ref.fun, rel=1e-4, abs=1e-4)


@pytest.mark.parametrize("T,nx", [(10, 6), (25, 4)])
def test_staircase(T, nx):
    A, AL, AU, l, u, c = staircase(T, nx)
    ref = _reference_opt(A, AL, AU, l, u, c)
    assert ref.status == 0
    res = hp.solve(A, AL, AU, l, u, c,
                   parameters=Parameters(verbose=False, stop_tol=1e-7))
    assert res.status == "OPTIMAL"
    assert res.primal_obj == pytest.approx(ref.fun, rel=1e-4, abs=1e-4)


def test_assignment_relaxation_exact_integrality():
    # LP relaxation of assignment is integral: permutation optimum.
    rng = np.random.default_rng(3)
    k = 12
    cost = rng.uniform(0, 1, (k, k))
    n = k * k
    rows, cols, vals = [], [], []
    for i in range(k):
        for j in range(k):
            t = i * k + j
            rows += [i, k + j]
            cols += [t, t]
            vals += [1.0, 1.0]
    A = sp.coo_matrix((vals, (rows, cols)), shape=(2 * k, n)).tocsr()
    b = np.ones(2 * k)
    res = hp.solve(A, b, b, np.zeros(n), np.ones(n), cost.ravel(),
                   parameters=Parameters(verbose=False, stop_tol=1e-8,
                                         precision="f64"))
    assert res.status == "OPTIMAL"
    from scipy.optimize import linear_sum_assignment

    ri, ci = linear_sum_assignment(cost)
    assert res.primal_obj == pytest.approx(cost[ri, ci].sum(), abs=1e-5)


def test_multicommodity():
    """Benchmark-scale generator (benchmarks/run.py::multicommodity_lp) at
    a small size: K-commodity grid flow optimum matches scipy/HiGHS."""
    import os
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir,
                                    "benchmarks"))
    from run import multicommodity_lp

    p = multicommodity_lp(6, 3)
    ref = _reference_opt_eq(p.A.tocsr(), p.AL, p.AU, p.l, p.u, p.c)
    assert ref.status == 0
    res = hp.solve(p.A, p.AL, p.AU, p.l, p.u, p.c,
                   parameters=Parameters(verbose=False, stop_tol=1e-7))
    assert res.status == "OPTIMAL"
    assert res.primal_obj == pytest.approx(ref.fun, rel=1e-4, abs=1e-4)


def _reference_opt_eq(A, AL, AU, l, u, c):
    eq = np.isfinite(AL) & np.isfinite(AU) & (AL == AU)
    ub = np.isfinite(AU) & ~eq
    lb = np.isfinite(AL) & ~eq
    return linprog(
        c,
        A_ub=sp.vstack([A[ub], -A[lb]]),
        b_ub=np.concatenate([AU[ub], -AL[lb]]),
        A_eq=A[eq] if eq.any() else None,
        b_eq=AL[eq] if eq.any() else None,
        bounds=list(zip(l, [None if np.isinf(x) else x for x in u])),
        method="highs")


@pytest.mark.parametrize("family", ["transport", "staircase",
                                    "multicommodity"])
def test_direct_f64_1e8_matches_highs(family):
    """precision="f64" (native f64 end to end, what the GPU's refinement
    stages run) reaches 1e-8 on the structured benchmark families; the
    host-f64 KKT certifies it and the objective matches HiGHS."""
    import os
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir,
                                    "benchmarks"))
    from run import multicommodity_lp, staircase_lp, transportation_lp

    p = {"transport": lambda: transportation_lp(10, 14, 7),
         "staircase": lambda: staircase_lp(24, 6, 8),
         "multicommodity": lambda: multicommodity_lp(5, 2, 9)}[family]()
    ref = _reference_opt_eq(p.A.tocsr(), p.AL, p.AU, p.l, p.u, p.c)
    assert ref.status == 0
    res = hp.Model(p).solve(Parameters(verbose=False, stop_tol=1e-8,
                                       precision="f64"))
    assert res.status == "OPTIMAL"
    assert p.kkt_error(res.x, res.y, res.z)["kkt"] < 1e-8
    assert res.primal_obj == pytest.approx(ref.fun, rel=1e-6, abs=1e-6)
