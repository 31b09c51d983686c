"""High-precision solves: precision="mixed" (f32 refinement stages +
warm-started f64 tail) reaches 1e-8 KKT from the fast f32 iterations;
precision="f64" runs native f64 end to end."""

import numpy as np
import scipy.sparse as sp

import hprlp_tpu as hp


def main():
    rng = np.random.default_rng(7)
    m, n = 300, 500
    A = sp.random(m, n, density=0.05, random_state=rng,
                  data_rvs=lambda k: rng.normal(size=k)).tocsr()
    x_feas = rng.uniform(-1.0, 1.0, n)
    Ax = A @ x_feas
    prob_args = (A, Ax - 1.0, Ax + 1.0, x_feas - 2.0, x_feas + 2.0,
                 rng.normal(size=n))

    res = hp.solve(*prob_args,
                   parameters=hp.Parameters(verbose=False, stop_tol=1e-8,
                                            precision="mixed"))
    print(f"mixed : {res.status}  kkt={res.residuals:.2e}  "
          f"iters={res.iter}  obj={res.primal_obj:.10f}")
    assert res.status == "OPTIMAL" and res.residuals < 1e-8

    res64 = hp.solve(*prob_args,
                     parameters=hp.Parameters(verbose=False, stop_tol=1e-8,
                                              precision="f64"))
    print(f"f64   : {res64.status}  kkt={res64.residuals:.2e}  "
          f"iters={res64.iter}  obj={res64.primal_obj:.10f}")
    assert abs(res.primal_obj - res64.primal_obj) < 1e-6 * (
        1 + abs(res64.primal_obj))
    print("OK")


if __name__ == "__main__":
    main()
