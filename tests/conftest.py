"""Test configuration: force the CPU backend with a virtual 8-device mesh
so sharding tests run anywhere, and enable x64 for exact oracles.  The
persistent compile cache is the package's own (JAX_COMPILATION_CACHE_DIR
when set, else .jax_cache/ in the checkout)."""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import scipy.sparse as sp  # noqa: E402


@pytest.fixture
def demo_lp():
    """The repo-wide 2x2 ground-truth LP (reference: data/model.mps,
    examples/*): min -3x1 -5x2 s.t. x1+2x2<=10, 3x1+x2<=12, x>=0.
    Optimum: x=(2.8, 3.6), obj=-26.4."""
    from hprlp_tpu.problem import LpProblem
    A = sp.csr_matrix(np.array([[1.0, 2.0], [3.0, 1.0]]))
    return LpProblem.from_arrays(
        A, [-np.inf, -np.inf], [10.0, 12.0], [0.0, 0.0],
        [np.inf, np.inf], [-3.0, -5.0])


def random_lp(seed: int, m: int = 40, n: int = 60, density: float = 0.3):
    """Random feasible bounded LP with interior structure for property tests."""
    rng = np.random.default_rng(seed)
    A = sp.random(m, n, density=density, random_state=rng,
                  data_rvs=lambda k: rng.normal(size=k)).tocsr()
    x_feas = rng.uniform(-1.0, 1.0, n)
    Ax = A @ x_feas
    AL = Ax - rng.uniform(0.1, 2.0, m)
    AU = Ax + rng.uniform(0.1, 2.0, m)
    # Mix of equalities / one-sided rows.
    kind = rng.integers(0, 4, m)
    AL = np.where(kind == 1, -np.inf, AL)
    AU = np.where(kind == 2, np.inf, AU)
    eq = kind == 3
    AL = np.where(eq, Ax, AL)
    AU = np.where(eq, Ax, AU)
    l = x_feas - rng.uniform(0.1, 3.0, n)
    u = x_feas + rng.uniform(0.1, 3.0, n)
    kindv = rng.integers(0, 3, n)
    l = np.where(kindv == 1, -np.inf, l)
    u = np.where(kindv == 2, np.inf, u)
    c = rng.normal(size=n)
    from hprlp_tpu.problem import LpProblem
    return LpProblem.from_arrays(A, AL, AU, l, u, c)
