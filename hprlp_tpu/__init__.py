"""hprlp_tpu — a Halpern Peaceman-Rachford LP solver in JAX.

From-scratch JAX/XLA reimplementation of the capabilities of the HPR-LP-C
reference solver (PolyU-IOR/HPR-LP-C): bucketed-ELL sparse products,
jit-compiled iteration chunks (the CUDA-Graph analogue), device meshes for
multi-device scaling.  Runs on NVIDIA GPUs and on the CPU.

Standard form (reference: include/HPRLP.h:57-62):
    minimize    c'x        s.t.   AL <= A x <= AU,   l <= x <= u
"""

import os as _os

_CHECKOUT_CACHE = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
    ".jax_cache")


def compile_cache_dir(environ=None):
    """Directory of the persistent XLA compile cache, or None when
    HPRLP_TPU_NO_COMPILE_CACHE is set: JAX_COMPILATION_CACHE_DIR when set,
    else the fixed path .jax_cache/ at the root of the checkout."""
    env = _os.environ if environ is None else environ
    if env.get("HPRLP_TPU_NO_COMPILE_CACHE"):
        return None
    return env.get("JAX_COMPILATION_CACHE_DIR") or _CHECKOUT_CACHE


def _enable_compile_cache():
    """Persistent XLA compile cache, on by default: every cold process
    otherwise pays the chunk/scaling compiles again.  This is the one
    place the package configures the cache; a directory the user already
    gave jax.config is left alone."""
    cache = compile_cache_dir()
    if cache is None:
        return
    import jax

    if jax.config.jax_compilation_cache_dir:
        return
    try:
        _os.makedirs(cache, exist_ok=True)
    except OSError:
        return  # unwritable cache dir: run uncached
    jax.config.update("jax_compilation_cache_dir", cache)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1)


_enable_compile_cache()

# Allocator tuning is OPT-IN (host-global THP policy + process mallopt;
# see _malloc.py).  Importing the library never touches /sys or malloc
# state; entry points that own the process (bench, CLI) call tune_malloc().
if _os.environ.get("HPRLP_MALLOC_TUNE") == "1":
    from ._malloc import tune_malloc as _tune_malloc

    _tune_malloc()

from .params import Parameters
from .problem import LpProblem
from .results import BatchedResults, Results
from .io.mps import read_mps
from .model import Model, solve, solve_mps
from .modeling import (Constraint, LinearExpression, ModelBuilder, Sense,
                       TwoSidedConstraint, Variable, between, maximize,
                       minimize)
from .solver.loop import solve_problem
from .solver.batched import solve_batched

__version__ = "0.1.0"

__all__ = [
    "Parameters", "LpProblem", "Results", "BatchedResults", "Model",
    "read_mps", "solve", "solve_mps", "solve_problem", "solve_batched",
    "ModelBuilder", "Variable", "LinearExpression", "Constraint",
    "TwoSidedConstraint", "between", "minimize", "maximize", "Sense",
    "__version__",
]
