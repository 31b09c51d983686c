"""Central numeric constants for the HPR-LP solver.

Mirrors the role of the reference's include/constants.h (reference:
/root/reference/include/constants.h) but holds only values that are part of
the algorithm's observable behaviour; device layout constants live here too.
"""

# Bounds with magnitude at or above this value are treated as infinite.
# (reference: include/constants.h:176 NUMERICAL_INFINITY = 1e20)
NUMERICAL_INFINITY = 1e20

# Threshold used when classifying bound types (free / lower / upper / boxed).
# (reference: src/preprocess.cu:5 kInfiniteBoundThreshold = 1e90)
INFINITE_BOUND_THRESHOLD = 1e90

# Residual-check cadence (reference: include/structs.h:30 check_iter = 150).
DEFAULT_CHECK_ITER = 150

# Restart condition ratios (reference: src/main_iterate.cu:341-351).
RESTART_SUFFICIENT_RATIO = 0.2
RESTART_NECESSARY_RATIO = 0.6
RESTART_LONG_RATIO = 0.2

# Power method budget (reference: src/HPRLP.cu:86, src/power_iteration.cu:20-26).
POWER_METHOD_MAX_ITER = 5000
POWER_METHOD_TOL = 1e-4
POWER_METHOD_SAFETY = 1.01
POWER_METHOD_CHECK_EVERY = 10
POWER_METHOD_SEED = 1

# Scaling iteration counts (reference: src/scaling.cu:48 CR=20, :125 Ruiz=10).
CURTIS_REID_ITERS = 20
RUIZ_ITERS = 10

# Default stopping tolerances (reference: include/structs.h:27, :50-57).
DEFAULT_STOP_TOL = 1e-4
MILESTONE_TOLS = (1e-4, 1e-6, 1e-8)

# --- Device layout constants (no reference counterpart) ---

# Vectors (and the padded row/col spaces of the problem) are padded to a
# multiple of this, so padded sizes stay stable across similar problems
# (fewer distinct shapes to compile) and divide evenly over a mesh.
VECTOR_PAD_MULTIPLE = 256

# Minimum ELL bucket width. Row nnz is rounded up to a power of two >= this.
MIN_ELL_WIDTH = 4

# Buckets with fewer rows than this are merged into the next wider bucket
# to avoid launching many tiny ops.
MIN_BUCKET_ROWS = 256

# Dense-SpMV/SpMM candidate HBM budgets (autotuner; reference analogue:
# the fused-kernel autotuner, src/main_iterate.cu:517-595).  Two budgets
# on purpose:
#   * single-LP SpMV reads the whole dense matrix per matvec, so a dense
#     candidate only pays off while the matrix read stays comfortably
#     inside HBM alongside the solver state;
#   * batched SpMM amortises the matrix read over the B batch columns,
#     so a dense candidate stays profitable (and worth probing) at 3x the
#     single-LP size.
DENSE_BYTES_LIMIT_SINGLE = 2 * 1024 * 1024 * 1024
DENSE_BYTES_LIMIT_BATCHED = 6 * 1024 * 1024 * 1024
