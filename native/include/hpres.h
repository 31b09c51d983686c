/* hpres — native LP presolver for the HPR-LP framework.
 *
 * Role parity with the reference's embedded PSLP presolver
 * (reference: third_party/PSLP, src/pslp_integration.cpp), re-designed and
 * written from scratch in C++:
 *   - reductions: empty/singleton/redundant/forcing rows, fixed/empty
 *     columns, dual fixing via up/down locks, free singleton column
 *     substitution, doubleton equality substitution, parallel rows/cols,
 *     activity-based primal propagation with INSTALLED bounds (BoundChange
 *     postsolve records transfer the bound multiplier back to the implying
 *     row, parity: PSLP BOUND_CHANGE_* + retrieve_bound_change)
 *   - FAST/MEDIUM phase driver with <5%-nnz cycle termination and a
 *     wall-clock budget (parity: PSLP Presolver.c:52-53, :643-748)
 *   - typed postsolve log replayed in reverse to recover (x, y, z) in the
 *     original space (parity: PSLP include/core/Postsolver.h semantics)
 *   - opt-in invariant checker run after every pass (parity: PSLP
 *     Debugger.c, which the reference excludes from its embedded build)
 *
 * Problem form (same as the solver):
 *     minimize c'x   s.t.  AL <= A x <= AU,  l <= x <= u
 *
 * C ABI consumed from Python via ctypes.  All arrays are caller-allocated.
 */
#ifndef HPRES_H
#define HPRES_H

#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

typedef struct hpres_handle hpres_handle;

/* Status codes. */
enum {
    HPRES_OK = 0,
    HPRES_INFEASIBLE = 1,
    HPRES_UNBOUNDED = 2,
    HPRES_ERROR = 3,
};

/* Run presolve on a CSR LP.  Returns a handle owning the reduced problem
 * and the postsolve log (never NULL; check hpres_status). */
hpres_handle *hpres_presolve(
    int64_t m, int64_t n,
    const int64_t *Ap, const int32_t *Ai, const double *Ax, /* CSR of A */
    const double *AL, const double *AU,
    const double *l, const double *u, const double *c,
    double feas_tol,     /* feasibility tolerance (reference: 1e-6) */
    int max_rounds);     /* reduction rounds (0 = default) */

/* Extended entry: wall-clock budget and the opt-in invariant checker.
 * max_time <= 0 selects the 60 s default (reference: PSLP Presolver.c:90,
 * clipped by the integration layer to the solver time limit).
 * debug_checks != 0 validates internal invariants after every pass and
 * fails the presolve (HPRES_ERROR -> caller solves unreduced) on any
 * violation — parity: PSLP Debugger.c / DEBUGGER_ENABLED. */
hpres_handle *hpres_presolve_ex(
    int64_t m, int64_t n,
    const int64_t *Ap, const int32_t *Ai, const double *Ax,
    const double *AL, const double *AU,
    const double *l, const double *u, const double *c,
    double feas_tol, int max_rounds, double max_time, int debug_checks);

int hpres_status(const hpres_handle *h);

/* Reduced problem dimensions. */
int64_t hpres_reduced_m(const hpres_handle *h);
int64_t hpres_reduced_n(const hpres_handle *h);
int64_t hpres_reduced_nnz(const hpres_handle *h);
/* Objective constant accumulated by fixed variables. */
double hpres_obj_shift(const hpres_handle *h);

/* Copy the reduced problem out (arrays sized by the getters above;
 * Ap has reduced_m + 1 entries). */
void hpres_get_reduced(const hpres_handle *h,
                       int64_t *Ap, int32_t *Ai, double *Ax,
                       double *AL, double *AU,
                       double *l, double *u, double *c);

/* Copy the reduced->original index maps out (row_map has reduced_m
 * entries, col_map reduced_n): reduced position k corresponds to original
 * row/column row_map[k] / col_map[k].  Used to project an original-space
 * warm start onto the reduced problem. */
void hpres_get_maps(const hpres_handle *h, int64_t *row_map,
                    int64_t *col_map);

/* Map a reduced-space solution back to the original space.
 * x/y/z are original-sized outputs; x_red/y_red/z_red reduced-sized. */
void hpres_postsolve(const hpres_handle *h,
                     const double *x_red, const double *y_red,
                     const double *z_red,
                     double *x, double *y, double *z);

/* Reduction statistics (optional, for logging). */
void hpres_stats(const hpres_handle *h, int64_t *rows_removed,
                 int64_t *cols_removed, int64_t *nnz_removed,
                 int64_t *rounds);

/* Per-explorer wall-time report (parity: PSLP's per-explorer stats).
 * Writes "name seconds" lines into buf; returns the full length. */
int64_t hpres_report(const hpres_handle *h, char *buf, int64_t buflen);

void hpres_free(hpres_handle *h);

#ifdef __cplusplus
}
#endif

#endif /* HPRES_H */
