/* hpmps — native MPS/QPS reader for the HPR-LP framework.
 *
 * Role parity with the reference C++ reader (reference: src/mps_reader.cpp
 * readqps/coo_to_csr/build_model_from_mps), re-implemented from scratch:
 * free-format MPS, sections NAME/OBJSENSE/ROWS/COLUMNS/RHS/RANGES/BOUNDS/
 * QUADOBJ/ENDATA, gzip input via zlib, duplicate entries summed during
 * COO->CSR.  Fixes the reference's documented quirks deliberately (SURVEY
 * §2 "MPS reader" row): OBJSENSE MAX is APPLIED (c negated, sense
 * reported); QUADOBJ makes the parse fail unless ignore_quadobj != 0.
 */
#ifndef HPMPS_H
#define HPMPS_H

#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

typedef struct hpmps_handle hpmps_handle;

enum {
    HPMPS_OK = 0,
    HPMPS_IO_ERROR = 1,
    HPMPS_FORMAT_ERROR = 2,
};

/* Parse path (.mps or .mps.gz).  Never returns NULL; check hpmps_status. */
hpmps_handle *hpmps_read(const char *path, int ignore_quadobj);

int hpmps_status(const hpmps_handle *h);
const char *hpmps_error(const hpmps_handle *h);  /* empty string if OK */

int64_t hpmps_m(const hpmps_handle *h);
int64_t hpmps_n(const hpmps_handle *h);
int64_t hpmps_nnz(const hpmps_handle *h);
double hpmps_obj_constant(const hpmps_handle *h);
/* +1 minimise; -1 the file declared OBJSENSE MAX (c already negated). */
int hpmps_objsense(const hpmps_handle *h);
const char *hpmps_name(const hpmps_handle *h);

/* Copy the CSR problem out.  Ap: m+1 int64; Ai: nnz int32; Ax: nnz double;
 * AL/AU: m; l/u/c: n. */
void hpmps_get(const hpmps_handle *h, int64_t *Ap, int32_t *Ai, double *Ax,
               double *AL, double *AU, double *l, double *u, double *c);

void hpmps_free(hpmps_handle *h);

#ifdef __cplusplus
}
#endif

#endif /* HPMPS_H */
