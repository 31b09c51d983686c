"""ctypes bindings to the native library (libhprlp_native.so).

The native layer carries the components the reference implements in
C/C++ — the presolver (reference: third_party/PSLP + pslp_integration.cpp)
and the MPS reader (reference: src/mps_reader.cpp).  Python is the
orchestration layer, exactly as CUDA C++ is in the reference.

The library is built from native/ with `make`; if missing, we attempt one
automatic build and otherwise degrade gracefully (presolve off, Python MPS
reader) — the same warn-and-continue posture as the reference's presolve
fallback (pslp_integration.cpp:677-700).
"""

from __future__ import annotations

import ctypes as ct
import os
import subprocess
import sys

import numpy as np

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
_NATIVE_DIR = os.path.join(_PKG_DIR, os.pardir, "native")
# Search order: wheel-bundled copy (hprlp_tpu/_native, placed by
# setup.py's build step), then the source checkout's native/lib.
_LIB_CANDIDATES = [
    os.path.join(_PKG_DIR, "_native", "libhprlp_native.so"),
    os.path.abspath(os.path.join(_NATIVE_DIR, "lib",
                                 "libhprlp_native.so")),
]
_LIB_PATH = next((p for p in _LIB_CANDIDATES if os.path.exists(p)),
                 _LIB_CANDIDATES[-1])

_lib = None
_lib_error: str | None = None

_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")


def _try_build() -> bool:
    try:
        subprocess.run(["make", "-C", _NATIVE_DIR], check=True,
                       capture_output=True, timeout=300)
        return os.path.exists(_LIB_PATH)
    except Exception:
        return False


def _configure(lib):
    h = ct.c_void_p
    lib.hpres_presolve.restype = h
    lib.hpres_presolve.argtypes = [
        ct.c_int64, ct.c_int64, _i64p, _i32p, _f64p, _f64p, _f64p, _f64p,
        _f64p, _f64p, ct.c_double, ct.c_int]
    lib.hpres_presolve_ex.restype = h
    lib.hpres_presolve_ex.argtypes = [
        ct.c_int64, ct.c_int64, _i64p, _i32p, _f64p, _f64p, _f64p, _f64p,
        _f64p, _f64p, ct.c_double, ct.c_int, ct.c_double, ct.c_int]
    lib.hpres_status.restype = ct.c_int
    lib.hpres_status.argtypes = [h]
    for fn in ("hpres_reduced_m", "hpres_reduced_n", "hpres_reduced_nnz"):
        getattr(lib, fn).restype = ct.c_int64
        getattr(lib, fn).argtypes = [h]
    lib.hpres_obj_shift.restype = ct.c_double
    lib.hpres_obj_shift.argtypes = [h]
    lib.hpres_get_reduced.restype = None
    lib.hpres_get_reduced.argtypes = [h, _i64p, _i32p, _f64p, _f64p, _f64p,
                                      _f64p, _f64p, _f64p]
    lib.hpres_get_maps.restype = None
    lib.hpres_get_maps.argtypes = [h, _i64p, _i64p]
    lib.hpres_postsolve.restype = None
    lib.hpres_postsolve.argtypes = [h, _f64p, _f64p, _f64p, _f64p, _f64p,
                                    _f64p]
    lib.hpres_stats.restype = None
    lib.hpres_stats.argtypes = [h] + [ct.POINTER(ct.c_int64)] * 4
    lib.hpres_free.restype = None
    lib.hpres_free.argtypes = [h]
    lib.hpres_report.restype = ct.c_int64
    lib.hpres_report.argtypes = [h, ct.c_char_p, ct.c_int64]

    lib.hpmps_read.restype = h
    lib.hpmps_read.argtypes = [ct.c_char_p, ct.c_int]
    lib.hpmps_read_ex.restype = h
    lib.hpmps_read_ex.argtypes = [ct.c_char_p, ct.c_int, ct.c_int]
    lib.hpmps_status.restype = ct.c_int
    lib.hpmps_status.argtypes = [h]
    lib.hpmps_error.restype = ct.c_char_p
    lib.hpmps_error.argtypes = [h]
    for fn in ("hpmps_m", "hpmps_n", "hpmps_nnz"):
        getattr(lib, fn).restype = ct.c_int64
        getattr(lib, fn).argtypes = [h]
    lib.hpmps_obj_constant.restype = ct.c_double
    lib.hpmps_obj_constant.argtypes = [h]
    lib.hpmps_objsense.restype = ct.c_int
    lib.hpmps_objsense.argtypes = [h]
    lib.hpmps_name.restype = ct.c_char_p
    lib.hpmps_name.argtypes = [h]
    lib.hpmps_get.restype = None
    lib.hpmps_get.argtypes = [h, _i64p, _i32p, _f64p, _f64p, _f64p, _f64p,
                              _f64p, _f64p]
    lib.hpmps_free.restype = None
    lib.hpmps_free.argtypes = [h]


def get_lib():
    """The loaded native library, or None if unavailable."""
    global _lib, _lib_error
    if _lib is not None or _lib_error is not None:
        return _lib
    if not os.path.exists(_LIB_PATH) and not _try_build():
        _lib_error = f"native library not found at {_LIB_PATH}"
        return None
    try:
        lib = ct.CDLL(_LIB_PATH)
        _configure(lib)
        _lib = lib
    except OSError as e:
        _lib_error = str(e)
    return _lib


def is_available() -> bool:
    return get_lib() is not None
