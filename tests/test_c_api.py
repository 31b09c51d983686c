"""C ABI tests: compile and run the C example against libhprlp_tpu.so
(the pipe-transport C API, native/src/hprlp_c_api.cpp), and drive the
library from Python via ctypes as a second consumer."""

import ctypes as ct
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LIB = os.path.join(REPO, "native", "lib", "libhprlp_tpu.so")

pytestmark = pytest.mark.skipif(not os.path.exists(LIB),
                                reason="libhprlp_tpu.so not built")


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    env["HPRLP_TPU_PYTHON"] = sys.executable
    env["HPRLP_TPU_ROOT"] = REPO
    env["JAX_PLATFORMS"] = "cpu"
    return env


def test_c_example_compiles_and_solves(tmp_path):
    cc = shutil.which("gcc") or shutil.which("cc")
    if cc is None:
        pytest.skip("no C compiler")
    src = os.path.join(REPO, "examples", "c", "example_direct_lp.c")
    exe = str(tmp_path / "example")
    subprocess.run(
        [cc, src, "-I" + os.path.join(REPO, "native", "include"),
         "-L" + os.path.join(REPO, "native", "lib"), "-lhprlp_tpu",
         "-o", exe], check=True)
    env = _env()
    env["LD_LIBRARY_PATH"] = os.path.join(REPO, "native", "lib")
    r = subprocess.run([exe], env=env, capture_output=True, text=True,
                       timeout=600)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "status: OPTIMAL" in r.stdout
    assert "OK" in r.stdout


class _Params(ct.Structure):
    _fields_ = [("stop_tol", ct.c_double), ("time_limit", ct.c_double),
                ("max_iter", ct.c_int64), ("check_iter", ct.c_int),
                ("use_CR_scaling", ct.c_int), ("use_Ruiz_scaling", ct.c_int),
                ("use_Pock_Chambolle_scaling", ct.c_int),
                ("use_bc_scaling", ct.c_int), ("use_presolve", ct.c_int),
                ("precision", ct.c_char * 8)]


class _Results(ct.Structure):
    _fields_ = [("status", ct.c_char * 16), ("iter", ct.c_int64),
                ("time", ct.c_double), ("primal_obj", ct.c_double),
                ("dual_obj", ct.c_double), ("gap", ct.c_double),
                ("residuals", ct.c_double),
                ("iter4", ct.c_int64), ("iter6", ct.c_int64),
                ("iter8", ct.c_int64),
                ("time4", ct.c_double), ("time6", ct.c_double),
                ("time8", ct.c_double),
                ("n", ct.c_int64), ("m", ct.c_int64),
                ("x", ct.POINTER(ct.c_double)),
                ("y", ct.POINTER(ct.c_double)),
                ("z", ct.POINTER(ct.c_double))]


def test_ctypes_consumer_mps():
    # The C ABI worker inherits this process's environment; force the
    # CPU backend (the tests must not grab an accelerator).
    os.environ.setdefault("HPRLP_TPU_PYTHON", sys.executable)
    os.environ["HPRLP_TPU_ROOT"] = REPO
    os.environ["JAX_PLATFORMS"] = "cpu" 
    lib = ct.CDLL(LIB)
    lib.hprlp_parameters_default.argtypes = [ct.POINTER(_Params)]
    lib.hprlp_create_model_from_mps.restype = ct.c_void_p
    lib.hprlp_create_model_from_mps.argtypes = [ct.c_char_p]
    lib.hprlp_solve.restype = ct.POINTER(_Results)
    lib.hprlp_solve.argtypes = [ct.c_void_p, ct.POINTER(_Params)]
    lib.hprlp_free_results.argtypes = [ct.POINTER(_Results)]
    lib.hprlp_free_model.argtypes = [ct.c_void_p]

    p = _Params()
    lib.hprlp_parameters_default(ct.byref(p))
    p.stop_tol = 1e-6
    p.precision = b"f64"
    model = lib.hprlp_create_model_from_mps(
        os.path.join(REPO, "data", "model.mps").encode())
    res = lib.hprlp_solve(model, ct.byref(p))
    assert res
    r = res.contents
    assert r.status == b"OPTIMAL", (r.status,
                                    lib.hprlp_last_error and "")
    assert abs(r.primal_obj - (-26.4)) < 1e-2
    x = np.ctypeslib.as_array(r.x, shape=(r.n,)).copy()
    np.testing.assert_allclose(x, [2.8, 3.6], atol=1e-3)
    lib.hprlp_free_results(res)
    lib.hprlp_free_model(model)
    # No shutdown: later ctypes tests reuse this warm worker (the
    # round-3 suite paid a fresh Python+JAX start-up per test; the
    # worker exits on pipe EOF at interpreter exit regardless).


class _BatchedResults(ct.Structure):
    _fields_ = [("m", ct.c_int64), ("n", ct.c_int64),
                ("batch_size", ct.c_int64),
                ("x", ct.POINTER(ct.c_double)),
                ("y", ct.POINTER(ct.c_double)),
                ("z", ct.POINTER(ct.c_double)),
                ("primal_obj", ct.POINTER(ct.c_double)),
                ("residuals", ct.POINTER(ct.c_double)),
                ("gap", ct.POINTER(ct.c_double)),
                ("iter", ct.POINTER(ct.c_int64)),
                ("status", ct.POINTER(ct.c_char)),
                ("time", ct.c_double), ("setup_time", ct.c_double),
                ("solve_time", ct.c_double), ("power_time", ct.c_double)]


def _lib_batched():
    os.environ.setdefault("HPRLP_TPU_PYTHON", sys.executable)
    os.environ["HPRLP_TPU_ROOT"] = REPO
    os.environ["JAX_PLATFORMS"] = "cpu"
    lib = ct.CDLL(LIB)
    lib.hprlp_parameters_default.argtypes = [ct.POINTER(_Params)]
    lib.hprlp_create_model_from_arrays.restype = ct.c_void_p
    lib.hprlp_create_model_from_mps.restype = ct.c_void_p
    lib.hprlp_create_model_from_mps.argtypes = [ct.c_char_p]
    dp = ct.POINTER(ct.c_double)
    lib.hprlp_create_model_from_arrays.argtypes = [
        ct.c_int64, ct.c_int64, ct.POINTER(ct.c_int64),
        ct.POINTER(ct.c_int32), dp, dp, dp, dp, dp, dp, ct.c_double]
    lib.hprlp_solve_batched.restype = ct.POINTER(_BatchedResults)
    lib.hprlp_solve_batched.argtypes = [
        ct.c_void_p, ct.c_int64, dp, dp, dp, dp, dp, dp,
        ct.POINTER(_Params)]
    lib.hprlp_free_batched_results.argtypes = [ct.POINTER(_BatchedResults)]
    lib.hprlp_free_model.argtypes = [ct.c_void_p]
    lib.hprlp_last_error.restype = ct.c_char_p
    return lib


def _demo_model(lib):
    Ap = (ct.c_int64 * 3)(0, 2, 4)
    Ai = (ct.c_int32 * 4)(0, 1, 0, 1)
    Ax = (ct.c_double * 4)(1.0, 2.0, 3.0, 1.0)
    inf = float("inf")
    AL = (ct.c_double * 2)(-inf, -inf)
    AU = (ct.c_double * 2)(10.0, 12.0)
    lo = (ct.c_double * 2)(0.0, 0.0)
    hi = (ct.c_double * 2)(inf, inf)
    c = (ct.c_double * 2)(-3.0, -5.0)
    return lib.hprlp_create_model_from_arrays(
        2, 2, Ap, Ai, Ax, AL, AU, lo, hi, c, 0.0)


def test_ctypes_solve_batched():
    """C ABI batched entry point (parity: reference extern-C
    solve_batched, src/batched_solver.cu:939-1092): B=3 LPs sharing the
    demo A; member 0 is the ground-truth LP."""
    lib = _lib_batched()
    model = _demo_model(lib)
    assert model

    inf = float("inf")
    B = 3
    C = (ct.c_double * (2 * B))(-3, -5, -2, -6, -4, -4)
    AL = (ct.c_double * (2 * B))(*([-inf] * 6))
    AU = (ct.c_double * (2 * B))(10, 12, 9, 13, 11, 11)
    lo = (ct.c_double * (2 * B))(*([0.0] * 6))
    hi = (ct.c_double * (2 * B))(inf, inf, inf, inf, 4.0, inf)

    p = _Params()
    lib.hprlp_parameters_default(ct.byref(p))
    p.stop_tol = 1e-6
    res = lib.hprlp_solve_batched(model, B, C, AL, AU, lo, hi, None,
                                  ct.byref(p))
    assert res, lib.hprlp_last_error()
    r = res.contents
    assert (r.m, r.n, r.batch_size) == (2, 2, B)
    for k in range(B):
        st = ct.string_at(ct.addressof(r.status.contents) + 64 * k)
        assert st == b"OPTIMAL", (k, st)
    assert abs(r.primal_obj[0] - (-26.4)) < 1e-2
    x0 = np.ctypeslib.as_array(r.x, shape=(B * 2,))[:2].copy()
    np.testing.assert_allclose(x0, [2.8, 3.6], atol=1e-3)
    assert r.iter[0] > 0 and r.solve_time >= 0.0
    lib.hprlp_free_batched_results(res)
    lib.hprlp_free_model(model)
    # No shutdown: keep the worker warm for the next ctypes test.


def test_ctypes_solve_batched_from_mps():
    """Batched solve over an MPS-backed model: the server parses the
    file, reuses its A, and reports dims via the mps_dims op."""
    lib = _lib_batched()
    model = lib.hprlp_create_model_from_mps(
        os.path.join(REPO, "data", "model.mps").encode())
    assert model

    inf = float("inf")
    B = 2
    C = (ct.c_double * (2 * B))(-3, -5, -3, -5)
    AL = (ct.c_double * (2 * B))(*([-inf] * 4))
    AU = (ct.c_double * (2 * B))(10, 12, 10, 12)
    lo = (ct.c_double * (2 * B))(*([0.0] * 4))
    hi = (ct.c_double * (2 * B))(*([inf] * 4))
    p = _Params()
    lib.hprlp_parameters_default(ct.byref(p))
    p.stop_tol = 1e-6
    res = lib.hprlp_solve_batched(model, B, C, AL, AU, lo, hi, None,
                                  ct.byref(p))
    assert res, lib.hprlp_last_error()
    r = res.contents
    assert r.batch_size == B
    for k in range(B):
        assert abs(r.primal_obj[k] - (-26.4)) < 1e-2
    lib.hprlp_free_batched_results(res)
    lib.hprlp_free_model(model)
    # No shutdown: keep the worker warm for the next ctypes test.


def test_c_api_hostile_paths():
    """Protocol hardening: hostile MPS paths (newlines, quotes,
    backslashes, control chars, non-ASCII) must round-trip the
    line-delimited JSON pipe without desynchronising it — each solve
    returns a clean ERROR result (missing file), and a normal solve
    still works afterwards on the SAME worker."""
    lib = _lib_batched()
    lib.hprlp_solve.restype = ct.POINTER(_Results)
    lib.hprlp_solve.argtypes = [ct.c_void_p, ct.POINTER(_Params)]
    lib.hprlp_free_results.argtypes = [ct.POINTER(_Results)]

    p = _Params()
    lib.hprlp_parameters_default(ct.byref(p))
    p.stop_tol = 1e-4
    hostile = [b"/no/such\nfile.mps", b'/tmp/we"ird.mps',
               b"/tmp/back\\slash.mps", b"/tmp/ctrl\x01\x1f.mps",
               b"/tmp/\xc3\xbcnicode.mps", b"\ttabs\tin\tpath"]
    for path in hostile:
        model = lib.hprlp_create_model_from_mps(path)
        res = lib.hprlp_solve(model, ct.byref(p))
        # Transport must survive; the solve itself fails cleanly.
        assert res, (path, lib.hprlp_last_error())
        assert res.contents.status == b"ERROR", path
        lib.hprlp_free_results(res)
        lib.hprlp_free_model(model)
    # Worker is still in sync: a real solve succeeds.
    model = lib.hprlp_create_model_from_mps(
        os.path.join(REPO, "data", "model.mps").encode())
    res = lib.hprlp_solve(model, ct.byref(p))
    assert res and res.contents.status == b"OPTIMAL"
    lib.hprlp_free_results(res)
    lib.hprlp_free_model(model)
    lib.hprlp_shutdown()


def test_c_batched_example_compiles_and_solves(tmp_path):
    cc = shutil.which("gcc") or shutil.which("cc")
    if cc is None:
        pytest.skip("no C compiler")
    src = os.path.join(REPO, "examples", "c", "example_batched_lp.c")
    exe = str(tmp_path / "example_batched")
    subprocess.run(
        [cc, src, "-I" + os.path.join(REPO, "native", "include"),
         "-L" + os.path.join(REPO, "native", "lib"), "-lhprlp_tpu",
         "-o", exe], check=True)
    env = _env()
    env["LD_LIBRARY_PATH"] = os.path.join(REPO, "native", "lib")
    r = subprocess.run([exe], env=env, capture_output=True, text=True,
                       timeout=600)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "OK" in r.stdout


def test_c_mps_example_compiles_and_solves(tmp_path):
    cc = shutil.which("gcc") or shutil.which("cc")
    if cc is None:
        pytest.skip("no C compiler")
    src = os.path.join(REPO, "examples", "c", "example_mps_file.c")
    exe = str(tmp_path / "example_mps")
    subprocess.run(
        [cc, src, "-I" + os.path.join(REPO, "native", "include"),
         "-L" + os.path.join(REPO, "native", "lib"), "-lhprlp_tpu",
         "-o", exe], check=True)
    env = _env()
    env["LD_LIBRARY_PATH"] = os.path.join(REPO, "native", "lib")
    r = subprocess.run([exe, os.path.join(REPO, "data", "model.mps")],
                       env=env, capture_output=True, text=True,
                       timeout=600)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "status: OPTIMAL" in r.stdout
    assert "OK" in r.stdout


def test_cpp_example_compiles_and_solves(tmp_path):
    """The C++ examples (examples/cpp, parity with the reference's
    examples/cpp) build with g++ against the installed-style include/lib
    layout and solve the demo LP."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no C++ compiler")
    src = os.path.join(REPO, "examples", "cpp", "example_direct_lp.cpp")
    exe = str(tmp_path / "example_cpp")
    subprocess.run(
        [cxx, "-std=c++17", src,
         "-I" + os.path.join(REPO, "native", "include"),
         "-L" + os.path.join(REPO, "native", "lib"), "-lhprlp_tpu",
         "-o", exe], check=True)
    env = _env()
    env["LD_LIBRARY_PATH"] = os.path.join(REPO, "native", "lib")
    r = subprocess.run([exe], env=env, capture_output=True, text=True,
                       timeout=600)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "status: OPTIMAL" in r.stdout
    assert "OK" in r.stdout


def test_ctypes_csc_ingestion():
    """hprlp_create_model_from_arrays_csc accepts the demo LP's matrix in
    CSC layout and solves to the same ground truth (parity: the
    reference's is_csc path, src/HPRLP.cu:354-396 — MATLAB/SciPy CSC
    consumers need no client-side transpose)."""
    os.environ.setdefault("HPRLP_TPU_PYTHON", sys.executable)
    os.environ["HPRLP_TPU_ROOT"] = REPO
    os.environ["JAX_PLATFORMS"] = "cpu"
    lib = ct.CDLL(LIB)
    lib.hprlp_parameters_default.argtypes = [ct.POINTER(_Params)]
    dp = ct.POINTER(ct.c_double)
    lib.hprlp_create_model_from_arrays_csc.restype = ct.c_void_p
    lib.hprlp_create_model_from_arrays_csc.argtypes = [
        ct.c_int64, ct.c_int64, ct.POINTER(ct.c_int64),
        ct.POINTER(ct.c_int32), dp, dp, dp, dp, dp, dp, ct.c_double]
    lib.hprlp_solve.restype = ct.POINTER(_Results)
    lib.hprlp_solve.argtypes = [ct.c_void_p, ct.POINTER(_Params)]
    lib.hprlp_free_results.argtypes = [ct.POINTER(_Results)]
    lib.hprlp_free_model.argtypes = [ct.c_void_p]

    # Demo A = [[1, 2], [3, 1]] in CSC: col0 rows (0,1) vals (1,3);
    # col1 rows (0,1) vals (2,1).
    Ap = (ct.c_int64 * 3)(0, 2, 4)
    Ai = (ct.c_int32 * 4)(0, 1, 0, 1)
    Ax = (ct.c_double * 4)(1.0, 3.0, 2.0, 1.0)
    inf = float("inf")
    AL = (ct.c_double * 2)(-inf, -inf)
    AU = (ct.c_double * 2)(10.0, 12.0)
    lo = (ct.c_double * 2)(0.0, 0.0)
    hi = (ct.c_double * 2)(inf, inf)
    c = (ct.c_double * 2)(-3.0, -5.0)
    model = lib.hprlp_create_model_from_arrays_csc(
        2, 2, Ap, Ai, Ax, AL, AU, lo, hi, c, 0.0)
    assert model

    p = _Params()
    lib.hprlp_parameters_default(ct.byref(p))
    p.stop_tol = 1e-6
    p.precision = b"f64"
    res = lib.hprlp_solve(model, ct.byref(p))
    assert res, lib.hprlp_last_error()
    r = res.contents
    assert r.status == b"OPTIMAL"
    assert abs(r.primal_obj - (-26.4)) < 1e-2
    x = np.ctypeslib.as_array(r.x, shape=(r.n,)).copy()
    np.testing.assert_allclose(x, [2.8, 3.6], atol=1e-3)
    lib.hprlp_free_results(res)
    lib.hprlp_free_model(model)
