"""Persistent solver server: line-delimited JSON protocol with base64
array transport.

Why: the reference's Julia/MATLAB bindings ccall a C shared library
(reference: bindings/julia/package/src/wrapper.jl, bindings/matlab/
hprlp_mex.cpp); this framework's engine is a Python/JAX process, so
non-Python front ends drive a WARM server process instead — one JAX
start-up amortised over every solve (round-1 gap: the CLI shims paid the
full cold start per call).

Transport:
  * default: requests on stdin, responses on stdout, one JSON object per
    line (binary arrays as base64 of little-endian raw bytes; float64,
    int64 for index arrays);
  * --request FILE --response FILE: serve exactly one request from/to
    files (used by the MATLAB wrapper, which cannot keep a pipe open).

Operations:
  {"op": "ping"}                      -> {"ok": true, "result": "pong"}
  {"op": "shutdown"}                  -> {"ok": true} and exit
  {"op": "solve_mps", "path": p, "params": {...}, "mps_format": "free"}
  {"op": "solve", "m","n","Ap","Ai","Ax","AL","AU","l","u","c",
   "obj_constant", "params"}          (CSR of A; base64 arrays)
  {"op": "solve_batched", "m","n","batch","Ap","Ai","Ax",
   "C","AL","AU","l","u",            ((dim, B) column-major f64)
   "obj_constants", "params"}

Solve responses carry status/iter/time/primal_obj/dual_obj/gap/residuals
plus x/y/z (base64 f64); batched responses use column-major (dim, B).
"""

from __future__ import annotations

import base64
import json
import os
import sys

import numpy as np


def _enc(a: np.ndarray) -> str:
    return base64.b64encode(
        np.ascontiguousarray(a).tobytes()).decode("ascii")


def _dec_f64(s: str) -> np.ndarray:
    return np.frombuffer(base64.b64decode(s), dtype="<f8").copy()


def _dec_i64(s: str) -> np.ndarray:
    return np.frombuffer(base64.b64decode(s), dtype="<i8").copy()


def _params(d: dict):
    from .params import Parameters

    p = Parameters(verbose=False)
    for k, v in (d or {}).items():
        if not hasattr(p, k):
            raise ValueError(f"unknown parameter {k!r}")
        setattr(p, k, v)
    return p


def _fin(v: float) -> float:
    """JSON has no Infinity/NaN tokens (json.dumps would emit the
    non-standard `Infinity`, which the Julia/MATLAB parsers reject), so
    non-finite diagnostics travel as +-DBL_MAX; wrappers map magnitudes
    >= 1e307 back to Inf.  An unconverged solve's residuals/gap are Inf,
    so this path is hit by every INFEASIBLE/UNBOUNDED/ERROR response."""
    v = float(v)
    if v != v:  # NaN reads as "no usable value": overflow sentinel too
        return 1.7976931348623157e308
    if v == float("inf"):
        return 1.7976931348623157e308
    if v == float("-inf"):
        return -1.7976931348623157e308
    return v


def _pack_results(res) -> dict:
    out = {
        "status": res.status, "iter": int(res.iter),
        "time": _fin(res.time), "primal_obj": _fin(res.primal_obj),
        "dual_obj": _fin(res.dual_obj), "gap": _fin(res.gap),
        "residuals": _fin(res.residuals),
        "iter4": int(res.iter4), "iter6": int(res.iter6),
        "iter8": int(res.iter8), "time4": _fin(res.time4),
        "time6": _fin(res.time6), "time8": _fin(res.time8),
    }
    for k in ("x", "y", "z"):
        v = getattr(res, k)
        out[k] = _enc(np.asarray(v, np.float64)) if v is not None else ""
    return out


def handle(req: dict) -> dict:
    """Dispatch one request; ANY failure returns an error response (the
    error boundary lives here so both transports share it)."""
    try:
        return _handle(req)
    except Exception as e:
        return {"ok": False, "error": f"{type(e).__name__}: {e}"}


def _handle(req: dict) -> dict:
    op = req.get("op")
    if op == "ping":
        return {"ok": True, "result": "pong"}

    if op == "mps_dims":
        from .model import Model

        model = Model.from_mps(req["path"],
                               mps_format=req.get("mps_format", "free"))
        return {"ok": True, "result": {"m": model.m, "n": model.n,
                                       "nnz": model.nnz}}

    if op == "solve_mps":
        from .model import Model

        model = Model.from_mps(req["path"],
                               mps_format=req.get("mps_format", "free"))
        res = model.solve(_params(req.get("params")))
        return {"ok": True, "result": _pack_results(res)}

    if op == "solve":
        import scipy.sparse as sp

        from .model import Model

        m, n = int(req["m"]), int(req["n"])
        A = sp.csr_matrix((_dec_f64(req["Ax"]),
                           _dec_i64(req["Ai"]).astype(np.int32),
                           _dec_i64(req["Ap"])), shape=(m, n))
        model = Model.from_arrays(
            A, _dec_f64(req["AL"]), _dec_f64(req["AU"]),
            _dec_f64(req["l"]), _dec_f64(req["u"]), _dec_f64(req["c"]),
            obj_constant=float(req.get("obj_constant", 0.0)))
        res = model.solve(_params(req.get("params")))
        return {"ok": True, "result": _pack_results(res)}

    if op == "solve_batched":
        import scipy.sparse as sp

        from .solver.batched import solve_batched

        B = int(req["batch"])
        if req.get("path"):
            # MPS-backed model: reuse its A only (reference parity —
            # solve_batched takes any LP_info_cpu and ignores its
            # vectors, src/batched_solver.cu:959-973).
            from .model import Model

            prob = Model.from_mps(
                req["path"],
                mps_format=req.get("mps_format", "free")).problem
            A = prob.A.tocsr()
            m, n = A.shape
        else:
            m, n = int(req["m"]), int(req["n"])
            A = sp.csr_matrix((_dec_f64(req["Ax"]),
                               _dec_i64(req["Ai"]).astype(np.int32),
                               _dec_i64(req["Ap"])), shape=(m, n))

        def mat(key, rows):
            return _dec_f64(req[key]).reshape(rows, B, order="F")

        oc = (_dec_f64(req["obj_constants"])
              if req.get("obj_constants") else None)
        res = solve_batched(A, mat("C", n), mat("AL", m), mat("AU", m),
                            mat("l", n), mat("u", n), obj_constants=oc,
                            params=_params(req.get("params")))
        out = {
            "m": res.m, "n": res.n, "batch": res.batch_size,
            "status": list(res.status),
            "iter": _enc(np.asarray(res.iter, np.int64)),
            "residuals": _enc(np.asarray(res.residuals, np.float64)),
            "gap": _enc(np.asarray(res.gap, np.float64)),
            "primal_obj": _enc(np.asarray(res.primal_obj, np.float64)),
            "x": _enc(np.asarray(res.x, np.float64).ravel(order="F")),
            "y": _enc(np.asarray(res.y, np.float64).ravel(order="F")),
            "z": _enc(np.asarray(res.z, np.float64).ravel(order="F")),
            "time": float(res.time), "setup_time": float(res.setup_time),
            "solve_time": float(res.solve_time),
            "power_time": float(res.power_time),
        }
        return {"ok": True, "result": out}

    return {"ok": False, "error": f"unknown op {op!r}"}


def serve_stream(inp, outp) -> None:
    for line in inp:
        line = line.strip()
        if not line:
            continue
        try:
            req = json.loads(line)
        except json.JSONDecodeError as e:
            outp.write(json.dumps({"ok": False,
                                   "error": f"bad json: {e}"}) + "\n")
            outp.flush()
            continue
        if req.get("op") == "shutdown":
            try:
                outp.write(json.dumps({"ok": True}) + "\n")
                outp.flush()
            except (BrokenPipeError, ValueError):
                pass  # client already hung up
            return
        resp = handle(req)
        try:
            # Standard JSON only: a stray non-finite float must become a
            # clean error response, not an `Infinity` token the wrapper
            # parsers reject (scalars are sanitised in _pack_results).
            text = json.dumps(resp, allow_nan=False)
        except ValueError as e:
            text = json.dumps({"ok": False,
                               "error": f"non-finite in response: {e}"})
        outp.write(text + "\n")
        outp.flush()


def serve_watch_dir(watch_dir: str, idle_timeout: float = 1800.0) -> None:
    """Warm request-directory transport (the MATLAB/Octave wrapper's
    persistent server: process pipes are awkward there, sockets absent in
    Octave, but atomic file renames work everywhere).

    Protocol: clients atomically rename a JSON request into
    `<id>.req.json`; the server handles it, atomically renames the
    response into `<id>.resp.json` and deletes the request.  A file named
    `shutdown.req.json` stops the server.  The server also exits after
    idle_timeout seconds without requests, or when the directory
    disappears (client session ended)."""
    import time

    last = time.monotonic()
    while True:
        try:
            names = sorted(os.listdir(watch_dir))
        except OSError:
            return  # directory removed: client session is gone
        served = False
        for name in names:
            if not name.endswith(".req.json"):
                continue
            path = os.path.join(watch_dir, name)
            if name == "shutdown.req.json":
                try:
                    os.unlink(path)
                except OSError:
                    pass
                return
            try:
                with open(path) as f:
                    req = json.load(f)
            except (OSError, ValueError):
                continue  # mid-rename or unreadable: retry next scan
            resp = handle(req)
            out = path[:-len(".req.json")] + ".resp.json"
            tmp = out + ".tmp"
            with open(tmp, "w") as f:
                f.write(json.dumps(resp))
            os.replace(tmp, out)  # atomic: clients never see partials
            try:
                os.unlink(path)
            except OSError:
                pass
            served = True
        now = time.monotonic()
        if served:
            last = now
        elif now - last > idle_timeout:
            return
        else:
            time.sleep(0.05)


def _honor_jax_platforms_env() -> None:
    """Make JAX_PLATFORMS authoritative for this worker: a client that
    spawns the worker with JAX_PLATFORMS=cpu (the test suites) gets the
    CPU even where a site configuration has already picked a platform.
    When the variable is unset, JAX's default platform stands."""
    want = os.environ.get("JAX_PLATFORMS")
    if not want:
        return
    try:
        import jax

        jax.config.update("jax_platforms", want)
    except Exception:
        pass


def main(argv=None) -> int:
    import argparse

    _honor_jax_platforms_env()

    ap = argparse.ArgumentParser(prog="hprlp-server")
    ap.add_argument("--request", default=None,
                    help="serve ONE request from this JSON file")
    ap.add_argument("--response", default=None,
                    help="write the one-shot response to this JSON file")
    ap.add_argument("--watch", default=None, metavar="DIR",
                    help="serve <id>.req.json files dropped in DIR until "
                         "shutdown.req.json arrives or DIR disappears "
                         "(the warm MATLAB/Octave transport)")
    ap.add_argument("--idle-timeout", type=float, default=1800.0,
                    help="with --watch: exit after this many seconds "
                         "without requests")
    args = ap.parse_args(argv)

    # The protocol owns the real stdout; everything else that prints —
    # a client-supplied {"verbose": true}, autotune notes, JAX warnings —
    # goes to stderr instead.  Without this, one verbose solve would
    # interleave iteration log lines with the JSON responses and
    # permanently desynchronise pipe clients (the C ABI worker parses
    # stdout line by line).
    proto_out = sys.stdout
    sys.stdout = sys.stderr

    if args.watch:
        serve_watch_dir(args.watch, args.idle_timeout)
        return 0

    if args.request:
        with open(args.request) as f:
            req = json.load(f)
        resp = handle(req)
        text = json.dumps(resp)
        if args.response:
            with open(args.response, "w") as f:
                f.write(text)
        else:
            proto_out.write(text + "\n")
        return 0 if resp.get("ok") else 1

    serve_stream(sys.stdin, proto_out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
