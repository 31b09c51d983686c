"""Host allocator tuning for giant-LP ingest (OPT-IN).

The host pipeline (MPS parse, presolve, layout, tile packing) allocates
and frees multi-GB numpy/C++ buffers per phase.  With glibc defaults every
large allocation is a fresh mmap that is munmapped on free, so each phase
re-faults its working set page by page; on this class of VM (Firecracker
guests; also bare metal under memory pressure) minor faults are expensive
enough that KERNEL time dominates: the 20M-nnz presolve benchmark measured
user 5 s / sys 96-116 s before tuning.

Tuning applied by tune_malloc() — NEVER on import.  It runs only when
explicitly requested: HPRLP_MALLOC_TUNE=1 in the environment, or a direct
call from an entry point that owns the process (bench.py, benchmarks/,
the CLI's --malloc-tune flag):

- mallopt(M_MMAP_MAX, 0) + huge M_TRIM_THRESHOLD / M_MMAP_THRESHOLD:
  all allocations come from the brk heap and freed pages are KEPT by the
  process, so later phases reuse hot pages instead of re-faulting.
  Process-local, dies with the process.
- transparent_hugepage=always: heap faults map 2 MB pages, cutting fault
  count ~512x.  Combined effect on the presolve benchmark: wall
  105 s -> 13.6 s.  This is a HOST-GLOBAL kernel policy: it is only
  written when tune_malloc(thp=True) is called (CLI flag / benchmark
  entry points), the previous value is logged and restored at interpreter
  exit via atexit.

Trade-off: peak RSS is held for the process lifetime (the heap never
shrinks back).  Right for a solver appliance / benchmark run; wrong for
memory-constrained co-tenancy — hence opt-in.

No reference counterpart (the reference's host side never exceeds MPS
parsing; SURVEY 5.7).
"""
from __future__ import annotations

import atexit
import ctypes
import os
import sys

_done: dict = {}

# glibc mallopt parameter numbers (malloc.h).
_M_TRIM_THRESHOLD = -1
_M_MMAP_THRESHOLD = -3
_M_MMAP_MAX = -4

_THP_PATH = "/sys/kernel/mm/transparent_hugepage/enabled"


def _restore_thp(prev: str) -> None:
    try:
        with open(_THP_PATH, "w") as f:
            f.write(prev)
    except OSError:
        pass


def tune_malloc(thp: bool | None = None) -> dict:
    """Apply the allocator tuning once per process (explicit opt-in only);
    returns a report dict {"mallopt": bool, "thp": "always"|"unchanged"|...}.

    thp=True additionally enables transparent hugepages host-wide (kernel
    policy; previous value restored at exit).  Default: only when
    HPRLP_MALLOC_TUNE=1 is set in the environment.
    """
    if _done:
        return _done
    report = {"mallopt": False, "thp": "unchanged"}
    if os.environ.get("HPRLP_MALLOC_TUNE") == "0" or \
            not sys.platform.startswith("linux"):
        report["thp"] = "disabled"
        _done.update(report)
        return report
    if thp is None:
        thp = os.environ.get("HPRLP_MALLOC_TUNE") == "1"

    try:
        libc = ctypes.CDLL(None)
        ok = libc.mallopt(_M_TRIM_THRESHOLD, 2**31 - 1)
        ok &= libc.mallopt(_M_MMAP_THRESHOLD, 2**31 - 1)
        ok &= libc.mallopt(_M_MMAP_MAX, 0)
        report["mallopt"] = bool(ok)
    except Exception:
        pass

    if thp:
        try:
            with open(_THP_PATH) as f:
                cur = f.read()
            if "[always]" not in cur:
                # Extract the bracketed current policy, e.g.
                # "always [madvise] never" -> "madvise".
                prev = cur[cur.index("[") + 1:cur.index("]")] \
                    if "[" in cur else "madvise"
                with open(_THP_PATH, "w") as f:
                    f.write("always")
                print(f"[hprlp_tpu] transparent_hugepage: {prev} -> always "
                      f"(restored at exit)", file=sys.stderr)
                atexit.register(_restore_thp, prev)
                # atexit does not run on SIGTERM (how `timeout` kills a
                # benchmark): restore on TERM too, chaining any existing
                # handler.
                import signal

                prev_handler = signal.getsignal(signal.SIGTERM)

                def _on_term(signum, frame):
                    _restore_thp(prev)
                    if callable(prev_handler):
                        prev_handler(signum, frame)
                    else:
                        signal.signal(signal.SIGTERM, signal.SIG_DFL)
                        os.kill(os.getpid(), signal.SIGTERM)

                try:
                    signal.signal(signal.SIGTERM, _on_term)
                except ValueError:
                    pass  # non-main thread: atexit alone
            report["thp"] = "always"
        except OSError:
            pass  # not root / no THP: mallopt alone still pays

    _done.update(report)
    return report
