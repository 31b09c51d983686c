"""Command-line LP solver: ``python -m hprlp_tpu.cli -i model.mps``.

Flag-level parity with the reference CLI (reference:
src/solve_mps_file.cpp:14-32): same 13 options plus extras
(--precision, --mesh).  ``--cusparse-spmv`` maps to forcing the plain XLA
SpMV backend (the non-fused analogue); ``--device`` selects the JAX device.
"""

from __future__ import annotations

import argparse
import os
import sys


def _bool(s: str) -> bool:
    t = s.strip().lower()
    if t in ("true", "1", "yes", "on"):
        return True
    if t in ("false", "0", "no", "off"):
        return False
    raise argparse.ArgumentTypeError(f"expected true/false, got {s!r}")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="hprlp-solve",
        description="Solve an LP from an MPS file with the HPR-LP "
                    "solver.")
    p.add_argument("-i", "--input", required=True,
                   help="Path to input .mps or .mps.gz file")
    p.add_argument("--device", type=int, default=0,
                   help="Device id (default: 0)")
    p.add_argument("--max-iter", type=int, default=2**31 - 1,
                   help="Max iterations (default: INT32_MAX)")
    p.add_argument("--tol", type=float, default=1e-4,
                   help="Stopping tolerance (default: 1e-4)")
    p.add_argument("--time-limit", type=float, default=3600.0,
                   help="Time limit in seconds (default: 3600)")
    p.add_argument("--check-iter", type=int, default=150,
                   help="Check interval (default: 150)")
    p.add_argument("--cusparse-spmv", type=_bool, default=False,
                   metavar="true/false",
                   help="Force the plain (non-fused) SpMV backend")
    p.add_argument("--autotune-verbose", type=_bool, default=False,
                   metavar="true/false",
                   help="Print SpMV backend autotune results")
    p.add_argument("--cr", type=_bool, default=True, metavar="true/false",
                   help="Curtis-Reid prescaling (default: true)")
    p.add_argument("--ruiz", type=_bool, default=True, metavar="true/false",
                   help="Ruiz scaling (default: true)")
    p.add_argument("--pock", type=_bool, default=True, metavar="true/false",
                   help="Pock-Chambolle scaling (default: true)")
    p.add_argument("--bc", type=_bool, default=True, metavar="true/false",
                   help="Bounds/cost scaling (default: true)")
    p.add_argument("--presolve", type=_bool, default=True,
                   metavar="true/false",
                   help="Presolve (default: true)")
    # Extras beyond the reference CLI.
    p.add_argument("--precision",
                   choices=("auto", "f32", "f64", "mixed"),
                   default="auto",
                   help="Solve precision (default: auto; mixed = f32 "
                        "stages + f64 refinement tail)")
    p.add_argument("--mesh", type=int, default=None, metavar="N",
                   help="Shard the solve over N devices")
    p.add_argument("--mps-format", choices=("free", "fixed"),
                   default="free",
                   help="MPS card format: free (whitespace tokens, default) "
                        "or fixed (column positions; names may contain "
                        "spaces)")
    p.add_argument("--quiet", action="store_true", help="Suppress progress")
    p.add_argument("--malloc-tune", action="store_true",
                   help="Tune the host allocator for giant ingest (brk-heap "
                        "mallopt + transparent hugepages; THP is a "
                        "host-global kernel policy, restored at exit)")
    p.add_argument("--solution-out", metavar="FILE", default=None,
                   help="Write status/objective/x/y/z to FILE in a plain "
                        "text format (consumed by the Julia/MATLAB "
                        "wrappers)")
    return p


def write_solution(path: str, res) -> None:
    """Plain-text solution file: `key value` lines, then one `<name> <len>`
    header per vector followed by its values, one per line."""
    with open(path, "w") as f:
        f.write(f"status {res.status}\n")
        f.write(f"iter {res.iter}\n")
        f.write(f"time {res.time!r}\n")
        f.write(f"primal_obj {res.primal_obj!r}\n")
        f.write(f"dual_obj {res.dual_obj!r}\n")
        f.write(f"gap {res.gap!r}\n")
        f.write(f"residuals {res.residuals!r}\n")
        for name in ("x", "y", "z"):
            v = getattr(res, name)
            if v is None:
                f.write(f"{name} 0\n")
                continue
            f.write(f"{name} {len(v)}\n")
            for val in v:
                f.write(f"{float(val)!r}\n")


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if not os.path.exists(args.input):
        print(f"Input file not found: {args.input}", file=sys.stderr)
        return 1

    if args.malloc_tune:
        from ._malloc import tune_malloc

        tune_malloc(thp=True)

    from .model import Model
    from .params import Parameters

    params = Parameters(
        max_iter=args.max_iter,
        stop_tol=args.tol,
        time_limit=args.time_limit,
        device_number=args.device,
        check_iter=args.check_iter,
        spmv_backend="xla" if args.cusparse_spmv else "auto",
        autotune_verbose=args.autotune_verbose,
        use_CR_scaling=args.cr,
        use_Ruiz_scaling=args.ruiz,
        use_Pock_Chambolle_scaling=args.pock,
        use_bc_scaling=args.bc,
        use_presolve=args.presolve,
        precision=args.precision,
        mesh_shape=args.mesh,
        verbose=not args.quiet,
    )
    try:
        model = Model.from_mps(args.input, mps_format=args.mps_format)
    except Exception as e:  # parse errors -> exit 1 with message
        print(f"Failed to read {args.input}: {e}", file=sys.stderr)
        return 1
    res = model.solve(params)
    if args.quiet:
        print(f"status={res.status} iter={res.iter} time={res.time:.3f}s "
              f"obj={res.primal_obj:.12e} kkt={res.residuals:.3e}")
    if args.solution_out:
        write_solution(args.solution_out, res)
    return 0 if res.status == "OPTIMAL" else 2


if __name__ == "__main__":
    sys.exit(main())
