"""``nodal-solver`` command line: solve a CSV netlist and print the solution.

Parity target: reference solver.py — same positional netlist path, same
``-s/--sparse`` flag, same exit codes (missing file → 1, unconnected
circuit → 1), same printed format.  Additional flags select precision and
print solver statistics.
"""

from __future__ import annotations

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Solve electrical circuits using nodal analysis"
    )
    parser.add_argument(
        "netlist_path", metavar="FILE", help="csv file describing the netlist"
    )
    parser.add_argument(
        "-s", "--sparse", action="store_true", help="use the sparse/iterative backend"
    )
    parser.add_argument(
        "--dtype",
        choices=("f32", "f64"),
        default="f64",
        help="numeric precision (default f64; f32 is the fast path)",
    )
    parser.add_argument(
        "--stats", action="store_true", help="print timing statistics to stderr"
    )
    parser.add_argument(
        "--native",
        choices=("auto", "on", "off"),
        default="auto",
        help="use the C++ netlist parser + iterative solve for large "
        "netlists (auto: over 256 KiB)",
    )
    parser.add_argument(
        "--compat-vccs",
        action="store_true",
        help="stamp VCCS with VCVS semantics, bit-matching upstream nodal "
        "(whose dispatcher routes VCCS to its VCVS stamp); default is "
        "correct transconductance semantics",
    )
    parser.add_argument(
        "--sensitivity",
        metavar="TARGET",
        default=None,
        help="also print d TARGET / d value for every component, where "
        "TARGET is an output quantity as printed, e.g. 'e(2)' or 'i(v1)' "
        "— computed by the adjoint method (one extra solve total, not one "
        "per component)",
    )
    return parser


_NATIVE_SIZE_THRESHOLD = 256 * 1024


def _try_native(args) -> bool:
    """Native fast path: C++ parse -> stamp tensors -> Krylov solve ->
    print.  Returns True if it handled the request."""
    import os
    import time

    if args.native == "off":
        return False
    try:
        size = os.path.getsize(args.netlist_path)
    except OSError:
        return False
    if args.native == "auto" and size < _NATIVE_SIZE_THRESHOLD:
        return False
    try:
        from nodal_tpu.utils import native
    except ImportError:  # pragma: no cover
        return False
    quirks = None
    if args.compat_vccs:
        from nodal_tpu.models.stamps import Quirks

        quirks = Quirks(vccs_as_vcvs=True)
    t0 = time.perf_counter()
    try:
        with open(args.netlist_path, "rb") as fh:
            stamps, symbols = native.parse_stamps(fh.read(), quirks=quirks)
    except native.NativeUnavailable:
        return False
    t1 = time.perf_counter()

    import numpy as np

    from nodal_tpu.ops.sparse import solve_sparse_system

    x, info = solve_sparse_system(stamps, stamps.params)
    device = (next(iter(x.devices())).platform if hasattr(x, "devices")
              else "host")
    x = np.asarray(x, dtype=np.float64)
    if not bool(info.converged) or not np.all(np.isfinite(x)):
        # Non-convergence here does NOT imply a singular system (Krylov can
        # stall on hard-but-solvable MNA systems) — fall back to the full
        # Python path, whose Circuit.solve has the dense rescue and the
        # uniform singularity diagnosis.
        return False
    t2 = time.perf_counter()

    lines = [f"Ground node: {symbols.ground}"]
    for name, row in sorted(symbols.node_rows()):
        lines.append(f"e({name}) \t= {x[row]}")
    for name, row in sorted(symbols.anomalous_rows()):
        lines.append(f"i({name}) \t= {x[row]}")
    print("\n".join(lines))
    if args.stats:
        print(
            f"parse: {t1 - t0:.4f}s  compile+solve: {t2 - t1:.4f}s  "
            f"method: native+{getattr(info, 'method', '') or 'krylov'}  "
            f"device: {device}  "
            f"residual: {float(info.residual):.2e}  "
            f"iterations: {int(info.iterations)}",
            file=sys.stderr,
        )
    return True


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)

    from nodal_tpu.utils.cache import enable_persistent_cache

    enable_persistent_cache()

    if args.dtype == "f64":
        import nodal_tpu

        nodal_tpu.enable_x64()

    if args.sensitivity is None and _try_native(args):
        return

    import time

    from nodal_tpu import Circuit, Netlist, UnconnectedCircuitError

    t0 = time.perf_counter()
    try:
        netlist = Netlist(args.netlist_path)
    except FileNotFoundError:
        sys.exit(1)
    t1 = time.perf_counter()

    quirks = None
    if args.compat_vccs:
        from nodal_tpu.models.stamps import Quirks

        quirks = Quirks(vccs_as_vcvs=True)
    circuit = Circuit(netlist, sparse=args.sparse, quirks=quirks)
    try:
        solution = circuit.solve()
    except UnconnectedCircuitError:
        sys.exit(1)
    t2 = time.perf_counter()

    print(solution)
    if args.sensitivity is not None:
        import re

        m = re.fullmatch(r"([ei])\((.+)\)", args.sensitivity.strip())
        if m is None:
            print(f"bad --sensitivity target {args.sensitivity!r}: "
                  "expected e(<node>) or i(<component>)", file=sys.stderr)
            sys.exit(1)
        from nodal_tpu.batch import sensitivities

        kind, name = m.group(1), m.group(2)
        try:
            sens = sensitivities(
                circuit,
                **({"potential": name} if kind == "e"
                   else {"current": name}),
            )
        except KeyError as exc:
            print(f"--sensitivity: {exc.args[0]}", file=sys.stderr)
            sys.exit(1)
        print(f"Sensitivities of {kind}({name}):")
        for comp in sorted(sens):
            print(f"d/d({comp}) \t= {sens[comp]}")
    if args.stats:
        detail = ""
        if solution.stats:
            s = solution.stats
            detail = (
                f"  method: {s['method']}  device: {s['device']}"
                f"  residual: {s['residual']:.2e}"
                + (f"  iterations: {s['iterations']}" if "iterations" in s else "")
            )
        print(
            f"parse: {t1 - t0:.4f}s  compile+solve: {t2 - t1:.4f}s{detail}",
            file=sys.stderr,
        )


if __name__ == "__main__":
    main()
