"""Run the five BASELINE.json benchmark configurations end to end.

Usage:  python examples/run_baseline_configs.py [--quick]

--quick shrinks the heavy configs (for CPU smoke runs); without it the
sizes match BASELINE.json exactly (expects a GPU for sane wall times).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

# Allow running as `python examples/run_baseline_configs.py` from a source
# checkout without installation.
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def banner(i, text):
    print(f"\n=== config[{i}] {text}")


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--quick", action="store_true")
    args = parser.parse_args(argv)

    import nodal_tpu

    nodal_tpu.enable_x64()  # exact reference-parity output for configs 0-2

    import jax
    import jax.numpy as jnp

    from nodal_tpu import Circuit, Netlist, Quirks
    from nodal_tpu.batch import monte_carlo
    from nodal_tpu.ops.grid import grid_equivalent_resistance
    from nodal_tpu.utils.gridgen import ladder_rows

    # -- config[0]: doc/netlist.csv divider through the documented API ----
    banner(0, "3-component divider (dense path)")
    rows = [["1", "A", "1", "1", "3"], ["r2", "R", "1", "2", "3"],
            ["r3", "R", "1", "1", "2"]]
    print(Circuit(Netlist.from_rows(rows)).solve())

    # -- config[1]: 1.6.1 with E source + CCCS branch currents -------------
    banner(1, "1.6.1 circuit: branch equations i(d1), i(e1)")
    rows = [r.split(",") for r in (
        "r1,R,2,1,4", "r2,R,2,1,g", "r3,R,0.5,1,2",
        "e1,E,8,4,g", "a1,A,4,1,2", "d1,CCCS,2,2,g,1,g,r2")]
    print(Circuit(Netlist.from_rows(rows)).solve())

    # -- config[2]: OPMODEL macromodel expansion ---------------------------
    banner(2, "OPMODEL non-inverting amplifier + voltage buffer")
    amp = [["q1", "OPMODEL", "1", "2", "g", "3", "1"],
           ["v1", "E", "1", "3", "g"], ["r1", "R", "1", "g", "1"]]
    sol = Circuit(Netlist.from_rows(amp)).solve()
    print(f"amplifier e(2) = {sol.potential('2'):.12f}  (ideal: 2)")
    buf = [["q1", "OPMODEL", "0", "2", "g", "3", "2"],
           ["v1", "E", "1", "3", "g"]]
    sol = Circuit(Netlist.from_rows(buf)).solve()
    print(f"buffer    e(2) = {sol.potential('2'):.12f}  (ideal: 1)")

    # -- config[3]: 10k-way Monte Carlo on a 256-node ladder ---------------
    n_mc = 1024 if args.quick else 10_000
    banner(3, f"{n_mc}-way resistor-tolerance Monte Carlo, 256-node ladder")
    circuit = Circuit(Netlist.from_rows(ladder_rows(256)))
    tolerances = {f"rs{k}": 0.05 for k in range(256)}
    t0 = time.perf_counter()
    out = monte_carlo(circuit, tolerances, n=n_mc, seed=0)
    mean = float(out["mean"][circuit.netlist.nodenum["n0"]])
    cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = monte_carlo(circuit, tolerances, n=n_mc, seed=1)
    std = float(out["std"][circuit.netlist.nodenum["n0"]])
    warm = time.perf_counter() - t0
    print(f"e(n0): mean={mean:.5f} std={std:.5f}  "
          f"({n_mc} solves: {cold:.2f}s cold incl. compile, {warm:.3f}s warm "
          f"-> {n_mc/warm:,.0f} solves/s)")

    # -- config[4]: 1024x1024 grid knight's-move equivalent resistance -----
    n = 128 if args.quick else 1024
    banner(4, f"{n}x{n} resistor grid knight's-move equivalent resistance")
    a, b = (n // 2, n // 2), (n // 2 + 1, n // 2 + 2)
    t0 = time.perf_counter()
    r, info = grid_equivalent_resistance(n, n, a, b, dtype=jnp.float32,
                                         tol=1e-6)
    r = float(r)
    dt = time.perf_counter() - t0
    print(f"R = {r:.6f}  ({int(info.iterations)} MG-CG iterations, "
          f"{dt:.2f}s incl. compile; xkcd-356 infinite-grid value: "
          f"{4/np.pi - 0.5:.6f})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
