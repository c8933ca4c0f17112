"""Regression tests for round-2 review findings (VERDICT.md / ADVICE.md).

Covers: BatchedSolver method validation, the monte_carlo residual audit
(negative-sample sweeps), verified f64 refinement in the stamp-level
equivalent-resistance path, and the reference-compatible Solution
constructor.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from nodal_tpu import Circuit, Netlist
from nodal_tpu.batch import BatchedSolver, monte_carlo
from nodal_tpu.utils.gridgen import grid_rows, ladder_rows

import fixtures as fx


def test_unknown_method_rejected():
    circuit = Circuit(Netlist.from_rows(ladder_rows(8)))
    with pytest.raises(ValueError, match="unknown method"):
        BatchedSolver(circuit, method="tridiagonal")


def test_monte_carlo_audit_reports_residual():
    circuit = Circuit(Netlist.from_rows(ladder_rows(32)))
    name = next(iter(circuit.stamps.param_slot))
    out = monte_carlo(circuit, {name: 0.05}, n=64, seed=0)
    assert "max_residual" in out
    assert out["max_residual"] < 1e-3

    out_off = monte_carlo(circuit, {name: 0.05}, n=64, seed=0, audit=False)
    assert "max_residual" not in out_off


def test_monte_carlo_audit_flags_negative_samples(caplog):
    # Relative sigma 1.0 draws negative resistances in ~16% of samples,
    # leaving the no-pivot tridiag fast path's diagonal-dominance domain.
    # The RAW tier (refine=False) must still measure and flag that; the
    # round-4 default (refine="auto") instead rescues such samples — see
    # tests/test_contract_tier.py.
    circuit = Circuit(Netlist.from_rows(ladder_rows(64)))
    tolerances = {k: 1.0 for k in circuit.stamps.param_slot}
    with caplog.at_level("WARNING", logger="nodal_tpu.batch"):
        out = monte_carlo(circuit, tolerances, n=256, seed=0,
                          refine=False)
    assert out["max_residual"] > 1e-3
    assert any("diagonal-dominance" in r.message for r in caplog.records)


def test_residuals_detect_corruption_tridiag():
    circuit = Circuit(Netlist.from_rows(ladder_rows(32)))
    solver = BatchedSolver(circuit, dtype=jnp.float64)
    batch = np.tile(circuit.stamps.params, (4, 1))
    xs = np.asarray(solver(batch))
    good = np.asarray(solver.residuals(batch, xs))
    bad = np.asarray(solver.residuals(batch, xs + 1.0))
    assert np.all(good < 1e-9)
    assert np.all(bad > 1e-3)


def test_residuals_detect_corruption_dense():
    rows = [r.split(",") for r in fx.CIRCUIT_161.strip().splitlines()]
    circuit = Circuit(Netlist.from_rows(rows))
    solver = BatchedSolver(circuit, dtype=jnp.float64)  # dense: has branch eqs
    assert solver.method == "dense"
    batch = np.tile(circuit.stamps.params, (4, 1))
    xs = np.asarray(solver(batch))
    bad = np.asarray(solver.residuals(batch, 0.0 * xs))
    assert np.all(bad > 1e-3)


def test_residuals_coo_matches_dense_matvec():
    # The assembly-free COO audit (one scatter-add matvec from stamp
    # entries, replacing the chunked dense/band re-assembly that OOMed at
    # B=4096) must agree with an explicit dense G x residual.
    from nodal_tpu.ops.assemble import assemble_dense

    rows = list(grid_rows(3, 3, (0, 0), (2, 2)))
    rows.append(["src", "A", "1", "1", "g"])
    circuit = Circuit(Netlist.from_rows(rows))
    solver = BatchedSolver(circuit, dtype=jnp.float64)
    rng = np.random.default_rng(0)
    batch = circuit.stamps.params * (
        1.0 + 0.1 * rng.standard_normal((7, len(circuit.stamps.params)))
    )
    xs = np.array(solver(batch))  # writable copy
    xs[3] *= 1.5  # one corrupted sample must be flagged
    got = np.asarray(solver.residuals(batch, xs))
    want = np.zeros(7)
    for i in range(7):
        G, b = assemble_dense(circuit.stamps, jnp.asarray(batch[i]))
        r = np.asarray(b) - np.asarray(G) @ xs[i]
        want[i] = np.max(np.abs(r)) / max(np.max(np.abs(np.asarray(b))), 1.0)
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-15)
    assert got[3] > 1e-2 and got[0] < 1e-12


# -- equivalent resistance from stamps (equiv.py) ---------------------------


def _ladder_probe(n=32):
    circuit = Circuit(Netlist.from_rows(ladder_rows(n)))
    G, _ = circuit.build_model()
    rhs = np.zeros(circuit.stamps.n)
    rhs[0], rhs[-1] = 1.0, -1.0
    x = np.linalg.solve(np.asarray(G), rhs)
    return circuit.stamps, x[0] - x[-1]


def test_equivalent_resistance_stamps_f64_is_direct():
    # f64 solves in f64 end to end (no f32 solve + refinement detour).
    from nodal_tpu.equiv import equivalent_resistance_stamps

    stamps, want = _ladder_probe()
    got = equivalent_resistance_stamps(stamps, 0, stamps.n - 1,
                                       dtype=jnp.float64, tol=1e-12)
    assert abs(got - want) / abs(want) < 1e-9


def test_equivalent_resistance_stamps_f32():
    from nodal_tpu.equiv import equivalent_resistance_stamps

    stamps, want = _ladder_probe()
    got = equivalent_resistance_stamps(stamps, 0, stamps.n - 1,
                                       dtype=jnp.float32, tol=1e-6)
    assert abs(got - want) / abs(want) < 1e-4


# -- shipped example corpus (VERDICT #9) --------------------------------------

_EXAMPLES = "examples"


def _example(name):
    import os

    path = os.path.join(os.path.dirname(__file__), "..", _EXAMPLES, name)
    assert os.path.exists(path), f"missing shipped example {name}"
    return path


@pytest.mark.parametrize("name,node,expected", [
    ("netlist.csv", "2", -1.0),
    ("1.6.1.csv", "2", -1.0),
    ("buffer.csv", "2", 9.999900000899993),
    ("opmodel_amplifier.csv", "2", 1.9997600287845492),
    ("opmodel_voltage_buffer.csv", "2", 0.999990000099999),
    ("test_1.csv", "6", 1.0),
    ("divider.csv", "2", -1.0),
    ("all_components.csv", "6", 1.0),
    ("opamp_amplifier.csv", "2", 1.9997600287845492),
    ("unconnected_0.csv", "2", 6.0),
])
def test_shipped_solver_examples(name, node, expected):
    solution = Circuit(Netlist(_example(name))).solve()
    np.testing.assert_allclose(solution.potential(node), expected, rtol=1e-6)


@pytest.mark.parametrize("name,expected", [
    ("resistive_1.csv", 2.0),
    ("resistive_2.csv", 1.0),
    ("resistive_3.csv", 1.0),
])
def test_shipped_resistance_examples(name, expected):
    from nodal_tpu.equiv import equivalent_resistance

    r = equivalent_resistance(Netlist(_example(name)), "1", "g")
    np.testing.assert_allclose(r, expected, rtol=1e-9)


def test_shipped_unconnected_example_exits_1():
    from nodal_tpu import solver_cli

    with pytest.raises(SystemExit) as exc:
        solver_cli.main([_example("unconnected_1.csv")])
    assert exc.value.code == 1


def test_solution_reference_constructor_shape(tmp_netlist):
    # Reference code constructs Solution(e, netlist, currents) positionally
    # (reference nodal.py:414-420); the third slot must accept that.
    from nodal_tpu import Solution

    nl = Netlist.from_rows([["r1", "R", "2", "1", "g"],
                            ["a1", "A", "1", "1", "g"]])
    e = np.array([2.0])
    sol = Solution(e, nl, ["i_r1"])
    assert sol.currents == ["i_r1"]
    assert sol.potential("1") == 2.0
    assert sol.stats is None
