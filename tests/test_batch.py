"""Batched-sweep consistency: vmapped solves must match per-sample solves."""

import numpy as np
import jax.numpy as jnp

from nodal_tpu import Circuit, Netlist
from nodal_tpu.batch import BatchedSolver, monte_carlo

import fixtures as fx


def test_batched_matches_single(tmp_netlist):
    circuit = Circuit(Netlist(tmp_netlist(fx.CIRCUIT_161)))
    solver = BatchedSolver(circuit, dtype=jnp.float64)

    rng = np.random.default_rng(42)
    B = 16
    base = circuit.stamps.params
    batch = base * (1.0 + 0.1 * rng.standard_normal((B, len(base))))
    results = np.asarray(solver(batch))

    for i in range(B):
        G, b = _assemble_numpy(circuit, batch[i])
        expected = np.linalg.solve(G, b)
        np.testing.assert_allclose(results[i], expected, rtol=1e-8, atol=1e-12)


def _assemble_numpy(circuit, params):
    from nodal_tpu.ops.assemble import assemble_dense

    G, b = assemble_dense(circuit.stamps, jnp.asarray(params, dtype=jnp.float64))
    return np.asarray(G), np.asarray(b)


def test_f32_refined_reaches_f64_accuracy(tmp_netlist):
    circuit = Circuit(Netlist(tmp_netlist(fx.RESISTIVE_3)))
    base = circuit.stamps.params
    batch = np.tile(base, (4, 1))

    refined = np.asarray(BatchedSolver(circuit, refine=True)(batch))
    G, b = _assemble_numpy(circuit, base)
    expected = np.linalg.solve(G, b)
    np.testing.assert_allclose(refined[0], expected, rtol=1e-9, atol=1e-12)


def test_params_with_overrides(tmp_netlist):
    circuit = Circuit(Netlist(tmp_netlist(fx.RESISTIVE_1)))
    solver = BatchedSolver(circuit)
    batch = solver.params_with({"r1": np.array([1.0, 2.0, 3.0])})
    assert batch.shape == (3, 2)
    slot = circuit.stamps.param_slot["r1"]
    np.testing.assert_array_equal(batch[:, slot], [1.0, 2.0, 3.0])
    other = circuit.stamps.param_slot["r2"]
    np.testing.assert_array_equal(batch[:, other], [1.0, 1.0, 1.0])


def test_residual_audit(tmp_netlist):
    from nodal_tpu.utils.gridgen import ladder_rows

    circuit = Circuit(Netlist.from_rows(ladder_rows(64)))
    solver = BatchedSolver(circuit, dtype=jnp.float64)
    batch = np.tile(circuit.stamps.params, (4, 1))
    solutions = solver(batch)
    res = np.asarray(solver.residuals(batch, solutions))
    assert res.shape == (4,)
    assert np.all(res < 1e-9)


def test_residual_gather_fold_matches_scatter(tmp_netlist):
    """The gather-fold audit must equal the scatter-add form bit-for-bit
    wherever both apply (the fold is the fast path; the scatter is the
    dense-row fallback and the historical reference)."""
    import jax
    import jax.numpy as jnp2

    from nodal_tpu.batch import _coo_residuals, _resid_gather_tables
    from nodal_tpu.utils.gridgen import grid_rows

    rows = list(grid_rows(5, 8, (0, 0), (4, 7))) + [
        ["src", "A", "1", "n1_1", "g"],
        ["e1", "E", "2", "n0_0", "g"],
        ["d", "VCCS", "0.5", "n2_2", "g", "n0_0", "g"],
    ]
    circuit = Circuit(Netlist.from_rows(rows))
    solver = BatchedSolver(circuit, dtype=jnp.float64)
    rng = np.random.default_rng(7)
    batch = circuit.stamps.params * rng.uniform(
        0.8, 1.2, (6, len(circuit.stamps.params)))
    xs = jnp2.asarray(np.asarray(solver(batch), np.float64))
    batch = jnp2.asarray(batch)

    assert _resid_gather_tables(circuit.stamps) is not None
    fold = np.asarray(_coo_residuals(circuit.stamps, batch, xs))
    circuit.stamps.__dict__["_resid_gf"] = None  # force the scatter path
    try:
        jax.clear_caches()
        scatter = np.asarray(_coo_residuals(circuit.stamps, batch, xs))
    finally:
        del circuit.stamps.__dict__["_resid_gf"]
    np.testing.assert_array_equal(fold, scatter)
    assert fold.max() < 1e-9  # solutions are genuinely good


def test_sweep_api(tmp_netlist):
    from nodal_tpu.batch import sweep

    circuit = Circuit(Netlist(tmp_netlist(fx.DIVIDER)))
    values = np.linspace(1.0, 4.0, 7)
    result = sweep(circuit, "r3", values, dtype=jnp.float64, method="dense")
    # Divider: e(2) = -r3 * 1A (current flows 1->3, r3 spans 1-2; from the
    # golden, e(2) = -1 at r3=1) -> linear in r3.
    e2 = np.asarray(result.potential("2"))
    np.testing.assert_allclose(e2, -values, rtol=1e-9)
    # Ground potential accessor: zeros.
    np.testing.assert_array_equal(np.asarray(result.potential("1")), 0.0)


def test_monte_carlo_stats(tmp_netlist):
    # Divider: e(2) = -r3 * I; 5% tolerance on r3 propagates linearly.
    circuit = Circuit(Netlist(tmp_netlist(fx.DIVIDER)))
    out = monte_carlo(circuit, {"r3": 0.05}, n=2048, seed=1)
    node2 = circuit.netlist.nodenum["2"]
    mean = float(out["mean"][node2])
    std = float(out["std"][node2])
    np.testing.assert_allclose(mean, -1.0, atol=0.01)
    np.testing.assert_allclose(std, 0.05, atol=0.01)
