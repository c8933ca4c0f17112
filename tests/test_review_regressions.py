"""Regression tests for the round-1 code-review findings."""

import numpy as np
import jax.numpy as jnp
import pytest

from nodal_tpu import Circuit, Netlist, NetlistError
from nodal_tpu.batch import BatchedSolver
from nodal_tpu.utils.gridgen import grid_rows, ladder_rows

import fixtures as fx


def test_forced_tridiag_on_wide_matrix_rejected():
    # Silently dropping out-of-band entries returned wrong answers before.
    circuit = Circuit(Netlist.from_rows(grid_rows(3, 3, (0, 0), (2, 2))))
    with pytest.raises(ValueError, match="bandwidth"):
        BatchedSolver(circuit, method="tridiag")


def test_forced_fast_method_on_anomalous_rejected():
    rows = [r.split(",") for r in fx.CIRCUIT_161.strip().splitlines()]
    circuit = Circuit(Netlist.from_rows(rows))
    for method in ("tridiag", "block"):
        with pytest.raises(ValueError, match="resistive"):
            BatchedSolver(circuit, method=method)


@pytest.mark.parametrize("h,w", [(24, 40), (30, 44)])
def test_grid_solve_any_even_or_odd_shape(h, w):
    # The XLA V-cycle stops coarsening at odd sizes instead of rejecting
    # the shape; CG must still converge to the grounded solve.
    from nodal_tpu.ops.grid import grid_solve, laplacian_matvec

    rng = np.random.default_rng(h * w)
    b = rng.standard_normal((h, w))
    b -= b.mean()
    x, info = grid_solve(h, w, jnp.asarray(b), dtype=jnp.float64, tol=1e-10)
    assert bool(info.converged)
    r = np.asarray(laplacian_matvec(x)) - b
    assert np.max(np.abs(r)) < 1e-8


def test_pcr_long_chain():
    # 65,536-row chain through the XLA PCR (no length cap).
    from nodal_tpu.ops.tridiag import tridiag_matvec, tridiag_solve

    n = 65536
    rng = np.random.default_rng(0)
    dl = -rng.uniform(0.5, 1.0, (2, n))
    du = -rng.uniform(0.5, 1.0, (2, n))
    dl[:, 0] = 0.0
    du[:, -1] = 0.0
    d = 2.5 + rng.uniform(0.0, 1.0, (2, n))
    b = rng.standard_normal((2, n))
    x = tridiag_solve(*(jnp.asarray(t) for t in (dl, d, du, b)))
    r = np.asarray(tridiag_matvec(*(jnp.asarray(t) for t in (dl, d, du)),
                                  x)) - b
    assert np.max(np.abs(r)) < 1e-10


def test_empty_name_field_is_clean():
    # ',R,1,a,b' used to crash with IndexError in the Python front-end.
    nl = Netlist.from_rows([["", "R", "1", "a", "b"],
                            ["r2", "R", "1", "b", "g"]])
    assert "" in nl.components  # empty-name component, like the C++ parser


def test_monte_carlo_honors_f64(tmp_netlist):
    from nodal_tpu.batch import monte_carlo

    circuit = Circuit(Netlist(tmp_netlist(fx.DIVIDER)))
    out = monte_carlo(circuit, {"r3": 0.05}, n=64, dtype=jnp.float64)
    assert out["mean"].dtype == jnp.float64


def test_native_accepts_trailing_blank_in_value():
    native = pytest.importorskip("nodal_tpu.utils.native")
    try:
        native._load()
    except native.NativeUnavailable:
        pytest.skip("no native build")
    stamps, symbols = native.parse_stamps("r1,R,1.0 ,a,b\nr2,R,2,b,g\n")
    np.testing.assert_allclose(stamps.params, [1.0, 2.0])


def test_huge_sparse_nonconvergence_not_rescued(monkeypatch):
    # The dense rescue must not fire above the size gate.
    import nodal_tpu.circuit as circuit_mod

    monkeypatch.setattr(circuit_mod, "_DENSE_RESCUE_MAX_N", 4)
    circuit = Circuit(Netlist.from_rows(ladder_rows(16)), sparse=True)
    # Force the residual check to fail so the rescue path runs.
    monkeypatch.setattr(
        circuit_mod.Circuit, "_acceptable", lambda self, r, d=None: False
    )
    from numpy.linalg import LinAlgError

    with pytest.raises(LinAlgError):
        circuit.solve()
