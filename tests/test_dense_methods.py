"""General-topology dense solver paths: the Schur-complement method for
branch-equation systems, the multi-RHS blocked solve it relies on, and the
batched dense tiers."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from nodal_tpu import Circuit, Netlist
from nodal_tpu.batch import BatchedSolver, _schur_supported
from nodal_tpu.ops import block_lu
from nodal_tpu.ops.assemble import assemble_dense
from nodal_tpu.utils.gridgen import grid_rows


def _mesh_with_branches():
    rows = list(grid_rows(8, 8, (0, 0), (7, 7)))
    rows += [
        ["e1", "E", "2", "1", "g"],
        ["d1", "VCCS", "0.5", "n0_3", "g", "1", "g"],
        ["f1", "CCCS", "1.5", "n3_3", "g", "1", "g", "e1"],
    ]
    return Circuit(Netlist.from_rows(rows))


def _expected(circuit, params):
    G, b = assemble_dense(circuit.stamps, jnp.asarray(params, jnp.float64))
    return np.linalg.solve(np.asarray(G), np.asarray(b))


def test_schur_matches_dense_f64():
    circuit = _mesh_with_branches()
    solver = BatchedSolver(circuit, dtype=jnp.float64, method="schur")
    rng = np.random.default_rng(1)
    base = circuit.stamps.params
    batch = base * (1.0 + 0.05 * rng.standard_normal((5, len(base))))
    xs = np.asarray(solver(batch))
    for i in range(5):
        exp = _expected(circuit, batch[i])
        np.testing.assert_allclose(xs[i], exp, rtol=1e-10, atol=1e-12)


def test_schur_refined_f32_reaches_1e6():
    circuit = _mesh_with_branches()
    solver = BatchedSolver(circuit, dtype=jnp.float32, refine=True,
                           method="schur")
    batch = np.tile(circuit.stamps.params, (3, 1))
    xs = np.asarray(solver(batch))
    exp = _expected(circuit, batch[0])
    err = np.max(np.abs(xs[0] - exp)) / np.max(np.abs(exp))
    assert err < 1e-6


def test_schur_auto_selected_on_large_mesh_with_source():
    rows = list(grid_rows(25, 40, (0, 0), (24, 39))) + [
        ["e1", "E", "2", "1", "g"]
    ]
    circuit = Circuit(Netlist.from_rows(rows))
    assert BatchedSolver(circuit).method == "schur"


def test_schur_rejected_when_node_block_singular():
    # Node "1" is held only by the voltage source; nodes 1-2 form a
    # resistive island with no path to ground -> A singular -> dense.
    rows = [["e1", "E", "1", "1", "g"],
            ["r1", "R", "1", "1", "2"],
            ["r2", "R", "2", "2", "1"]]
    circuit = Circuit(Netlist.from_rows(rows))
    assert not _schur_supported(circuit.stamps)
    assert BatchedSolver(circuit).method == "dense"
    with pytest.raises(ValueError, match="Cholesky probe"):
        BatchedSolver(circuit, method="schur")


def test_schur_rejected_on_resistive_circuit():
    circuit = Circuit(Netlist.from_rows(grid_rows(4, 4, (0, 0), (3, 3))))
    with pytest.raises(ValueError, match="branch equations"):
        BatchedSolver(circuit, method="schur")


def test_blocked_solve_factored_matrix_rhs():
    rng = np.random.default_rng(0)
    n, r = 256, 7
    A = rng.standard_normal((n, n)) * 0.3
    A = A + A.T + np.eye(n) * (np.abs(A).sum(1).max() + 1.0)
    R = rng.standard_normal((n, r))
    panels = block_lu.blocked_factor(jnp.asarray(A))
    Y = np.asarray(block_lu.blocked_solve_factored(panels, jnp.asarray(R)))
    np.testing.assert_allclose(Y, np.linalg.solve(A, R), rtol=1e-8,
                               atol=1e-10)
    # Vector RHS still works (shape round-trip).
    y = np.asarray(
        block_lu.blocked_solve_factored(panels, jnp.asarray(R[:, 0]))
    )
    np.testing.assert_allclose(y, np.linalg.solve(A, R[:, 0]), rtol=1e-8,
                               atol=1e-10)


def _dominant(rng, B, n, r=None):
    A = rng.standard_normal((B, n, n)).astype(np.float32) * 0.5
    A = A + np.transpose(A, (0, 2, 1))
    A += np.eye(n)[None] * (np.abs(A).sum(-1).max(-1)[:, None, None] + 1.0)
    shape = (B, n) if r is None else (B, n, r)
    return A, rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("n", [256, 999])
def test_blocked_solve_f32_matches_numpy(n):
    # The block tier's f32 solve (padded to the 128 block when n=999).
    rng = np.random.default_rng(n)
    A, b = _dominant(rng, 3, n)
    x = np.asarray(block_lu.blocked_solve(jnp.asarray(A), jnp.asarray(b)))
    exp = np.linalg.solve(A.astype(np.float64),
                          b[..., None].astype(np.float64))[..., 0]
    err = np.max(np.abs(x - exp)) / np.max(np.abs(exp))
    assert err < 5e-6


def test_blocked_solve_f32_multi_rhs():
    rng = np.random.default_rng(7)
    A, R = _dominant(rng, 3, 256, r=5)
    X = np.asarray(block_lu.blocked_solve(jnp.asarray(A), jnp.asarray(R)))
    exp = np.linalg.solve(A.astype(np.float64), R.astype(np.float64))
    err = np.max(np.abs(X - exp)) / np.max(np.abs(exp))
    assert err < 5e-5


def test_schur_solve_f32_matches_dense():
    # The dense Schur tier at f32: block elimination of the branch rows.
    circuit = _mesh_with_branches()
    stamps = circuit.stamps
    batch = np.tile(stamps.params, (2, 1)).astype(np.float32)
    G, b = jax.vmap(lambda p: assemble_dense(stamps, p,
                                             dtype=jnp.float32))(
        jnp.asarray(batch))
    x = np.asarray(block_lu.schur_solve(G, b, stamps.n_kcl))
    exp = _expected(circuit, batch[0])
    err = np.max(np.abs(x[0] - exp)) / np.max(np.abs(exp))
    assert err < 1e-4


def test_block_method_f64_matches_dense():
    # The block tier (pinned) on random long-range resistors.
    rng = np.random.default_rng(3)
    n = 150
    rows = [["rg", "R", "1", "n0", "g"]]
    rows += [[f"rc{i}", "R", "1", f"n{i}", f"n{i + 1}"]
             for i in range(n - 1)]
    for k, j in enumerate(rng.integers(0, n, size=120)):
        i = int((j * 7919 + 13) % n)
        if i != int(j):
            rows.append([f"rl{k}", "R", "2", f"n{j}", f"n{i}"])
    circuit = Circuit(Netlist.from_rows(rows))
    solver = BatchedSolver(circuit, dtype=jnp.float64, method="block")
    xs = np.asarray(solver(np.tile(circuit.stamps.params, (2, 1))))
    np.testing.assert_allclose(xs[0], _expected(circuit,
                                                circuit.stamps.params),
                               rtol=1e-9, atol=1e-11)


def test_solve_dense_f64_is_direct():
    # f64 LU runs in f64 on every backend (no f32 refinement detour).
    from nodal_tpu.ops.dense_solve import solve_dense

    rng = np.random.default_rng(4)
    A = rng.standard_normal((40, 40)) + 40 * np.eye(40)
    b = rng.standard_normal(40)
    x = solve_dense(jnp.asarray(A), jnp.asarray(b))
    assert x.dtype == jnp.float64
    np.testing.assert_allclose(np.asarray(x), np.linalg.solve(A, b),
                               rtol=1e-13, atol=1e-14)


def test_blocked_factor_weakly_dominant_laplacian():
    # Interior Laplacian rows have |diag| == sum|offdiag| (weak dominance);
    # the no-pivot blocked factorization must still solve to f64 accuracy.
    n = 256
    A = np.zeros((n, n))
    for i in range(n):
        A[i, i] = 4.0 + (1e-3 if i == 0 else 0.0)
        for j in (i - 1, i + 1, i - 16, i + 16):
            if 0 <= j < n:
                A[i, j] = -1.0
    b = np.random.default_rng(0).standard_normal(n)
    x = np.asarray(block_lu.blocked_solve(jnp.asarray(A), jnp.asarray(b)))
    np.testing.assert_allclose(A @ x, b, atol=1e-10)
