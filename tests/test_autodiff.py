"""Adjoint gradients through BatchedSolver (implicit-function custom VJP).

Every solver method — including the Pallas-kernel paths, which have no
autodiff rules of their own — must be differentiable with jax.grad, and
the gradients must match reverse mode through a plain differentiable
reference (dense assembly + jnp.linalg.solve, which JAX differentiates
natively).  The custom VJP is one adjoint solve Gᵀλ = x̄ plus the COO
chain rule; see BatchedSolver._finalize (nodal_tpu/batch.py).

The reference has no gradient capability at all (numpy/scipy solves,
reference nodal.py:325-327) — this is new capability.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from nodal_tpu import Circuit, Netlist
from nodal_tpu.batch import BatchedSolver, monte_carlo
from nodal_tpu.ops.assemble import assemble_dense
from nodal_tpu.utils.gridgen import grid_rows, ladder_rows


def _oracle_grad(stamps, p, w):
    """d sum(w·x) / dp through plain differentiable dense assembly+solve."""

    def f(q):
        G, b = assemble_dense(stamps, q, dtype=jnp.float64)
        return jnp.sum(w * jnp.linalg.solve(G, b))

    return jax.grad(f)(p)


def _check_grad(rows, tol, **solver_kw):
    circuit = Circuit(Netlist.from_rows(rows))
    solver = BatchedSolver(circuit, **solver_kw)
    rng = np.random.default_rng(11)
    B = 3
    p = jnp.asarray(
        np.tile(circuit.stamps.params, (B, 1))
        * rng.uniform(0.9, 1.1, (B, len(circuit.stamps.params)))
    )
    w = jnp.asarray(rng.standard_normal((B, circuit.stamps.n)))
    g = jax.grad(lambda q: jnp.sum(w * solver._solve(q)))(p)
    go = jax.vmap(
        lambda pi, wi: _oracle_grad(circuit.stamps, pi, wi)
    )(p.astype(jnp.float64), w.astype(jnp.float64))
    rel = float(jnp.max(jnp.abs(g - go)) / jnp.max(jnp.abs(go)))
    assert rel < tol, (solver.method, rel)
    return solver.method


MESH = list(grid_rows(9, 40, (0, 0), (8, 39))) + [
    ["src", "A", "1", "n1_1", "g"]
]
SMALL_MESH = list(grid_rows(5, 20, (0, 0), (4, 19))) + [
    ["src", "A", "1", "n1_1", "g"]
]
# Resistively grounded mesh + branch equations: SPD node block -> schur.
SCHUR_ROWS = (
    list(grid_rows(9, 40, (0, 0), (8, 39)))
    + [["rg", "R", "1", "n0_0", "g"], ["rg2", "R", "1", "n8_39", "g"],
       ["e1", "E", "2", "n0_1", "g"],
       ["d", "VCCS", "0.5", "n2_2", "g", "n0_1", "g"]]
)
DENSE_ROWS = [
    ["e1", "E", "5", "1", "g"], ["r1", "R", "2", "1", "2"],
    ["r2", "R", "3", "2", "g"], ["d", "VCCS", "0.5", "3", "g", "1", "g"],
    ["r3", "R", "7", "3", "g"],
]


@pytest.mark.parametrize(
    "rows,kw,expect_method",
    [
        (ladder_rows(32), dict(dtype=jnp.float64), "tridiag"),
        (ladder_rows(32), dict(refine=True), "tridiag"),
        (MESH, dict(dtype=jnp.float64), "sband"),
        (MESH, dict(refine=True), "sband"),
        (MESH, dict(dtype=jnp.float64, method="band"), "band"),
        (MESH, dict(refine=True, method="band"), "band"),
        (SMALL_MESH, dict(dtype=jnp.float64, method="block"), "block"),
        (SMALL_MESH, dict(refine=True, method="block"), "block"),
        (SCHUR_ROWS, dict(dtype=jnp.float64), "schur"),
        (SCHUR_ROWS, dict(refine=True), "schur"),
        (DENSE_ROWS, dict(dtype=jnp.float64), "dense"),
        (DENSE_ROWS, dict(refine=True), "dense"),
    ],
)
def test_grad_matches_dense_autodiff(rows, kw, expect_method):
    method = _check_grad(rows, 1e-9, **kw)
    assert method == expect_method


def test_grad_f32_fast_tier_within_f32_floor():
    # The f32 fast tier's gradients inherit its ~1e-6 solution accuracy.
    method = _check_grad(MESH, 5e-4)
    assert method == "sband"


def test_schur_band_transpose_grad():
    """nk > 2048 bandable node block: the XLA band-Thomas Schur
    sub-branch, whose adjoint swaps the border blocks B ↔ Cᵀ."""
    rows = (
        list(grid_rows(9, 240, (0, 0), (8, 239)))
        + [["rg", "R", "1", "n0_0", "g"],
           ["rg2", "R", "1", "n8_239", "g"],
           ["e1", "E", "2", "n0_1", "g"],
           ["d", "VCCS", "0.5", "n2_2", "g", "n0_1", "g"]]
    )
    method = _check_grad(rows, 1e-9, dtype=jnp.float64)
    assert method == "schur"


def test_grad_through_jit_and_sum_of_squares():
    """jit(grad(loss)) composition — the optimization-loop usage."""
    circuit = Circuit(Netlist.from_rows(ladder_rows(16)))
    solver = BatchedSolver(circuit, dtype=jnp.float64)
    target = jnp.asarray(
        np.asarray(solver(np.tile(circuit.stamps.params, (1, 1))))[0]
    )

    @jax.jit
    def loss(p):
        x = solver._solve(p[None, :])[0]
        return jnp.sum((x - target) ** 2)

    p0 = jnp.asarray(circuit.stamps.params * 1.3)
    g = jax.jit(jax.grad(loss))(p0)
    # finite-difference spot check on the largest-gradient slot
    k = int(jnp.argmax(jnp.abs(g)))
    eps = 1e-6 * float(p0[k])
    lp = loss(p0.at[k].add(eps))
    lm = loss(p0.at[k].add(-eps))
    fd = (float(lp) - float(lm)) / (2 * eps)
    assert abs(float(g[k]) - fd) <= 1e-5 * max(1.0, abs(fd))
    # and gradient descent actually reduces the loss
    p1 = p0 - 0.1 * g
    assert float(loss(p1)) < float(loss(p0))


def test_monte_carlo_is_differentiable():
    """d(mean voltage)/d(nominal value) through the fused MC program —
    sampling is reparameterized (value = nominal·(1+σ·noise)), so the
    whole sweep differentiates w.r.t. the netlist values."""
    circuit = Circuit(Netlist.from_rows(ladder_rows(16)))
    stamps = circuit.stamps
    node = circuit.netlist.nodenum["n0"]

    def mean_v(params):
        solver = BatchedSolver(circuit, dtype=jnp.float64)
        key = jax.random.PRNGKey(0)
        noise = jax.random.normal(key, (64, len(params)),
                                  dtype=jnp.float64)
        batch = params * (1.0 + 0.05 * noise)
        xs = solver._solve(batch)
        return jnp.mean(xs[:, node])

    p0 = jnp.asarray(stamps.params)
    g = jax.grad(mean_v)(p0)
    assert np.all(np.isfinite(np.asarray(g)))
    k = int(jnp.argmax(jnp.abs(g)))
    eps = 1e-5
    fd = (float(mean_v(p0.at[k].mul(1 + eps)))
          - float(mean_v(p0.at[k].mul(1 - eps)))) / (2 * eps * float(p0[k]))
    assert abs(float(g[k]) - fd) <= 1e-6 * max(1.0, abs(fd))


def test_zero_valued_source_grad_is_nan_free():
    """A legal 0 V source must not poison gradients (the 1/x where-branch
    in stamp_values is masked with a double-where)."""
    rows = [
        ["e1", "E", "0", "1", "g"],   # 0 V source (ammeter idiom)
        ["r1", "R", "2", "1", "2"],
        ["r2", "R", "3", "2", "g"],
        ["a1", "A", "1", "2", "g"],
    ]
    circuit = Circuit(Netlist.from_rows(rows))
    solver = BatchedSolver(circuit, dtype=jnp.float64)
    p = jnp.asarray(circuit.stamps.params)[None, :]
    g = jax.grad(lambda q: jnp.sum(solver._solve(q)))(p)
    assert np.all(np.isfinite(np.asarray(g)))


def test_sensitivities_api_matches_finite_differences():
    from nodal_tpu.batch import sensitivities

    rows = [r.split(",") for r in (
        "r1,R,2,1,4", "r2,R,2,1,g", "r3,R,0.5,1,2",
        "e1,E,8,4,g", "a1,A,4,1,2", "d1,CCCS,2,2,g,1,g,r2")]
    circuit = Circuit(Netlist.from_rows(rows))
    sens = sensitivities(circuit, current="e1")
    base = circuit.stamps.params.copy()

    def i_e1(params):
        import dataclasses

        st = circuit.stamps
        from nodal_tpu.ops.assemble import assemble_dense

        G, b = assemble_dense(st, jnp.asarray(params, jnp.float64))
        x = np.linalg.solve(np.asarray(G), np.asarray(b))
        return x[circuit.netlist.nums["kcl"]
                 + circuit.netlist.anomnum["e1"]]

    for name, slot in circuit.stamps.param_slot.items():
        eps = 1e-6 * max(abs(base[slot]), 1.0)
        p = base.copy(); p[slot] += eps
        m = base.copy(); m[slot] -= eps
        fd = (i_e1(p) - i_e1(m)) / (2 * eps)
        assert abs(sens[name] - fd) < 1e-6 * max(1.0, abs(fd)), (name, sens[name], fd)


def test_sensitivities_ground_is_zero_and_errors():
    import pytest as _pytest

    from nodal_tpu.batch import sensitivities

    circuit = Circuit(Netlist.from_rows(ladder_rows(8)))
    gnd = circuit.netlist.ground
    assert all(v == 0.0 for v in
               sensitivities(circuit, potential=gnd).values())
    with _pytest.raises(ValueError):
        sensitivities(circuit)
    with _pytest.raises(KeyError):
        sensitivities(circuit, potential="nope")
    with _pytest.raises(KeyError):
        sensitivities(circuit, current="rs0")
