"""Scalar banded LDLᵀ tier: plan, assembly, scan solver, GPU kernel.

The scalar tier replaces the kb=128 block-Thomas path on narrow bands
(ops/scalar_band.py); these tests pin its numerics to the dense f64
oracle and the kernel (interpret mode on CPU) to the scan reference.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from nodal_tpu import Circuit, Netlist
from nodal_tpu.models.stamps import compile_stamps
from nodal_tpu.ops.assemble import assemble_dense
from nodal_tpu.ops.scalar_band import (
    make_scalar_band_plan,
    sband_matvec,
    sband_plan,
    scalar_band_solve_scan,
)
from nodal_tpu.utils.gridgen import grid_rows, ladder_rows


def _mesh(h, w, with_src=True):
    rows = list(grid_rows(h, w, (0, 0), (h - 1, w - 1)))
    if with_src:
        rows.append(["src", "A", "1", "1", "g"])
    return Circuit(Netlist.from_rows(rows))


def test_plan_shape_and_band():
    c = _mesh(13, 17)
    plan = make_scalar_band_plan(c.stamps)
    assert plan is not None
    assert plan.n == c.stamps.n
    assert plan.n_pad % 8 == 0
    # RCM bandwidth of an h×w grid is ~min(h,w)+1
    assert plan.w <= 15
    assert plan.W1 == plan.w + 1


def test_assembly_matches_dense():
    c = _mesh(9, 11)
    st = c.stamps
    plan = make_scalar_band_plan(st)
    U, b = jax.tree.map(
        np.asarray, plan.assemble(st, st.params, dtype=jnp.float64)
    )
    G, A = jax.tree.map(
        np.asarray, assemble_dense(st, st.params, dtype=jnp.float64)
    )
    Gp = G[np.ix_(plan.order, plan.order)]
    for k in range(plan.W1):
        d = np.diagonal(Gp, k)
        np.testing.assert_allclose(U[: len(d), k], d, atol=0)
    # pad rows: unit diagonal
    assert np.all(U[plan.n:, 0] == 1.0)
    assert np.all(U[plan.n:, 1:] == 0.0)
    bp = np.zeros(plan.n_pad)
    bp[: plan.n] = A[plan.order]
    np.testing.assert_allclose(b, bp, atol=0)


def test_scan_solver_vs_dense_f64():
    c = _mesh(9, 23)
    st = c.stamps
    plan = make_scalar_band_plan(st)
    with jax.enable_x64(True):
        U, b = plan.assemble(st, st.params, dtype=jnp.float64)
        x = plan.unpermute(scalar_band_solve_scan(U, b))
        G, A = assemble_dense(st, st.params, dtype=jnp.float64)
    x_ref = np.linalg.solve(np.asarray(G), np.asarray(A))
    np.testing.assert_allclose(np.asarray(x), x_ref, rtol=1e-12, atol=1e-12)


def test_scan_solver_multi_rhs_and_batch():
    c = _mesh(7, 9)
    st = c.stamps
    plan = make_scalar_band_plan(st)
    with jax.enable_x64(True):
        U, b = plan.assemble(st, st.params, dtype=jnp.float64)
        x1 = scalar_band_solve_scan(U, b)
        x2 = scalar_band_solve_scan(U, jnp.stack([b, 3.0 * b], axis=-1))
        xb = scalar_band_solve_scan(
            jnp.stack([U, 2.0 * U]), jnp.stack([b, b])
        )
    np.testing.assert_allclose(np.asarray(x2[:, 0]), np.asarray(x1),
                               rtol=1e-12)
    np.testing.assert_allclose(np.asarray(x2[:, 1]), 3 * np.asarray(x1),
                               rtol=1e-12)
    np.testing.assert_allclose(np.asarray(xb[1]), np.asarray(x1) / 2,
                               rtol=1e-12)


def test_sband_matvec_roundtrip():
    c = _mesh(6, 8)
    st = c.stamps
    plan = make_scalar_band_plan(st)
    with jax.enable_x64(True):
        U, b = plan.assemble(st, st.params, dtype=jnp.float64)
        x = scalar_band_solve_scan(U, b)
        r = sband_matvec(U, x) - b
    assert float(jnp.abs(r).max()) < 1e-12


def test_pallas_kernel_interpret_matches_scan():
    """Interpret-mode run of the GPU kernel against the f64 scan on a real
    mesh plan (small case: interpret executes per-op in Python)."""
    from nodal_tpu.ops.pallas_scalar_band import pallas_scalar_band_solve

    c = _mesh(5, 6)
    st = c.stamps
    plan = make_scalar_band_plan(st)
    B = 3
    rng = np.random.default_rng(7)
    pb = st.params[None] * rng.uniform(0.9, 1.1, (B, len(st.params)))
    U, b = jax.vmap(
        lambda p: plan.assemble(st, p, dtype=jnp.float32)
    )(jnp.asarray(pb, jnp.float32))
    x = np.asarray(pallas_scalar_band_solve(U, b, interpret=True))
    assert x.dtype == np.float32
    with jax.enable_x64(True):
        xr = np.asarray(
            scalar_band_solve_scan(
                jnp.asarray(np.asarray(U), jnp.float64),
                jnp.asarray(np.asarray(b), jnp.float64),
            )
        )
    assert np.abs(x - xr).max() / np.abs(xr).max() < 1e-5


def _random_spd_band(rng, B, n_pad, w):
    """Diagonally dominant upper-band storage [B, n_pad, w+1] (SPD)."""
    U = rng.uniform(-1.0, 0.0, (B, n_pad, w + 1))
    U[..., 0] = 2.0 * w + 1.0 + rng.uniform(0.0, 1.0, (B, n_pad))
    return U


@pytest.mark.parametrize(
    "B,n_pad,w,n_rhs,dtype",
    [
        (5, 24, 3, 1, np.float32),    # batch padded up to one tile
        (33, 16, 4, 2, np.float32),   # crosses the 32-system tile boundary
        (64, 16, 2, 1, np.float64),   # two full tiles, f64
        (3, 40, 7, 3, np.float64),    # multi-RHS (the Schur tier's form)
        (2, 16, 1, 1, np.float32),    # tridiagonal band
        (4, 8, 0, 2, np.float32),     # diagonal: no carry at all
        (2, 8, 9, 1, np.float64),     # band wider than n_pad/2
    ],
)
def test_kernel_interpret_matches_scan(B, n_pad, w, n_rhs, dtype):
    from nodal_tpu.ops.pallas_scalar_band import (
        pallas_scalar_band_solve_multi)

    rng = np.random.default_rng(B * 100 + n_pad + w)
    U = _random_spd_band(rng, B, n_pad, w)
    R = rng.standard_normal((B, n_pad, n_rhs))
    x = np.asarray(pallas_scalar_band_solve_multi(
        jnp.asarray(U, dtype), jnp.asarray(R, dtype), interpret=True))
    assert x.shape == (B, n_pad, n_rhs) and x.dtype == dtype
    with jax.enable_x64(True):
        ref = np.asarray(scalar_band_solve_scan(jnp.asarray(U),
                                                jnp.asarray(R)))
    tol = 1e-5 if dtype == np.float32 else 1e-12
    assert np.abs(x - ref).max() / np.abs(ref).max() < tol


def test_kernel_n_valid_trims_padding():
    from nodal_tpu.ops.pallas_scalar_band import pallas_scalar_band_solve

    rng = np.random.default_rng(11)
    U = jnp.asarray(_random_spd_band(rng, 2, 16, 3), jnp.float32)
    b = jnp.asarray(rng.standard_normal((2, 16)), jnp.float32)
    full = np.asarray(pallas_scalar_band_solve(U, b, interpret=True))
    cut_ = np.asarray(pallas_scalar_band_solve(U, b, n_valid=13,
                                               interpret=True))
    assert cut_.shape == (2, 13)
    np.testing.assert_array_equal(cut_, full[:, :13])


def test_sband_solver_dispatch():
    """The kernel is chosen where the solve is lowered: a CUDA lowering
    holds the Triton call, a CPU lowering the scan; interpret=True runs the
    kernel on any platform."""
    from nodal_tpu.ops.pallas_scalar_band import sband_solver

    rng = np.random.default_rng(12)
    U = jnp.asarray(_random_spd_band(rng, 3, 16, 2), jnp.float32)
    b = jnp.asarray(rng.standard_normal((3, 16)), jnp.float32)
    solve = jax.jit(sband_solver())
    assert "triton" in solve.trace(U, b).lower(
        lowering_platforms=("cuda",)).as_text()
    assert "triton" not in solve.lower(U, b).as_text()
    xs = np.asarray(scalar_band_solve_scan(U, b))
    np.testing.assert_array_equal(np.asarray(solve(U, b)), xs)
    xk = np.asarray(sband_solver(interpret=True)(U, b))
    assert xk.shape == xs.shape == (3, 16)
    np.testing.assert_allclose(xk, xs, rtol=1e-5, atol=1e-6)


def _branch_mesh(h, w):
    rows = list(grid_rows(h, w, (0, 0), (h - 1, w - 1)))
    rows.append(["e1", "E", "2", "1", "g"])
    rows.append(["d1", "VCCS", "0.5", "n3_3", "g", "1", "g"])
    return Circuit(Netlist.from_rows(rows))


@pytest.mark.parametrize("circuit,method", [
    (lambda: _mesh(9, 30), "sband"),
    (lambda: _branch_mesh(11, 24), "schur"),
], ids=["mesh", "branch_mesh"])
def test_batched_tiers_lower_kernel_only_for_cuda(circuit, method):
    """BatchedSolver's sband and Schur tiers (forward and adjoint) hold the
    kernel when lowered for a CUDA device and the scan when lowered for
    the CPU — the choice does not follow jax.default_backend()."""
    from nodal_tpu.batch import BatchedSolver

    c = circuit()
    solver = BatchedSolver(c, dtype=jnp.float32, refine=False)
    assert solver.method == method
    pb = jnp.tile(jnp.asarray(c.stamps.params, jnp.float32), (2, 1))
    grad = jax.jit(jax.grad(lambda p: jnp.sum(solver._solve(p))))
    cuda = grad.trace(pb).lower(lowering_platforms=("cuda",)).as_text()
    assert cuda.count("triton") >= 2  # forward and adjoint solves
    assert "triton" not in grad.lower(pb).as_text()


def _dense_grad(stamps, ia, ib=None):
    """d(x[ia] - x[ib]) / d params by dense f64 autodiff."""
    from nodal_tpu.models.stamps import stamp_values

    def out(p):
        g, rhs = stamp_values(stamps, p)
        G = jnp.zeros((stamps.n, stamps.n), p.dtype).at[
            stamps.g_rows, stamps.g_cols].add(g)
        x = jnp.linalg.solve(G, jnp.zeros(stamps.n, p.dtype).at[
            stamps.rhs_rows].add(rhs))
        return x[ia] - (x[ib] if ib is not None else 0.0)

    return np.asarray(jax.grad(out)(jnp.asarray(stamps.params, jnp.float64)))


@pytest.mark.parametrize("api", ["sensitivities", "resistance_sensitivities"])
def test_sensitivities_follow_host_scope_on_gpu_machines(api, monkeypatch):
    """On a GPU machine a 999-unknown mesh solves under the host-CPU device
    scope (Circuit._device_scope).  Its sband solve must lower to the scan
    there even though jax.default_backend() names the GPU — a kernel chosen
    from the default backend would be sent to the CPU and rejected."""
    from nodal_tpu.batch import sensitivities
    from nodal_tpu.equiv import resistance_sensitivities

    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    c = _mesh(25, 40, with_src=api == "sensitivities")
    net, st = c.netlist, c.stamps
    if api == "sensitivities":
        got = sensitivities(c, potential="n12_20")
        ref = _dense_grad(st, net.nodenum["n12_20"])
        names = st.param_slot
    else:
        got = resistance_sensitivities(net, "1", "n12_20")
        probed = net.with_component([net.fresh_name("a1"), "A", "1",
                                     "1", "n12_20"])
        st = compile_stamps(probed)
        ref = _dense_grad(st, probed.nodenum["1"],
                          probed.nodenum["n12_20"])
        names = [k for k, comp in probed.components.items()
                 if comp.type == "R"]
    want = np.array([ref[st.param_slot[k]] for k in names])
    have = np.array([got[k] for k in names])
    np.testing.assert_allclose(have, want, rtol=1e-9,
                               atol=1e-12 * np.abs(want).max())


@pytest.mark.parametrize("dtype,widest", [(jnp.float32, 41),
                                           (jnp.float64, 36)])
def test_carry_budget_bounds_wide_multi_rhs(dtype, widest):
    from nodal_tpu.ops.scalar_band import carry_fits, max_w

    assert max_w(dtype) == widest
    assert carry_fits(widest, 1, dtype)
    assert not carry_fits(widest, 2, dtype)
    assert not carry_fits(widest + 1, 1, dtype)
    assert carry_fits(26, 3, dtype)          # the 1k bench mesh's Schur tier
    assert not carry_fits(26, 200, dtype)    # a wide border keeps the band tier


def test_tier_width_limit_follows_solve_dtype():
    """A mesh of half-bandwidth 39 takes the sband tier in f32 (and under
    refine=True, whose banded solves run in f32) but the band tier in f64."""
    from nodal_tpu.batch import BatchedSolver

    c = _mesh(38, 40)
    assert sband_plan(c.stamps).w == 39
    assert BatchedSolver(c, dtype=jnp.float32).method == "sband"
    assert BatchedSolver(c, dtype=jnp.float64, refine=True).method == "sband"
    assert BatchedSolver(c, dtype=jnp.float64).method == "band"
    assert BatchedSolver(c, dtype=jnp.float64, method="sband").method \
        == "sband"


@pytest.mark.gpu
def test_kernel_compiled_matches_scan():
    """The Triton-compiled kernel (no interpreter) on the card."""
    from nodal_tpu.ops.pallas_scalar_band import (
        pallas_scalar_band_solve_multi)

    rng = np.random.default_rng(13)
    U = _random_spd_band(rng, 70, 200, 12)
    R = rng.standard_normal((70, 200, 2))
    for dtype, tol in ((np.float32, 1e-5), (np.float64, 1e-12)):
        x = np.asarray(pallas_scalar_band_solve_multi(
            jnp.asarray(U, dtype), jnp.asarray(R, dtype)))
        with jax.default_device(jax.devices("cpu")[0]):
            ref = np.asarray(scalar_band_solve_scan(jnp.asarray(U),
                                                    jnp.asarray(R)))
        assert np.abs(x - ref).max() / np.abs(ref).max() < tol


def test_plan_rejects_unsymmetric_and_wide():
    # Branch equations (E source) break symmetry of the full system.
    rows = list(grid_rows(5, 6, (0, 0), (4, 5)))
    rows.append(["e1", "E", "1", "1", "g"])
    st = Circuit(Netlist.from_rows(rows)).stamps
    assert make_scalar_band_plan(st) is None
    # Too-wide band: max_w gate.
    c = _mesh(30, 30)
    assert make_scalar_band_plan(c.stamps, max_w=8) is None


def test_plan_cached_on_stamps():
    c = _mesh(5, 5)
    p1 = sband_plan(c.stamps)
    p2 = sband_plan(c.stamps)
    assert p1 is p2 and p1 is not None


def test_ladder_prefers_natural_order():
    """A chain is already bandwidth-1; the plan must keep the natural
    ordering (w <= 2) rather than degrade it."""
    c = Circuit(Netlist.from_rows(ladder_rows(64)))
    plan = make_scalar_band_plan(c.stamps)
    assert plan is not None and plan.w <= 2


def test_kernel_interpret_multi_rhs_mesh():
    """Two RHS columns through the kernel on a 210-node mesh plan."""
    from nodal_tpu.ops.pallas_scalar_band import (
        pallas_scalar_band_solve_multi)

    rows = list(grid_rows(7, 30, (0, 0), (6, 29)))
    rows.append(["src", "A", "1", "1", "g"])
    st = Circuit(Netlist.from_rows(rows)).stamps
    plan = make_scalar_band_plan(st)
    B = 2
    rng = np.random.default_rng(3)
    pb = st.params[None] * rng.uniform(0.9, 1.1, (B, len(st.params)))
    U, b = jax.vmap(
        lambda p: plan.assemble(st, p, dtype=jnp.float32)
    )(jnp.asarray(pb, jnp.float32))
    R = jnp.stack([b, -2.0 * b], axis=-1)
    xs = np.asarray(pallas_scalar_band_solve_multi(U, R, interpret=True))
    with jax.enable_x64(True):
        xr = np.asarray(
            scalar_band_solve_scan(
                jnp.asarray(np.asarray(U), jnp.float64),
                jnp.asarray(np.asarray(b), jnp.float64),
            )
        )
    scale = np.abs(xr).max()
    assert np.abs(xs[..., 0] - xr).max() / scale < 1e-4
    assert np.abs(xs[..., 1] + 2 * xr).max() / scale < 1e-4


def test_kernel_adjoint_matches_dense_autodiff():
    """jax.grad through the custom_vjp adjoint around the kernel (interpret
    mode) against dense f64 autodiff."""
    from nodal_tpu.batch import BatchedSolver, make_adjoint_solver
    from nodal_tpu.models.stamps import stamp_values

    st = _mesh(5, 6).stamps
    fwd, tr = BatchedSolver(st, dtype=jnp.float64, refine=False,
                            interpret=True).solve_pair
    solve = make_adjoint_solver(st, fwd, tr)
    rng = np.random.default_rng(5)
    pb = jnp.asarray(st.params[None] * rng.uniform(0.9, 1.1,
                                                  (2, len(st.params))))
    wts = jnp.asarray(rng.standard_normal((2, st.n)))

    def dense_solve(p):
        g, rhs = stamp_values(st, p)
        G = jnp.zeros((st.n, st.n), p.dtype).at[st.g_rows, st.g_cols].add(g)
        b = jnp.zeros(st.n, p.dtype).at[st.rhs_rows].add(rhs)
        return jnp.linalg.solve(G, b)

    g_k = jax.grad(lambda p: jnp.sum(wts * solve(p)))(pb)
    g_d = jax.grad(lambda p: jnp.sum(wts * jax.vmap(dense_solve)(p)))(pb)
    np.testing.assert_allclose(np.asarray(g_k), np.asarray(g_d),
                               rtol=1e-8, atol=1e-10)


def test_midsize_mesh_routes_to_sband():
    """A 4000-node narrow mesh stays on the sband method (kernel on GPUs;
    scan elsewhere) — residuals at f64."""
    from nodal_tpu.batch import BatchedSolver

    rows = list(grid_rows(5, 800, (0, 0), (4, 799)))  # n=4000, w ~ 6
    rows.append(["src", "A", "1", "1", "g"])
    c = Circuit(Netlist.from_rows(rows))
    solver = BatchedSolver(c, dtype=jnp.float64)
    assert solver.method == "sband"
    pb = np.tile(c.stamps.params, (2, 1))
    xs = np.asarray(solver(pb))
    res = np.asarray(solver.residuals(pb, xs))
    assert res.max() < 1e-10
