"""Banded (block-tridiagonal) solver: planning, assembly, solves, selection.

The band path replaces the dense blocked LU for locally-connected circuits
(the reference solves everything dense/SuperLU — nodal.py:325-327); these
tests pin its correctness against the dense assembly + numpy f64 oracle.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from nodal_tpu import Circuit, Netlist
from nodal_tpu.batch import BatchedSolver, _schur_band_assembler
from nodal_tpu.ops.assemble import assemble_dense
from nodal_tpu.ops.band import (
    _K,
    band_matvec,
    band_plan,
    band_thomas_solve,
    make_band_plan,
    node_band_plan,
    rcm_order,
)
from nodal_tpu.utils.gridgen import grid_rows


def _mesh_circuit(h, w, extra=()):
    rows = list(grid_rows(h, w, (0, 0), (h - 1, w - 1)))
    rows.extend(extra)
    return Circuit(Netlist.from_rows(rows))


def _lattice_circuit(a, b, length):
    """3D resistor lattice a x b x length + source: min cut ~ a*b nodes, so
    the RCM half-bandwidth is ~a*b — the wide-band (kb > 128) regime."""
    idx = lambda x, y, z: f"n{x}_{y}_{z}"  # noqa: E731
    rows = []
    k = 0
    for z in range(length):
        for x in range(a):
            for y in range(b):
                if x + 1 < a:
                    rows.append([f"r{k}", "R", "1", idx(x, y, z),
                                 idx(x + 1, y, z)]); k += 1
                if y + 1 < b:
                    rows.append([f"r{k}", "R", "1", idx(x, y, z),
                                 idx(x, y + 1, z)]); k += 1
                if z + 1 < length:
                    rows.append([f"r{k}", "R", "1", idx(x, y, z),
                                 idx(x, y, z + 1)]); k += 1
    rows.append(["rg", "R", "1", idx(0, 0, 0), "g"])
    rows.append(["src", "A", "1", idx(a - 1, b - 1, length - 1), "g"])
    return Circuit(Netlist.from_rows(rows))


def _dense_f64(circuit, params=None):
    p = circuit.stamps.params if params is None else params
    G, b = assemble_dense(circuit.stamps, jnp.asarray(p, jnp.float64))
    return np.asarray(G), np.asarray(b)


class TestRCM:
    def test_grid_bandwidth_reduction(self):
        h, w = 10, 60
        idx = lambda r, c: r * w + c  # noqa: E731
        rows, cols = [], []
        for r in range(h):
            for c in range(w):
                if r + 1 < h:
                    rows.append(idx(r, c)), cols.append(idx(r + 1, c))
                if c + 1 < w:
                    rows.append(idx(r, c)), cols.append(idx(r, c + 1))
        rows, cols = np.array(rows), np.array(cols)
        order = rcm_order(h * w, rows, cols)
        assert sorted(order) == list(range(h * w))  # a permutation
        rank = np.argsort(order)
        bw = np.max(np.abs(rank[rows] - rank[cols]))
        assert bw <= h + 1  # grid RCM bandwidth ~ short dimension
        assert bw < np.max(np.abs(rows - cols))

    def test_disconnected_components_covered(self):
        rows = np.array([0, 3])
        cols = np.array([1, 4])
        order = rcm_order(6, rows, cols)
        assert sorted(order) == list(range(6))


class TestPlanAndAssembly:
    def test_mesh_plans_banded(self):
        c = _mesh_circuit(9, 40)
        plan = band_plan(c.stamps)
        assert plan is not None
        assert plan.halfbw <= 12
        assert plan.n_pad % _K == 0
        # cached
        assert band_plan(c.stamps) is plan

    def test_assembly_matches_dense(self):
        c = _mesh_circuit(7, 23)
        plan = band_plan(c.stamps)
        W, b = plan.assemble(c.stamps, c.stamps.params, dtype=jnp.float64)
        G, bd = _dense_f64(c)
        n, n_pad, nb = plan.n, plan.n_pad, plan.nb
        # reconstruct the permuted padded matrix from the band
        Gp = np.eye(n_pad)
        Gp[:n, :n] = G[np.ix_(plan.order, plan.order)]
        Wref = np.zeros((nb, _K, 3 * _K))
        for i in range(n_pad):
            lo = (i // _K - 1) * _K
            for j in range(max(0, lo), min(n_pad, lo + 3 * _K)):
                Wref[i // _K, i % _K, j - lo] = Gp[i, j]
        np.testing.assert_allclose(np.asarray(W), Wref, atol=1e-12)
        np.testing.assert_allclose(np.asarray(b)[plan.rank], bd, atol=1e-12)

    def test_band_matvec_matches_dense(self):
        c = _mesh_circuit(6, 30)
        plan = band_plan(c.stamps)
        W, _ = plan.assemble(c.stamps, c.stamps.params, dtype=jnp.float64)
        G, _ = _dense_f64(c)
        x = np.random.default_rng(1).standard_normal(plan.n_pad)
        y = np.asarray(band_matvec(W, jnp.asarray(x)))
        Gp = np.eye(plan.n_pad)
        Gp[:plan.n, :plan.n] = G[np.ix_(plan.order, plan.order)]
        np.testing.assert_allclose(y, Gp @ x, rtol=1e-12, atol=1e-12)

    def test_wide_topology_returns_none(self):
        # A random graph on 1200 nodes has no locality: RCM cannot push the
        # half-bandwidth under the largest block size (384).
        rng = np.random.default_rng(0)
        rows = ["v", "A", "1", "n0", "g"]
        netl = [rows]
        for k in range(4800):
            a, b = rng.integers(0, 1200, 2)
            if a == b:
                continue
            netl.append([f"r{k}", "R", "1", f"n{a}", f"n{b}"])
        for j in range(1200):  # ground ties keep it connected + SPD
            netl.append([f"rg{j}", "R", "1", f"n{j}", "g"])
        c = Circuit(Netlist.from_rows(netl))
        assert band_plan(c.stamps) is None

    def test_wide_band_picks_larger_block(self):
        # 14x14xL lattice: even RCM's diagonal level sets cross >128
        # nodes, so the plan moves up to the next block size (192).
        c = _lattice_circuit(14, 14, 12)
        plan = band_plan(c.stamps)
        assert plan is not None
        assert plan.kb == 192
        assert 128 < plan.halfbw <= 192


class TestBandSolve:
    def test_thomas_matches_dense_f64(self):
        c = _mesh_circuit(8, 33)
        plan = band_plan(c.stamps)
        W, b = plan.assemble(c.stamps, c.stamps.params, dtype=jnp.float64)
        x = plan.unpermute(band_thomas_solve(W, b))
        G, bd = _dense_f64(c)
        np.testing.assert_allclose(
            np.asarray(x), np.linalg.solve(G, bd), rtol=1e-10, atol=1e-12
        )

    def test_f32_batch_matches_f64_thomas(self):
        # The f32 tier at 'highest' precision (no TF32 on GPUs) against the
        # same band in f64; B=5 odd.
        c = _mesh_circuit(8, 33)
        plan = band_plan(c.stamps)
        rng = np.random.default_rng(2)
        B = 5
        pb = c.stamps.params * (
            1.0 + 0.05 * rng.standard_normal((B, len(c.stamps.params)))
        )
        W, b = jax.vmap(
            lambda p: plan.assemble(c.stamps, p, dtype=jnp.float32)
        )(jnp.asarray(pb, jnp.float32))
        got = band_thomas_solve(W, b)
        W64, b64 = jax.vmap(
            lambda p: plan.assemble(c.stamps, p, dtype=jnp.float64)
        )(jnp.asarray(pb))
        want = band_thomas_solve(W64, b64)
        np.testing.assert_allclose(
            np.asarray(got), np.asarray(want), rtol=2e-4, atol=1e-6
        )

    def test_f32_multi_rhs_matches_f64(self):
        c = _mesh_circuit(8, 20)
        plan = band_plan(c.stamps)
        W, _ = jax.vmap(
            lambda p: plan.assemble(c.stamps, p, dtype=jnp.float32)
        )(jnp.asarray([c.stamps.params], jnp.float32))
        R = np.random.default_rng(3).standard_normal((1, plan.n_pad, 7))
        X = band_thomas_solve(W, jnp.asarray(R, jnp.float32))
        W64 = W.astype(jnp.float64)
        want = band_thomas_solve(W64, jnp.asarray(R))
        np.testing.assert_allclose(
            np.asarray(X), np.asarray(want), rtol=2e-4, atol=1e-5
        )


class TestLongBands:
    """Many block rows (n up to 2560) on random diagonally dominant bands."""

    def _random_band(self, rng, B, nb):
        W = rng.standard_normal((B, nb, _K, 3 * _K)).astype(np.float32) * 0.1
        W[:, 0, :, :_K] = 0.0
        W[:, -1, :, 2 * _K:] = 0.0
        idx = np.arange(_K)
        W[:, :, idx, _K + idx] = np.abs(W).sum(-1)[:, :, idx] + 1.0
        return W

    def test_long_band_f32_matches_f64(self):
        rng = np.random.default_rng(8)
        W = self._random_band(rng, 3, 20)  # n=2560
        b = rng.standard_normal((3, 20 * _K)).astype(np.float32)
        x = band_thomas_solve(jnp.asarray(W), jnp.asarray(b))
        ref = band_thomas_solve(jnp.asarray(W, jnp.float64),
                                jnp.asarray(b, jnp.float64))
        np.testing.assert_allclose(np.asarray(x), np.asarray(ref),
                                   rtol=2e-4, atol=1e-5)

    def test_multi_rhs_f32_matches_f64(self):
        rng = np.random.default_rng(9)
        W = self._random_band(rng, 2, 4)
        R = rng.standard_normal((2, 4 * _K, 6)).astype(np.float32)
        X = band_thomas_solve(jnp.asarray(W), jnp.asarray(R))
        ref = band_thomas_solve(jnp.asarray(W, jnp.float64),
                                jnp.asarray(R, jnp.float64))
        np.testing.assert_allclose(np.asarray(X), np.asarray(ref),
                                   rtol=2e-4, atol=1e-5)

    def test_multi_rhs_columns_equal_single_solves(self):
        # A multi-RHS solve is column-wise the single-RHS solve.
        rng = np.random.default_rng(10)
        W = jnp.asarray(self._random_band(rng, 2, 8))
        R = rng.standard_normal((2, 8 * _K, 3)).astype(np.float32)
        X = np.asarray(band_thomas_solve(W, jnp.asarray(R)))
        for j in range(3):
            xj = np.asarray(band_thomas_solve(W, jnp.asarray(R[..., j])))
            np.testing.assert_allclose(X[..., j], xj, rtol=1e-5, atol=1e-7)


class TestBatchedSolverBand:
    def test_auto_selects_sband_for_mesh(self):
        # Narrow bands now route to the scalar LDL^T tier; the block
        # band tier stays reachable explicitly.
        c = _mesh_circuit(9, 40, extra=[["src", "A", "1", "n1_1", "g"]])
        solver = BatchedSolver(c)
        assert solver.method == "sband"
        assert BatchedSolver(c, method="band").method == "band"

    def test_band_matches_dense_reference(self):
        c = _mesh_circuit(9, 40, extra=[["src", "A", "1", "n1_1", "g"]])
        solver = BatchedSolver(c, dtype=jnp.float64, method="band")
        rng = np.random.default_rng(4)
        B = 6
        pb = c.stamps.params * (
            1.0 + 0.05 * rng.standard_normal((B, len(c.stamps.params)))
        )
        xs = np.asarray(solver(pb))
        for i in range(B):
            G, b = _dense_f64(c, pb[i])
            np.testing.assert_allclose(
                xs[i], np.linalg.solve(G, b), rtol=1e-9, atol=1e-11
            )

    def test_band_refine_hits_f64(self):
        c = _mesh_circuit(9, 30, extra=[["src", "A", "1", "n1_1", "g"]])
        solver = BatchedSolver(c, dtype=jnp.float32, refine=True,
                               method="band")
        pb = np.tile(c.stamps.params, (2, 1))
        xs = np.asarray(solver(pb))
        G, b = _dense_f64(c)
        np.testing.assert_allclose(
            xs[0], np.linalg.solve(G, b), rtol=1e-8, atol=1e-10
        )

    def test_band_residual_audit(self):
        c = _mesh_circuit(9, 30, extra=[["src", "A", "1", "n1_1", "g"]])
        solver = BatchedSolver(c, dtype=jnp.float64, method="band")
        rng = np.random.default_rng(6)
        pb = c.stamps.params * (
            1.0 + 0.05 * rng.standard_normal((3, len(c.stamps.params)))
        )
        xs = solver(pb)
        res = np.asarray(solver.residuals(pb, xs))
        assert res.shape == (3,)
        assert np.all(res < 1e-12)
        # a corrupted solution must be flagged
        bad = np.asarray(xs).copy()
        bad[1] *= 2.0
        res_bad = np.asarray(solver.residuals(pb, bad))
        assert res_bad[1] > 1e-3 and res_bad[0] < 1e-12

    def test_band_rejects_branch_equations(self):
        c = _mesh_circuit(5, 8, extra=[["e1", "E", "1", "n0_0", "g"]])
        with pytest.raises(ValueError, match="resistive"):
            BatchedSolver(c, method="band")

    def test_band_rejects_unbandable(self):
        rng = np.random.default_rng(5)
        netl = [["v", "A", "1", "n0", "g"]]
        for k in range(4800):
            a, b = rng.integers(0, 1200, 2)
            if a == b:
                continue
            netl.append([f"r{k}", "R", "1", f"n{a}", f"n{b}"])
        for j in range(1200):
            netl.append([f"rg{j}", "R", "1", f"n{j}", "g"])
        c = Circuit(Netlist.from_rows(netl))
        with pytest.raises(ValueError, match="band"):
            BatchedSolver(c, method="band")
        assert BatchedSolver(c).method == "block"  # auto falls back

    def test_wide_band_auto_selected(self):
        # kb=256 + n > 1024: the wide-band tier takes over from 'block'.
        big = _lattice_circuit(14, 14, 12)  # n=2352
        assert BatchedSolver(big).method == "band"

    def test_wide_band_solve_matches_dense(self):
        c = _lattice_circuit(14, 14, 12)
        solver = BatchedSolver(c, dtype=jnp.float64, method="band")
        pb = np.tile(c.stamps.params, (2, 1))
        xs = np.asarray(solver(pb))
        G, b = _dense_f64(c)
        np.testing.assert_allclose(
            xs[0], np.linalg.solve(G, b), rtol=1e-9, atol=1e-11
        )

    def test_wide_band_f32_solve(self):
        c = _lattice_circuit(14, 14, 12)
        plan = band_plan(c.stamps)
        assert plan.kb == 192
        W, b = jax.vmap(
            lambda p: plan.assemble(c.stamps, p, dtype=jnp.float32)
        )(jnp.asarray(np.tile(c.stamps.params, (2, 1)), jnp.float32))
        x = plan.unpermute(band_thomas_solve(W, b))
        G, bd = _dense_f64(c)
        ref = np.linalg.solve(G, bd)
        err = np.max(np.abs(np.asarray(x[0], np.float64) - ref)) / np.max(
            np.abs(ref))
        assert err < 1e-4


class TestCircuitSolveBand:
    def test_single_solve_routes_banded(self):
        c = _mesh_circuit(9, 40, extra=[["src", "A", "1", "n1_1", "g"]])
        sol = c.solve()
        assert sol.stats["method"] == "band_thomas"
        G, b = _dense_f64(c)
        ref = np.linalg.solve(G, b)
        got = np.array([sol.result[i] for i in range(c.stamps.n)])
        np.testing.assert_allclose(got, ref, rtol=1e-9, atol=1e-12)
        assert sol.stats["residual"] < 1e-10

    def test_branch_circuit_stays_dense(self):
        c = _mesh_circuit(5, 8, extra=[["e1", "E", "1", "n0_0", "g"]])
        sol = c.solve()
        assert sol.stats["method"] == "dense_lu"

    def test_unbandable_stays_dense(self):
        # Dense enough that RCM's half-bandwidth passes the largest block
        # size (384), so no band plan exists.
        rng = np.random.default_rng(11)
        netl = [["v", "A", "1", "n0", "g"]]
        for k in range(5000):
            a, b = rng.integers(0, 500, 2)
            if a == b:
                continue
            netl.append([f"r{k}", "R", "1", f"n{a}", f"n{b}"])
        for j in range(500):
            netl.append([f"rg{j}", "R", "1", f"n{j}", "g"])
        c = Circuit(Netlist.from_rows(netl))
        assert c.solve().stats["method"] == "dense_lu"

    def test_singular_banded_circuit_still_raises(self):
        # floating mesh chunk: band path solves garbage, the residual gate
        # + rescue must still surface UnconnectedCircuitError.
        from nodal_tpu.netlist import UnconnectedCircuitError

        rows = list(grid_rows(4, 40, (0, 0), (3, 39)))
        rows.append(["rf", "R", "1", "x1", "x2"])  # floating pair
        rows.append(["src", "A", "1", "x1", "x2"])
        c = Circuit(Netlist.from_rows(rows))
        with pytest.raises(UnconnectedCircuitError):
            c.solve()


class TestSchurBandAssembler:
    def test_blocks_match_dense_partition(self):
        c = _mesh_circuit(
            7, 25,
            extra=[
                ["e1", "E", "2", "n1_1", "g"],
                ["d1", "VCCS", "0.5", "n3_3", "g", "n1_1", "g"],
            ],
        )
        stamps = c.stamps
        nk = stamps.n_kcl
        kbe = stamps.n - nk
        assert kbe == 2
        nplan = node_band_plan(stamps)
        assert nplan is not None and nplan.n == nk
        assemble = _schur_band_assembler(stamps, jnp.float64, nplan)
        W, Bm, C, D, bk, bb = assemble(stamps.params)
        G, b = _dense_f64(c)
        A = G[:nk, :nk]
        o = nplan.order
        # node block, permuted + padded, reconstructed from the band
        n_pad = nplan.n_pad
        Ap = np.eye(n_pad)
        Ap[:nk, :nk] = A[np.ix_(o, o)]
        got = np.zeros((n_pad, n_pad))
        Wn = np.asarray(W)
        for i in range(n_pad):
            lo = (i // _K - 1) * _K
            for jj in range(max(0, lo), min(n_pad, lo + 3 * _K)):
                got[i, jj] = Wn[i // _K, i % _K, jj - lo]
        np.testing.assert_allclose(got, Ap, atol=1e-12)
        # Bm rows / C cols are carried in band order: index by rank to
        # recover the natural ordering.
        np.testing.assert_allclose(
            np.asarray(Bm)[nplan.rank], G[:nk, nk:], atol=1e-12
        )
        np.testing.assert_allclose(
            np.asarray(C)[:, nplan.rank], G[nk:, :nk], atol=1e-12
        )
        np.testing.assert_allclose(np.asarray(D), G[nk:, nk:], atol=1e-12)
        np.testing.assert_allclose(
            np.asarray(bk)[nplan.rank], b[:nk], atol=1e-12
        )
        np.testing.assert_allclose(np.asarray(bb), b[nk:], atol=1e-12)

    def test_schur_band_solution_matches_dense(self):
        # The banded Schur path: banded multi-RHS Thomas through the same
        # algebra BatchedSolver uses.
        c = _mesh_circuit(
            7, 25,
            extra=[
                ["e1", "E", "2", "n1_1", "g"],
                ["d1", "VCCS", "0.5", "n3_3", "g", "n1_1", "g"],
            ],
        )
        stamps = c.stamps
        nk = stamps.n_kcl
        kbe = stamps.n - nk
        nplan = node_band_plan(stamps)
        assemble = _schur_band_assembler(stamps, jnp.float64, nplan)
        W, Bm, C, D, bk, bb = assemble(stamps.params)
        R = jnp.concatenate([Bm, bk[..., None]], axis=-1)
        Y = band_thomas_solve(W, R)
        YB, yb = Y[..., :kbe], Y[..., kbe]
        S = D - C @ YB
        xb = jnp.linalg.solve(S, (bb - C @ yb)[..., None])[..., 0]
        xk = nplan.unpermute(yb - YB @ xb)
        x = np.concatenate([np.asarray(xk), np.asarray(xb)])
        G, b = _dense_f64(c)
        np.testing.assert_allclose(
            x, np.linalg.solve(G, b), rtol=1e-9, atol=1e-11
        )
