"""Algebraic multigrid (smoothed aggregation) for general resistive
networks.

The matrix-free geometric multigrid (ops/grid.py) only applies to uniform
grids; arbitrary resistive netlists solve through the COO path, where plain
Jacobi-CG needs O(diameter) iterations.  This module builds a
smoothed-aggregation AMG hierarchy on the host — greedy neighborhood
aggregation, tentative piecewise-constant prolongation smoothed by one
damped-Jacobi step (``P = (I − ω D⁻¹A) P_tent``), exact Galerkin coarse
operators — and applies the V-cycle on device with segment-sum transfers
and weighted-Jacobi smoothing.  Smoothing the prolongator roughly halves
the CG iteration count over unsmoothed aggregation on irregular networks
(the classic SA result); set ``smooth_prolongation=False`` to get the
round-1 unsmoothed hierarchy.

Host setup uses scipy.sparse for the Galerkin triple product only; the
device path is pure JAX.  Setup is value-dependent, so each hierarchy
belongs to one parameter vector (Circuit.solve's single solve — exactly
where it's needed).

The V(1,1) cycle with symmetric smoothing and Galerkin coarse operators is
SPD, so plain (non-flexible) CG remains valid.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp

import jax
import jax.numpy as jnp

_JACOBI_OMEGA = 0.7
#: Damping for the prolongator smoother: ω = 4/(3 λmax(D⁻¹A)); λmax ≤ 2
#: for Laplacian-like matrices, so 2/3 is the standard safe choice.
_P_SMOOTH_OMEGA = 2.0 / 3.0
#: Revert a level to the tentative (unsmoothed) prolongator when the
#: smoothed Galerkin operator's nnz exceeds this multiple of the fine
#: level's — on mesh-like graphs the ratio is ~2.2 and smoothing cuts CG
#: iterations ~5x; on expander-like graphs it blows past 25x while the
#: iteration count barely moves (measured on 200x200 weighted mesh: 82->16
#: iters; random ring+chords graph: 12->11 iters at 26x the memory).
_SA_FILL_CAP = 4.0
_COARSEST_N = 256
_COARSE_SWEEPS = 64
_MAX_LEVELS = 12


@dataclass(frozen=True)
class _Level:
    n: int
    rows: np.ndarray  # int32[nnz], row-sorted
    cols: np.ndarray
    vals: np.ndarray  # float64[nnz]
    diag: np.ndarray  # float64[n]
    # Prolongator COO (None at the coarsest level), row-sorted.
    p_rows: np.ndarray | None
    p_cols: np.ndarray | None
    p_vals: np.ndarray | None
    n_coarse: int


#: Above this many vertices aggregation runs the vectorized rounds;
#: below it the O(n)-Python greedy loop is faster and keeps the exact
#: historical aggregates (its per-vertex cost only matters at scale —
#: measured 0.46 s at 40k / 1.16 s at 100k vertices, the dominant AMG
#: setup cost and squarely on the cold-solve critical path).
_VECTORIZED_AGG_N = 4096


def _aggregate(n: int, rows: np.ndarray, cols: np.ndarray) -> np.ndarray:
    """Greedy neighborhood aggregation: each seed swallows its unassigned
    neighbors; leftovers join a neighboring aggregate.

    Large graphs take the vectorized randomized-MIS rounds
    (:func:`_aggregate_vectorized`) — same aggregate-quality class
    (seed + its free neighbors), O(nnz) numpy work per round and
    O(log n) expected rounds instead of a Python loop over vertices.
    """
    if n > _VECTORIZED_AGG_N:
        return _aggregate_vectorized(n, rows, cols)
    neighbors_start, neighbors = _adjacency(n, rows, cols)
    agg = np.full(n, -1, dtype=np.int32)
    next_agg = 0
    for v in range(n):
        if agg[v] >= 0:
            continue
        nbrs = neighbors[neighbors_start[v]:neighbors_start[v + 1]]
        if np.all(agg[nbrs] >= 0) and len(nbrs):
            agg[v] = agg[nbrs[0]]  # orphan joins a neighbor
            continue
        agg[v] = next_agg
        free = nbrs[agg[nbrs] < 0]
        agg[free] = next_agg
        next_agg += 1
    return agg


def _aggregate_vectorized(n: int, rows: np.ndarray,
                          cols: np.ndarray) -> np.ndarray:
    """Vectorized aggregation: rounds of randomized-priority maximal
    independent seeding (Luby-style), each seed swallowing its unassigned
    neighbors; orphans (unassigned vertices whose whole neighborhood got
    assigned) join a neighbor's aggregate, mirroring the greedy loop.

    Deterministic (fixed permutation seed).  Each round is O(nnz) numpy
    ``minimum.at`` work; expected O(log n) rounds.
    """
    off = rows != cols
    r = rows[off].astype(np.int64)
    c = cols[off].astype(np.int64)

    agg = np.full(n, -1, dtype=np.int32)
    pri = np.random.default_rng(0).permutation(n).astype(np.int64)
    INF = np.iinfo(np.int64).max
    next_agg = 0
    for _ in range(256):  # far above the expected O(log n) rounds
        un = agg < 0
        if not un.any():
            break
        active = un[r]
        # Orphans first (greedy parity): unassigned vertices with
        # neighbors but none unassigned join the aggregate of their
        # min-index assigned neighbor.
        nbr_assigned_min = np.full(n, INF, np.int64)
        sel = active & ~un[c]
        np.minimum.at(nbr_assigned_min, r[sel], c[sel])
        nbr_un_min_pri = np.full(n, INF, np.int64)
        sel = active & un[c]
        np.minimum.at(nbr_un_min_pri, r[sel], pri[c[sel]])
        orphan = un & (nbr_un_min_pri == INF) & (nbr_assigned_min < INF)
        if orphan.any():
            agg[orphan] = agg[nbr_assigned_min[orphan]]
            un = agg < 0
            if not un.any():
                break
        # Seeds: unassigned vertices beating every unassigned neighbor's
        # priority (isolated/all-assigned-neighbor vertices seed too).
        seed = un & (pri < nbr_un_min_pri)
        ids = (np.cumsum(seed) - 1 + next_agg).astype(np.int32)
        agg[seed] = ids[seed]
        next_agg += int(seed.sum())
        # Unassigned non-seeds adjacent to a seed join their best
        # (min-priority) seed neighbor.  Encode (priority, vertex) in one
        # int64 key so minimum.at doubles as argmin.
        un2 = agg < 0
        sel = un2[r] & seed[c]
        best = np.full(n, INF, np.int64)
        np.minimum.at(best, r[sel], pri[c[sel]] * n + c[sel])
        join = un2 & (best < INF)
        agg[join] = agg[best[join] % n]
    else:  # pragma: no cover - safety net
        un = agg < 0
        agg[un] = next_agg + np.arange(int(un.sum()), dtype=np.int32)
    return agg


def _adjacency(n, rows, cols):
    off = rows != cols
    r, c = rows[off], cols[off]
    order = np.argsort(r, kind="stable")
    r, c = r[order], c[order]
    start = np.searchsorted(r, np.arange(n + 1))
    return start.astype(np.int64), c


def build_hierarchy(n, rows, cols, vals, *,
                    smooth_prolongation: bool = True) -> list[_Level]:
    """Host-side AMG setup from deduped COO (numpy float64 values)."""
    rows = np.asarray(rows, np.int32)
    cols = np.asarray(cols, np.int32)
    vals = np.asarray(vals, np.float64)
    levels: list[_Level] = []
    for _ in range(_MAX_LEVELS):
        diag = np.zeros(n)
        on_diag = rows == cols
        np.add.at(diag, rows[on_diag], vals[on_diag])
        if n <= _COARSEST_N:
            levels.append(_Level(n, rows, cols, vals, diag,
                                 None, None, None, 0))
            break
        agg = _aggregate(n, rows, cols)
        n_coarse = int(agg.max()) + 1
        if n_coarse >= n:  # no coarsening progress; stop
            levels.append(_Level(n, rows, cols, vals, diag,
                                 None, None, None, 0))
            break

        A = sp.csr_matrix((vals, (rows, cols)), shape=(n, n))
        P_tent = sp.csr_matrix(
            (np.ones(n), (np.arange(n), agg)), shape=(n, n_coarse)
        )
        P = P_tent
        if smooth_prolongation:
            dinv = np.where(diag != 0, 1.0 / np.where(diag == 0, 1.0, diag),
                            1.0)
            # P <- (I - ω D⁻¹ A) P_tent: spreads each aggregate's basis
            # function over its neighbors, so the coarse space captures
            # smooth error the piecewise-constant space misses.
            P = P_tent - sp.diags(_P_SMOOTH_OMEGA * dinv) @ (A @ P_tent)
        Ac = (P.T @ A @ P).tocoo()
        Ac.eliminate_zeros()
        if smooth_prolongation and Ac.nnz > _SA_FILL_CAP * max(A.nnz, 1):
            # Expander-like level: smoothing buys nothing and the Galerkin
            # fill compounds down the hierarchy — revert to tentative.
            P = P_tent
            Ac = (P.T @ A @ P).tocoo()
            Ac.eliminate_zeros()

        Pc = P.tocoo()
        order = np.argsort(
            Pc.row.astype(np.int64) * n_coarse + Pc.col, kind="stable"
        )
        levels.append(_Level(
            n, rows, cols, vals, diag,
            Pc.row[order].astype(np.int32),
            Pc.col[order].astype(np.int32),
            Pc.data[order],
            n_coarse,
        ))

        order = np.argsort(
            Ac.row.astype(np.int64) * n_coarse + Ac.col, kind="stable"
        )
        rows = Ac.row[order].astype(np.int32)
        cols = Ac.col[order].astype(np.int32)
        vals = Ac.data[order]
        n = n_coarse
    return levels


def hierarchy_arrays(levels: list[_Level], dtype):
    """Split the host hierarchy into ``(arrays, meta)`` for jit-argument
    passing.

    ``arrays`` is a pytree (tuple of per-level dicts of jnp arrays) meant to
    be a *traced argument* of a jitted program; ``meta`` is the static shape
    info (``(n, n_coarse)`` per level, hashable).  Passing the hierarchy as
    arguments instead of closure constants matters twice over: XLA
    constant-folds large embedded scatter/gather constants at compile time
    (measured: multi-second folds of a 40k-row segment_sum during the
    bordered-elimination compile), and argument-passed buffers can be
    ``device_put`` once and reused across dispatches with zero re-transfer.
    """
    arrays = tuple(
        {
            "rows": jnp.asarray(lv.rows),
            "cols": jnp.asarray(lv.cols),
            "vals": jnp.asarray(lv.vals, dtype=dtype),
            "dinv": jnp.asarray(
                np.where(lv.diag != 0, 1.0 / np.where(lv.diag == 0, 1.0,
                                                      lv.diag), 1.0),
                dtype=dtype,
            ),
            "p_rows": None if lv.p_rows is None else jnp.asarray(lv.p_rows),
            "p_cols": None if lv.p_cols is None else jnp.asarray(lv.p_cols),
            "p_vals": (None if lv.p_vals is None
                       else jnp.asarray(lv.p_vals, dtype=dtype)),
        }
        for lv in levels
    )
    meta = tuple((lv.n, lv.n_coarse) for lv in levels)
    return arrays, meta


def make_vcycle(arrays, meta):
    """V(1,1)-cycle closure over hierarchy ``arrays`` (traced or concrete)
    with static ``meta`` shapes — the jit-argument-friendly form of
    :func:`make_amg_preconditioner`."""

    def matvec(lv, n, x):
        prods = lv["vals"] * x[lv["cols"]]
        return jax.ops.segment_sum(
            prods, lv["rows"], num_segments=n, indices_are_sorted=True
        )

    def smooth(lv, n, x, r):
        return x + _JACOBI_OMEGA * lv["dinv"] * (r - matvec(lv, n, x))

    def restrict(lv, nc, res):
        # P^T res: scatter fine contributions into coarse slots.
        prods = lv["p_vals"] * res[lv["p_rows"]]
        return jax.ops.segment_sum(prods, lv["p_cols"], num_segments=nc)

    def prolong(lv, n, xc):
        # P xc: gather coarse values, weight, sum per fine row (sorted).
        prods = lv["p_vals"] * xc[lv["p_cols"]]
        return jax.ops.segment_sum(
            prods, lv["p_rows"], num_segments=n, indices_are_sorted=True
        )

    def vcycle(r, i):
        lv = arrays[i]
        n, nc = meta[i]
        if lv["p_rows"] is None:
            x = jnp.zeros_like(r)
            for _ in range(2):
                x = smooth(lv, n, x, r)

            def body(_, x):
                return smooth(lv, n, x, r)

            return jax.lax.fori_loop(0, _COARSE_SWEEPS, body, x)
        x = _JACOBI_OMEGA * lv["dinv"] * r  # one sweep from zero
        res = r - matvec(lv, n, x)
        x = x + prolong(lv, n, vcycle(restrict(lv, nc, res), i + 1))
        return smooth(lv, n, x, r)

    def M(r):
        return vcycle(r, 0)

    return M


def make_amg_preconditioner(levels: list[_Level], dtype):
    """Device-side V(1,1) application closure for the host hierarchy.

    The hierarchy arrays are closure constants here — fine for programs
    compiled once per (topology, values) like Circuit.solve's CG.  Paths
    that recompile per parameter vector or dispatch repeatedly should use
    :func:`hierarchy_arrays` + :func:`make_vcycle` and pass the arrays as
    jit arguments instead.
    """
    arrays, meta = hierarchy_arrays(levels, dtype)
    return make_vcycle(arrays, meta)


def pack_hierarchy(levels: list[_Level], dtype):
    """Pack the whole hierarchy into TWO host buffers ``(ibuf, fbuf,
    meta)`` for single-shot device transfer.

    Each ``jax.device_put`` leaf is one host→device transfer, whose fixed
    latency dwarfs the bytes of a small level (~3 MB of payload in all for
    a 40k-node hierarchy).  ``ibuf`` concatenates every index array
    (``rows, cols, p_rows, p_cols`` per level, int32), ``fbuf`` every
    value array (``vals, dinv, p_vals`` per level, ``dtype``); ``meta`` is
    the static ``(n, n_coarse, nnz, p_nnz)`` tuple per level from which
    :func:`unpack_hierarchy` rebuilds the per-level views with static
    slices inside a jitted program (XLA fuses them away).
    """
    ints, flts, meta = [], [], []
    for lv in levels:
        pnnz = 0 if lv.p_rows is None else len(lv.p_rows)
        meta.append((lv.n, lv.n_coarse, len(lv.rows), pnnz))
        ints += [lv.rows, lv.cols]
        dinv = np.where(lv.diag != 0,
                        1.0 / np.where(lv.diag == 0, 1.0, lv.diag), 1.0)
        flts += [lv.vals, dinv]
        if pnnz:
            ints += [lv.p_rows, lv.p_cols]
            flts += [lv.p_vals]
    ibuf = np.concatenate([a.astype(np.int32) for a in ints])
    fbuf = np.concatenate(flts).astype(np.dtype(dtype))
    return ibuf, fbuf, tuple(meta)


def unpack_hierarchy(ibuf, fbuf, meta):
    """Rebuild ``(arrays, vmeta)`` for :func:`make_vcycle` from packed
    buffers (traced or concrete) — static slices only."""
    arrays = []
    io = fo = 0
    for (n, nc, nnz, pnnz) in meta:
        lv = {
            "rows": ibuf[io:io + nnz],
            "cols": ibuf[io + nnz:io + 2 * nnz],
            "vals": fbuf[fo:fo + nnz],
            "dinv": fbuf[fo + nnz:fo + nnz + n],
        }
        io += 2 * nnz
        fo += nnz + n
        if pnnz:
            lv["p_rows"] = ibuf[io:io + pnnz]
            lv["p_cols"] = ibuf[io + pnnz:io + 2 * pnnz]
            lv["p_vals"] = fbuf[fo:fo + pnnz]
            io += 2 * pnnz
            fo += pnnz
        else:
            lv["p_rows"] = lv["p_cols"] = lv["p_vals"] = None
        arrays.append(lv)
    vmeta = tuple((n, nc) for (n, nc, _, _) in meta)
    return tuple(arrays), vmeta
