"""On-device MNA system assembly: one fused scatter-add per netlist.

Replaces the reference's per-element ``G[i, j] +=`` writes into numpy /
``dok_matrix`` (reference nodal.py:347-397, the measured bottleneck —
9.25 s stamping vs 0.79 s solve at 40k nodes, SURVEY.md §2.3).  Here the
index arrays are compile-time constants, so XLA lowers the whole assembly to
a single scatter-add; only the *values* depend on runtime parameters, which
makes ``vmap`` over parameter sweeps free of re-assembly cost.
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp

from nodal_tpu.models.stamps import StampTensors, stamp_values


def assemble_dense(stamps: StampTensors, params, dtype=None,
                   pad_to: int | None = None):
    """Assemble the dense MNA system ``(G, b)`` for one parameter vector.

    jit/vmap-friendly.  ``params`` is the component-value vector in netlist
    order (``stamps.params`` holds the netlist's own values).

    ``pad_to`` assembles directly into a [pad_to, pad_to] matrix with a
    unit diagonal on the padding (the no-pivot block solvers need
    128-multiples; padding here avoids materializing a second copy of a
    multi-GB batch inside their wrappers).
    """
    params = jnp.asarray(params, dtype=dtype)
    g_vals, rhs_vals = stamp_values(stamps, params)
    n = stamps.n
    m = pad_to if pad_to is not None else n
    assert m >= n, (m, n)
    G = jnp.zeros((m, m), dtype=params.dtype).at[stamps.g_rows, stamps.g_cols].add(
        g_vals
    )
    if m > n:
        pad_idx = np.arange(n, m)
        G = G.at[pad_idx, pad_idx].add(1.0)
    b = jnp.zeros(m, dtype=params.dtype).at[stamps.rhs_rows].add(rhs_vals)
    return G, b


def assemble_rhs(stamps: StampTensors, params, dtype=None):
    """Assemble only the RHS vector ``b`` (for probe-source sweeps where G
    is fixed)."""
    params = jnp.asarray(params, dtype=dtype)
    _, rhs_vals = stamp_values(stamps, params)
    return jnp.zeros(stamps.n, dtype=params.dtype).at[stamps.rhs_rows].add(rhs_vals)


def bandwidth(stamps: StampTensors) -> int:
    """Matrix bandwidth of the stamp template in natural node order.

    The stamp compiler's structural view of the circuit: 1 means
    tridiagonal (chain/ladder topologies), enabling the PCR fast path."""
    if len(stamps.g_rows) == 0:
        return 0
    return int(np.max(np.abs(stamps.g_rows.astype(np.int64) - stamps.g_cols)))


def _gather_plan(rows: np.ndarray, entry_idx: np.ndarray, n: int):
    """Turn a scatter (``out[rows[e]] += vals[entry_idx[e]]``) into a dense
    gather: per-row padded entry-index matrix [n, K] + 0/1 mask.

    K is the max entries landing on one row (2 for ladder diagonals), so
    the assembly becomes ``(vals[idx] * mask).sum(-1)`` — pure gathers that
    run at memory speed, instead of a scatter-add."""
    order = np.argsort(rows, kind="stable")
    rows_sorted = rows[order]
    entries_sorted = entry_idx[order]
    counts = np.bincount(rows_sorted, minlength=n)
    K = int(counts.max()) if len(counts) else 1
    idx = np.zeros((n, K), dtype=np.int32)
    mask = np.zeros((n, K), dtype=np.float64)
    slot = np.zeros(n, dtype=np.int64)
    for r, e in zip(rows_sorted, entries_sorted):
        idx[r, slot[r]] = e
        mask[r, slot[r]] = 1.0
        slot[r] += 1
    return idx, mask


def _band_gather_plans(stamps: StampTensors):
    """Host-side: per-band and RHS gather plans, cached on the stamps."""
    cached = getattr(stamps, "_band_gather", None)
    if cached is None:
        off = stamps.g_rows.astype(np.int64) - stamps.g_cols
        n = stamps.n
        plans = {}
        for o in (-1, 0, 1):
            e = np.nonzero(off == o)[0].astype(np.int32)
            plans[o] = _gather_plan(stamps.g_rows[e], e, n)
        plans["rhs"] = _gather_plan(
            stamps.rhs_rows, np.arange(len(stamps.rhs_rows), dtype=np.int32), n
        )
        stamps._band_gather = cached = plans  # type: ignore[attr-defined]
    return cached


def assemble_tridiag(stamps: StampTensors, params, dtype=None):
    """Assemble the three bands + RHS directly (no dense G at all).

    Valid when ``bandwidth(stamps) <= 1``.  Returns ``(dl, d, du, b)``,
    each [n]: per-system assembly traffic drops from O(n²) to O(n), and
    the band fold is a gather (not a scatter-add), so the batched
    formulation runs at HBM speed.
    """
    params = jnp.asarray(params, dtype=dtype)
    g_vals, rhs_vals = stamp_values(stamps, params)
    plans = _band_gather_plans(stamps)

    def fold(vals, plan):
        idx, mask = plan
        return (vals[..., idx] * jnp.asarray(mask, dtype=vals.dtype)).sum(-1)

    dl = fold(g_vals, plans[1])  # G[i, i-1]
    d = fold(g_vals, plans[0])
    du = fold(g_vals, plans[-1])  # G[i, i+1]
    b = fold(rhs_vals, plans["rhs"])
    return dl, d, du, b
