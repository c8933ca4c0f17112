"""Sparse MNA path: deduplicated COO operator + Krylov solve.

Replaces the reference's ``dok_matrix`` stamping + SuperLU ``spsolve``
(reference nodal.py:349-350, 325).  The stamp COO entries are deduplicated
and row-sorted once on the host; on device, parameter values fold into the
deduped slots with one ``segment_sum`` and the matvec is a gather +
multiply + row-``segment_sum`` — all static-shape, so sweeps ``vmap`` over
values only.

Solver selection: a purely resistive netlist yields the grounded Laplacian,
which is SPD → preconditioned CG.  Branch equations (E/controlled sources)
make the system indefinite/asymmetric → BiCGStab.  Jacobi preconditioning
skips zero diagonals (voltage-source branch rows have none).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

import jax
import jax.numpy as jnp

from nodal_tpu.models.stamps import StampTensors, stamp_values
from nodal_tpu.ops.cg import bicgstab, cg


@dataclass(frozen=True)
class SparseTopology:
    """Deduplicated, row-major-sorted COO structure for one netlist."""

    n: int
    rows: np.ndarray  # int32[nnz] sorted
    cols: np.ndarray  # int32[nnz]
    entry_to_slot: np.ndarray  # int32[raw_nnz]: raw stamp entry -> slot
    diag_slot: np.ndarray  # int32[n]: slot of (i, i), or -1 if absent


def build_sparse_topology(stamps: StampTensors) -> SparseTopology:
    """Host-side: sort raw COO entries by (row, col) and merge duplicates."""
    key = stamps.g_rows.astype(np.int64) * stamps.n + stamps.g_cols
    uniq, inverse = np.unique(key, return_inverse=True)
    rows = (uniq // stamps.n).astype(np.int32)
    cols = (uniq % stamps.n).astype(np.int32)
    diag_slot = np.full(stamps.n, -1, dtype=np.int32)
    on_diag = rows == cols
    diag_slot[rows[on_diag]] = np.nonzero(on_diag)[0].astype(np.int32)
    return SparseTopology(
        n=stamps.n,
        rows=rows,
        cols=cols,
        entry_to_slot=inverse.astype(np.int32),
        diag_slot=diag_slot,
    )


def _topology(stamps: StampTensors) -> SparseTopology:
    cached = getattr(stamps, "_sparse_topology", None)
    if cached is None:
        cached = build_sparse_topology(stamps)
        stamps._sparse_topology = cached  # type: ignore[attr-defined]
    return cached


def sparse_values(topo: SparseTopology, stamps: StampTensors, params):
    """Fold raw stamp values into deduped slots (device, one segment_sum)."""
    g_vals, _ = stamp_values(stamps, params)
    return jax.ops.segment_sum(
        g_vals, jnp.asarray(topo.entry_to_slot), num_segments=len(topo.rows)
    )


def coo_matvec(topo: SparseTopology, vals, x):
    """y = G @ x via gather + segment_sum.  Rows are pre-sorted, which lets
    XLA use the cheap sorted-segment path."""
    prods = vals * x[jnp.asarray(topo.cols)]
    return jax.ops.segment_sum(
        prods,
        jnp.asarray(topo.rows),
        num_segments=topo.n,
        indices_are_sorted=True,
    )


def jacobi_preconditioner(topo: SparseTopology, vals):
    """Inverse-diagonal preconditioner; identity on empty/zero diagonals
    (voltage-source branch rows)."""
    slot = jnp.asarray(topo.diag_slot)
    diag = jnp.where(slot >= 0, vals[jnp.clip(slot, 0)], 0.0)
    inv = jnp.where(jnp.abs(diag) > 0, 1.0 / jnp.where(diag == 0, 1.0, diag), 1.0)

    def M(r):
        return r * inv

    return M


# Auto preconditioner policy: below this unknown count, Jacobi-CG's cheap
# iterations beat AMG's per-cycle cost + program size (measured at 40k
# nodes: AMG cuts iterations 14x — 79 vs 1140 — but loses on wall clock on
# a cold start); above it, iteration counts grow with graph diameter and
# AMG wins outright.
_AMG_THRESHOLD_N = 100_000


def _solve_spd_skyline(stamps: StampTensors, topo: SparseTopology, params,
                       rhs):
    """Host-direct solve of a purely resistive (SPD) system through the
    native skyline LDLᵀ tier, or None to fall through to Krylov.

    The factorization is cached on the stamps object per value
    fingerprint, so repeat solves (equiv probes with different RHS) pay
    one backsolve.
    """
    import os

    if os.environ.get("NODAL_TPU_NO_SKYLINE", "0") == "1":
        return None
    from nodal_tpu.models.stamps import stamp_values_np
    from nodal_tpu.ops import skyline
    from nodal_tpu.ops.sparse_schur import GeneralSolveInfo

    if not skyline.available() or stamps.n == 0:
        return None
    plan = getattr(stamps, "_spd_skyline_plan", "missing")
    if plan == "missing":
        plan = skyline.plan_skyline(stamps.n, topo.rows, topo.cols)
        stamps._spd_skyline_plan = plan  # type: ignore[attr-defined]
    if plan is None:
        return None

    params_np = np.asarray(params, dtype=np.float64)
    g_vals, rhs_vals = stamp_values_np(stamps, params_np)
    cache = getattr(stamps, "_spd_skyline_fact", None)
    key = g_vals.tobytes()
    if cache is not None and cache[0] == key:
        fact = cache[1]
        if fact is None:
            return None  # memoized pivot failure
    else:
        fact = skyline.factor(plan, stamps.g_rows, stamps.g_cols, g_vals)
        stamps._spd_skyline_fact = (key, fact)  # type: ignore[attr-defined]
        if fact is None:
            return None

    b = np.zeros(stamps.n)
    np.add.at(b, stamps.rhs_rows, rhs_vals)
    if rhs is not None:
        b = np.asarray(rhs, dtype=np.float64)
    x = skyline.solve(fact, b)
    gr = stamps.g_rows.astype(np.int64)
    gc = stamps.g_cols.astype(np.int64)
    y = np.zeros(stamps.n)
    with np.errstate(invalid="ignore"):
        np.add.at(y, gr, g_vals * x[gc])
    b_scale = max(float(np.max(np.abs(b))) if stamps.n else 0.0, 1.0)
    rel = float(np.max(np.abs(b - y))) / b_scale
    return x, GeneralSolveInfo(
        residual=np.float64(rel),
        iterations=np.int64(1),
        converged=np.bool_(bool(np.isfinite(rel))),
        method="skyline",
    )


def solve_sparse_system(stamps: StampTensors, params, dtype=None, tol=None,
                        rhs=None, preconditioner: str = "auto",
                        general: str = "auto"):
    """Solve the full MNA system sparsely.  Returns ``(x, SolveInfo)``.

    Purely resistive systems are SPD and solve with preconditioned CG
    (``jacobi``, ``amg``, or ``auto`` — AMG above ~100k unknowns).  Systems
    with branch equations (E/controlled sources make G indefinite) default
    to :func:`nodal_tpu.ops.sparse_schur.solve_general_auto` — ideal-
    voltage-source supernode reduction (ops/reduce_e.py), then bordered
    block elimination: AMG-CG on the resistively-grounded node block plus
    a small dense pivoted Schur complement, the SuperLU-robustness role
    (reference nodal.py:325).  A border that exceeds the Schur cap even
    after reduction raises a clear ValueError (``general='krylov'`` forces
    the legacy Jacobi-BiCGStab instead).  ``rhs`` overrides the netlist's
    own source vector (used by the equivalent-resistance probe injection).
    """
    topo = _topology(stamps)

    spd = stamps.n == stamps.n_kcl  # no branch equations -> grounded Laplacian
    if not spd and general != "krylov":
        from nodal_tpu.ops.sparse_schur import solve_general_auto

        # Entirely host-side: np.asarray happens on the *original*
        # argument before any device placement, and the result stays
        # numpy, so this host path never round-trips through the
        # accelerator.
        # solve_general_auto routes: ideal-source constraint reduction
        # (ops/reduce_e.py) first, bordered elimination on the reduced
        # system; a border that stays over the cap raises a clear
        # ValueError instead of falling into a Krylov method known to
        # stall on branch-equation circuits (general="krylov" still
        # forces the old fallback explicitly).
        gtol = tol
        if gtol is None:
            gtol = 1e-10 if np.dtype(dtype or np.float64) == np.float64 \
                else 1e-6
        x, info = solve_general_auto(
            stamps,
            np.asarray(params, dtype=np.float64),
            rhs=None if rhs is None else np.asarray(rhs, np.float64),
            tol=max(float(gtol), 1e-12),
        )
        return x.astype(np.dtype(dtype) if dtype is not None
                        else np.float64), info

    if spd and preconditioner == "auto":
        # Native skyline direct tier (round 5): a one-shot resistive
        # solve pays zero XLA compile — RCM + profile LDLᵀ in C++ —
        # and returns at the f64 floor.  Falls through to the Krylov
        # paths when the profile blows the caps, the factor hits a
        # non-SPD pivot, or the tier is disabled.
        direct = _solve_spd_skyline(stamps, topo, params, rhs)
        if direct is not None:
            x, info = direct
            return (x.astype(np.dtype(dtype) if dtype is not None
                             else np.float64), info)

    params = jnp.asarray(params, dtype=dtype)
    if tol is None:
        tol = 1e-10 if params.dtype == jnp.float64 else 1e-6
    if preconditioner == "auto":
        preconditioner = (
            "amg" if spd and stamps.n >= _AMG_THRESHOLD_N else "jacobi"
        )

    if preconditioner == "amg":
        if not spd:
            raise ValueError("AMG preconditioning requires an SPD system")
        from nodal_tpu.models.stamps import stamp_values_np
        from nodal_tpu.ops.amg import build_hierarchy, make_amg_preconditioner

        vals = sparse_values(topo, stamps, params)
        if rhs is None:
            _, rhs_vals = stamp_values(stamps, params)
            b = jnp.zeros(stamps.n, dtype=params.dtype).at[
                stamps.rhs_rows].add(rhs_vals)
        else:
            b = jnp.asarray(rhs, dtype=params.dtype)
        g_np, _ = stamp_values_np(stamps, np.asarray(params, np.float64))
        merged = np.zeros(len(topo.rows))
        np.add.at(merged, topo.entry_to_slot, g_np)
        levels = build_hierarchy(stamps.n, topo.rows, topo.cols, merged)
        M = make_amg_preconditioner(levels, params.dtype)
        x, info = cg(lambda x: coo_matvec(topo, vals, x), b,
                     preconditioner=M, tol=tol, maxiter=20 * stamps.n)
        return x, info

    # Jacobi path: the whole solve — value fold, RHS assembly, CG/BiCGStab
    # loop — is ONE jitted program, cached per (dtype, tol, spd, rhs?) on
    # the stamps object.  Eager dispatch here would cost dozens of per-op
    # device dispatches (see Circuit._solve_dense).
    key = (str(jnp.dtype(params.dtype)), float(tol), spd, rhs is not None)
    fns = getattr(stamps, "_krylov_fns", None)
    if fns is None:
        fns = stamps._krylov_fns = {}  # type: ignore[attr-defined]
    fn = fns.get(key)
    if fn is None:
        solver = cg if spd else bicgstab
        maxiter = 20 * stamps.n
        with_rhs = rhs is not None

        def f(params, rhs):
            vals = sparse_values(topo, stamps, params)
            if with_rhs:
                b = rhs
            else:
                _, rhs_vals = stamp_values(stamps, params)
                b = jnp.zeros(stamps.n, dtype=params.dtype).at[
                    stamps.rhs_rows].add(rhs_vals)
            M = jacobi_preconditioner(topo, vals)
            return solver(lambda x: coo_matvec(topo, vals, x), b,
                          preconditioner=M, tol=tol, maxiter=maxiter)

        fn = jax.jit(f)
        fns[key] = fn

    b_arg = (jnp.asarray(rhs, dtype=params.dtype) if rhs is not None
             else jnp.zeros((), dtype=params.dtype))
    x, info = fn(params, b_arg)
    return x, info
