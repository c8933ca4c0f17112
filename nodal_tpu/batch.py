"""Batched parameter sweeps: vmap over stamp values.

The reference has no batching story at all (SURVEY.md §2.5 — one
``solve()`` per process).  Here a netlist topology compiles once; a sweep is
``vmap`` over the component-value vector, so assembling + factoring B
systems is a single XLA program on the accelerator.  This is the ≥10k
solves/sec @1k-nodes target path (BASELINE.json).

Typical use:

    circuit = Circuit(netlist)
    sweep = BatchedSolver(circuit)                    # compile once
    results = sweep(params_batch)                     # [B, n] solutions

    # Monte Carlo tolerance analysis on resistor values:
    stats = monte_carlo(circuit, {"r1": 0.05, "r2": 0.05}, n=10_000, seed=0)
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from nodal_tpu.circuit import Circuit
from nodal_tpu.models.stamps import StampTensors
from nodal_tpu.ops.assemble import assemble_dense
from nodal_tpu.ops import dense_solve


def _schur_band_assembler(stamps: StampTensors, dtype, bplan):
    """Closure assembling the MNA 2x2 block partition for the banded Schur
    paths, with no full-G materialization: the resistive node block A goes
    straight into RCM-reordered band storage (``bplan`` is a
    ops.band.BandPlan or ops.scalar_band.ScalarBandPlan), with B's rows /
    C's columns / bk carried in the same ordering so only the final xk
    needs un-permuting.  Returns ``(W, B, C, D, bk, bb)``."""
    from nodal_tpu.models.stamps import stamp_values

    nk = stamps.n_kcl
    kbe = stamps.n - nk
    gr = stamps.g_rows
    gc = stamps.g_cols
    rank = bplan.rank
    iB = np.nonzero((gr < nk) & (gc >= nk))[0]
    iC = np.nonzero((gr >= nk) & (gc < nk))[0]
    iD = np.nonzero((gr >= nk) & (gc >= nk))[0]
    rB = rank[gr[iB].astype(np.int64)]  # B rows in band order
    cC = rank[gc[iC].astype(np.int64)]  # C cols in band order
    rr = stamps.rhs_rows
    ib = np.nonzero(rr >= nk)[0]
    n_pad = bplan.n_pad

    def blocks(params):
        params = jnp.asarray(params, dtype=dtype)
        g_vals, rhs_vals = stamp_values(stamps, params)
        W, bk = bplan.assemble_from_values(g_vals, rhs_vals)
        Bm = jnp.zeros((n_pad, kbe), dtype).at[rB, gc[iB] - nk].add(
            g_vals[iB])
        C = jnp.zeros((kbe, n_pad), dtype).at[gr[iC] - nk, cC].add(
            g_vals[iC])
        D = jnp.zeros((kbe, kbe), dtype).at[gr[iD] - nk, gc[iD] - nk].add(
            g_vals[iD])
        bb = jnp.zeros(kbe, dtype).at[rr[ib] - nk].add(rhs_vals[ib])
        return W, Bm, C, D, bk, bb

    return blocks


def _make_schur_band_solver(assemble, multi_solve, nplan, nk: int, kbe: int):
    """(solve_batch, solve_rhs_t) for the banded Schur paths.

    ``solve_batch(pb, rhs=None)`` solves G x = b (or the given natural-order
    RHS); ``solve_rhs_t(pb, rhs)`` solves the TRANSPOSED system Gᵀλ = rhs
    for the adjoint pass.  The node block A is symmetric (SPD — the Schur
    precondition), so transposition only swaps the border blocks
    B ↔ Cᵀ and D → Dᵀ; the same banded multi-RHS kernel and Schur algebra
    run unchanged, at the same cost as the forward solve.
    """
    def core(params_batch, rhs=None, transpose=False):
        W, Bm, C, D, bk, bb = jax.vmap(assemble)(params_batch)
        if rhs is None:
            rk, rb = bk, bb
        else:
            rk = nplan.rhs_to_band(rhs, W.dtype)
            rb = rhs[:, nk:].astype(W.dtype)
        if transpose:
            Bm, C, D = (jnp.swapaxes(C, 1, 2), jnp.swapaxes(Bm, 1, 2),
                        jnp.swapaxes(D, 1, 2))
        R = jnp.concatenate([Bm, rk[..., None]], axis=-1)
        Y = multi_solve(W, R)
        YB = Y[..., :kbe]
        yb = Y[..., kbe]
        with jax.default_matmul_precision("highest"):
            S = D - C @ YB
            rhs_b = rb - (C @ yb[..., None])[..., 0]
            xb = jnp.linalg.solve(S, rhs_b[..., None])[..., 0]
            xk_band = yb - (YB @ xb[..., None])[..., 0]
        xk = nplan.unpermute(xk_band)
        return jnp.concatenate([xk, xb], axis=-1)

    return core, (lambda pb, rhs: core(pb, rhs, transpose=True))


def _schur_supported(stamps: StampTensors) -> bool:
    """Host-side probe: is the resistive node block A = G[:nk, :nk] SPD?

    Only resistor stamps land in A (source couplings go to the branch
    rows/columns — see ops.block_lu.schur_solve), so SPD-ness means every
    node is resistively tied to ground directly or transitively.  A node
    held only by voltage sources makes A singular; those circuits take the
    pivoted dense path.  The probe runs once per topology at the netlist's
    default parameters and is cached on the stamps object:

    * nk ≤ 8192 — dense f64 Cholesky (cheap at this size);
    * nk  > 8192 — banded f64 Cholesky (LAPACK pbtrf) on the RCM-reordered
      node block.  Large node blocks only ride the Schur fast path through
      the banded multi-RHS kernel anyway, so "bandable" is a precondition,
      not a restriction — this lifts the round-2 nk ≤ 8192 cap (branch
      circuits beyond it silently fell to ~820/s pivoted LU).

    Both probes share the margin rule: a barely-positive pivot means the
    f32 no-pivot kernels will blow up even though f64 Cholesky squeaked
    through.
    """
    cached = getattr(stamps, "_schur_ok", None)
    if cached is not None:
        return cached
    nk = stamps.n_kcl
    ok = False
    if 0 < nk <= 8192 and stamps.n > nk:
        from nodal_tpu.models.stamps import stamp_values_np

        mask = (stamps.g_rows < nk) & (stamps.g_cols < nk)
        g_np, _ = stamp_values_np(stamps, stamps.params)
        A = np.zeros((nk, nk))
        np.add.at(A, (stamps.g_rows[mask], stamps.g_cols[mask]), g_np[mask])
        try:
            L = np.linalg.cholesky(A)
            ok = bool(np.min(np.diag(L)) > 1e-6 * np.max(np.diag(L)))
        except np.linalg.LinAlgError:
            ok = False
    elif nk > 8192 and stamps.n > nk:
        from nodal_tpu.ops.band import node_band_plan

        plan = node_band_plan(stamps)
        if plan is not None and plan.nb >= 2:
            ok = _banded_spd_probe(stamps, plan)
    stamps._schur_ok = ok  # type: ignore[attr-defined]
    return ok


def _banded_spd_probe(stamps: StampTensors, plan) -> bool:
    """f64 banded Cholesky (scipy pbtrf) of the RCM-reordered node block.

    O(nk·halfbw²) LAPACK work — seconds at nk=20k — versus the dense
    probe's O(nk³)/O(nk²·8B) which is unpayable past ~8k.  Returns False
    (not an exception) for non-SPD blocks, with the same relative pivot
    margin as the dense probe.
    """
    import scipy.linalg as sla

    from nodal_tpu.models.stamps import stamp_values_np

    nk = stamps.n_kcl
    g_np, _ = stamp_values_np(stamps, stamps.params)
    mask = (stamps.g_rows < nk) & (stamps.g_cols < nk)
    r = plan.rank[stamps.g_rows[mask].astype(np.int64)]
    c = plan.rank[stamps.g_cols[mask].astype(np.int64)]
    v = g_np[mask]
    upper = c >= r
    u = plan.halfbw
    ab = np.zeros((u + 1, nk))
    np.add.at(ab, (u + r[upper] - c[upper], c[upper]), v[upper])
    try:
        with np.errstate(all="ignore"):
            cb = sla.cholesky_banded(ab, lower=False)
        d = cb[u, :]
        return bool(np.all(np.isfinite(d))
                    and np.min(d) > 1e-6 * np.max(d))
    except Exception:
        return False


#: Rows with more COO entries than this keep the scatter-add audit (the
#: gather-fold pass reads ``width`` slots per output row).
_RESID_FOLD_MAX_WIDTH = 16

#: Auto-selection refuses the dense ('block') tier above this many
#: unknowns: one [n, n] f32 factorization is already 1 GB at n=16384, and
#: a batch of them has no chance — large circuits without banded
#: structure belong on the iterative/stencil paths (Circuit.solve,
#: grid_solve), not in a silent OOM.
_DENSE_BATCH_MAX_N = 16384


def _resid_gather_tables(stamps: StampTensors):
    """Per-MNA-row gather lists over the COO stamp entries, or None when
    some row is denser than ``_RESID_FOLD_MAX_WIDTH``.

    Returns ``(entry_ids, x_cols, valid, rhs_ids, rhs_valid)`` — the first
    three [n, width] (entry index into the raw stamp-value vector, the
    entry's column as an index into x, 1.0/0.0 slot mask), the last two
    [n, rhs_width] for the RHS.  Built vectorized (argsort + cumcount) so
    planning stays O(nnz) numpy work even at 1M entries, and cached on the
    StampTensors as numpy (device arrays would leak tracers across traces
    — see BandPlan._gather_fold).
    """
    cached = stamps.__dict__.get("_resid_gf", False)
    if cached is not False:
        return cached

    def fold(rows, nnz):
        counts = np.bincount(rows, minlength=stamps.n)
        width = int(counts.max()) if nnz else 1
        if width > _RESID_FOLD_MAX_WIDTH:
            return None
        order = np.argsort(rows, kind="stable")
        offsets = np.zeros(stamps.n, dtype=np.int64)
        np.cumsum(counts[:-1], out=offsets[1:])
        pos = np.arange(nnz, dtype=np.int64) - offsets[rows[order]]
        ids = np.zeros((stamps.n, max(width, 1)), dtype=np.int32)
        valid = np.zeros((stamps.n, max(width, 1)), dtype=np.float64)
        ids[rows[order], pos] = order
        valid[rows[order], pos] = 1.0
        return ids, valid

    out = None
    g = fold(stamps.g_rows.astype(np.int64), len(stamps.g_rows))
    r = fold(stamps.rhs_rows.astype(np.int64), len(stamps.rhs_rows))
    if g is not None and r is not None:
        entry_ids, valid = g
        rhs_ids, rhs_valid = r
        x_cols = np.zeros_like(entry_ids)
        x_cols[valid > 0] = stamps.g_cols[
            entry_ids[valid > 0].astype(np.int64)]
        out = (entry_ids, x_cols, valid, rhs_ids, rhs_valid)
    stamps.__dict__["_resid_gf"] = out
    return out


def _coo_apply(stamps: StampTensors, g_vals, xs):
    """``y = G·x`` straight from the COO stamp entries — no matrix built.

    Folds each row's few entries with dense gathers when rows are narrow
    (the common case) instead of a per-sample scatter-add.  Dense rows
    fall back to the scatter-add.
    """
    gf = _resid_gather_tables(stamps)
    if gf is not None:
        entry_ids, x_cols, valid, _, _ = gf
        vmask = jnp.asarray(valid, dtype=g_vals.dtype)
        return jnp.sum(g_vals[:, entry_ids] * vmask * xs[:, x_cols],
                       axis=-1)
    gx = g_vals * xs[:, stamps.g_cols]
    return jnp.zeros_like(xs).at[:, stamps.g_rows].add(gx)


def _coo_rhs_vec(stamps: StampTensors, rhs_vals, like):
    """Natural-order RHS vector ``b`` from the COO RHS entries; ``like``
    fixes the [B, n] output shape/dtype."""
    if not len(stamps.rhs_rows):
        return jnp.zeros_like(like)
    gf = _resid_gather_tables(stamps)
    if gf is not None:
        _, _, _, rhs_ids, rhs_valid = gf
        return jnp.sum(
            rhs_vals[:, rhs_ids]
            * jnp.asarray(rhs_valid, dtype=rhs_vals.dtype),
            axis=-1,
        )
    return jnp.zeros_like(like).at[:, stamps.rhs_rows].add(rhs_vals)


def _coo_residuals(stamps: StampTensors, params_batch, xs):
    """Relative residuals straight from the COO stamp entries (no matrix
    built): ``r = b − G·x`` evaluated entrywise, O(B·nnz).  Shared by
    BatchedSolver.residuals (f64, host) and monte_carlo's fused audit
    (sweep precision, on device); trace-time dtype follows the inputs.
    """
    from nodal_tpu.models.stamps import stamp_values

    g_vals, rhs_vals = jax.vmap(lambda p: stamp_values(stamps, p))(
        params_batch)
    y = _coo_apply(stamps, g_vals, xs)
    b = _coo_rhs_vec(stamps, rhs_vals, xs)
    return jnp.max(jnp.abs(b - y), axis=1) / jnp.maximum(
        jnp.max(jnp.abs(b), axis=1), 1.0
    )


def _coo_defect_refine(stamps: StampTensors, params_batch, rhs, x, resolve,
                       iters: int = 2):
    """f64 defect correction against the *exact* COO operator.

    ``x`` is the f32-tier solution (any dtype; promoted to f64); ``rhs``
    is an explicit natural-order RHS or None for the stamped one;
    ``resolve`` maps an f32 natural-order residual to an f32 correction
    (a re-solve against the already-assembled/factored f32 operator).
    Refining against the COO entries rather than the assembled-and-rounded
    f32 matrix is what buys true f64 accuracy (~1e-12) instead of an
    ~1e-7 floor set by assembly rounding — the band/tridiag refined tiers
    established this; the block/schur/dense tiers share it here.
    """
    from nodal_tpu.models.stamps import stamp_values

    g_vals, rhs_vals = jax.vmap(lambda p: stamp_values(stamps, p))(
        params_batch.astype(jnp.float64))
    x = x.astype(jnp.float64)
    if rhs is None:
        b64 = _coo_rhs_vec(stamps, rhs_vals, x)
    else:
        b64 = rhs.astype(jnp.float64)
    for _ in range(iters):
        r = b64 - _coo_apply(stamps, g_vals, x)
        x = x + resolve(r.astype(jnp.float32)).astype(jnp.float64)
    return x


#: The default accuracy contract (BASELINE.json north star): node voltages
#: within 1e-6 *of the f64 reference* — an ERROR bound, not a residual
#: bound.  Round-4 review item #2: backward-stable f32 solves keep the
#: residual under 1e-6 while the error sits κ(A)× higher (measured
#: 4.6e-4 at n=10k), so the auto tier now always defect-corrects and
#: gates continuation on a correction-based error estimate.
_CONTRACT_TOL = 1e-6

#: Escalation pass cap: each exact-COO defect correction contracts the
#: error by ~the f32 tier's own relative error ρ (1e-4 at n=10k), so
#: well-posed batches converge in 1-2 passes; the cap only bites for
#: near-divergent (ρ→1) systems, which then hit the pivoted rescue.
_ESCALATE_MAX_PASSES = 4

#: Samples that defect correction cannot repair (the no-pivot tier's
#: factorization itself broke — e.g. indefinite systems from negative
#: Monte Carlo draws) are re-solved with pivoted dense LU, assembled in
#: chunks bounded by this many bytes.  Above this n the dense rescue is
#: structurally impossible ([B, n, n]) and such samples stay flagged.
_ESCALATE_DENSE_MAX_N = 4096
_ESCALATE_CHUNK_BYTES = 1 << 28


def _escalating_solver(stamps: StampTensors, inner, transpose: bool = False):
    """The ``refine="auto"`` tier: f32 kernels + exact-f64-COO defect
    correction until a correction-based ERROR estimate meets the 1e-6
    contract.

    ``inner(pb, rhs=None)`` is the tier's raw f32 solve (``rhs`` in
    natural order; for ``transpose=True`` it solves the transposed system
    and ``rhs`` is required).

    Why error, not residual (round-4 review item #2): the f32 kernels are
    backward-stable, so their residual sits at ~ε₃₂ regardless of
    conditioning while the error is κ(A)·ε₃₂ — a residual gate never
    fires on exactly the circuits that miss the contract.  Defect
    correction supplies a *direct* error estimate for free: the
    correction ``dx = Ã⁻¹(b − A x_k)`` approximates the current error
    ``x* − x_k``, and successive corrections contract by the solver's own
    relative error ρ.  So the tier always runs one pass (after it the
    error is ~ρ², ≤1e-7 even at n=10k where ρ≈4.6e-4) and keeps going
    while the *predicted post-pass error* ``‖dx‖·ρ̂`` (ρ̂ = measured
    contraction ratio, seeded with ‖dx₁‖ ≈ ρ) exceeds ``_CONTRACT_TOL``.
    Output is f64 (like ``refine=True``); non-finite corrections
    (structurally singular samples) exit immediately — refinement cannot
    repair a failed factorization, and the rescue/audit below still
    handles them.
    """
    from nodal_tpu.models.stamps import stamp_values

    st = _transposed_stamps(stamps) if transpose else stamps

    def refine_loop(params_batch, rhs, x):
        """f64 defect-correction loop: 1 unconditional pass + error-gated
        continuation."""
        x = x.astype(jnp.float64)
        g_vals, rhs_vals = jax.vmap(lambda p: stamp_values(st, p))(
            params_batch.astype(jnp.float64))
        if rhs is None:
            b64 = _coo_rhs_vec(st, rhs_vals, x)
        else:
            b64 = rhs.astype(jnp.float64)
        b_scale = jnp.maximum(jnp.max(jnp.abs(b64), axis=1), 1.0)

        def correct(x):
            """One defect pass: returns (x+dx, dx_rel) with dx_rel the
            worst per-sample ‖dx‖∞/‖x‖∞ — the error estimate of x."""
            r = b64 - _coo_apply(st, g_vals, x)
            dx = inner(params_batch, r.astype(jnp.float32)).astype(
                jnp.float64)
            x_scale = jnp.maximum(jnp.max(jnp.abs(x), axis=1), 1e-30)
            dx_rel = jnp.max(jnp.max(jnp.abs(dx), axis=1) / x_scale)
            return x + dx, dx_rel

        # Pass 1, unconditional.  dx₁ estimates the raw solve's error,
        # which for a single solve IS the contraction factor ρ.
        x, dx1 = correct(x)

        def cond(state):
            _x, dx_rel, rho, k = state
            return jnp.logical_and(
                jnp.logical_and(dx_rel * rho > _CONTRACT_TOL,
                                jnp.isfinite(dx_rel)),
                k < _ESCALATE_MAX_PASSES,
            )

        def body(state):
            x, dx_prev, _rho, k = state
            x, dx_rel = correct(x)
            # Measured contraction this pass; ≥1 means divergence — keep
            # 1.0 so the loop runs to the cap and hands off to the rescue.
            rho = jnp.minimum(dx_rel / jnp.maximum(dx_prev, 1e-300), 1.0)
            return (x, dx_rel, rho, k + 1)

        x, _, _, _ = jax.lax.while_loop(
            cond, body, (x, dx1, dx1, jnp.array(1, jnp.int32)))

        # Residual of the refined iterate — drives only the pivoted
        # rescue for samples whose factorization broke outright.
        r = b64 - _coo_apply(st, g_vals, x)

        if stamps.n > _ESCALATE_DENSE_MAX_N:
            return x
        # Pivoted rescue for samples the defect loop could not contract
        # (the no-pivot factorization itself broke — indefinite draws).
        # Chunked dense assembly bounds memory; runs only when the loop
        # exits over-contract (lax.cond), and only the still-bad samples
        # take the rescue values.
        rel_s = jnp.max(jnp.abs(r), axis=1) / b_scale
        bad = jnp.logical_or(rel_s > _CONTRACT_TOL, ~jnp.isfinite(rel_s))

        def rescue(x):
            B = params_batch.shape[0]
            chunk = max(1, min(B, _ESCALATE_CHUNK_BYTES
                               // max(stamps.n * stamps.n * 4, 1)))
            while B % chunk:  # largest divisor of B within the budget
                chunk -= 1
            # Native f64 pivoted LU: defect iteration around an f32
            # factorization diverges once cond(A)·eps_f32 > 1 (~1e7 —
            # reachable by near-singular draws), while f64 LU is
            # backward-stable regardless.
            core = make_dense_core(stamps, jnp.float64, refine=False)
            if B % chunk == 0 and B > chunk:
                pbc = params_batch.reshape(B // chunk, chunk, -1)
                if rhs is None:
                    xd = jax.lax.map(
                        lambda p: core(p, None, transpose), pbc)
                else:
                    rc = rhs.reshape(B // chunk, chunk, -1)
                    xd = jax.lax.map(
                        lambda pr: core(pr[0], pr[1], transpose),
                        (pbc, rc))
                xd = xd.reshape(B, -1)
            else:
                xd = core(params_batch, rhs, transpose)
            return jnp.where(bad[:, None], xd.astype(jnp.float64), x)

        return jax.lax.cond(jnp.any(bad), rescue, lambda x: x, x)

    def run(params_batch, rhs=None):
        # The first defect pass is unconditional: a residual pre-gate
        # cannot see κ(A)-amplified error (round-4 review item #2), and
        # the pass doubles as the error estimator.
        return refine_loop(params_batch, rhs, inner(params_batch, rhs))

    return run


def make_dense_core(stamps: StampTensors, dtype, refine: bool):
    """``core(pb, rhs=None, transpose=False)``: the dense (pivoted-LU)
    MNA solve shared by BatchedSolver's 'dense' method and the sharded
    multi-chip solver's fallback — an LU in ``dtype``, or with ``refine``
    an f32 factorization plus exact-COO f64 defect correction
    (3 iterations)."""
    from nodal_tpu.ops import dense_solve
    from nodal_tpu.ops.assemble import assemble_dense

    def core(params_batch, rhs=None, transpose=False):
        G, b = jax.vmap(
            lambda p: assemble_dense(stamps, p, dtype=dtype)
        )(params_batch)
        if rhs is not None:
            b = rhs.astype(b.dtype)
        if transpose:
            G = jnp.swapaxes(G, 1, 2)
        if refine:
            Gf = G.astype(jnp.float32)
            x = dense_solve.solve_dense(
                Gf, b.astype(jnp.float32)[..., None])[..., 0]
            st = _transposed_stamps(stamps) if transpose else stamps
            resolve = lambda r32: dense_solve.solve_dense(  # noqa: E731
                Gf, r32[..., None])[..., 0]
            return _coo_defect_refine(st, params_batch, rhs, x, resolve,
                                      iters=3)
        return dense_solve.solve_dense(G, b[..., None])[..., 0]

    return core


def make_adjoint_solver(stamps: StampTensors, solve_batch, solve_rhs_t):
    """Implicit-function custom VJP around a batched MNA solve.

    ``solve_batch(pb) -> x`` solves ``G(p)·x = b(p)`` per batch row;
    ``solve_rhs_t(pb, rhs) -> λ`` solves the TRANSPOSED system against an
    arbitrary natural-order RHS.  Reverse mode is then one *adjoint
    solve* ``Gᵀλ = x̄`` (the same kernels — resistive operators are
    symmetric, branch-equation ones transpose by swapping the Schur
    border) followed by the COO chain rule ``v̄_G[e] = −λ[row_e]·x[col_e]``,
    ``v̄_rhs[e] = λ[row_e]``, pulled back to component values through
    ``stamp_values``'s own VJP.  Cost: one extra solve per backward pass —
    the textbook adjoint method, never materializing ∂G/∂p.  Shared by
    BatchedSolver and the sharded multi-chip solver.

    Limitation: custom_vjp disables *forward-mode* AD (``jax.jvp`` /
    ``jacfwd`` raise TypeError).  Reverse mode is the right shape for
    circuit problems (many parameters, few outputs); per-output
    sensitivities come from :func:`sensitivities` (adjoint), and full
    Jacobians from vmapped ``jax.grad`` rows.
    """

    @jax.custom_vjp
    def solve(pb):
        return solve_batch(pb)

    def fwd(pb):
        x = solve_batch(pb)
        return x, (pb, x)

    def bwd(res, xbar):
        from nodal_tpu.models.stamps import stamp_values

        pb, x = res
        lam = solve_rhs_t(pb, xbar)
        wd = jnp.promote_types(lam.dtype, x.dtype)
        lam = lam.astype(wd)
        x64 = x.astype(wd)
        gbar = -(lam[:, stamps.g_rows] * x64[:, stamps.g_cols])
        rhsbar = lam[:, stamps.rhs_rows]

        def chain(p, gb, rb):
            _, vjp = jax.vjp(lambda q: stamp_values(stamps, q), p)
            return vjp((gb.astype(p.dtype), rb.astype(p.dtype)))[0]

        pbar = jax.vmap(chain)(pb, gbar, rhsbar)
        return (pbar.astype(pb.dtype),)

    solve.defvjp(fwd, bwd)
    return solve


def _transposed_stamps(stamps: StampTensors) -> StampTensors:
    """A view of the stamps with G's rows/cols swapped (Gᵀ), for adjoint
    refinement.  The RHS template is untouched — transpose callers always
    supply an explicit RHS (the cotangent).  Cached: the copy carries its
    own gather-table cache."""
    cached = stamps.__dict__.get("_transposed")
    if cached is None:
        import dataclasses

        cached = dataclasses.replace(
            stamps, g_rows=stamps.g_cols, g_cols=stamps.g_rows)
        stamps.__dict__["_transposed"] = cached
    return cached


def _stamps_of(circuit_or_stamps) -> StampTensors:
    """Accept a Circuit or bare StampTensors (native-parser output)."""
    stamps = getattr(circuit_or_stamps, "stamps", circuit_or_stamps)
    if not isinstance(stamps, StampTensors):
        raise TypeError(
            f"expected Circuit or StampTensors, got {type(circuit_or_stamps)}"
        )
    return stamps


def _refined_tridiag_solver(stamps, dtype, iters: int = 2):
    """Band-space mixed precision: f32 PCR solves, f64 band residuals.

    The returned callable also accepts an optional explicit RHS (natural
    order, [B, n]) replacing the stamped one — the adjoint pass solves the
    same (symmetric) operator against the cotangent.
    """
    from nodal_tpu.ops.assemble import assemble_tridiag
    from nodal_tpu.ops.tridiag import tridiag_matvec, tridiag_solve

    def solve_batch(params_batch, rhs=None):
        dl, d, du, b = jax.vmap(
            lambda p: assemble_tridiag(stamps, p, dtype=jnp.float64)
        )(params_batch.astype(jnp.float64))
        if rhs is not None:
            b = rhs.astype(jnp.float64)
        f32 = lambda t: t.astype(jnp.float32)  # noqa: E731
        x = tridiag_solve(f32(dl), f32(d), f32(du), f32(b)).astype(jnp.float64)
        for _ in range(iters):
            r = b - tridiag_matvec(dl, d, du, x)
            dx = tridiag_solve(f32(dl), f32(d), f32(du), f32(r))
            x = x + dx.astype(jnp.float64)
        return x

    return solve_batch


class BatchedSolver:
    """Compiled vmapped assemble+solve for one netlist topology.

    The solver method follows the circuit's *structure*, detected by the
    stamp compiler:

    * ``tridiag`` — chain/ladder topologies (bandwidth ≤ 1, purely
      resistive): band assembly + parallel cyclic reduction, O(n log n)
      work, no dense matrix ever built.
    * ``sband``  — narrow-band resistive circuits (half-bandwidth after
      RCM ≤ ``scalar_band.max_w(dtype)`` — e.g. 2-D meshes): scalar banded
      LDLᵀ, one system per GPU thread (ops.scalar_band /
      ops.pallas_scalar_band), O(n·w²) work.
    * ``band``   — locally-connected resistive circuits (meshes, buses,
      3-D lattices) whose half-bandwidth after a reverse Cuthill-McKee
      reordering fits a block size kb (ops.band): block-tridiagonal
      no-pivot Thomas, O(n·kb²) work instead of O(n³/3) and 3·kb·n
      storage instead of n².
    * ``block``  — remaining resistive (diagonally dominant) systems: the
      no-pivot blocked LU (ops.block_lu).
    * ``schur``  — branch-equation systems whose resistive node block is
      SPD (checked host-side with a Cholesky probe): block elimination —
      no-pivot blocked LU on the node block, small pivoted solve on the
      branch Schur complement (ops.block_lu.schur_solve).
    * ``dense``  — remaining branch-equation systems (nodes held only by
      voltage sources make the node block singular): XLA's pivoted LU.

    Args:
        circuit: the compiled circuit (topology + default params), or bare
            :class:`StampTensors` (e.g. from the native parser,
            nodal_tpu.utils.native.parse_stamps).
        dtype: batch numerics; default float32 — the fast path.
        refine: add f64-residual iterative refinement (f64-level accuracy
            at f32 speed for well-conditioned systems).
        method: override the structure-based choice.
        interpret: run the scalar-band kernel in the Pallas interpreter on
            every platform (tests).
    """

    def __init__(
        self,
        circuit: Circuit | StampTensors,
        *,
        dtype=jnp.float32,
        refine: bool | str = "auto",
        method: str = "auto",
        interpret: bool = False,
    ):
        from nodal_tpu.ops.assemble import assemble_tridiag, bandwidth
        from nodal_tpu.ops import block_lu, tridiag

        self.stamps: StampTensors = _stamps_of(circuit)
        self.dtype = dtype
        self.refine = refine
        # refine="auto" (the default): build the raw f32 tier and wrap it
        # in the escalating contract layer at _finalize — batches whose
        # measured residual misses the 1e-6 contract are defect-corrected
        # automatically (round-3 review item #4: the fused audit used to
        # WARN instead of escalating).  refine=False: raw tier, no audit.
        self._auto_escalate = (refine == "auto"
                               and jnp.dtype(dtype) == jnp.float32)
        if refine == "auto":
            refine = False

        if method not in ("auto", "tridiag", "sband", "band", "block",
                          "schur", "dense"):
            raise ValueError(
                f"unknown method {method!r}; expected one of "
                "'auto', 'tridiag', 'sband', 'band', 'block', 'schur', "
                "'dense'"
            )
        from nodal_tpu.ops.band import band_plan
        from nodal_tpu.ops.scalar_band import MAX_W, max_w, sband_plan

        resistive = self.stamps.n == self.stamps.n_kcl  # no branch equations
        # The sband solve runs in f32 under refine=True (f64 residuals).
        sband_dtype = jnp.float32 if refine else dtype
        if method == "auto":
            if resistive and bandwidth(self.stamps) <= 1:
                method = "tridiag"
            elif resistive and (splan := sband_plan(self.stamps)) is not None \
                    and splan.w <= max_w(sband_dtype):
                # Narrow band after RCM: the scalar LDLᵀ tier does n·w²
                # flops/sample where the block tiers do n·kb² (kb ≥ 64).
                method = "sband"
            elif resistive and (plan := band_plan(self.stamps)) is not None \
                    and plan.nb >= 2 and (plan.kb <= 128 or plan.n > 1024):
                # Bandable after RCM: O(n·kb²) block-Thomas beats the dense
                # O(n³/3) LU and shrinks storage n² -> 3·kb·n.  Wide bands
                # (kb ≥ 256) stay dense up to n=1024, where the dense
                # factorization does fewer passes than kb²-sized block
                # solves (a rule not yet re-measured on the GPU).
                method = "band"
            elif resistive:
                if self.stamps.n > _DENSE_BATCH_MAX_N:
                    # No banded structure at a size where the dense tier
                    # cannot be materialized ([B, n, n] is ~22 GB/sample
                    # f32 at n=75k) — fail loudly instead of OOMing.
                    raise ValueError(
                        f"circuit has no banded structure and n="
                        f"{self.stamps.n} exceeds the dense batch tier "
                        f"(n <= {_DENSE_BATCH_MAX_N}); use Circuit.solve "
                        "(sparse AMG-CG), grid_solve for regular grids, "
                        "or equivalent_resistance_stamps for probe solves"
                    )
                method = "block"
            elif self.stamps.n_kcl >= 256 and _schur_supported(self.stamps):
                # Big node block + few branch equations: block elimination
                # on the SPD node block, a small pivoted solve on the
                # branch Schur complement.
                method = "schur"
            else:
                if self.stamps.n > _DENSE_BATCH_MAX_N:
                    # Same loud-failure rule as the resistive branch above:
                    # a large non-resistive circuit whose SPD probe failed
                    # (n_kcl < 256 or a non-SPD node block) must not
                    # silently materialize [B, n, n] dense systems.
                    raise ValueError(
                        f"circuit needs the dense batch tier but n="
                        f"{self.stamps.n} exceeds its bound "
                        f"(n <= {_DENSE_BATCH_MAX_N}); use Circuit.solve "
                        "with sparse=True (bordered elimination) for "
                        "one-shot solves of large general circuits"
                    )
                method = "dense"
        elif method in ("tridiag", "sband", "band", "block") \
                and not resistive:
            raise ValueError(
                f"method={method!r} requires a purely resistive circuit "
                "(branch equations put zeros on the diagonal)"
            )
        elif method == "sband" and sband_plan(self.stamps) is None:
            raise ValueError(
                "method='sband' requires a narrow symmetric band after "
                f"RCM reordering (half-bandwidth <= {MAX_W}); this "
                "circuit does not qualify — use 'band' or 'block'"
            )
        elif method == "band" and band_plan(self.stamps) is None:
            raise ValueError(
                "method='band' requires half-bandwidth <= 384 after RCM "
                "reordering; this circuit does not band — use 'block'"
            )
        elif method == "schur":
            if resistive:
                raise ValueError(
                    "method='schur' requires branch equations (use 'block' "
                    "for purely resistive circuits)"
                )
            if not _schur_supported(self.stamps):
                raise ValueError(
                    "method='schur' requires an SPD resistive node block "
                    "(every node resistively connected, ground included); "
                    "the Cholesky probe failed — use 'dense'"
                )
        elif method == "tridiag" and bandwidth(self.stamps) > 1:
            # Band assembly silently drops out-of-band entries; forcing the
            # method on a wider matrix would return wrong answers.
            raise ValueError(
                f"method='tridiag' requires bandwidth <= 1; this circuit "
                f"has bandwidth {bandwidth(self.stamps)}"
            )
        self.method = method
        from nodal_tpu.ops.pallas_scalar_band import sband_solver

        # The scalar-band kernel where the solve is lowered for a GPU, its
        # lax.scan form elsewhere.
        sband_core = sband_solver(interpret)

        if method == "tridiag":
            if refine:
                solve_batch = _refined_tridiag_solver(self.stamps, dtype)
            else:

                def solve_batch(params_batch, rhs=None):
                    dl, d, du, b = jax.vmap(
                        lambda p: assemble_tridiag(self.stamps, p, dtype=dtype)
                    )(params_batch)
                    if rhs is not None:
                        b = rhs.astype(b.dtype)
                    return tridiag.tridiag_solve(dl, d, du, b)

            # Resistive ⇒ symmetric operator: the adjoint solve is the
            # same solve with the cotangent as RHS.
            solve_rhs_t = solve_batch
        elif method in ("band", "sband"):
            if method == "band":
                from nodal_tpu.ops.band import band_thomas_solve

                plan, core = band_plan(self.stamps), band_thomas_solve
            else:
                plan, core = sband_plan(self.stamps), sband_core

            if refine:
                from nodal_tpu.models.stamps import stamp_values

                stamps = self.stamps

                def solve_batch(params_batch, rhs=None):
                    # f32 banded solves, f64 COO residuals.  The residual
                    # comes straight from the stamp entries (O(B·nnz), the
                    # audit's formulation) rather than a band matvec on f64
                    # band storage, which would hold the band in both f64
                    # and f32.
                    B = params_batch.shape[0]
                    W, b = jax.vmap(
                        lambda p: plan.assemble(stamps, p,
                                                dtype=jnp.float32)
                    )(params_batch.astype(jnp.float32))
                    if rhs is not None:
                        b = plan.rhs_to_band(rhs, jnp.float32)
                    x = core(W, b).astype(jnp.float64)  # [B, n_pad]
                    g_vals, rhs_vals = jax.vmap(
                        lambda p: stamp_values(stamps, p)
                    )(params_batch.astype(jnp.float64))
                    like = jnp.zeros((B, stamps.n), jnp.float64)
                    if rhs is None:
                        b64 = _coo_rhs_vec(stamps, rhs_vals, like)
                    else:
                        b64 = rhs.astype(jnp.float64)
                    for _ in range(2):
                        xn = plan.unpermute(x)  # natural order, [B, n]
                        r = b64 - _coo_apply(stamps, g_vals, xn)
                        dx = core(W, plan.rhs_to_band(r, jnp.float32))
                        x = x + dx.astype(jnp.float64)
                    return plan.unpermute(x)

            else:

                def solve_batch(params_batch, rhs=None):
                    W, b = jax.vmap(
                        lambda p: plan.assemble(self.stamps, p, dtype=dtype)
                    )(params_batch)
                    if rhs is not None:
                        b = plan.rhs_to_band(rhs, W.dtype)
                    return plan.unpermute(core(W, b))

            solve_rhs_t = solve_batch  # symmetric (resistive)

        elif method == "block":

            def single(params):
                return assemble_dense(self.stamps, params, dtype=dtype)

            if refine:
                stamps = self.stamps

                def solve_batch(params_batch, rhs=None):
                    # f32 factorization once, then f64 defect correction
                    # against the exact COO operator (not the assembled
                    # f32-rounded G — that would floor accuracy at ~1e-7).
                    G, b = jax.vmap(
                        lambda p: assemble_dense(stamps, p,
                                                 dtype=jnp.float32)
                    )(params_batch.astype(jnp.float32))
                    if rhs is not None:
                        b = rhs.astype(jnp.float32)
                    blk = block_lu._BLOCK
                    with jax.default_matmul_precision("highest"):
                        Ap, bp, nv = block_lu._pad_to_block(G, b, blk)
                        X = block_lu.blocked_factor(Ap, blk)
                        x = block_lu.blocked_solve_factored(
                            X, bp, blk)[..., :nv]

                        def resolve(r32):
                            rp = jnp.pad(
                                r32, [(0, 0), (0, Ap.shape[-1] - nv)])
                            return block_lu.blocked_solve_factored(
                                X, rp, blk)[..., :nv]

                        return _coo_defect_refine(
                            stamps, params_batch, rhs, x, resolve)

            else:

                def solve_batch(params_batch, rhs=None):
                    G, b = jax.vmap(single)(params_batch)
                    if rhs is not None:
                        b = rhs.astype(b.dtype)
                    return block_lu.blocked_solve(G, b)

            solve_rhs_t = solve_batch  # symmetric (resistive)

        elif method == "schur":
            nk = self.stamps.n_kcl
            kbe = self.stamps.n - nk
            from nodal_tpu.ops.band import band_thomas_solve, node_band_plan
            from nodal_tpu.ops.scalar_band import carry_fits, node_sband_plan

            # refine=True computes in f64 and returns f64, matching the
            # other refined paths' convention.
            sdtype = jnp.float64 if refine else dtype
            nsplan = node_sband_plan(self.stamps)
            nplan = node_band_plan(self.stamps)
            if nsplan is not None and carry_fits(nsplan.w, kbe + 1, sdtype):
                # Narrow-band node block: the scalar LDLᵀ solves
                # A⁻¹[B | bk] with every RHS column riding beside the band
                # — ~n·w² work instead of n·kb².
                assemble = _schur_band_assembler(self.stamps, sdtype, nsplan)
                solve_batch, solve_rhs_t = _make_schur_band_solver(
                    assemble, sband_core, nsplan, nk, kbe)
            elif nplan is not None and nplan.nb >= 2 and nk > 2048:
                # Large bandable node block: the block-Thomas multi-RHS.
                # Dense assembly would materialize an n² matrix per
                # sample — 1.6 GB at nk=20k — so the band tier is the
                # only viable one here; it is also what lets the banded
                # SPD probe lift the old nk ≤ 8192 cap.
                assemble = _schur_band_assembler(self.stamps, sdtype, nplan)
                solve_batch, solve_rhs_t = _make_schur_band_solver(
                    assemble, band_thomas_solve, nplan, nk, kbe)
            else:

                def single(params):
                    return assemble_dense(self.stamps, params, dtype=dtype)

                stamps = self.stamps

                def schur_dense_core(params_batch, rhs=None,
                                     transpose=False):
                    G, b = jax.vmap(single)(params_batch)
                    if transpose:
                        # The node block is symmetric, so Gᵀ keeps the
                        # SPD-A saddle form schur_solve requires.
                        G = jnp.swapaxes(G, 1, 2)
                    if rhs is not None:
                        b = rhs.astype(b.dtype)
                    x = block_lu.schur_solve(G, b, nk)
                    if refine:
                        # f64 defect correction against the exact COO
                        # operator; the extra Schur solves are O(n²) next
                        # to the factorization.
                        st = (_transposed_stamps(stamps) if transpose
                              else stamps)
                        resolve = lambda r32: block_lu.schur_solve(  # noqa
                            G, r32, nk)
                        x = _coo_defect_refine(st, params_batch, rhs, x,
                                               resolve, iters=3)
                    return x

                solve_batch = schur_dense_core
                solve_rhs_t = lambda pb, rhs: schur_dense_core(  # noqa: E731
                    pb, rhs, transpose=True)

        else:
            dense_core = make_dense_core(self.stamps, dtype, refine)
            solve_batch = dense_core
            solve_rhs_t = lambda pb, rhs: dense_core(  # noqa: E731
                pb, rhs, transpose=True)

        self._finalize(solve_batch, solve_rhs_t)

    def _finalize(self, solve_batch, solve_rhs_t):
        """Wrap the method's solver in an implicit-function custom VJP.

        Makes every BatchedSolver differentiable with ``jax.grad`` —
        through the Pallas kernel, which has no autodiff rule of its own.
        See :func:`make_adjoint_solver`.
        """
        # The tier's per-batch (forward, transpose) pair before the
        # contract layer: the sharded solver wraps it in shard_map.
        self.solve_pair = (solve_batch, solve_rhs_t)
        if self._auto_escalate:
            solve_batch = _escalating_solver(self.stamps, solve_batch)
            solve_rhs_t = _escalating_solver(self.stamps, solve_rhs_t,
                                             transpose=True)
        self._solve = jax.jit(
            make_adjoint_solver(self.stamps, solve_batch, solve_rhs_t))

    def __call__(self, params_batch):
        """Solve for a [B, n_components] batch of parameter vectors.

        Returns [B, n_unknowns] solutions (potentials then branch currents).
        """
        params_batch = jnp.asarray(params_batch, dtype=self.dtype)
        if params_batch.ndim != 2:
            raise ValueError(
                f"params_batch must be [B, n_components], got {params_batch.shape}"
            )
        return self._solve(params_batch)

    def residuals(self, params_batch, solutions):
        """Relative residuals ``max|G x - b| / max|b|`` per batch element.

        The tridiag/block fast paths assume diagonal dominance (true for
        positive resistor networks); sweeping parameters to negative or
        wildly disparate values can leave that domain.

        The audit is assembly-free: ``G x`` is evaluated straight from the
        COO stamp entries (``r = b − scatter_add(g_vals · x[cols])``), so
        it costs O(B·nnz) f64 work and memory with NO matrix — dense,
        band, or otherwise — ever built.  (Earlier shapes of this audit
        re-assembled per-method operators, which at B=4096 on a 1k-node
        mesh no longer fit device memory.)  It runs on the host CPU
        backend when one exists, so the audit is independent of the
        accelerator that produced the solutions.
        """
        import contextlib

        from nodal_tpu.circuit import _cpu_device_or_none

        params_batch = np.asarray(params_batch, dtype=np.float64)
        solutions = np.asarray(solutions, dtype=np.float64)
        stamps = self.stamps

        audit = self.__dict__.get("_audit_fn")
        if audit is None:

            @jax.jit
            def audit(pb, xs):
                return _coo_residuals(stamps, pb, xs)

            self._audit_fn = audit

        cpu = _cpu_device_or_none()
        # enable_x64 scope: the audit must be genuinely f64 even when the
        # session never enabled x64 (jnp.asarray would otherwise truncate
        # the inputs to f32 and the audit would inherit the f32 floor).
        with (jax.default_device(cpu) if cpu is not None
              else contextlib.nullcontext()), jax.enable_x64(True):
            return audit(jnp.asarray(params_batch),
                         jnp.asarray(solutions))

    def params_with(self, overrides: dict[str, np.ndarray]):
        """Build a params batch from per-component value arrays.

        ``overrides`` maps component name -> [B] array; all other components
        keep their netlist values.
        """
        arrays = list(overrides.values())
        if not arrays:
            raise ValueError("no overrides given")
        B = len(arrays[0])
        batch = np.tile(self.stamps.params, (B, 1))
        for name, values in overrides.items():
            batch[:, self.stamps.param_slot[name]] = np.asarray(values)
        return batch


class BatchResult:
    """Named access to a batch of solutions ([B, n_unknowns]).

    ``potential(node)`` / ``current(component)`` return [B] arrays, matching
    Solution's scalar accessors (circuit.py) for single solves.
    """

    def __init__(self, solutions, netlist):
        self.solutions = solutions
        self._netlist = netlist

    def potential(self, node: str):
        import jax.numpy as jnp

        if node == self._netlist.ground:
            return jnp.zeros(self.solutions.shape[0], self.solutions.dtype)
        return self.solutions[:, self._netlist.nodenum[node]]

    def current(self, name: str):
        i = self._netlist.nums["kcl"] + self._netlist.anomnum[name]
        return self.solutions[:, i]


def sweep(
    circuit: Circuit,
    component: str,
    values,
    *,
    dtype=jnp.float32,
    refine: bool = False,
    method: str = "auto",
) -> BatchResult:
    """Solve the circuit once per value of one component (all others at
    their netlist values).  The classic 'DC sweep' — one compiled batched
    solve."""
    solver = circuit.batched_solver(dtype=dtype, refine=refine, method=method)
    batch = solver.params_with({component: np.asarray(values)})
    return BatchResult(solver(batch), circuit.netlist)


def monte_carlo(
    circuit: Circuit,
    tolerances: dict[str, float],
    n: int,
    *,
    seed: int = 0,
    dtype=jnp.float32,
    refine: bool | str = "auto",
    return_solutions: bool = False,
    audit: bool | str = True,
):
    """Monte Carlo component-tolerance sweep, fully on device.

    Each named component's value is drawn i.i.d. normal around its netlist
    value with relative standard deviation ``tolerances[name]``.  Sampling,
    the batched solve, and the summary statistics run as ONE device
    program — only the [n_unknowns] mean/std vectors (and, if requested,
    the solution batch) ever cross the host link.  Returns a dict with
    ``mean``, ``std``, and optionally ``solutions``.

    With ``audit=True`` (the default) every sample's solution is verified
    with a COO residual check fused into the device program (one
    scatter-add matvec per sample — results never cross the host link),
    reported as ``max_residual`` plus a logged warning when any sample
    exceeds 1e-3 relative.  This matters because normal draws with a large
    relative ``tolerance`` can produce *negative* component values, leaving
    the diagonal-dominance domain the no-pivot tridiag / block fast paths
    assume — a silent-wrong-answer regime.  The fused check runs at the
    sweep's own precision (~1e-6 floor in f32 — three decades below the
    warn level); pass ``audit="exact"`` for a host-f64
    :meth:`BatchedSolver.residuals` audit of every sample (the exact
    number, at the cost of fetching the whole solution batch).

    ``circuit`` may also be bare :class:`StampTensors` from the native
    parser — its lazy param_slot resolves the tolerance names in C++.
    """
    stamps = _stamps_of(circuit)
    if hasattr(circuit, "batched_solver"):
        solver = circuit.batched_solver(dtype=dtype, refine=refine)
    else:
        solver = BatchedSolver(circuit, dtype=dtype, refine=refine)
    sample_dtype = jnp.dtype(dtype)  # draws match the requested precision
    names = list(tolerances)
    slots = jnp.asarray(
        np.array([stamps.param_slot[m] for m in names])
    )
    sigmas = jnp.asarray(np.array([tolerances[m] for m in names]),
                         dtype=sample_dtype)
    base = jnp.asarray(stamps.params, dtype=sample_dtype)

    # The fused runner is cached on the solver (slots/sigmas are traced
    # arguments), so repeated sweeps with the same sample count reuse the
    # compiled program.
    run = getattr(solver, "_mc_run", None)
    if run is None:
        @functools.partial(jax.jit, static_argnames=("n", "want", "check"))
        def run(key, base, slots, sigmas, n, want, check):
            noise = jax.random.normal(key, (n, slots.shape[0]),
                                      dtype=base.dtype)
            values = base[slots] * (1.0 + sigmas * noise)
            batch = jnp.broadcast_to(base, (n, base.shape[0]))
            batch = batch.at[:, slots].set(values)
            xs = solver._solve(batch)
            mean = jnp.mean(xs, axis=0)
            std = jnp.std(xs, axis=0)
            if check:
                # Audit at the SOLUTION's precision: casting an escalated
                # f64 solution down to f32 manufactures ~cond·eps_f32
                # phantom residuals on ill-conditioned draws.
                if xs.dtype == jnp.float64:
                    res = _coo_residuals(
                        stamps, batch.astype(jnp.float64), xs)
                else:
                    res = _coo_residuals(stamps, batch,
                                         xs.astype(batch.dtype))
                audit_out = (jnp.max(res),
                             jnp.sum(res > _AUDIT_WARN_TOL))
            else:
                audit_out = None
            # The sampled batch is returned alongside the solutions: the
            # exact audit must see the *in-program* f32 params — re-deriving
            # them eagerly can differ by 1 ulp from the jit-fused values,
            # which reads as a ~1e-8 phantom residual against an
            # f64-refined solution.
            return (mean, std, xs if want else None,
                    batch if want else None, audit_out)

        solver._mc_run = run

    exact = audit == "exact"
    mean, std, xs, batch, audit_out = run(
        jax.random.PRNGKey(seed), base, slots, sigmas, n,
        return_solutions or exact, bool(audit) and not exact,
    )
    out = {"mean": mean, "std": std}
    if return_solutions:
        out["solutions"] = xs
    if exact:
        # Opt-in exact tier (round-2 advisor note): the fused default audit
        # runs at sweep precision (~1e-6 floor in f32); audit='exact'
        # recomputes every sample's residual in host f64 via
        # BatchedSolver.residuals — the pre-round-2 behavior — at the cost
        # of fetching the whole solution batch off the device.
        res = np.asarray(solver.residuals(
            np.asarray(batch, np.float64), np.asarray(xs)))
        audit_out = (res.max(), int(np.sum(res > _AUDIT_WARN_TOL)))
    if audit:
        max_residual = float(audit_out[0])
        out["max_residual"] = max_residual
        if not np.isfinite(max_residual) or max_residual > _AUDIT_WARN_TOL:
            import logging

            logging.getLogger(__name__).warning(
                "monte_carlo: %d of %d samples exceed residual %.0e "
                "(worst %.2e) — large tolerances can draw negative "
                "component values outside the fast paths' "
                "diagonal-dominance domain; consider refine=True or a "
                "smaller tolerance",
                int(audit_out[1]), n, _AUDIT_WARN_TOL, max_residual,
            )
    return out


def sensitivities(
    circuit: Circuit,
    *,
    potential: str | None = None,
    current: str | None = None,
    dtype=jnp.float64,
):
    """d(output)/d(component value) for EVERY component, from one solve
    plus one adjoint solve (``jax.grad`` through :class:`BatchedSolver`).

    Pass exactly one of ``potential=<node name>`` (sensitivity of that
    node's voltage) or ``current=<anomalous component name>`` (sensitivity
    of that branch current).  Returns ``{component name: d output / d
    value}`` over all components, in netlist units (V per Ω, V per A,
    ...).  Cost is independent of the component count — the adjoint
    method's defining property; finite differences would need one extra
    solve *per component*.  The reference cannot do this at all
    (numpy/scipy black-box solves, reference nodal.py:325-327).
    """
    netlist = circuit.netlist
    stamps = _stamps_of(circuit)
    if (potential is None) == (current is None):
        raise ValueError(
            "pass exactly one of potential=<node> or current=<component>")
    if potential is not None:
        if potential == netlist.ground:
            return {name: 0.0 for name in stamps.param_slot}
        if potential not in netlist.nodenum:
            raise KeyError(f"unknown node {potential!r}")
        idx = netlist.nodenum[potential]
    else:
        if current not in netlist.anomnum:
            raise KeyError(
                f"{current!r} is not an anomalous component (no branch "
                "current variable)")
        idx = netlist.nums["kcl"] + netlist.anomnum[current]

    # Sparse-constructed circuits route through the bordered-elimination
    # adjoint (host f64, cached factorization): the BatchedSolver methods
    # below would fall to a dense [n, n] assembly on large general
    # circuits — at the 100k-node scale the sparse path exists for, that
    # is an 80 GB non-starter.  Cost: one forward + one transpose solve.
    if getattr(circuit, "sparse", False):
        from nodal_tpu.ops.sparse_schur import (
            general_auto_viable, general_sparse_adjoint_gradient)

        if general_auto_viable(stamps):
            pbar, _x, info_f, info_a = general_sparse_adjoint_gradient(
                stamps, idx)
            if not (bool(info_f.converged) and bool(info_a.converged)):
                raise np.linalg.LinAlgError(
                    "adjoint solve did not converge (residuals "
                    f"{float(info_f.residual):.2e} fwd / "
                    f"{float(info_a.residual):.2e} adj)")
            return {name: float(pbar[slot])
                    for name, slot in stamps.param_slot.items()}

    import contextlib

    # Follow the Circuit's device-placement policy (small systems belong on
    # the host CPU backend) — both the solver's method dispatch and the
    # solve must run under the scope.
    # f64 also needs x64 genuinely on: without it jnp would silently
    # truncate to f32 while this API promises adjoint-accurate numbers.
    scope = (circuit._device_scope() if hasattr(circuit, "_device_scope")
             else contextlib.nullcontext())
    x64_scope = (jax.enable_x64(True)
                 if jnp.dtype(dtype) == jnp.float64
                 else contextlib.nullcontext())
    with scope, x64_scope:
        solver = BatchedSolver(circuit, dtype=dtype)
        p = jnp.asarray(stamps.params, dtype=solver.dtype)[None, :]
        g = np.asarray(
            jax.grad(lambda q: solver._solve(q)[0, idx])(p)[0],
            dtype=np.float64,
        )
    return {name: float(g[slot])
            for name, slot in stamps.param_slot.items()}


#: Relative-residual level above which monte_carlo's audit warns.  An f32
#: fast-path solve of a well-conditioned system lands around 1e-6; crossing
#: 1e-3 means the solver left its assumptions (e.g. negative samples).
_AUDIT_WARN_TOL = 1e-3
