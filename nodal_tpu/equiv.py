"""Two-point equivalent resistance of resistive networks.

Parity target: reference equiv.py:22-61.  Works the same way — inject a 1 A
probe current source between the two nodes, solve, read off the potential
difference — but as a pure function over a rebuilt netlist: no ``deepcopy``,
and the probe source gets a guaranteed-fresh name (the reference hardcodes
``a1`` and silently clobbers an existing component of that name — quirk Q4,
SURVEY.md §2.4).

For large structured grids, prefer :mod:`nodal_tpu.ops.grid`'s matrix-free
path, which never materializes the netlist at all.
"""

from __future__ import annotations

from nodal_tpu.circuit import Circuit
from nodal_tpu.netlist import Netlist


def check_resistive(netlist: Netlist) -> bool:
    """True iff every component in the netlist is a resistor
    (reference equiv.py:22-28)."""
    return all(c.type == "R" for c in netlist.components.values())


def equivalent_resistance(
    netlist: Netlist, a: str, b: str, sparse: bool = False, *, dtype=None
) -> float:
    """Equivalent resistance seen through nodes ``a`` and ``b``.

    Injects a 1 A source from ``a`` to ``b`` and returns ``e(a) - e(b)``
    (reference equiv.py:31-61).

    Raises:
        ValueError: the netlist contains a non-resistor component.
        KeyError: either probe node is absent from the netlist.
    """
    if not check_resistive(netlist):
        raise ValueError("Network is not resistive")
    for node in (a, b):
        if node not in netlist.nodenum and node != netlist.ground:
            raise KeyError(f"Node `{node}` not found in netlist")

    probe = netlist.fresh_name("a1")
    probed = netlist.with_component([probe, "A", "1", a, b])
    solution = Circuit(probed, sparse=sparse, dtype=dtype).solve()

    return _potential_difference(solution, probed, a, b)


def resistance_sensitivities(netlist: Netlist, a: str, b: str):
    """d R_eq(a, b) / d R_k for EVERY resistor, via the adjoint method.

    The classic tolerance-design question — "which resistor's variation
    moves the port resistance most?" — answered with one solve plus one
    adjoint solve total (finite differences would cost one solve per
    resistor; the reference cannot do this at all).  Returns
    ``{resistor name: dR_eq/dR}`` in Ω/Ω.  Same validation surface as
    :func:`equivalent_resistance`.
    """
    import numpy as np

    import jax
    import jax.numpy as jnp

    if not check_resistive(netlist):
        raise ValueError("Network is not resistive")
    for node in (a, b):
        if node not in netlist.nodenum and node != netlist.ground:
            raise KeyError(f"Node `{node}` not found in netlist")

    from nodal_tpu.batch import BatchedSolver

    probe = netlist.fresh_name("a1")
    probed = netlist.with_component([probe, "A", "1", a, b])
    circuit = Circuit(probed)

    def row(node):
        return None if node == probed.ground else probed.nodenum[node]

    ia, ib = row(a), row(b)
    with circuit._device_scope(), jax.enable_x64(True):
        solver = BatchedSolver(circuit, dtype=jnp.float64)
        p = jnp.asarray(circuit.stamps.params)[None, :]

        def r_eq(q):
            x = solver._solve(q)[0]
            va = x[ia] if ia is not None else 0.0
            vb = x[ib] if ib is not None else 0.0
            return va - vb  # 1 A probe ⇒ potential difference = R_eq

        g = np.asarray(jax.grad(r_eq)(p)[0], dtype=np.float64)
    slot = circuit.stamps.param_slot
    return {name: float(g[slot[name]])
            for name, comp in probed.components.items()
            if comp.type == "R"}


#: Largest unbanded circuit the multi-probe path will solve densely; a
#: single [n, n] f64 factorization is 2 GB at this bound.  Bigger
#: circuits without a band plan take the per-pair preconditioned-CG path.
_DENSE_MANY_MAX_N = 16384


def _equiv_many_skyline(netlist, stamps, rows_a, rows_b):
    """All probe pairs through the native skyline LDLᵀ tier: ONE host
    factorization + k backsolves, no XLA compile, f64 throughout.
    Returns the resistances, or None to fall through (tier disabled,
    profile over caps, non-SPD pivot).  Shares ops.sparse's value-keyed
    factor cache, so a CLI solve followed by probes reuses the factor.
    """
    import os

    import numpy as np

    if os.environ.get("NODAL_TPU_NO_SKYLINE", "0") == "1":
        return None
    from nodal_tpu.models.stamps import stamp_values_np
    from nodal_tpu.ops import skyline
    from nodal_tpu.ops.sparse import _topology

    if not skyline.available() or stamps.n == 0:
        return None
    topo = _topology(stamps)
    plan = getattr(stamps, "_spd_skyline_plan", "missing")
    if plan == "missing":
        plan = skyline.plan_skyline(stamps.n, topo.rows, topo.cols)
        stamps._spd_skyline_plan = plan  # type: ignore[attr-defined]
    if plan is None:
        return None
    g_vals, _ = stamp_values_np(stamps,
                                np.asarray(stamps.params, np.float64))
    cache = getattr(stamps, "_spd_skyline_fact", None)
    key = g_vals.tobytes()
    if cache is not None and cache[0] == key:
        fact = cache[1]
    else:
        fact = skyline.factor(plan, stamps.g_rows, stamps.g_cols, g_vals)
        stamps._spd_skyline_fact = (key, fact)  # type: ignore[attr-defined]
    if fact is None:
        return None

    k = len(rows_a)
    n = stamps.n
    R = np.zeros((k, n))
    idx = np.arange(k)
    sel = rows_a >= 0
    R[idx[sel], rows_a[sel]] += 1.0
    sel = rows_b >= 0
    R[idx[sel], rows_b[sel]] -= 1.0
    X = skyline.solve(fact, R)

    # Residual + forward-amplification gate via one csr matmul (an
    # np.add.at formulation measured ~10 s for 64 probes at 40k nodes —
    # fancy-index scatter is the slow path; csr @ dense is milliseconds).
    import scipy.sparse as sp

    gr = stamps.g_rows.astype(np.int64)
    gc = stamps.g_cols.astype(np.int64)
    nnz = len(gr)
    A = sp.csr_matrix((g_vals, (gr, gc)), shape=(n, n))
    with np.errstate(invalid="ignore"):
        rmax = float(np.max(np.abs((A @ X.T).T - R))) if k else 0.0
    g_max = float(np.max(np.abs(g_vals))) if nnz else 0.0
    x_max = float(np.max(np.abs(X))) if X.size else 0.0
    scale = max(1.0, g_max * x_max)
    rmax /= scale
    eps = float(np.finfo(np.float64).eps)
    # Same two-level gate as the dense/banded paths below: backward-error
    # plus a forward-amplification tripwire for finite-garbage solves of
    # exactly-singular systems.
    if (not np.isfinite(rmax) or rmax > 1e-6
            or not np.isfinite(X).all() or scale > 0.01 / eps):
        from numpy.linalg import LinAlgError

        from nodal_tpu.netlist import UnconnectedCircuitError, is_connected

        if not is_connected(netlist):
            raise UnconnectedCircuitError
        if not np.isfinite(rmax) or rmax > 1e-6 \
                or not np.isfinite(X).all():
            raise LinAlgError("Singular matrix")
    ea = np.where(rows_a >= 0, X[idx, np.maximum(rows_a, 0)], 0.0)
    eb = np.where(rows_b >= 0, X[idx, np.maximum(rows_b, 0)], 0.0)
    return ea - eb


def equivalent_resistance_many(netlist: Netlist, pairs, *, dtype=None):
    """Equivalent resistance for many probe pairs of one netlist at once.

    ``pairs`` is a sequence of ``(a, b)`` node-label pairs; returns a
    float64 numpy array of the same length.  The conductance matrix is
    factored ONCE and every pair rides a multi-RHS solve — banded circuits
    use the block-Thomas factorization (ops.band), others a dense
    factorization — so k pairs cost roughly one solve plus k cheap
    back-substitutions instead of k full solves.  The reference has no
    multi-probe path at all (its equiv.py re-deep-copies and re-solves the
    whole netlist per probe, reference equiv.py:31-61).

    Raises like :func:`equivalent_resistance` (ValueError on non-resistive
    netlists, KeyError on unknown probe nodes, UnconnectedCircuitError /
    LinAlgError on singular systems — the solves are residual-gated like
    Circuit.solve, so a floating netlist cannot return silent NaNs).
    """
    import contextlib

    import jax
    import jax.numpy as jnp
    import numpy as np

    from nodal_tpu.circuit import _cpu_device_or_none
    from nodal_tpu.models.stamps import compile_stamps

    if not check_resistive(netlist):
        raise ValueError("Network is not resistive")
    pairs = list(pairs)
    for a, b in pairs:
        for node in (a, b):
            if node not in netlist.nodenum and node != netlist.ground:
                raise KeyError(f"Node `{node}` not found in netlist")
    if not pairs:
        return np.zeros(0)
    stamps = compile_stamps(netlist)
    n = stamps.n
    if dtype is None:
        dtype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32

    def row(node):
        return -1 if node == netlist.ground else netlist.nodenum[node]

    rows_a = np.array([row(a) for a, _ in pairs], dtype=np.int64)
    rows_b = np.array([row(b) for _, b in pairs], dtype=np.int64)

    # Native direct tier first (round 5): one skyline factorization + k
    # backsolves, pure host numpy — placed BEFORE the jax device scope so
    # a resistive probe sweep never even initializes a backend.
    sky = _equiv_many_skyline(netlist, stamps, rows_a, rows_b)
    if sky is not None:
        return sky

    cpu = _cpu_device_or_none()
    scope = (jax.default_device(cpu) if cpu is not None
             else contextlib.nullcontext())
    with scope:
        from nodal_tpu.ops.band import (band_matvec, band_plan,
                                        band_thomas_solve)

        plan = band_plan(stamps)
        k = len(pairs)
        if plan is not None and plan.nb >= 2:
            # Banded: one block-Thomas factorization, k RHS lanes.  Probe
            # rows must be permuted into band order.
            R = np.zeros((plan.n_pad, k))
            rank = plan.rank
            for j, (ra, rb) in enumerate(zip(rows_a, rows_b)):
                if ra >= 0:
                    R[rank[ra], j] += 1.0
                if rb >= 0:
                    R[rank[rb], j] -= 1.0
            W, _ = plan.assemble(stamps, stamps.params, dtype=jnp.dtype(dtype))
            Xp = band_thomas_solve(W, jnp.asarray(R, dtype))
            # residual gate (no-pivot solve of a singular system returns
            # garbage, not an exception)
            resid = band_matvec(W, Xp.T).T - jnp.asarray(R, dtype)
            scale = jnp.maximum(
                1.0, jnp.max(jnp.abs(W)) * jnp.max(jnp.abs(Xp))
            )
            X = plan.unpermute(Xp, rows_axis=-2)
        elif n > _DENSE_MANY_MAX_N:
            # No band plan at a size where a dense [n, n] factorization
            # cannot be materialized (2 GB f64 already at n=16384): solve
            # each probe pair with the preconditioned-CG stamps path
            # instead of silently attempting the dense tier.
            out = np.empty(k)
            for j, (ra, rb) in enumerate(zip(rows_a, rows_b)):
                try:
                    out[j] = equivalent_resistance_stamps(
                        stamps, int(ra), int(rb), dtype=dtype)
                except RuntimeError as exc:
                    from numpy.linalg import LinAlgError

                    from nodal_tpu.netlist import (UnconnectedCircuitError,
                                                   is_connected)

                    if not is_connected(netlist):
                        raise UnconnectedCircuitError from exc
                    raise LinAlgError(str(exc)) from exc
            return out
        else:
            from nodal_tpu.ops.assemble import assemble_dense

            R = np.zeros((n, k))
            for j, (ra, rb) in enumerate(zip(rows_a, rows_b)):
                if ra >= 0:
                    R[ra, j] += 1.0
                if rb >= 0:
                    R[rb, j] -= 1.0
            G, _ = assemble_dense(stamps, stamps.params,
                                  dtype=jnp.dtype(dtype))
            X = jnp.linalg.solve(G, jnp.asarray(R, dtype))
            resid = G @ X - jnp.asarray(R, dtype)
            scale = jnp.maximum(
                1.0, jnp.max(jnp.abs(G)) * jnp.max(jnp.abs(X))
            )
        Xn = np.asarray(X, dtype=np.float64)
        # Scale-relative gate (round-2 advisor finding): a raw absolute
        # residual misfires on badly scaled netlists — huge resistances
        # inflate ||X|| and trip the tol spuriously, tiny ones could let a
        # bad solve pass.  Normalize by max(1, ||W||_max * ||X||_max).
        rmax = float(jnp.max(jnp.abs(resid)) / scale)
        amplification = float(scale)
    tol = 1e-6 if jnp.dtype(dtype) == jnp.float64 else 3e-2
    # Forward-amplification tripwire alongside the backward-error gate: a
    # no-pivot solve of an exactly-singular system (floating probe
    # component whose elimination pivot rounds to tiny-nonzero) returns a
    # FINITE garbage X of size ~1/(eps·||W||) — tiny backward error, so
    # the normalized gate alone would pass it silently.  Huge ||W||·||X||
    # only triggers the (interpreter-cost) connectivity diagnosis; a
    # connected netlist with a genuinely enormous R_eq passes through.
    eps = float(jnp.finfo(jnp.dtype(dtype)).eps)
    suspicious = (not np.isfinite(rmax) or rmax > tol
                  or not np.isfinite(Xn).all()
                  or amplification > 0.01 / eps)
    if suspicious:
        from numpy.linalg import LinAlgError

        from nodal_tpu.netlist import UnconnectedCircuitError, is_connected

        if not is_connected(netlist):
            raise UnconnectedCircuitError
        if not np.isfinite(rmax) or rmax > tol or not np.isfinite(Xn).all():
            raise LinAlgError("Singular matrix")
    ea = np.where(rows_a >= 0, Xn[np.maximum(rows_a, 0), np.arange(k)], 0.0)
    eb = np.where(rows_b >= 0, Xn[np.maximum(rows_b, 0), np.arange(k)], 0.0)
    return ea - eb


def equivalent_resistance_stamps(stamps, row_a: int, row_b: int, *,
                                 dtype=None, tol: float = 1e-9) -> float:
    """Equivalent resistance directly from compiled stamp tensors.

    ``row_a``/``row_b`` are MNA row indices of the probe nodes (-1 for the
    ground/reference node).  Injects the unit probe current straight into
    the RHS vector — no netlist mutation, no re-parse — and solves the SPD
    resistive system with preconditioned CG.  This is the path the
    ``nodal-resistance`` CLI takes for large netlists via the native parser
    (nodal_tpu.utils.native).
    """
    import jax
    import jax.numpy as jnp

    from nodal_tpu.ops.sparse import solve_sparse_system

    if stamps.n != stamps.n_kcl:
        raise ValueError("Network is not resistive")
    if dtype is None:
        dtype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32

    # One-shot CLI economics: below ~256k unknowns, host-CPU CG is
    # expected to beat the accelerator's compile latency (a rule not yet
    # re-measured on the GPU).  Library users doing repeated solves can
    # pass dtype/device explicitly.
    import contextlib

    cpu = None
    if stamps.n <= 262_144 and jax.default_backend() != "cpu":
        try:
            cpu = jax.devices("cpu")[0]
        except RuntimeError:  # pragma: no cover
            cpu = None
    scope = jax.default_device(cpu) if cpu is not None else contextlib.nullcontext()
    with scope:
        return _equivalent_resistance_stamps_impl(stamps, row_a, row_b,
                                                  dtype, tol)


def _equivalent_resistance_stamps_impl(stamps, row_a, row_b, dtype, tol):
    import jax.numpy as jnp

    from nodal_tpu.ops.sparse import solve_sparse_system

    rhs = jnp.zeros(stamps.n, dtype=dtype)
    if row_a >= 0:
        rhs = rhs.at[row_a].add(1.0)
    if row_b >= 0:
        rhs = rhs.at[row_b].add(-1.0)

    x, info = solve_sparse_system(stamps, stamps.params, dtype=dtype,
                                  tol=tol, rhs=rhs)
    if not bool(info.converged):
        raise RuntimeError(
            f"CG did not converge (residual {float(info.residual):.2e})"
        )
    ea = float(x[row_a]) if row_a >= 0 else 0.0
    eb = float(x[row_b]) if row_b >= 0 else 0.0
    return ea - eb


def _potential_difference(solution, probed, a, b):

    # Ground is the 0 V reference; the literal label "g" is special-cased to
    # 0 exactly as the reference does (equiv.py:55-61) even when a different
    # node was elected ground.
    def potential(node: str) -> float:
        if node == "g":
            return 0.0
        if node == probed.ground:
            return 0.0
        return float(solution.result[probed.nodenum[node]])

    return potential(a) - potential(b)
