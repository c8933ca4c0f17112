"""Scalable general sparse MNA: bordered block elimination over AMG-CG.

The reference hands ANY sparse MNA system — voltage sources, controlled
sources, opamp macromodels — to SuperLU (reference nodal.py:325) and gets a
robust direct solve at any size that fits memory (0.79 s at 40k nodes,
SURVEY.md §6).  A JAX framework cannot call SuperLU; plain Krylov
(BiCGStab + Jacobi) on the full indefinite MNA system stalls on exactly the
circuits that matter (branch equations put zeros on the diagonal).  This
module is the structural answer — a *direct* method whose only iterative
piece is CG on an SPD matrix, where multigrid is reliable.

Structure: MNA orders unknowns [node potentials | branch currents], and only
resistor stamps produce node-node entries, so the node block of G is the
grounded resistor Laplacian.  Partition the unknowns into

* **K1** — nodes with a resistive path to ground.  The K1×K1 block A11 is
  SPD: every connected component of the K1-induced resistor subgraph
  contains a node with a resistor edge to ground, which shows up as diagonal
  excess of the Laplacian.
* **border** — everything else: nodes held only by sources, plus every
  branch-current row.  Typically tiny next to n (one row per E/VCVS/VCCS/
  CCVS/CCCS plus the rare non-resistively-grounded node).

No resistor edge crosses the partition (a node with a resistor into K1
would itself be resistively grounded), so A12/A21 carry only source
couplings::

    [A11 A12] [x1]   [b1]        S = A22 - A21 A11^-1 A12
    [A21 A22] [x2] = [b2]        (m x m, dense, pivoted f64)

Solve: AMG-preconditioned CG on A11 for the m+1 right-hand sides
[A12 | b1], a pivoted dense f64 factorization of the Schur complement S,
back-substitution, then full-system f64-residual refinement that *reuses*
both factorizations (each pass costs one CG solve + one dense
back-substitution).

Backends: when the session has an accelerator, the CG solves run on it in
f32 (the framework's standard fast-tier precision) and the outer
defect correction against the exact host-f64 COO residual restores
direct-solver accuracy, contracting by ~cg_tol per pass.  The host CPU
f64 tier remains as the exact fallback (CPU-only sessions; circuits whose
conditioning defeats the f32 CG).  All CG programs take the operator and
the whole AMG hierarchy as ARGUMENTS, not closure constants — embedded
large constants made XLA constant-fold 40k-row scatters at compile time
and cost ~18 s of compiles per topology (round-3); as arguments the
buffers are device-resident across dispatches and the programs are
data-independent.
"""

from __future__ import annotations

import contextlib
import functools
import logging
import os
from dataclasses import dataclass

import numpy as np

import jax
import jax.numpy as jnp

from nodal_tpu.models.stamps import StampTensors, stamp_values_np
from typing import NamedTuple

from nodal_tpu.ops.cg import cg

logger = logging.getLogger(__name__)


class GeneralSolveInfo(NamedTuple):
    """Host-side SolveInfo analogue (numpy scalars — see solve notes) with
    a solver label; field-compatible with ops.cg.SolveInfo consumers."""

    residual: np.float64
    iterations: np.int64
    converged: np.bool_
    method: str = "schur"

#: Border sizes beyond this make the dense Schur complement (m² f64) and the
#: m+1 CG right-hand sides unreasonable — such circuits are "mostly branch
#: equations" and fall back to BiCGStab / dense paths.
_BORDER_CAP = 4096

#: Extended border cap for the NATIVE skyline tier only (round-5: the last
#: strict capability gap vs SuperLU was a >4096-controlled-source border).
#: m direct backsolves for YB plus one m² dense LU are a few seconds of
#: host BLAS up to ~16k border rows; the CG tiers keep the tight cap —
#: m Krylov solves at that scale is exactly the stall the cap prevents.
_BORDER_CAP_NATIVE = int(os.environ.get(
    "NODAL_TPU_BORDER_CAP_NATIVE", "16384"))

#: Cap on the dense A11^-1·A12 block (n1 × m f64): 8 GB.
_YB_BYTES_CAP = 8 << 30

#: RHS columns solved per vmapped-CG launch (bounds peak CG workspace).
_RHS_CHUNK = 32


@dataclass
class GeneralPlan:
    """Host-side partition + index plan for one netlist topology.

    Built once per StampTensors (structure only — values fold in per
    parameter vector) and cached on the stamps object.
    """

    n: int
    n1: int  # |K1|
    m: int   # border size
    k1: np.ndarray       # int64[n1] original MNA rows of K1, ascending
    border: np.ndarray   # int64[m] original MNA rows of the border
    pos: np.ndarray      # int64[n]: position within its block (K1 or border)
    in_k1: np.ndarray    # bool[n]
    # Deduplicated A11 COO in K1-local numbering, row-sorted.
    a11_rows: np.ndarray
    a11_cols: np.ndarray
    a11_slot_of_entry: np.ndarray  # slot for each selected stamp entry
    a11_sel: np.ndarray            # stamp-entry indices landing in A11
    # Off-diagonal / border entry selections (raw stamp entries, not deduped
    # — np.add.at folds duplicates when the blocks are materialized).
    a12_sel: np.ndarray
    a21_sel: np.ndarray
    a22_sel: np.ndarray

    @property
    def viable(self) -> bool:
        return (
            self.m <= _BORDER_CAP
            and self.n1 * max(self.m, 1) * 8 <= _YB_BYTES_CAP
        )


def resistively_grounded_nodes(stamps: StampTensors) -> np.ndarray:
    """Boolean mask over the ``n_kcl`` node rows: True where the node has a
    resistive path to ground.

    Only resistor stamps create node-node entries (source couplings go to
    branch rows/columns — see models/stamps.py), so the node block is the
    grounded resistor Laplacian: a node's row sum over that block equals its
    total conductance to ground.  Connected components of the off-diagonal
    graph whose total row-sum excess is positive are grounded.  Component
    labeling runs through scipy.sparse.csgraph (C speed — a Python edge
    loop here would cost seconds at 1M edges); cached on the stamps object.
    """
    import scipy.sparse as sp
    from scipy.sparse.csgraph import connected_components

    cached = getattr(stamps, "_grounded_mask", None)
    if cached is not None:
        return cached
    nk = stamps.n_kcl
    mask = (stamps.g_rows < nk) & (stamps.g_cols < nk)
    rows = stamps.g_rows[mask].astype(np.int64)
    cols = stamps.g_cols[mask].astype(np.int64)
    vals, _ = stamp_values_np(stamps, stamps.params)
    vals = vals[mask]

    off = rows != cols
    adj = sp.csr_matrix(
        (np.ones(int(off.sum())), (rows[off], cols[off])), shape=(nk, nk)
    )
    _, roots = connected_components(adj, directed=False)
    # Row-sum excess per component = conductance to ground.  Scale-relative
    # threshold: a component is grounded when its excess is more than
    # rounding noise relative to its own diagonal mass.
    excess = np.zeros(nk)
    np.add.at(excess, roots[rows], vals)
    diag_mass = np.zeros(nk)
    np.add.at(diag_mass, roots[rows[~off]], np.abs(vals[~off]))
    grounded_root = excess > 1e-12 * np.maximum(diag_mass, 1e-300)
    out = grounded_root[roots]
    stamps._grounded_mask = out  # type: ignore[attr-defined]
    return out


def _k1_node_mask(stamps: StampTensors) -> np.ndarray:
    """Node rows whose A11 sub-block is guaranteed SPD.

    Nodes in resistively-grounded components all qualify.  A component of
    the resistor graph *without* a ground path (e.g. a mesh held only by
    voltage sources — extremely common: any circuit driven purely by E
    sources) has a singular Laplacian block, but deleting any single
    vertex of a connected component makes the remaining principal
    submatrix SPD — so one representative node per ungrounded component
    moves to the border and the rest stay in K1.  Nodes with no resistor
    entries at all are their own ungrounded singleton components and land
    in the border as their own representatives.
    """
    import scipy.sparse as sp
    from scipy.sparse.csgraph import connected_components

    nk = stamps.n_kcl
    mask = (stamps.g_rows < nk) & (stamps.g_cols < nk)
    rows = stamps.g_rows[mask].astype(np.int64)
    cols = stamps.g_cols[mask].astype(np.int64)
    vals, _ = stamp_values_np(stamps, stamps.params)
    vals = vals[mask]
    off = rows != cols
    adj = sp.csr_matrix(
        (np.ones(int(off.sum())), (rows[off], cols[off])), shape=(nk, nk)
    )
    ncomp, labels = connected_components(adj, directed=False)
    excess = np.zeros(ncomp)
    np.add.at(excess, labels[rows], vals)
    diag_mass = np.zeros(ncomp)
    np.add.at(diag_mass, labels[rows[~off]], np.abs(vals[~off]))
    grounded_comp = excess > 1e-12 * np.maximum(diag_mass, 1e-300)
    # Representative (first node) of each component; a node with no
    # resistor entries forms a singleton component and is its own rep.
    has_entries = np.zeros(nk, dtype=bool)
    has_entries[rows] = True
    _, rep = np.unique(labels, return_index=True)
    k1 = grounded_comp[labels] & has_entries
    ungrounded_rep = rep[~grounded_comp]
    promote = ~grounded_comp[labels] & has_entries
    promote[ungrounded_rep] = False
    k1 |= promote
    return k1


def general_plan(stamps: StampTensors) -> GeneralPlan:
    """Cached partition plan (see module docstring) for one topology."""
    cached = getattr(stamps, "_general_plan", None)
    if cached is not None:
        return cached
    n, nk = stamps.n, stamps.n_kcl
    in_k1 = np.zeros(n, dtype=bool)
    in_k1[:nk] = _k1_node_mask(stamps)
    k1 = np.nonzero(in_k1)[0]
    border = np.nonzero(~in_k1)[0]
    pos = np.empty(n, dtype=np.int64)
    pos[k1] = np.arange(len(k1))
    pos[border] = np.arange(len(border))

    gr = stamps.g_rows.astype(np.int64)
    gc = stamps.g_cols.astype(np.int64)
    rk = in_k1[gr]
    ck = in_k1[gc]
    a11_sel = np.nonzero(rk & ck)[0]
    a12_sel = np.nonzero(rk & ~ck)[0]
    a21_sel = np.nonzero(~rk & ck)[0]
    a22_sel = np.nonzero(~rk & ~ck)[0]

    n1 = len(k1)
    r11 = pos[gr[a11_sel]]
    c11 = pos[gc[a11_sel]]
    key = r11 * max(n1, 1) + c11
    uniq, inverse = np.unique(key, return_inverse=True)
    plan = GeneralPlan(
        n=n, n1=n1, m=len(border),
        k1=k1, border=border, pos=pos, in_k1=in_k1,
        a11_rows=(uniq // max(n1, 1)).astype(np.int32),
        a11_cols=(uniq % max(n1, 1)).astype(np.int32),
        a11_slot_of_entry=inverse.astype(np.int64),
        a11_sel=a11_sel,
        a12_sel=a12_sel, a21_sel=a21_sel, a22_sel=a22_sel,
    )
    stamps._general_plan = plan  # type: ignore[attr-defined]
    return plan


def _cpu_scope():
    try:
        cpu = jax.devices("cpu")[0]
    except RuntimeError:  # pragma: no cover - no CPU backend registered
        return contextlib.nullcontext()
    return jax.default_device(cpu)


def _skyline_plan_of(stamps: StampTensors, plan: GeneralPlan):
    """Cached pattern plan for the native skyline direct tier, or None
    when the RCM profile of A11 blows the memory/FLOP caps (irregular
    graphs) — topology-level, shared across parameter values."""
    sentinel = getattr(stamps, "_skyline_plan", "missing")
    if sentinel != "missing":
        return sentinel
    from nodal_tpu.ops import skyline

    splan = None
    if skyline.available() and plan.n1 > 0:
        splan = skyline.plan_skyline(plan.n1, plan.a11_rows, plan.a11_cols)
    stamps._skyline_plan = splan  # type: ignore[attr-defined]
    return splan


def _native_viable(stamps: StampTensors, plan: GeneralPlan) -> bool:
    """Is the native skyline tier worth attempting?  Pattern feasibility
    plus a not-previously-failed flag (pivot failures mark the value
    fingerprint so repeated solves don't retry a non-SPD block)."""
    if os.environ.get("NODAL_TPU_NO_SKYLINE", "0") == "1":
        return False
    return _skyline_plan_of(stamps, plan) is not None


def _plan_viable(stamps: StampTensors, plan: GeneralPlan) -> bool:
    """Can ANY tier serve this partition?  The CG tiers keep the tight
    ``_BORDER_CAP``; the native skyline tier extends it to
    ``_BORDER_CAP_NATIVE`` (m direct backsolves + one m² dense LU are
    host-BLAS work, not a Krylov stall)."""
    if plan.viable:
        return True
    return (
        plan.m <= _BORDER_CAP_NATIVE
        and plan.n1 * max(plan.m, 1) * 8 <= _YB_BYTES_CAP
        and _native_viable(stamps, plan)
    )


def _lu_solve64(lu, piv, rhs, trans=0):
    """lu_solve at the LU's own precision (an f32 LU must not be silently
    promoted — getrs on a casted-to-f64 copy costs an m² memcpy per
    solve), result upcast to f64 for the defect correction."""
    import scipy.linalg as sla

    out = sla.lu_solve((lu, piv), np.asarray(rhs, dtype=lu.dtype),
                       trans=trans)
    return out.astype(np.float64, copy=False)


def _value_blocks(stamps: StampTensors, plan: GeneralPlan, g_vals):
    """Numeric blocks of the partition for one value vector: deduped A11
    values, the dense A22 block, and the A21/A12 couplings as
    block-local triplets ``(rows, cols, vals)``."""
    gr = stamps.g_rows.astype(np.int64)
    gc = stamps.g_cols.astype(np.int64)
    a11_vals = np.zeros(len(plan.a11_rows))
    np.add.at(a11_vals, plan.a11_slot_of_entry, g_vals[plan.a11_sel])
    m = plan.m
    A22 = np.zeros((m, m))
    np.add.at(
        A22,
        (plan.pos[gr[plan.a22_sel]], plan.pos[gc[plan.a22_sel]]),
        g_vals[plan.a22_sel],
    )
    a21 = (plan.pos[gr[plan.a21_sel]], plan.pos[gc[plan.a21_sel]],
           g_vals[plan.a21_sel])
    a12 = (plan.pos[gr[plan.a12_sel]], plan.pos[gc[plan.a12_sel]],
           g_vals[plan.a12_sel])
    return a11_vals, A22, a21, a12


#: Border size above which the Schur complement may factor in f32 with
#: f64 defect correction (a stalled refinement promotes the LU back to
#: f64 once, reusing the cached YB/S blocks).  Disabled by default: on
#: this host's OpenBLAS, sgetrf measured NO faster than dgetrf at
#: m=8192 (19.0 s vs 17.8 s), so f32 only spends accuracy.  Set the env
#: var on machines whose BLAS actually doubles f32 GEMM throughput.
_SCHUR_F32_MIN_M = int(os.environ.get(
    "NODAL_TPU_SCHUR_F32_MIN_M", str(1 << 40)))


def _factorization(stamps: StampTensors, plan: GeneralPlan, g_vals,
                   cg_tol: float, backend: str = "cpu",
                   schur_f64: bool = False):
    """b-independent block factorization at ``cg_tol``: ``((solve_cols,
    YB, lu, piv), iters)``, or ``(None, iters)`` when CG stalled building
    YB.

    Cached on the stamps object keyed by (stamp-values digest, tol,
    backend): YB = A11⁻¹A12 is m CG solves — the dominant cost — while
    each *solve* with the factorization needs only one CG pass for its own
    RHS, so repeat solves on the same parameter values (the reference's
    SuperLU refactors every time) drop from ~m+1 CG solves to
    ~1 + refinement.  The same factorization serves the TRANSPOSED system
    (adjoint solves): A11 is symmetric, so only the Schur border needs
    ``trans=1``.
    """
    import hashlib

    import scipy.linalg as sla

    key = (hashlib.sha1(g_vals.tobytes()).hexdigest(), float(cg_tol),
           backend)
    cache = getattr(stamps, "_general_fact", None)
    if cache is not None and cache.get("key") == key:
        fact = cache["lus"].get(bool(schur_f64))
        if fact is not None:
            return fact, 0
        # Blocks (solve_cols, YB, S) are LU-precision-independent: a
        # schur_f64 promotion after a missed f32 attempt refactors ONLY
        # the m² Schur complement, not the m A11 solves behind YB.
        solve_cols, YBT, S = cache["blocks"]
        lu, piv = _schur_lu(S, plan.m, schur_f64)
        fact = (solve_cols, YBT, lu, piv)
        cache["lus"][bool(schur_f64)] = fact
        return fact, 0

    a11_vals, A22, a21, a12 = _value_blocks(stamps, plan, g_vals)
    a21_r, a21_c, a21_v = a21
    n1, m = plan.n1, plan.m
    iters = 0

    if n1 > 0:
        solve_cols = _a11_solver(stamps, plan, a11_vals, cg_tol, backend)
        R = np.zeros((m, n1))
        np.add.at(R, (a12[1], a12[0]), a12[2])
        # YBT is stored TRANSPOSED ([n1, m] C-contiguous): every consumer
        # wants it that way — the Schur build A21 @ YBT rides scipy's
        # contiguous fast path and the back-substitution x1 = y_b − YBT
        # @ x2 is a row-major GEMV.  Assembly ORDER matters at m=8192
        # (2.6 GB): fill natural-order [m, n1] rows contiguously, then
        # one 256-column-blocked transpose (~2 s).  The alternatives
        # both measured ~20 s+: np.ascontiguousarray of the whole
        # transpose (element-wise strided walk, 46 s) and writing
        # 32-wide transposed chunks straight into YBT's column slices
        # (millions of scattered 256-byte writes across the row pitch).
        YB = np.empty((m, n1))
        ok = True
        for lo in range(0, m, _RHS_CHUNK):
            hi = min(lo + _RHS_CHUNK, m)
            # Pass host numpy: solve_cols device_puts its inputs onto its
            # own backend's device (accel tier: f32 on the chip; cpu
            # tier: f64 on the host).  A jnp.asarray here would place the
            # batch on the session default device and could drag a CPU
            # tier's vmapped f64 CG onto the accelerator.
            xs, infos = solve_cols(R[lo:hi])
            YB[lo:hi] = np.asarray(xs)
            iters += int(np.sum(np.asarray(infos.iterations)))
            ok = ok and bool(np.all(np.asarray(infos.converged)))
        if not ok or not np.all(np.isfinite(YB)):
            logger.error(
                "AMG-CG stalled on the grounded node block (n1=%d)", n1
            )
            return None, iters
        YBT = np.empty((n1, m))
        for i0 in range(0, m, 256):
            YBT[:, i0:i0 + 256] = YB[i0:i0 + 256].T
        del YB

        # S = A22 - A21 Y_Bᵀ.  Sparse A21 (csr) times the dense YBᵀ: at
        # m=8192 the old broadcast form (a21_v[:,None] * YB[:,a21_c].T +
        # add.at) materialized a [nnz, m] f64 intermediate and took 39 s;
        # the csr matmul does the same 1e8 MACs in well under a second.
        if len(a21_v):
            import scipy.sparse as _sp

            A21 = _sp.csr_matrix((a21_v, (a21_r, a21_c)),
                                 shape=(m, plan.n1))
            S = A22 - A21 @ YBT
        else:
            S = A22.copy()
    else:
        solve_cols = None
        YBT = np.zeros((0, m))
        S = A22

    lu, piv = _schur_lu(S, m, schur_f64)
    fact = (solve_cols, YBT, lu, piv)
    stamps._general_fact = {  # type: ignore[attr-defined]
        "key": key,
        "blocks": (solve_cols, YBT, S),
        "lus": {bool(schur_f64): fact},
    }
    return fact, iters


def _schur_lu(S, m: int, schur_f64: bool):
    """Pivoted dense factorization of the Schur complement.  A singular S
    raises LinAlgError here — the same surface as the reference dense
    path (numpy.linalg.solve at reference nodal.py:327).  Extended-cap
    borders factor in f32 unless ``schur_f64`` promotes them."""
    import warnings

    import scipy.linalg as sla

    if m == 0:
        return None, None
    f32_lu = m >= _SCHUR_F32_MIN_M and not schur_f64
    with warnings.catch_warnings():
        # A zero pivot (structurally singular circuit) produces
        # inf/nan back-substitutions that the residual gate below
        # catches and surfaces as LinAlgError through the caller's
        # diagnosis — scipy's LinAlgWarning here is just noise.
        warnings.simplefilter("ignore", sla.LinAlgWarning)
        lu, piv = sla.lu_factor(S.astype(np.float32) if f32_lu else S)
        if f32_lu and not np.all(np.isfinite(lu)):
            # f32 overflow/underflow, not necessarily singular —
            # retry at full precision before declaring failure.
            lu, piv = sla.lu_factor(S)
    if not np.all(np.isfinite(lu)):
        raise np.linalg.LinAlgError("Singular matrix")
    return lu, piv


def solve_general_sparse(
    stamps: StampTensors,
    params=None,
    *,
    rhs=None,
    tol: float = 1e-9,
    setup_tol: float = 1e-4,
    refine_passes: int = 14,
):
    """Direct-quality f64 solve of a general sparse MNA system.

    Args:
        stamps: compiled stamp tensors (any structure — branch equations,
            source-held nodes, opamp macromodels).
        params: component parameter vector (defaults to netlist values).
        rhs: optional override of the netlist's source vector (length n).
        tol: target relative residual ``max|Gx-b| / max|b|`` of the final,
            audited full-system solution.
        setup_tol: CG tolerance for *building* the factorization (the m+1
            ``A11⁻¹[A12 | b1]`` solves).  Deliberately loose: defect
            correction against the exact f64 residual contracts by roughly
            ``setup_tol`` per pass while each pass costs only ONE cheap CG
            solve — so a sloppy-but-cheap factorization plus 2-3 refinement
            passes beats solving all m+1 columns to ``tol`` outright
            (measured at 100k nodes / m=49: 786 CG iterations → ~300).
            If refinement stalls (contraction worse than 0.3/pass), the
            factorization is rebuilt once at ``tol`` — the exact path.
        refine_passes: refinement-pass cap per attempt.

    Returns ``(x, GeneralSolveInfo)`` with ``x`` float64 numpy.
    ``info.converged`` is False when CG stalled or refinement could not
    reach ``tol``; callers keep their usual singularity diagnosis (a
    structurally singular Schur complement raises
    ``numpy.linalg.LinAlgError`` directly, matching the reference's
    dense-path surface).
    """
    import scipy.linalg as sla

    plan = general_plan(stamps)
    if not _plan_viable(stamps, plan):
        raise ValueError(
            f"border too large for bordered elimination "
            f"(m={plan.m}, n1={plan.n1}); use an iterative path"
        )
    if params is None:
        params = stamps.params
    params = np.asarray(params, dtype=np.float64)
    g_vals, rhs_vals = stamp_values_np(stamps, params)

    b = np.zeros(stamps.n)
    np.add.at(b, stamps.rhs_rows, rhs_vals)
    if rhs is not None:
        b = np.asarray(rhs, dtype=np.float64)
    b1 = b[plan.k1]
    b2 = b[plan.border]

    n1, m = plan.n1, plan.m
    gr = stamps.g_rows.astype(np.int64)
    gc = stamps.g_cols.astype(np.int64)
    _, _, (a21_r, a21_c, a21_v), _ = _value_blocks(stamps, plan, g_vals)

    b_scale = max(float(np.max(np.abs(b))) if stamps.n else 0.0, 1.0)
    total_iters = 0

    def full_residual(x):
        y = np.zeros(stamps.n)
        with np.errstate(invalid="ignore"):  # singular systems carry NaNs
            np.add.at(y, gr, g_vals * x[gc])
        return b - y

    def attempt(cg_tol, backend="cpu", schur_f64=False):
        """Solve with the (cached) factorization at ``cg_tol`` and refine.
        Returns ``(x, rel, stalled)``; ``x`` is None when CG stalled."""
        nonlocal total_iters
        fact, f_iters = _factorization(stamps, plan, g_vals, cg_tol,
                                       backend, schur_f64)
        total_iters += f_iters
        if fact is None:
            return None, np.inf, False
        solve_cols, YBT, lu, piv = fact
        if n1 > 0:
            y_bs, info = solve_cols(b1[None])
            total_iters += int(np.asarray(info.iterations)[0])
            y_b = np.asarray(y_bs)[0]  # A11^-1 b1
            if not bool(np.asarray(info.converged)[0]) or \
                    not np.all(np.isfinite(y_b)):
                logger.error(
                    "AMG-CG stalled on the grounded node block (n1=%d)", n1
                )
                return None, np.inf, False
            rhs_s = b2.copy()
            if len(a21_v):
                np.subtract.at(rhs_s, a21_r, a21_v * y_b[a21_c])
        else:
            y_b = np.zeros(0)
            rhs_s = b2

        def back_substitute(r1, r2):
            """One solve with the (approximate) block factorization."""
            nonlocal total_iters
            if n1:
                w1s, info = solve_cols(r1[None])
                total_iters += int(np.asarray(info.iterations)[0])
                if not bool(np.asarray(info.converged)[0]):
                    return None, None
                w1 = np.asarray(w1s)[0]
            else:
                w1 = np.zeros(0)
            rs = np.asarray(r2, dtype=np.float64).copy()
            if len(a21_v):
                np.subtract.at(rs, a21_r, a21_v * w1[a21_c])
            dx2 = _lu_solve64(lu, piv, rs) if m else np.zeros(0)
            dx1 = w1 - YBT @ dx2 if n1 else np.zeros(0)
            return dx1, dx2

        with np.errstate(invalid="ignore"):  # zero pivots -> NaNs, gated
            x2 = _lu_solve64(lu, piv, rhs_s) if m else np.zeros(0)
            x1 = y_b - YBT @ x2 if n1 else np.zeros(0)
        x = np.empty(stamps.n)
        x[plan.k1] = x1
        x[plan.border] = x2

        # Defect correction against the exact f64 residual, reusing both
        # factorizations: each pass is one cheap CG solve + one dense
        # back-substitution and contracts rel by ~cg_tol.
        rel = np.inf
        for _ in range(max(refine_passes, 1)):
            r = full_residual(x)
            rel_new = float(np.max(np.abs(r))) / b_scale
            if rel_new <= tol or not np.isfinite(rel_new):
                return x, rel_new, False
            if rel_new > 0.3 * rel:  # stalled: factorization too sloppy
                return x, rel_new, True
            rel = rel_new
            dx1, dx2 = back_substitute(r[plan.k1], r[plan.border])
            if dx1 is None:
                return x, rel, True
            x[plan.k1] += dx1
            x[plan.border] += dx2
        r = full_residual(x)
        return x, float(np.max(np.abs(r))) / b_scale, True

    cg_tol = min(max(setup_tol, tol), 1e-3)
    # Backend chain (round-5 order): native skyline LDLᵀ first — exact
    # f64 direct solves with no compile latency and no iteration, the
    # SuperLU-role tier (cpp/skyline.cpp) — whenever A11's RCM profile is
    # affordable; then the accelerator (f32 CG + exact-f64 outer
    # defect correction) — the m+1 YB/b1 solves are the batched work the
    # chip is for; then the host f64 AMG-CG path as the exact fallback.
    method = "schur"
    x, rel = None, np.inf
    if _native_viable(stamps, plan):
        from nodal_tpu.ops.skyline import SkylineUnavailable

        try:
            x, rel, _stalled = attempt(tol, "native")
            if (x is not None and np.isfinite(rel) and rel > tol
                    and plan.m >= _SCHUR_F32_MIN_M):
                # The f32 Schur LU could not carry refinement to tol
                # (ill-conditioned border): promote it to f64 once.
                xp, relp, _ = attempt(tol, "native", schur_f64=True)
                if xp is not None and relp < rel:
                    x, rel = xp, relp
        except SkylineUnavailable as e:
            logger.info("skyline tier unavailable (%s); falling back", e)
        if x is not None and np.isfinite(rel) and rel <= tol:
            method = "schur-skyline"
    if (x is None or not (np.isfinite(rel) and rel <= tol)) \
            and plan.m > _BORDER_CAP:
        # Extended-cap borders are native-tier-only: m Krylov solves at
        # this scale is exactly the stall the tight cap prevents.
        raise ValueError(
            f"border too large for the iterative tiers (m={plan.m}, cap "
            f"{_BORDER_CAP}) and the native direct tier could not serve it"
        )
    if (x is None or not (np.isfinite(rel) and rel <= tol)) \
            and _try_accel(stamps, g_vals):
        xa, rela, _stalled = attempt(max(cg_tol, _ACCEL_CG_TOL_FLOOR),
                                     "accel")
        if xa is not None and (x is None or rela < rel
                               or not np.isfinite(rel)):
            x, rel = xa, rela
        if xa is not None and np.isfinite(rela) and rela <= tol:
            method = "schur-accel"
        else:
            _mark_accel_failed(stamps, g_vals)
            logger.info(
                "bordered elimination: accelerator tier reached %.2e "
                "(target %.0e); rebuilding on the host f64 path", rel, tol,
            )
    if x is None or not (np.isfinite(rel) and rel <= tol):
        x2_, rel2, stalled = attempt(cg_tol)
        if x2_ is not None and (x is None or rel2 < rel
                                or not np.isfinite(rel)):
            x, rel = x2_, rel2
        if x2_ is not None and stalled and rel > tol and cg_tol > tol * 10:
            # Sloppy factorization could not carry refinement to tol —
            # rebuild at the target tolerance (the exact path).
            logger.info(
                "bordered elimination: refinement stalled at %.2e with "
                "setup_tol=%.0e; rebuilding at %.0e", rel, cg_tol, tol,
            )
            x2_, rel2, _ = attempt(tol)
            if x2_ is not None and (rel2 < rel or not np.isfinite(rel)):
                x, rel = x2_, rel2
    if x is None:
        return np.full(stamps.n, np.nan), GeneralSolveInfo(
            residual=np.float64(np.inf),
            iterations=np.int64(total_iters),
            converged=np.bool_(False),
            method="schur",
        )

    return x, GeneralSolveInfo(
        residual=np.float64(rel),
        iterations=np.int64(total_iters),
        converged=np.bool_(bool(np.isfinite(rel) and rel <= tol)),
        method=method,
    )


def _outer_defect_loop(x, residual_fn, scale, tol, converged,
                       solve_reduced_fn):
    """Shared outer defect-correction loop for :func:`solve_general_auto`
    and its transpose (round-4 advisor: the two ~30-line twins had to be
    kept in sync by hand).

    ``solve_reduced_fn(r) -> (dx | None, iters)`` solves the reduced
    system for a full-system residual ``r`` and lifts it back.  The loop
    drives the residual toward the f64 floor while contraction is strong,
    but exits as soon as the delivered residual is inside the ``10·tol``
    acceptance bound and a pass contracted by less than 10× — for
    right-hand sides with scale ≈ 1 the inner solve's own tolerance is
    the achievable floor, and chasing further only burns passes (round-4
    advisor item #1).

    Returns ``(x, rel, extra_iters)``.
    """
    r = residual_fn(x)
    rel = float(np.max(np.abs(r))) / scale
    floor = min(tol, 1e-13)
    iters = 0
    passes = 0
    while np.isfinite(rel) and rel > floor and passes < 4 and converged:
        dx, it = solve_reduced_fn(r)
        iters += it
        if dx is None:
            break
        x_new = x + dx
        r_new = residual_fn(x_new)
        rel_new = float(np.max(np.abs(r_new))) / scale
        passes += 1
        if not np.isfinite(rel_new) or rel_new >= rel:
            break  # no improvement — keep x; roundoff floor reached
        weak = rel_new >= 0.1 * rel
        stalled = rel_new >= 0.5 * rel
        x, r, rel = x_new, r_new, rel_new
        if rel <= 10 * tol and weak:
            break  # inside the acceptance bound and converging slowly
        if stalled:
            break  # improvement but no real contraction
    return x, rel, iters


def solve_general_auto(
    stamps: StampTensors,
    params=None,
    *,
    rhs=None,
    tol: float = 1e-9,
    setup_tol: float = 1e-4,
):
    """Structure-routed general sparse solve: ideal-voltage-constraint
    reduction first (:mod:`nodal_tpu.ops.reduce_e`), bordered elimination
    on the (possibly reduced) system.

    This is the SuperLU-robustness entry point (reference nodal.py:325):
    it handles any border population the reference can —
    "mostly-branch-equation" circuits (tens of thousands of E sources)
    reduce to supernodes before the Schur border is formed, so the border
    cap only bites on circuits with >4096 *controlled* sources, which
    raise a clear ValueError instead of stalling in a Krylov fallback.

    Returns ``(x, GeneralSolveInfo)`` with ``x`` float64 over the ORIGINAL
    unknown ordering.  Raises ``numpy.linalg.LinAlgError`` for structural
    singularities (E-cycles, singular Schur complement).
    """
    import os

    from nodal_tpu.ops import reduce_e

    if params is None:
        params = stamps.params
    params = np.asarray(params, dtype=np.float64)

    red = None
    if os.environ.get("NODAL_TPU_NO_EREDUCE", "0") != "1":
        red = reduce_e.e_reduction_or_none(stamps)
    if red is None:
        plan = general_plan(stamps)
        if not _plan_viable(stamps, plan):
            raise ValueError(
                f"bordered elimination cannot serve this circuit: "
                f"{plan.m} border rows (cap {_BORDER_CAP}) and no "
                f"eliminable ideal sources — the border is controlled "
                f"sources/ungrounded-island representatives; split the "
                f"sweep or ground the islands resistively"
            )
        return solve_general_sparse(stamps, params, rhs=rhs, tol=tol,
                                    setup_tol=setup_tol)

    g_vals, rhs_vals = stamp_values_np(stamps, params)
    b_full = np.zeros(stamps.n)
    np.add.at(b_full, stamps.rhs_rows, rhs_vals)
    if rhs is not None:
        b_full = np.asarray(rhs, dtype=np.float64)
    q = reduce_e.offsets(red, stamps, params)
    b_red = reduce_e.reduced_rhs(red, stamps, g_vals, b_full, q)

    if red.n_red == 0:
        # Pure ideal-source circuit: every potential is a q offset and
        # every current comes from tree peeling.
        x_red = np.zeros(0)
        info = GeneralSolveInfo(
            residual=np.float64(0.0), iterations=np.int64(0),
            converged=np.bool_(True), method="ereduce",
        )
    else:
        plan_red = general_plan(red.stamps_red)
        if not _plan_viable(red.stamps_red, plan_red):
            raise ValueError(
                f"bordered elimination cannot serve this circuit even "
                f"after ideal-source reduction: {plan_red.m} border rows "
                f"remain (cap {_BORDER_CAP}) — controlled sources/"
                f"ungrounded islands; split the sweep or ground the "
                f"islands resistively"
            )
        x_red, info = solve_general_sparse(
            red.stamps_red, params, rhs=b_red, tol=tol,
            setup_tol=setup_tol,
        )
        if not np.all(np.isfinite(x_red)):
            return np.full(stamps.n, np.nan), info

    x = reduce_e.expand_solution(red, stamps, x_red, g_vals, b_full, q)

    # Audit on the ORIGINAL system.  The reduction and recovery are exact
    # in exact arithmetic, but the inner solve's residual (targeted at
    # ``tol`` relative to the REDUCED right-hand side) is amplified by the
    # lift — group-sum row splitting and tree-peeled current recovery
    # spread one reduced-row defect over several original rows (measured
    # ~350x on the 40k-node bench circuit: inner 1e-9 → full 3.5e-7).
    gr = stamps.g_rows.astype(np.int64)
    gc = stamps.g_cols.astype(np.int64)
    b_scale = max(float(np.max(np.abs(b_full))) if stamps.n else 0.0, 1.0)

    def full_residual(xv):
        y = np.zeros(stamps.n)
        with np.errstate(invalid="ignore"):
            np.add.at(y, gr, g_vals * xv[gc])
        return b_full - y

    total_iters = int(info.iterations)

    # Outer defect correction through the SAME reduction + cached
    # factorization: solve ``G dx = r`` (branch-row offsets come from r
    # itself), lift, add.  Each pass contracts the full-system residual
    # by ~the inner solve's accuracy; the shared loop drives toward the
    # f64 floor while contraction is strong (when the right-hand-side
    # scale is ≈1 the inner tolerance itself is the achievable floor and
    # the loop exits inside the 10·tol acceptance bound instead).
    def solve_reduced(r):
        V_r = (r[red.n_kcl + red.tree_edge] if len(red.tree_edge)
               else np.zeros(0))
        q0 = reduce_e.offsets_from_branch_values(red, V_r)
        r_red = reduce_e.reduced_rhs(red, stamps, g_vals, r, q0)
        if red.n_red:
            dx_red, dinfo = solve_general_sparse(
                red.stamps_red, params, rhs=r_red, tol=tol,
                setup_tol=setup_tol,
            )
            if not (bool(dinfo.converged)
                    and np.all(np.isfinite(dx_red))):
                return None, int(dinfo.iterations)
            it = int(dinfo.iterations)
        else:
            dx_red, it = np.zeros(0), 0
        return (reduce_e.expand_solution(red, stamps, dx_red, g_vals, r,
                                         q0), it)

    x, rel, extra = _outer_defect_loop(
        x, full_residual, b_scale, tol, bool(info.converged),
        solve_reduced)
    total_iters += extra

    ok = np.isfinite(rel) and rel <= 10 * tol and bool(info.converged)
    return x, GeneralSolveInfo(
        residual=np.float64(rel),
        iterations=np.int64(total_iters),
        converged=np.bool_(bool(ok)),
        method=f"ereduce+{info.method}" if red.n_red else "ereduce",
    )


def solve_general_sparse_transpose(
    stamps: StampTensors,
    params=None,
    *,
    rhs,
    tol: float = 1e-9,
    setup_tol: float = 1e-4,
    refine_passes: int = 14,
):
    """f64 solve of the TRANSPOSED general sparse system ``Gᵀ y = rhs``.

    This is the adjoint-method workhorse at scale: the bordered
    factorization from :func:`solve_general_sparse` is reused verbatim
    (and shared through the same cache) because A11 is symmetric — the
    node block of G is the grounded resistor Laplacian, so
    A11⁻ᵀ = A11⁻¹ — and the Schur complement of Gᵀ is exactly Sᵀ:

        Gᵀ = [A11  A21ᵀ]      Schur(Gᵀ) = A22ᵀ − A12ᵀ A11⁻¹ A21ᵀ = Sᵀ.
             [A12ᵀ A22ᵀ]

    One transpose solve therefore costs two CG passes on A11 (w₁ = A11⁻¹
    rhs₁ and the back-substitution) plus one ``trans=1`` dense
    back-substitution on the cached Schur LU — no new factorization work.
    Refinement runs against the exact f64 COO residual of Gᵀ.

    Returns ``(y, GeneralSolveInfo)`` like the forward solve.
    """
    import scipy.linalg as sla

    plan = general_plan(stamps)
    if not _plan_viable(stamps, plan):
        raise ValueError(
            f"border too large for bordered elimination "
            f"(m={plan.m}, n1={plan.n1}); use an iterative path"
        )
    if params is None:
        params = stamps.params
    params = np.asarray(params, dtype=np.float64)
    g_vals, _ = stamp_values_np(stamps, params)

    c = np.asarray(rhs, dtype=np.float64)
    c1 = c[plan.k1]
    c2 = c[plan.border]

    n1, m = plan.n1, plan.m
    gr = stamps.g_rows.astype(np.int64)
    gc = stamps.g_cols.astype(np.int64)
    (_, _, (a21_r, a21_c, a21_v),
     (a12_r, a12_c, a12_v)) = _value_blocks(stamps, plan, g_vals)

    c_scale = max(float(np.max(np.abs(c))) if stamps.n else 0.0, 1.0)
    total_iters = 0

    def full_residual_t(y):
        z = np.zeros(stamps.n)
        with np.errstate(invalid="ignore"):
            np.add.at(z, gc, g_vals * y[gr])  # Gᵀ y
        return c - z

    def attempt(cg_tol, backend="cpu", schur_f64=False):
        nonlocal total_iters
        fact, f_iters = _factorization(stamps, plan, g_vals, cg_tol,
                                       backend, schur_f64)
        total_iters += f_iters
        if fact is None:
            return None, np.inf, False
        solve_cols, _YBT, lu, piv = fact

        def solve_a11(r):
            """One CG pass A11⁻¹ r, or None on stall."""
            nonlocal total_iters
            ws, info = solve_cols(r[None])
            total_iters += int(np.asarray(info.iterations)[0])
            w = np.asarray(ws)[0]
            if not bool(np.asarray(info.converged)[0]) or \
                    not np.all(np.isfinite(w)):
                logger.error(
                    "AMG-CG stalled on the grounded node block (n1=%d)", n1
                )
                return None
            return w

        def back_substitute_t(r1, r2):
            """One Gᵀ solve with the block factorization: eliminate y1 =
            A11⁻¹(r1 − A21ᵀ y2), Schur system Sᵀ y2 = r2 − A12ᵀ A11⁻¹ r1."""
            if n1:
                w1 = solve_a11(r1)
                if w1 is None:
                    return None, None
            else:
                w1 = np.zeros(0)
            rs = np.asarray(r2, dtype=np.float64).copy()
            if len(a12_v):
                np.subtract.at(rs, a12_c, a12_v * w1[a12_r])
            with np.errstate(invalid="ignore"):
                y2 = (_lu_solve64(lu, piv, rs, trans=1)
                      if m else np.zeros(0))
            if n1:
                t = np.zeros(n1)
                if len(a21_v):
                    np.add.at(t, a21_c, a21_v * y2[a21_r])
                # y1 = A11⁻¹(r1 − A21ᵀ y2) = w1 − A11⁻¹ A21ᵀ y2
                w2 = solve_a11(t) if len(a21_v) else np.zeros(n1)
                if w2 is None:
                    return None, None
                y1 = w1 - w2
            else:
                y1 = np.zeros(0)
            return y1, y2

        y1, y2 = back_substitute_t(c1, c2)
        if y1 is None:
            return None, np.inf, False
        y = np.empty(stamps.n)
        y[plan.k1] = y1
        y[plan.border] = y2

        rel = np.inf
        for _ in range(max(refine_passes, 1)):
            r = full_residual_t(y)
            rel_new = float(np.max(np.abs(r))) / c_scale
            if rel_new <= tol or not np.isfinite(rel_new):
                return y, rel_new, False
            if rel_new > 0.3 * rel:  # stalled: factorization too sloppy
                return y, rel_new, True
            rel = rel_new
            dy1, dy2 = back_substitute_t(r[plan.k1], r[plan.border])
            if dy1 is None:
                return y, rel, True
            y[plan.k1] += dy1
            y[plan.border] += dy2
        r = full_residual_t(y)
        return y, float(np.max(np.abs(r))) / c_scale, True

    cg_tol = min(max(setup_tol, tol), 1e-3)
    # Same backend chain as the forward solve (native skyline first —
    # A11 is symmetric so the direct factorization is shared verbatim —
    # then accelerator f32, then host f64 AMG-CG).
    method = "schur-T"
    y, rel = None, np.inf
    if _native_viable(stamps, plan):
        from nodal_tpu.ops.skyline import SkylineUnavailable

        try:
            y, rel, _stalled = attempt(tol, "native")
            if (y is not None and np.isfinite(rel) and rel > tol
                    and plan.m >= _SCHUR_F32_MIN_M):
                yp, relp, _ = attempt(tol, "native", schur_f64=True)
                if yp is not None and relp < rel:
                    y, rel = yp, relp
        except SkylineUnavailable as e:
            logger.info("skyline tier unavailable (%s); falling back", e)
        if y is not None and np.isfinite(rel) and rel <= tol:
            method = "schur-T-skyline"
    if (y is None or not (np.isfinite(rel) and rel <= tol)) \
            and plan.m > _BORDER_CAP:
        raise ValueError(
            f"border too large for the iterative tiers (m={plan.m}, cap "
            f"{_BORDER_CAP}) and the native direct tier could not serve it"
        )
    if (y is None or not (np.isfinite(rel) and rel <= tol)) \
            and _try_accel(stamps, g_vals):
        ya, rela, _stalled = attempt(max(cg_tol, _ACCEL_CG_TOL_FLOOR),
                                     "accel")
        if ya is not None and (y is None or rela < rel
                               or not np.isfinite(rel)):
            y, rel = ya, rela
        if ya is not None and np.isfinite(rela) and rela <= tol:
            method = "schur-T-accel"
        else:
            _mark_accel_failed(stamps, g_vals)
            logger.info(
                "bordered elimination (transpose): accelerator tier "
                "reached %.2e (target %.0e); rebuilding on the host f64 "
                "path", rel, tol,
            )
    if y is None or not (np.isfinite(rel) and rel <= tol):
        y2_, rel2, stalled = attempt(cg_tol)
        if y2_ is not None and (y is None or rel2 < rel
                                or not np.isfinite(rel)):
            y, rel = y2_, rel2
        if y2_ is not None and stalled and rel > tol and cg_tol > tol * 10:
            logger.info(
                "bordered elimination (transpose): refinement stalled at "
                "%.2e with setup_tol=%.0e; rebuilding at %.0e",
                rel, cg_tol, tol,
            )
            y2_, rel2, _ = attempt(tol)
            if y2_ is not None and (rel2 < rel or not np.isfinite(rel)):
                y, rel = y2_, rel2
    if y is None:
        return np.full(stamps.n, np.nan), GeneralSolveInfo(
            residual=np.float64(np.inf),
            iterations=np.int64(total_iters),
            converged=np.bool_(False),
            method="schur-T",
        )
    return y, GeneralSolveInfo(
        residual=np.float64(rel),
        iterations=np.int64(total_iters),
        converged=np.bool_(bool(np.isfinite(rel) and rel <= tol)),
        method=method,
    )


def general_auto_viable(stamps: StampTensors) -> bool:
    """Can :func:`solve_general_auto` serve this circuit?  Viability of
    the bordered elimination AFTER ideal-source reduction (raises
    LinAlgError on a structural E-cycle, which is singular regardless)."""
    import os

    from nodal_tpu.ops import reduce_e

    target = stamps
    if os.environ.get("NODAL_TPU_NO_EREDUCE", "0") != "1":
        red = reduce_e.e_reduction_or_none(stamps)
        if red is not None:
            if red.n_red == 0:
                return True
            target = red.stamps_red
    return _plan_viable(target, general_plan(target))


def solve_general_auto_transpose(
    stamps: StampTensors,
    params=None,
    *,
    rhs,
    tol: float = 1e-9,
    setup_tol: float = 1e-4,
):
    """Transpose counterpart of :func:`solve_general_auto`: ``Gᵀ y = rhs``
    with the same ideal-source reduction.

    ``(L G R)ᵀ = Rᵀ Gᵀ Lᵀ``, so the reduced transpose system is exactly
    the reduced forward matrix transposed — the adjoint shares the
    forward's cached factorization.  The eliminated sources' adjoint
    pieces mirror the forward's: their current *columns* become tree
    constraints on the adjoint node-row values (offsets ``p``), and their
    branch-row adjoints are recovered by peeling the same tree against the
    grouped node columns' transpose equations (see ops/reduce_e.py).
    """
    import os

    from nodal_tpu.ops import reduce_e

    if params is None:
        params = stamps.params
    params = np.asarray(params, dtype=np.float64)

    red = None
    if os.environ.get("NODAL_TPU_NO_EREDUCE", "0") != "1":
        red = reduce_e.e_reduction_or_none(stamps)
    if red is None:
        plan = general_plan(stamps)
        if not _plan_viable(stamps, plan):
            raise ValueError(
                f"bordered elimination cannot serve this circuit: "
                f"{plan.m} border rows (cap {_BORDER_CAP}) and no "
                f"eliminable ideal sources"
            )
        return solve_general_sparse_transpose(stamps, params, rhs=rhs,
                                              tol=tol, setup_tol=setup_tol)

    g_vals, _ = stamp_values_np(stamps, params)
    c_full = np.asarray(rhs, dtype=np.float64)
    p = reduce_e.offsets_transpose(red, c_full)
    c_red = reduce_e.reduced_rhs_transpose(red, stamps, g_vals, c_full, p)

    if red.n_red == 0:
        y_red = np.zeros(0)
        info = GeneralSolveInfo(
            residual=np.float64(0.0), iterations=np.int64(0),
            converged=np.bool_(True), method="ereduce-T",
        )
    else:
        plan_red = general_plan(red.stamps_red)
        if not _plan_viable(red.stamps_red, plan_red):
            raise ValueError(
                f"bordered elimination cannot serve this circuit even "
                f"after ideal-source reduction: {plan_red.m} border rows "
                f"remain (cap {_BORDER_CAP})"
            )
        y_red, info = solve_general_sparse_transpose(
            red.stamps_red, params, rhs=c_red, tol=tol,
            setup_tol=setup_tol,
        )
        if not np.all(np.isfinite(y_red)):
            return np.full(stamps.n, np.nan), info

    y = reduce_e.expand_solution_transpose(red, stamps, y_red, g_vals,
                                           c_full, p)

    gr = stamps.g_rows.astype(np.int64)
    gc = stamps.g_cols.astype(np.int64)
    c_scale = max(float(np.max(np.abs(c_full))) if stamps.n else 0.0, 1.0)

    def full_residual_t(yv):
        z = np.zeros(stamps.n)
        with np.errstate(invalid="ignore"):
            np.add.at(z, gc, g_vals * yv[gr])
        return c_full - z

    total_iters = int(info.iterations)

    # Outer defect correction — the transpose mirror of the forward loop,
    # through the SAME shared helper (round-4 advisor item #2).
    def solve_reduced_t(r):
        p0 = reduce_e.offsets_transpose(red, r)
        r_red = reduce_e.reduced_rhs_transpose(red, stamps, g_vals, r, p0)
        if red.n_red:
            dy_red, dinfo = solve_general_sparse_transpose(
                red.stamps_red, params, rhs=r_red, tol=tol,
                setup_tol=setup_tol,
            )
            if not (bool(dinfo.converged)
                    and np.all(np.isfinite(dy_red))):
                return None, int(dinfo.iterations)
            it = int(dinfo.iterations)
        else:
            dy_red, it = np.zeros(0), 0
        return (reduce_e.expand_solution_transpose(red, stamps, dy_red,
                                                   g_vals, r, p0), it)

    y, rel, extra = _outer_defect_loop(
        y, full_residual_t, c_scale, tol, bool(info.converged),
        solve_reduced_t)
    total_iters += extra

    ok = np.isfinite(rel) and rel <= 10 * tol and bool(info.converged)
    return y, GeneralSolveInfo(
        residual=np.float64(rel),
        iterations=np.int64(total_iters),
        converged=np.bool_(bool(ok)),
        method=f"ereduce+{info.method}" if red.n_red else "ereduce-T",
    )


def general_sparse_adjoint_gradient(
    stamps: StampTensors,
    out_index: int,
    params=None,
    *,
    tol: float = 1e-9,
):
    """d x[out_index] / d(every component value) via the adjoint method,
    entirely host-side — the at-scale (100k+ node) counterpart of
    :func:`nodal_tpu.batch.sensitivities`.

    Cost: one forward solve + one transpose solve (both reuse the cached
    bordered factorization — on a warm cache this is two CG passes) + the
    COO chain rule; independent of the component count.  Returns
    ``(pbar [n_components] float64, x, info_forward, info_adjoint)``.
    """
    from nodal_tpu.models.stamps import _INV, _LIN

    if params is None:
        params = stamps.params
    params = np.asarray(params, dtype=np.float64)

    x, info_f = solve_general_auto(stamps, params, tol=tol)
    e = np.zeros(stamps.n)
    e[out_index] = 1.0
    lam, info_a = solve_general_auto_transpose(stamps, params, rhs=e,
                                               tol=tol)

    # x̄ = λᵀ(∂b/∂p − ∂G/∂p·x): per-entry cotangents, then the product-
    # rule pullback of stamp values v = coeff · f(p₁,e₁) · f(p₂,e₂) with
    # f = p, 1/p, or 1 (numpy mirror of stamp_values' jax VJP).
    gbar = -(lam[stamps.g_rows.astype(np.int64)]
             * x[stamps.g_cols.astype(np.int64)])
    rhsbar = lam[stamps.rhs_rows.astype(np.int64)]

    def fac(pidx, exp):
        v = params[pidx]
        return np.where(exp == _LIN, v, np.where(exp == _INV, 1.0 / v, 1.0))

    def dfac(pidx, exp):
        v = params[pidx]
        with np.errstate(divide="ignore"):
            d = np.where(exp == _INV, -1.0 / (v * v), 0.0)
        return np.where(exp == _LIN, 1.0, d)

    pbar = np.zeros_like(params)
    for pidx1, exp1, pidx2, exp2, coeff, bar in (
        (stamps.g_p1, stamps.g_e1, stamps.g_p2, stamps.g_e2,
         stamps.g_coeff, gbar),
        (stamps.rhs_p1, stamps.rhs_e1, stamps.rhs_p2, stamps.rhs_e2,
         stamps.rhs_coeff, rhsbar),
    ):
        f1 = fac(pidx1, exp1)
        f2 = fac(pidx2, exp2)
        np.add.at(pbar, pidx1, bar * coeff * dfac(pidx1, exp1) * f2)
        np.add.at(pbar, pidx2, bar * coeff * f1 * dfac(pidx2, exp2))
    return pbar, x, info_f, info_a


#: f32 CG cannot meaningfully converge below ~1e-6 relative residual; the
#: accelerator tier floors its CG tolerance here and leaves the rest to
#: the outer f64 defect correction (which contracts by ~cg_tol per pass).
_ACCEL_CG_TOL_FLOOR = 1e-5

#: Iteration cap for the accelerator (f32) CG tier: AMG-CG on these SPD
#: blocks converges in tens of iterations; a plateau past this means the
#: f32 tier cannot serve this system and the CPU f64 path takes over.
_ACCEL_MAXITER = 400

#: Node-block size below which the accelerator tier is not worth waking:
#: host f64 AMG-CG solves these in well under a second, while the
#: accelerator costs device transfers + (first time) a program compile —
#: the small-system policy Circuit._device_scope applies to dense solves,
#: replicated here for the bordered elimination.
_ACCEL_MIN_N1 = int(os.environ.get("NODAL_TPU_SPARSE_ACCEL_MIN_N", "20000"))


@functools.partial(
    jax.jit, static_argnames=("meta", "tol", "maxiter"))
def _multi_cg_program(B, ibuf, fbuf, *, meta, tol, maxiter):
    """One compiled program: vmapped AMG-preconditioned CG over RHS columns.

    The operator and the whole AMG hierarchy arrive as TWO packed traced
    arguments (``pack_hierarchy``), not closure constants: embedded large
    constants make XLA constant-fold 40k-row scatters at compile time
    (multi-second folds per program at 40k nodes), and each
    ``device_put`` leaf is one host-to-device transfer — two packed buffers
    cost two where the hierarchy pytree costs 29.  The A11 operator IS the
    hierarchy's level-0 matrix, so no separate COO triple is passed.
    """
    from nodal_tpu.ops.amg import make_vcycle, unpack_hierarchy

    arrays, vmeta = unpack_hierarchy(ibuf, fbuf, meta)
    M = make_vcycle(arrays, vmeta)
    lv0 = arrays[0]
    n1 = meta[0][0]

    def mv(x):
        return jax.ops.segment_sum(
            lv0["vals"] * x[lv0["cols"]], lv0["rows"], num_segments=n1,
            indices_are_sorted=True,
        )

    def one(bcol):
        return cg(mv, bcol, preconditioner=M, tol=tol, maxiter=maxiter)

    return jax.vmap(one)(B)


def _accel_device_or_none():
    """The non-CPU default-backend device, or None (CPU-only session or
    ``NODAL_TPU_SPARSE_ACCEL=0``)."""
    import os

    if os.environ.get("NODAL_TPU_SPARSE_ACCEL", "1") == "0":
        return None
    try:
        dev = jax.devices()[0]
    except RuntimeError:  # pragma: no cover - no backend at all
        return None
    return dev if dev.platform != "cpu" else None


def _try_accel(stamps: StampTensors, g_vals) -> bool:
    """Should this solve try the accelerator tier?  False when the node
    block is too small to amortize device transfers/compiles, when no
    accelerator exists, or when the tier already failed for these exact
    values (warm solves must not re-pay a doomed f32 factorization)."""
    plan = general_plan(stamps)
    if plan.n1 < _ACCEL_MIN_N1:
        return False
    if _accel_device_or_none() is None:
        return False
    import hashlib

    digest = hashlib.sha1(g_vals.tobytes()).hexdigest()
    return getattr(stamps, "_accel_schur_failed", None) != digest


def _mark_accel_failed(stamps: StampTensors, g_vals) -> None:
    import hashlib

    stamps._accel_schur_failed = (  # type: ignore[attr-defined]
        hashlib.sha1(g_vals.tobytes()).hexdigest())


def _a11_solver(stamps: StampTensors, plan: GeneralPlan, a11_vals, tol,
                backend: str = "cpu"):
    """Compiled vmapped AMG-CG solver for the SPD grounded node block.

    Returns ``solve_cols`` mapping a [c, n1] f64 right-hand-side batch to
    ``(xs [c, n1], SolveInfo arrays)``.  The AMG hierarchy is cached on the
    stamps object per parameter-values fingerprint (setup is value-
    dependent) and shared across tolerances and backends; device-resident
    operands and solver closures are cached per (tolerance, backend).

    ``backend``: ``"cpu"`` — native f64 on the host (the exact tier);
    ``"accel"`` — f32 on the session's accelerator: the m+1 YB/b1
    right-hand sides are exactly the batched work the chip is for, and the
    outer exact-f64 defect correction in :func:`solve_general_sparse`
    restores direct-solver accuracy (the framework's standard
    f32-kernel + f64-refinement pattern).
    """
    import hashlib

    from nodal_tpu.ops.amg import build_hierarchy, pack_hierarchy

    # Exact-bytes fingerprint (same policy as _factorization's cache key):
    # sum/sum-of-squares moments collide on permuted value vectors — e.g.
    # swapping two resistor values — and a stale hit would silently solve
    # the wrong A11 through the cached mv closure and AMG hierarchy.
    fingerprint = hashlib.sha1(
        np.ascontiguousarray(a11_vals, dtype=np.float64).tobytes()
    ).hexdigest()
    cache = getattr(stamps, "_a11_cache", None)
    if cache is None or cache["fp"] != fingerprint:
        cache = {
            "fp": fingerprint,
            # The AMG hierarchy is built lazily on first CG-tier use: the
            # native skyline tier never needs it, and its setup (~2 s at
            # 100k nodes) would otherwise sit on the direct tier's cold
            # path for nothing.
            "levels": None,
            "solvers": {},
            "operands": {},
        }
        stamps._a11_cache = cache  # type: ignore[attr-defined]
    key = (float(tol), backend)
    hit = cache["solvers"].get(key)
    if hit is not None:
        return hit

    if backend == "native":
        from nodal_tpu.ops import skyline

        if cache.get("native_failed"):
            # Pivot failure is a property of this value vector — don't
            # re-pay the full factorization attempt on every warm solve.
            raise skyline.SkylineUnavailable(
                "non-positive pivot (A11 not SPD here)")
        splan = _skyline_plan_of(stamps, plan)
        if splan is None:
            raise skyline.SkylineUnavailable("profile over caps")
        fact = skyline.factor(splan, plan.a11_rows, plan.a11_cols, a11_vals)
        if fact is None:
            cache["native_failed"] = True
            raise skyline.SkylineUnavailable(
                "non-positive pivot (A11 not SPD here)")

        def solve_cols_native(B):
            xs = skyline.solve(fact, np.asarray(B, dtype=np.float64))
            c = xs.shape[0]
            return xs, GeneralSolveInfo(
                residual=np.zeros(c),
                iterations=np.ones(c, dtype=np.int64),
                converged=np.ones(c, dtype=bool),
                method="skyline",
            )

        cache["solvers"][key] = solve_cols_native
        return solve_cols_native

    accel = _accel_device_or_none() if backend == "accel" else None
    if backend == "accel" and accel is None:
        raise RuntimeError("no accelerator backend available")
    n1 = plan.n1

    operands = cache["operands"].get(backend)
    if operands is None:
        if backend == "accel":
            dev, dtype = accel, jnp.float32
        else:
            dev, dtype = jax.devices("cpu")[0], jnp.float64
        if cache["levels"] is None:
            cache["levels"] = build_hierarchy(
                plan.n1, plan.a11_rows, plan.a11_cols, a11_vals)
        ibuf, fbuf, meta = pack_hierarchy(cache["levels"], dtype)
        with jax.enable_x64(True):  # keep i32/f64 splits exact
            operands = (
                jax.device_put(jnp.asarray(ibuf), dev),
                jax.device_put(jnp.asarray(fbuf), dev),
                meta,
                dev,
                dtype,
            )
        cache["operands"][backend] = operands
    ibuf, fbuf, meta, dev, dtype = operands

    if backend == "accel":
        maxiter = _ACCEL_MAXITER
        cg_tol = max(float(tol), _ACCEL_CG_TOL_FLOOR)
    else:
        maxiter = min(4 * n1 + 100, 100_000)
        cg_tol = float(tol)

    def solve_cols(B):
        # Pad EVERY batch to _RHS_CHUNK so all of a topology's solves —
        # multi-RHS YB sweep chunks, the b1 solve, every refinement pass —
        # share exactly ONE compiled program.  A separate width-1 program
        # looks cheaper but costs a compile of its own (and power-of-two
        # padding compiled six programs).  Execution cost of the padding
        # is small — zero columns converge in 0 iterations and ride the
        # batched while_loop select-frozen.  Width-1 calls dominate
        # refinement, so this is the
        # difference between a ~5 s and a ~400 s cold solve.  The host
        # CPU tier keeps the width-1 program: XLA:CPU compiles it in
        # milliseconds and executes vmap lanes sequentially, so padding
        # would multiply every refinement pass's work by the chunk width.
        B = np.asarray(B, dtype=np.float64)
        c = B.shape[0]
        if backend == "accel":
            width = _RHS_CHUNK
        else:
            width = 1 if c == 1 else _RHS_CHUNK
        if c < width:
            B = np.concatenate(
                [B, np.zeros((width - c,) + B.shape[1:])], axis=0
            )
        with jax.enable_x64(True):
            Bdev = jax.device_put(jnp.asarray(B, dtype=dtype), dev)
            xs, infos = _multi_cg_program(
                Bdev, ibuf, fbuf,
                meta=meta, tol=cg_tol, maxiter=maxiter,
            )
        if c == width:  # skip no-op slices (each is an eager-op compile)
            return xs, infos
        return xs[:c], jax.tree.map(lambda a: a[:c], infos)

    cache["solvers"][key] = solve_cols
    return solve_cols
