"""Scalar banded LDLᵀ: plan, assembly, and run-anywhere solver.

The block-Thomas tier (ops/band.py) pads every band to kb-wide dense
blocks — an O(n·kb²) cost even when the true half-bandwidth is tiny.  After
RCM a 2-D circuit mesh has half-bandwidth w ≈ its smaller grid dimension
(w=26 for the 25×40 bench mesh), so the block tier runs hundreds of
MFLOP/sample where the *scalar* banded factorization needs n·w² ≈ 1.4
MFLOP.

This module holds the topology plan and the portable implementation of the
scalar path; ops/pallas_scalar_band.py holds the GPU kernel that runs it
with one system per thread.

Math: the system is the RCM-reordered grounded resistor Laplacian —
symmetric positive definite — so the no-pivot banded LDLᵀ

    for i:  d = A[i,i];  m_r = A[i, i+r]/d
            A[i+a, i+b] -= m_a · A[i, i+b]          (1 ≤ a ≤ b ≤ w)
            b[i+r]      -= m_r · b[i]
    backward:  x_i = b'_i/d_i − Σ_r m_r · x_{i+r}

is unconditionally stable (Cholesky-class growth bounds) on exactly the
circuits this plan accepts (purely resistive, the same domain as the block
band tier).  Only the upper band is stored: U[i, k] = A[i, i+k], k = 0..w.

The reference has no structure-aware solver of any kind (dense LAPACK /
SuperLU at reference nodal.py:325-327); this is new capability, not a port.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

import jax
import jax.numpy as jnp

from nodal_tpu.models.stamps import StampTensors, stamp_values
from nodal_tpu.ops.band import rcm_order

#: Widest half-bandwidth the scalar-band tier serves, by the dtype its
#: solve runs in.  The GPU kernel carries each system's w(w+1)/2 pending
#: updates (plus w per RHS column) in registers, spilling to local memory
#: as w grows, so its time per row grows faster than w², while the
#: block-Thomas tier's stays flat up to kb=64; f64 carries twice the bytes.
#: Measured end to end on an H100 at B=1024 (PERF.md): in f32 the kernel
#: wins 1.17× at w=41 and loses 1.09× at w=46; in f64 it wins 1.16× at
#: w=36 and loses 1.3× at w=41.  Wider bands take the block-Thomas tier.
MAX_W = 41
MAX_W_F64 = 36


def max_w(dtype) -> int:
    """Widest band the scalar-band tier takes for a solve in ``dtype``."""
    return MAX_W if jnp.dtype(dtype).itemsize <= 4 else MAX_W_F64


def carry_fits(w: int, n_rhs: int, dtype) -> bool:
    """Whether a w-wide band with ``n_rhs`` RHS columns carries no more per
    system than the widest single-RHS band the tier takes in ``dtype`` (the
    multi-RHS Schur tier checks this)."""
    m = max_w(dtype)
    return w * (w + 1) // 2 + w * n_rhs <= m * (m + 1) // 2 + m


@dataclass
class ScalarBandPlan:
    """Host-side plan: RCM order + symmetric upper-band assembly tables.

    Built once per topology by :func:`make_scalar_band_plan`, cached on the
    stamps object by :func:`sband_plan`.  All arrays are compile-time
    constants inside jit/vmap.
    """

    n: int
    w: int             # half-bandwidth after reordering
    W1: int            # stored slots per row = w + 1 (diagonal first)
    n_pad: int         # n rounded up to a multiple of 8
    order: np.ndarray  # [n] order[new] = old
    rank: np.ndarray   # [n] rank[old] = new
    sel: np.ndarray    # stamp entries in the upper band (row' <= col')
    u_flat: np.ndarray     # flat scatter targets into [n_pad * W1]
    unit_flat: np.ndarray  # unit-diagonal targets for pad rows
    rhs_sel: np.ndarray
    rhs_perm_rows: np.ndarray

    #: Rows denser than this fall back to the scatter assembly (same
    #: rationale and knob as BandPlan._GATHER_FOLD_MAX_WIDTH).
    _GATHER_FOLD_MAX_WIDTH = 16

    def assemble(self, stamps: StampTensors, params, dtype=None):
        """One parameter vector -> (U [n_pad, W1], b [n_pad]).

        jit/vmap-friendly: indices are constants, values fold in.  Upper
        band only — the system is symmetric by construction (resistor
        stamps are the only node-node entries; models/stamps.py).
        """
        params = jnp.asarray(params, dtype=dtype)
        g_vals, rhs_vals = stamp_values(stamps, params)
        return self.assemble_from_values(g_vals, rhs_vals)

    def assemble_from_values(self, g_vals, rhs_vals):
        gf = self._gather_fold()
        if gf is not None:
            entry_ids, slots, valid, fill = gf
            rowvals = (g_vals[entry_ids] * valid.astype(g_vals.dtype)
                       + fill.astype(g_vals.dtype))      # [n_pad, width]
            iota = jax.lax.broadcasted_iota(
                jnp.int32, (self.n_pad, slots.shape[1], self.W1), 2
            )
            U = jnp.sum(
                rowvals[:, :, None]
                * (slots[:, :, None] == iota).astype(g_vals.dtype),
                axis=1,
            )
        else:
            flat = jnp.zeros(self.n_pad * self.W1, dtype=g_vals.dtype)
            flat = flat.at[self.u_flat].add(g_vals[self.sel])
            if len(self.unit_flat):
                flat = flat.at[self.unit_flat].add(1.0)
            U = flat.reshape(self.n_pad, self.W1)
        b = jnp.zeros(self.n_pad, dtype=rhs_vals.dtype)
        b = b.at[self.rhs_perm_rows].add(rhs_vals[self.rhs_sel])
        return U, b

    def _gather_fold(self):
        cached = self.__dict__.get("_gf_cache", False)
        if cached is not False:
            return cached
        out = None
        if os.environ.get("NODAL_TPU_BAND_ASSEMBLY") != "scatter":
            rows = self.u_flat // self.W1
            slots_np = self.u_flat % self.W1
            urows = self.unit_flat // self.W1
            all_rows = np.concatenate([rows, urows])
            counts = np.bincount(all_rows, minlength=self.n_pad)
            width = int(counts.max()) if len(all_rows) else 1
            if width <= self._GATHER_FOLD_MAX_WIDTH and len(self.sel):
                entry_ids = np.zeros((self.n_pad, width), dtype=np.int64)
                slots = np.zeros((self.n_pad, width), dtype=np.int32)
                valid = np.zeros((self.n_pad, width), dtype=np.float32)
                fill = np.zeros((self.n_pad, width), dtype=np.float32)
                cursor = np.zeros(self.n_pad, dtype=np.int64)
                for r, i, s in zip(rows, self.sel.astype(np.int64),
                                   slots_np.astype(np.int32)):
                    entry_ids[r, cursor[r]] = i
                    slots[r, cursor[r]] = s
                    valid[r, cursor[r]] = 1.0
                    cursor[r] += 1
                for r in urows:
                    # pad-row unit diagonal: slot 0, constant 1.0
                    fill[r, cursor[r]] = 1.0
                    cursor[r] += 1
                # numpy (not jnp): cached across traces — see BandPlan.
                out = (entry_ids, slots, valid, fill)
        self.__dict__["_gf_cache"] = out
        return out

    def rhs_to_band(self, rhs, dtype=None):
        """Natural-order [..., m] RHS -> [..., n_pad] in band order."""
        dt = dtype if dtype is not None else rhs.dtype
        out = jnp.zeros(rhs.shape[:-1] + (self.n_pad,), dt)
        sel = jnp.take(rhs, jnp.asarray(self.order), axis=-1).astype(dt)
        return out.at[..., : self.n].set(sel)

    def unpermute(self, x, *, rows_axis: int = -1):
        """Reordered [..., n_pad] solution -> natural [..., n]."""
        assert x.shape[rows_axis] == self.n_pad, (x.shape, self.n_pad)
        return jnp.take(x, jnp.asarray(self.rank), axis=rows_axis)


def make_scalar_band_plan(
    stamps: StampTensors, n_limit: int | None = None, max_w: int = MAX_W,
) -> ScalarBandPlan | None:
    """Scalar-band plan for the leading ``n_limit`` unknowns, or None when
    the system is not symmetric-banded under ``max_w`` (the widest band the
    tier takes in any dtype; callers check :func:`max_w` for theirs).

    Requires a *symmetric* block.  Only resistor stamps write node-node
    entries (models/stamps.py), so the node block (``n_limit =
    stamps.n_kcl``) is symmetric by construction; the full system is only
    accepted when it has no branch equations — E/controlled-source
    couplings are value-antisymmetric (G[i,be] = +1, G[be,i] = −1) even
    though their sparsity is symmetric, and LDLᵀ would silently solve the
    wrong matrix.  Structural symmetry is additionally verified below as a
    cheap belt-and-braces check.
    """
    n = stamps.n if n_limit is None else n_limit
    if n == 0:
        return None
    if n > stamps.n_kcl:  # includes branch rows: not symmetric
        return None
    if n_limit is None:
        sel_all = np.arange(len(stamps.g_rows), dtype=np.int64)
    else:
        sel_all = np.nonzero(
            (stamps.g_rows < n) & (stamps.g_cols < n)
        )[0]
    rows = stamps.g_rows[sel_all].astype(np.int64)
    cols = stamps.g_cols[sel_all].astype(np.int64)
    if len(rows) == 0:
        return None
    # Structural symmetry of the pattern.
    key_fwd = np.unique(rows * n + cols)
    key_bwd = np.unique(cols * n + rows)
    if len(key_fwd) != len(key_bwd) or not np.array_equal(key_fwd, key_bwd):
        return None

    natural_bw = int(np.max(np.abs(rows - cols)))
    order = rcm_order(n, rows, cols)
    rank = np.argsort(order)
    rcm_bw = int(np.max(np.abs(rank[rows] - rank[cols])))
    if natural_bw <= rcm_bw:  # keep the netlist's own ordering if no worse
        order = np.arange(n, dtype=np.int64)
        rank = order
        w = natural_bw
    else:
        w = rcm_bw
    if w > max_w:
        return None
    W1 = w + 1
    n_pad = -(-n // 8) * 8

    pr, pc = rank[rows], rank[cols]
    upper = pr <= pc
    sel = sel_all[upper]
    u_flat = pr[upper] * W1 + (pc[upper] - pr[upper])
    pad_rows = np.arange(n, n_pad, dtype=np.int64)
    unit_flat = pad_rows * W1  # slot 0 (diagonal)
    rhs_sel = np.nonzero(stamps.rhs_rows < n)[0]
    rhs_perm_rows = rank[stamps.rhs_rows[rhs_sel].astype(np.int64)]
    return ScalarBandPlan(
        n=n, w=w, W1=W1, n_pad=n_pad,
        order=order, rank=rank, sel=sel,
        u_flat=u_flat.astype(np.int64),
        unit_flat=unit_flat,
        rhs_sel=rhs_sel,
        rhs_perm_rows=rhs_perm_rows.astype(np.int64),
    )


def sband_plan(stamps: StampTensors) -> ScalarBandPlan | None:
    """Cached full-system scalar-band plan (None if not applicable)."""
    cached = getattr(stamps, "_sband_plan", False)
    if cached is False:
        cached = make_scalar_band_plan(stamps)
        stamps._sband_plan = cached  # type: ignore[attr-defined]
    return cached


def node_sband_plan(stamps: StampTensors) -> ScalarBandPlan | None:
    """Cached scalar-band plan of the resistive node block (Schur path)."""
    cached = getattr(stamps, "_node_sband_plan", False)
    if cached is False:
        cached = make_scalar_band_plan(stamps, n_limit=stamps.n_kcl)
        stamps._node_sband_plan = cached  # type: ignore[attr-defined]
    return cached


def sband_matvec(U, x):
    """Symmetric band matvec ``y = A·x`` from upper storage.

    ``U`` [..., n_pad, W1], ``x`` [..., n_pad].  O(n·w) — the residual /
    refinement workhorse for this tier (any dtype, f64 included).
    """
    W1 = U.shape[-1]
    y = U[..., 0] * x
    for k in range(1, W1):
        uk = U[..., :-k, k]
        y = y.at[..., :-k].add(uk * x[..., k:])
        y = y.at[..., k:].add(uk * x[..., :-k])
    return y


def _aug_index_mask(W1: int, W1a: int, n_rhs: int):
    """Constant gather/mask tables for the augmented update.

    Augmented rows are [d, u_1..u_w, rhs_0..rhs_{n_rhs-1}, 0-pad] of width
    ``W1a``.  The elimination update of row i+r reads q_r[k]:

        q_r[k] = row_i[k + r]   for band slots k ≤ w − r
        q_r[k] = row_i[k]       for RHS slots (they never shift)

    Returns ``IDX`` [W1a, W1a] gather indices into row_i and ``MASK``
    [W1a, W1a] with zeros where no update applies (r = 0, out-of-band).
    """
    w = W1 - 1
    r_ = np.arange(W1a)[:, None]
    k_ = np.arange(W1a)[None, :]
    is_rhs = (k_ >= W1) & (k_ < W1 + n_rhs)
    idx = np.where(is_rhs, k_, np.minimum(r_ + k_, W1a - 1))
    mask = (r_ >= 1) & (r_ <= w) & (((k_ + r_) <= w) | is_rhs)
    return idx.astype(np.int32), mask.astype(np.float32)


def scalar_band_solve_scan(U, b):
    """Run-anywhere banded LDLᵀ solve: ``U`` [..., n_pad, W1] upper band,
    ``b`` [..., n_pad] (or [..., n_pad, r] multi-RHS) -> x of b's shape.

    lax.scan over rows; any float dtype (the CPU path and the test
    oracle).  The GPU kernel (ops/pallas_scalar_band) computes the same
    recurrence with one system per thread.
    """
    vector_rhs = b.ndim == U.ndim - 1
    if vector_rhs:
        b = b[..., None]
    *batch, n_pad, W1 = U.shape
    n_rhs = b.shape[-1]
    w = W1 - 1
    W1a = W1 + n_rhs
    dtype = b.dtype

    A = jnp.concatenate([U.astype(dtype), b], axis=-1)  # [..., n_pad, W1a]
    # Trailing scratch rows so every [W1a, W1a] window is in bounds (unit
    # diagonal; their m is 0 so they never touch the solution).
    unit = jnp.zeros((W1a,), dtype).at[0].set(1.0)
    scratch = jnp.broadcast_to(unit, tuple(batch) + (W1a, W1a))
    A = jnp.concatenate([A, scratch], axis=-2)

    IDX, MASK = _aug_index_mask(W1, W1a, n_rhs)
    IDXj = jnp.asarray(IDX)
    MASKj = jnp.asarray(MASK, dtype)
    keep = jnp.asarray(
        (np.arange(W1a) == 0) | (np.arange(W1a) >= W1), dtype
    )  # slots of row_new kept from the raw row (d and the rhs values)
    mslot = jnp.asarray(
        ((np.arange(W1a) >= 1) & (np.arange(W1a) <= w)).astype(np.float64),
        dtype,
    )

    def solve_one(Ai):
        def fstep(Acar, i):
            win = jax.lax.dynamic_slice(Acar, (i, 0), (W1a, W1a))
            row = win[0]
            m = row / row[0]
            q = row[IDXj] * MASKj              # [W1a (r), W1a (k)]
            upd = m[:, None] * q
            row_new = keep * row + (1.0 - keep) * m
            win = (win - upd).at[0].set(row_new)
            Acar = jax.lax.dynamic_update_slice(Acar, win, (i, 0))
            return Acar, None

        Af, _ = jax.lax.scan(fstep, Ai, jnp.arange(n_pad))

        def bstep(x, i):
            row = jax.lax.dynamic_slice(Af, (i, 0), (1, W1a))[0]
            xwin = jax.lax.dynamic_slice(x, (i, 0), (W1a, n_rhs))
            s = jnp.sum((mslot * row)[:, None] * xwin, axis=0)
            xi = row[W1:W1a] / row[0] - s
            x = jax.lax.dynamic_update_slice(x, xi[None], (i, 0))
            return x, None

        x0 = jnp.zeros((n_pad + W1a, n_rhs), dtype)
        xf, _ = jax.lax.scan(
            bstep, x0, jnp.arange(n_pad - 1, -1, -1)
        )
        return xf[:n_pad]

    fn = solve_one
    for _ in batch:
        fn = jax.vmap(fn)
    x = fn(A)
    return x[..., 0] if vector_rhs else x
