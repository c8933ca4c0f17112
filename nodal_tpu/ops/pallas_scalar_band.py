"""Pallas (Triton) scalar-band LDLᵀ kernel: one thread per system.

GPU counterpart of ops/scalar_band.scalar_band_solve_scan.  The scan form
runs one XLA loop step per matrix row — about 2n sequential steps per solve
(forward elimination, then back substitution), each a separate kernel
launch on the GPU, so at n=1000 the launch chain, not arithmetic, bounds
the whole batch.  This kernel keeps the row loop *inside* the kernel:

* one program owns a tile of ``BLOCK_B`` batch systems, with the batch on
  the threads (each thread runs one system's whole recurrence);
* the band streams from device memory one row per step, laid out
  ``[n_pad, slot, batch]`` so each slot of a row is one coalesced load;
* the sliding window of pending updates — row ``i+j`` has received
  ``w−j`` slot updates from earlier pivots — is the loop carry, so it
  stays on chip (registers, spilling to L1-resident local memory for wide
  bands): ``w(w+1)/2 + w·n_rhs`` values per system;
* RHS columns ride beside the band and are eliminated in the same pass —
  the multi-RHS form serves the Schur branch-equation tier, which solves
  ``A⁻¹[B | b]`` in one factorization.

Forward step i (pivot row ``p`` = raw row i minus its pending updates):

    d = p_0,  m_r = p_r / d                         (r = 1..w)
    pending(i+r)[k] += m_r · p_{r+k}                (k = 0..w−r)
    pending_rhs(i+r) += m_r · rhs_i

The multipliers and ``y_i = rhs_i / d`` go to device memory; the backward
sweep ``x_i = y_i − Σ_r m_r · x_{i+r}`` carries the last w solution rows.

Stability domain: SPD after RCM — exactly what ScalarBandPlan accepts
(purely resistive blocks).  No pivoting, no matmuls: the arithmetic is the
same recurrence as the scan (tests/test_scalar_band.py cross-checks them
in interpret mode).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

#: Systems per program: one warp, one system per thread.  16, 32 and 64
#: ran within 3% of each other on an H100 (PERF.md).
BLOCK_B = 32


def _kernel(u_ref, r_ref, f_ref, x_ref, *, n_pad: int, w: int, n_rhs: int,
            barrier: bool):
    """Factor + solve ``BLOCK_B`` systems; refs are [n_pad, slots, BLOCK_B].

    ``f_ref`` receives the multipliers m_1..m_w of every row; ``x_ref``
    first holds y = rhs'/d and is overwritten with x by the backward sweep.
    """
    W1 = w + 1
    zero = jnp.zeros(x_ref.shape[-1], x_ref.dtype)
    # Carry layout: pending slot updates of rows i..i+w-1 (row i+j has w-j
    # slots), then their pending RHS updates (n_rhs each).
    acc_len = [w - j for j in range(w)]

    def unflatten(flat):
        acc, pos = [], 0
        for ln in acc_len:
            acc.append(list(flat[pos:pos + ln]))
            pos += ln
        accr = [list(flat[pos + j * n_rhs:pos + (j + 1) * n_rhs])
                for j in range(w)]
        return acc, accr

    def fwd(i, flat):
        acc, accr = unflatten(flat)
        p = [u_ref[i, k] for k in range(W1)]
        rc = [r_ref[i, c] for c in range(n_rhs)]
        if w:
            p = [p[k] - acc[0][k] if k < w else p[k] for k in range(W1)]
            rc = [rc[c] - accr[0][c] for c in range(n_rhs)]
        inv = 1.0 / p[0]
        m = [None] + [p[r] * inv for r in range(1, W1)]
        for r in range(1, W1):
            f_ref[i, r - 1] = m[r]
        for c in range(n_rhs):
            x_ref[i, c] = rc[c] * inv
        new_acc, new_accr = [], []
        for j in range(w):
            r = j + 1  # the old window row that becomes new row j
            row = []
            for k in range(w - j):
                v = m[r] * p[r + k]
                if r < w and k < acc_len[r]:
                    v = v + acc[r][k]
                row.append(v)
            new_acc.append(row)
            new_accr.append([
                m[r] * rc[c] + (accr[r][c] if r < w else 0.0)
                for c in range(n_rhs)
            ])
        return tuple(v for row in new_acc for v in row) + tuple(
            v for row in new_accr for v in row)

    n_carry = sum(acc_len) + w * n_rhs
    jax.lax.fori_loop(0, n_pad, fwd, (zero,) * n_carry)
    if barrier:
        # The backward sweep reads what other threads may have stored.
        plgpu.debug_barrier()

    def bwd(j, xs):
        # xs[(r-1)*n_rhs + c] = x_{i+r}[c] for r = 1..w
        i = n_pad - 1 - j
        m = [f_ref[i, r] for r in range(w)]
        new = []
        for c in range(n_rhs):
            s = x_ref[i, c]
            for r in range(w):
                s = s - m[r] * xs[r * n_rhs + c]
            x_ref[i, c] = s
            new.append(s)
        return tuple(new) + xs[:(w - 1) * n_rhs] if w else xs

    jax.lax.fori_loop(0, n_pad, bwd, (zero,) * (w * n_rhs))


@functools.partial(jax.jit, static_argnames=("n_valid", "interpret"))
def pallas_scalar_band_solve_multi(U, R, *, n_valid: int | None = None,
                                   interpret: bool = False):
    """Batched multi-RHS scalar-band solve: ``U`` [B, n_pad, W1] upper band
    storage (ScalarBandPlan.assemble), ``R`` [B, n_pad, n_rhs] ->
    x [B, n_pad, n_rhs] in U's dtype (f32 or f64).

    ``n_valid`` trims the plan's padded row tail from the result;
    ``interpret`` runs the kernel in the Pallas interpreter (tests).
    """
    B, n_pad, W1 = U.shape
    n_rhs = R.shape[-1]
    w = W1 - 1
    dtype = U.dtype
    R = R.astype(dtype)
    # Batch pad to a tile multiple with unit systems (d=1, rhs=0 -> x=0).
    Bp = -(-B // BLOCK_B) * BLOCK_B
    if Bp != B:
        unit = jnp.zeros((W1,), dtype).at[0].set(1.0)
        U = jnp.concatenate(
            [U, jnp.broadcast_to(unit, (Bp - B, n_pad, W1))], axis=0)
        R = jnp.concatenate(
            [R, jnp.zeros((Bp - B, n_pad, n_rhs), dtype)], axis=0)
    Ut = jnp.transpose(U, (1, 2, 0))  # [n_pad, W1, Bp]: batch contiguous
    Rt = jnp.transpose(R, (1, 2, 0))

    def spec(slots):
        return pl.BlockSpec((n_pad, slots, BLOCK_B), lambda t: (0, 0, t))

    kernel = functools.partial(_kernel, n_pad=n_pad, w=w, n_rhs=n_rhs,
                               barrier=not interpret)
    _, xt = pl.pallas_call(
        kernel,
        grid=(Bp // BLOCK_B,),
        in_specs=[spec(W1), spec(n_rhs)],
        out_specs=[spec(max(w, 1)), spec(n_rhs)],
        out_shape=[
            jax.ShapeDtypeStruct((n_pad, max(w, 1), Bp), dtype),
            jax.ShapeDtypeStruct((n_pad, n_rhs, Bp), dtype),
        ],
        compiler_params=plgpu.CompilerParams(
            num_warps=BLOCK_B // 32, num_stages=1),
        interpret=interpret,
        name="scalar_band_ldlt",
    )(Ut, Rt)
    x = jnp.transpose(xt, (2, 0, 1))[:B]
    return x if n_valid is None else x[:, :n_valid]


def pallas_scalar_band_solve(U, b, *, n_valid: int | None = None,
                             interpret: bool = False):
    """Single-RHS form: ``U`` [B, n_pad, W1], ``b`` [B, n_pad] ->
    x [B, n_pad]."""
    return pallas_scalar_band_solve_multi(
        U, b[..., None], n_valid=n_valid, interpret=interpret
    )[..., 0]


def sband_solver(interpret: bool = False):
    """The batched scalar-band solve
    ``solve(U [B, n_pad, W1], R [B, n_pad] or [B, n_pad, r]) -> x``,
    computed in R's dtype.

    The kernel is chosen where the program is lowered, not where it is
    traced: a program lowered for a CUDA device runs the kernel, any other
    (the host CPU, including a solve placed there with
    ``jax.default_device`` on a GPU machine) runs the lax.scan recurrence.
    ``interpret=True`` runs the kernel in the Pallas interpreter on every
    platform (tests).
    """
    from nodal_tpu.ops.scalar_band import scalar_band_solve_scan

    def kernel(U, R):
        if R.ndim == U.ndim - 1:
            return pallas_scalar_band_solve(U, R, interpret=interpret)
        return pallas_scalar_band_solve_multi(U, R, interpret=interpret)

    def solve(U, R):
        U = U.astype(R.dtype)
        if interpret:
            return kernel(U, R)
        return jax.lax.platform_dependent(
            U, R, cuda=kernel, default=scalar_band_solve_scan)

    return solve
