"""Batched tridiagonal solves via parallel cyclic reduction (PCR) — the
structure-aware fast path for chain topologies.

The stamp compiler sees the whole circuit graph, so it can detect when the
MNA matrix (in natural node order) is tridiagonal — true for ladder/chain
networks like the 1k-node batched-sweep benchmark circuit (BASELINE.json
configs[3]).  A dense factorization then does ~n²/5 times more work than
necessary; SPICE-class simulators always exploit such structure, and so do
we.

PCR is the data-parallel tridiagonal algorithm: log2(n) levels of fully
vectorized elementwise recurrences over [B, n] arrays, applied to *every*
row each level so the system fully decouples — no sequential
back-substitution at all (the classical Thomas algorithm would serialize n
tiny steps).  O(n log n) work, but every op is a fused elementwise map
over the batch that XLA fuses level by level.  Stable for the diagonally dominant systems resistive networks
produce.
"""

from __future__ import annotations

import jax.numpy as jnp


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _shift(x, s: int, fill: float):
    """x shifted by s along the last axis (s>0 reads index i-s), padded
    with ``fill``."""
    if s == 0:
        return x
    pad_shape = x.shape[:-1] + (abs(s),)
    pad = jnp.full(pad_shape, fill, dtype=x.dtype)
    if s > 0:
        return jnp.concatenate([pad, x[..., :-s]], axis=-1)
    return jnp.concatenate([x[..., -s:], pad], axis=-1)


def tridiag_matvec(dl, d, du, x):
    """y_i = dl_i x_{i-1} + d_i x_i + du_i x_{i+1} (batched)."""
    return (
        d * x
        + dl * _shift(x, 1, 0.0)
        + du * _shift(x, -1, 0.0)
    )


def tridiag_solve(dl, d, du, b):
    """Solve batched tridiagonal systems ``dl_i x_{i-1} + d_i x_i +
    du_i x_{i+1} = b_i`` by parallel cyclic reduction.

    Args:
        dl: [..., n] sub-diagonal (dl[..., 0] must be 0 / is ignored).
        d:  [..., n] main diagonal.
        du: [..., n] super-diagonal (du[..., n-1] must be 0 / is ignored).
        b:  [..., n] right-hand side.

    Returns [..., n] solutions.  jit/vmap-friendly; n is static.
    """
    n = d.shape[-1]
    m = _next_pow2(n)
    pad = m - n

    def padded(x, fill):
        if pad == 0:
            return x
        p = jnp.full(x.shape[:-1] + (pad,), fill, dtype=x.dtype)
        return jnp.concatenate([x, p], axis=-1)

    # Pad with decoupled identity rows (x_extra = 0); clear the dangling
    # couplings at both physical ends.
    a = padded(dl, 0.0).at[..., 0].set(0.0)
    c = padded(du, 0.0).at[..., m - 1].set(0.0)
    if pad:
        c = c.at[..., n - 1].set(0.0)
    dd = padded(d, 1.0)
    rhs = padded(b, 0.0)

    stride = 1
    while stride < m:
        # Eliminate the +-stride couplings of every row simultaneously.
        # Out-of-range neighbors read as decoupled identity rows.
        alpha = a / _shift(dd, stride, 1.0)
        gamma = c / _shift(dd, -stride, 1.0)
        a_new = -alpha * _shift(a, stride, 0.0)
        c_new = -gamma * _shift(c, -stride, 0.0)
        dd = (
            dd
            - alpha * _shift(c, stride, 0.0)
            - gamma * _shift(a, -stride, 0.0)
        )
        rhs = (
            rhs
            - alpha * _shift(rhs, stride, 0.0)
            - gamma * _shift(rhs, -stride, 0.0)
        )
        a, c = a_new, c_new
        stride *= 2

    return (rhs / dd)[..., :n]
