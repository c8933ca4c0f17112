"""Batched blocked LU (no pivoting) for diagonally dominant systems.

For the symmetric diagonally-dominant systems produced by resistive
networks, pivoting is unnecessary, so the factorization can be
reorganized into block operations that are almost entirely 128-wide
batched matmuls:

    for each 128-block column j:
        Dinv_j = inv(D_jj)                  (small batched inverse)
        L_ij   = A_ij @ Dinv_j              (tall matmul)
        A_kl  -= L_kj @ A_jl                (rank-128 update)

The packed factor stores Dinv on the diagonal blocks, so both triangular
solves are pure matmuls too.

Stability domain: diagonally dominant / SPD systems (all-resistor MNA,
grounded Laplacians).  General MNA systems with voltage sources have
zero diagonal entries in branch rows — those route to the pivoted XLA path
(see ops.dense_solve / batch.BatchedSolver selection logic).  For extra
margin the batch layer's refine tier defect-corrects against the exact
f64 COO operator (nodal_tpu.batch._coo_defect_refine).
"""

from __future__ import annotations


import jax
import jax.numpy as jnp

_BLOCK = 128


def _pad_to_block(A, b, block: int):
    n = A.shape[-1]
    pad = (-n) % block
    if pad == 0:
        return A, b, n
    eye = jnp.eye(pad, dtype=A.dtype)
    A = jnp.pad(A, [(0, 0)] * (A.ndim - 2) + [(0, pad), (0, pad)])
    A = A.at[..., n:, n:].add(eye)
    b = jnp.pad(b, [(0, 0)] * (b.ndim - 1) + [(0, pad)])
    return A, b, n


def blocked_factor(A, block: int = _BLOCK):
    """Panel block LU of [..., n, n] (n a multiple of ``block``), no pivoting.

    Returns a list of panels ``(Dinv_t, L_t, U_t)`` where ``L_t`` is the
    [..., n-(t+1)k, k] sub-diagonal column panel and ``U_t`` the
    [..., k, n-(t+1)k] Schur-updated row panel.  Carrying a *shrinking*
    Schur complement (instead of ``.at[]`` updates on the full matrix)
    avoids rewriting the whole [B, n, n] buffer every step — the update
    traffic drops from O(nb·n²) to O(n²) per batch element.
    """
    n = A.shape[-1]
    assert n % block == 0, (n, block)
    nb = n // block
    panels = []
    S = A
    for _ in range(nb):
        # Exact batched inverse: on an H100 it beat 12 Newton-Schulz
        # matmul steps on both time and accuracy (PERF.md).
        Dinv = jnp.linalg.inv(S[..., :block, :block])
        U = S[..., :block, block:]
        L = S[..., block:, :block] @ Dinv
        S = S[..., block:, block:] - L @ U
        panels.append((Dinv, L, U))
    return panels


def blocked_solve_factored(panels, b, block: int = _BLOCK):
    """Solve with panels from :func:`blocked_factor`; both sweeps are
    batched matmuls.  ``b`` is [..., n] (vector) or [..., n, r] (multi-RHS
    — the Schur-complement path solves ``A @ Y = [B | b]`` in one sweep)."""
    nb = len(panels)
    vector_rhs = b.ndim == panels[0][0].ndim - 1
    # Forward elimination: peel one block of y per panel.
    ys = []
    rest = b[..., None] if vector_rhs else b  # [..., m, r], shrinking
    for Dinv, L, U in panels:
        y_t = rest[..., :block, :]
        rest = rest[..., block:, :] - L @ y_t
        ys.append(y_t)
    # Backward substitution: x_t = Dinv_t (y_t - U_t x_below).
    x_below = None
    for t in range(nb - 1, -1, -1):
        Dinv, L, U = panels[t]
        rhs = ys[t] if x_below is None else ys[t] - U @ x_below
        x_t = Dinv @ rhs
        x_below = x_t if x_below is None else jnp.concatenate(
            [x_t, x_below], axis=-2
        )
    return x_below[..., 0] if vector_rhs else x_below


def blocked_solve(A, b, block: int = _BLOCK, precision: str = "highest"):
    """No-pivot blocked dense solve for diagonally-dominant/SPD systems.

    Accepts any n (pads internally to the block size).  vmap/jit-friendly.
    ``precision`` sets the matmul precision for f32 inputs: "highest" is
    true f32; lower settings run in TF32 on the GPU (~1e-3 relative) and
    need refinement.
    """
    with jax.default_matmul_precision(precision):
        Ap, bp, n = _pad_to_block(A, b, block)
        X = blocked_factor(Ap, block)
        return blocked_solve_factored(X, bp, block)[..., :n]


def schur_solve(G, b, nk: int, block: int = _BLOCK,
                precision: str = "highest"):
    """Branch-equation MNA systems via block elimination.

    MNA orders unknowns as [node potentials | branch currents]
    (SURVEY.md §2.2), so ``G`` is the 2x2 saddle-point form::

        [ A  B ] [xk]   [bk]      A: nk x nk resistive node block
        [ C  D ] [xb] = [bb]      D: branch-branch couplings (often 0)

    Only resistor stamps land in A (voltage/controlled-source couplings go
    to B/C/D), so A is a diagonally dominant grounded Laplacian — the
    no-pivot blocked LU's home turf — while the zero-diagonal branch rows
    that would break a no-pivot factorization are eliminated exactly:

        A Y = [B | bk]      (one multi-RHS blocked solve, batched matmuls)
        S   = D - C Y_B     (small dense Schur complement)
        S xb = bb - C y_b   (pivoted LU — kbe is small, XLA's is fine)
        xk  = y_b - Y_B xb

    Callers must ensure A is nonsingular (every node resistively connected
    to ground — BatchedSolver checks this host-side with a Cholesky probe
    before selecting this method); vmap/jit-friendly.
    """
    n = G.shape[-1]
    kbe = n - nk
    assert kbe > 0, "schur_solve requires branch equations"
    A = G[..., :nk, :nk]
    Bm = G[..., :nk, nk:]
    C = G[..., nk:, :nk]
    D = G[..., nk:, nk:]
    bk = b[..., :nk]
    bb = b[..., nk:]
    with jax.default_matmul_precision(precision):
        R = jnp.concatenate([Bm, bk[..., None]], axis=-1)  # [..., nk, kbe+1]
        pad = (-nk) % block
        if pad:
            eye = jnp.eye(pad, dtype=A.dtype)
            A = jnp.pad(A, [(0, 0)] * (A.ndim - 2) + [(0, pad), (0, pad)])
            A = A.at[..., nk:, nk:].add(eye)
            R = jnp.pad(R, [(0, 0)] * (R.ndim - 2) + [(0, pad), (0, 0)])
        panels = blocked_factor(A, block)
        Y = blocked_solve_factored(panels, R, block)[..., :nk, :]
        YB = Y[..., :kbe]
        yb = Y[..., kbe]
        S = D - C @ YB
        rhs_b = bb - (C @ yb[..., None])[..., 0]
        xb = jnp.linalg.solve(S, rhs_b[..., None])[..., 0]
        xk = yb - (YB @ xb[..., None])[..., 0]
    return jnp.concatenate([xk, xb], axis=-1)
