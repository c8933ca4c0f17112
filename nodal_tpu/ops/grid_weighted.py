"""Weighted resistor grids: matrix-free solves with per-edge conductances.

Generalizes ops/grid.py from uniform unit resistors to an arbitrary
conductance field — ``gx[h, w-1]`` on horizontal edges, ``gy[h-1, w]`` on
vertical ones.  The matvec stays pure elementwise flux differencing
(vmappable, shardable), and the Galerkin multigrid construction survives
intact: with prolongation-by-replication, the exact coarse operator is
again a weighted grid whose edge weight is the SUM of the fine edges
crossing each 2×2-block boundary (interior edges cancel) — so the
preconditioner is Galerkin-exact for ANY conductance field, not an
approximation.

This is where the framework's two scaling axes meet: ``vmap`` over
``(gx, gy)`` gives batched Monte Carlo over *large structured* systems —
e.g. tolerance analysis of a 256×256 resistor fabric in one compiled
program, something neither the netlist path (would re-stamp per sample)
nor the reference (minutes per solve) can express.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from nodal_tpu.ops.cg import cg

_OMEGA = 0.8
_COARSEST = 8
_COARSE_SWEEPS = 96


def weighted_laplacian_matvec(x, gx, gy):
    """y[i,j] = Σ_neighbors g_edge (x[i,j] - x_neighbor), flux form."""
    fx = gx * (x[:, 1:] - x[:, :-1])  # [h, w-1] flow left->right
    fy = gy * (x[1:, :] - x[:-1, :])  # [h-1, w] flow top->bottom
    zx = jnp.zeros_like(x[:, :1])
    zy = jnp.zeros_like(x[:1, :])
    # y[i,j] = fx[i,j-1] - fx[i,j] + fy[i-1,j] - fy[i,j]  ==  Σ g (x - x_nbr)
    return (
        jnp.concatenate([zx, fx], axis=1)
        - jnp.concatenate([fx, zx], axis=1)
        + jnp.concatenate([zy, fy], axis=0)
        - jnp.concatenate([fy, zy], axis=0)
    )


def _degree(gx, gy, h, w):
    """Diagonal of the weighted Laplacian."""
    zx = jnp.zeros((h, 1), gx.dtype)
    zy = jnp.zeros((1, w), gy.dtype)
    return (
        jnp.concatenate([gx, zx], axis=1)
        + jnp.concatenate([zx, gx], axis=1)
        + jnp.concatenate([gy, zy], axis=0)
        + jnp.concatenate([zy, gy], axis=0)
    )


def _coarsen_weights(gx, gy):
    """Exact Galerkin coarse conductances for replication prolongation:
    sum the fine edges crossing each coarse-cell boundary."""
    h, wm1 = gx.shape
    w = wm1 + 1
    # Horizontal: crossing edges are at fine columns 1, 3, 5, ... (between
    # column blocks); sum the two rows of each block row.
    cross_x = gx[:, 1::2]  # [h, w/2 - 1]
    gxc = cross_x[0::2, :] + cross_x[1::2, :]
    cross_y = gy[1::2, :]  # [h/2 - 1, w]
    gyc = cross_y[:, 0::2] + cross_y[:, 1::2]
    return gxc, gyc


def make_weighted_preconditioner(h: int, w: int, gx, gy, nu: int = 1):
    """Galerkin-exact V(nu, nu) cycle for the weighted Neumann grid."""
    levels = []
    while True:
        deg = _degree(gx, gy, h, w)
        levels.append((gx, gy, deg, h, w))
        if min(h, w) <= _COARSEST or h % 2 or w % 2:
            break
        gx, gy = _coarsen_weights(gx, gy)
        h, w = h // 2, w // 2

    def jacobi(x, r, lv, sweeps):
        gx_l, gy_l, deg, _, _ = lv
        dinv = _OMEGA / jnp.maximum(deg, jnp.finfo(deg.dtype).tiny)

        def sweep(x):
            return x + dinv * (r - weighted_laplacian_matvec(x, gx_l, gy_l))

        if sweeps <= 4:
            for _ in range(sweeps):
                x = sweep(x)
            return x
        return jax.lax.fori_loop(0, sweeps, lambda _, v: sweep(v), x)

    def restrict(r):
        hh, ww = r.shape
        return r.reshape(hh // 2, 2, ww // 2, 2).sum(axis=(1, 3))

    def prolong(x):
        return jnp.repeat(jnp.repeat(x, 2, axis=0), 2, axis=1)

    def vcycle(r, i):
        lv = levels[i]
        if i == len(levels) - 1:
            x = jacobi(jnp.zeros_like(r), r - jnp.mean(r), lv,
                       _COARSE_SWEEPS)
            return x - jnp.mean(x)
        x = jacobi(jnp.zeros_like(r), r, lv, nu)
        res = r - weighted_laplacian_matvec(x, lv[0], lv[1])
        x = x + prolong(vcycle(restrict(res), i + 1))
        return jacobi(x, r, lv, nu)

    def M(r):
        out = vcycle(r, 0)
        return out - jnp.mean(out)

    return M


def weighted_grid_solve(gx, gy, b, *, tol: float = 1e-7,
                        maxiter: int | None = None, mg: bool = True):
    """Solve the weighted-grid Neumann system ``L x = b`` (b zero-sum) via
    the rank-one-regularized CG.  jit/vmap-friendly over (gx, gy, b)...
    with the caveat that the MG hierarchy is rebuilt per call from the
    traced weights (pure functions of gx/gy — exactly what vmap needs).

    Differentiable with ``jax.grad`` w.r.t. ``gx``/``gy``/``b`` via an
    implicit-function custom VJP (CG's ``lax.while_loop`` cannot be
    reverse-differentiated, and unrolling it would be absurd anyway):
    the adjoint solve reuses this very solver (the operator is
    symmetric), and the edge-conductance cotangent is pure elementwise
    flux algebra, ``ḡ_e = −(x_i−x_j)(λ_i−λ_j)`` — the foundation for
    gradient-based design of resistor fabrics (d R_eq / d g_edge on
    every edge from ONE extra solve).
    """

    def raw_solve(gx_, gy_, b_):
        h, w = b_.shape
        mean_scale = 1.0 / (h * w)

        def matvec(x):
            return (weighted_laplacian_matvec(x, gx_, gy_)
                    + jnp.sum(x) * mean_scale)

        M = make_weighted_preconditioner(h, w, gx_, gy_) if mg else None
        mi = maxiter if maxiter is not None else (300 if mg
                                                  else 20 * max(h, w))
        return cg(matvec, b_ - jnp.mean(b_), preconditioner=M, tol=tol,
                  maxiter=mi)

    @jax.custom_vjp
    def solve(gx_, gy_, b_):
        return raw_solve(gx_, gy_, b_)

    def fwd(gx_, gy_, b_):
        out = raw_solve(gx_, gy_, b_)
        return out, (gx_, gy_, out[0])

    def bwd(res, ct):
        gx_, gy_, x = res
        xbar = ct[0]  # the CGInfo cotangent is ignored (diagnostics)
        # A = L + 11ᵀ/hw is symmetric and A·1 = 1, so
        # A⁻¹x̄ = A⁻¹Px̄ + mean(x̄)·1 — one more call to the same solver.
        lam = raw_solve(gx_, gy_, xbar)[0] + jnp.mean(xbar)
        gxbar = -(x[:, 1:] - x[:, :-1]) * (lam[:, 1:] - lam[:, :-1])
        gybar = -(x[1:, :] - x[:-1, :]) * (lam[1:, :] - lam[:-1, :])
        # x = A⁻¹P b ⇒ b̄ = P A⁻¹ x̄ = λ − mean(λ).
        return gxbar, gybar, lam - jnp.mean(lam)

    solve.defvjp(fwd, bwd)
    return solve(gx, gy, b)


@functools.partial(jax.jit, static_argnames=("h", "w", "tol"))
def weighted_equivalent_resistance(h: int, w: int, gx, gy, a, b,
                                   tol: float = 1e-7):
    """Two-point equivalent resistance on a weighted grid.

    ``a``/``b`` are (row, col) index pairs (static or traced).  Returns
    ``(R, residual)``.
    """
    rhs = (
        jnp.zeros((h, w), gx.dtype)
        .at[a[0], a[1]].add(1.0)
        .at[b[0], b[1]].add(-1.0)
    )
    x, info = weighted_grid_solve(gx, gy, rhs, tol=tol)
    return x[a[0], a[1]] - x[b[0], b[1]], info.residual
