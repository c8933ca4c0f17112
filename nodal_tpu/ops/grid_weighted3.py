"""Weighted 3-D resistor lattices: matrix-free solves with per-edge
conductances.

Extends ops/grid_weighted.py to three dimensions: conductance fields
``gx[d, h, w-1]`` (edges along the last axis), ``gy[d, h-1, w]`` (middle
axis) and ``gz[d-1, h, w]`` (leading axis) on a ``d x h x w`` lattice.  The
matvec stays pure elementwise flux differencing (vmappable,
shardable), and the Galerkin multigrid construction survives unchanged:
with prolongation-by-replication over 2x2x2 blocks, the exact coarse
operator is again a weighted lattice whose edge weight is the SUM of the
four fine edges crossing each coarse-cell face (edges interior to a block
connect nodes that prolongation maps to the same coarse value, so they
cancel).  The preconditioner is therefore Galerkin-exact for ANY
conductance field — verified against P^T L P in tests/test_grid_weighted3.py.

Why this exists: 3-D lattices are the worst case for the direct band tiers
— an a x b x L lattice has RCM half-bandwidth ~a*b (its minimum cut), which
pushes the block-band tier to kb=256 blocks, hundreds of times the scalar
flop count.  For lattice topologies the structured matrix-free
path sidesteps bandwidth entirely: O(n) per matvec, a handful of MG-CG
iterations per solve, and ``vmap`` over the conductance fields gives
batched Monte Carlo over 3-D fabrics in one compiled program.  The
reference has no analogue (dense LAPACK / SuperLU per solve, reference
nodal.py:325-327).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from nodal_tpu.ops.cg import cg

_OMEGA = 0.8
_COARSEST = 8
_COARSE_SWEEPS = 96


def weighted_laplacian_matvec_3d(x, gx, gy, gz):
    """y[i,j,k] = Σ_neighbors g_edge (x[i,j,k] - x_neighbor), flux form."""
    fx = gx * (x[:, :, 1:] - x[:, :, :-1])   # [d, h, w-1]
    fy = gy * (x[:, 1:, :] - x[:, :-1, :])   # [d, h-1, w]
    fz = gz * (x[1:, :, :] - x[:-1, :, :])   # [d-1, h, w]
    zx = jnp.zeros_like(x[:, :, :1])
    zy = jnp.zeros_like(x[:, :1, :])
    zz = jnp.zeros_like(x[:1, :, :])
    return (
        jnp.concatenate([zx, fx], axis=2)
        - jnp.concatenate([fx, zx], axis=2)
        + jnp.concatenate([zy, fy], axis=1)
        - jnp.concatenate([fy, zy], axis=1)
        + jnp.concatenate([zz, fz], axis=0)
        - jnp.concatenate([fz, zz], axis=0)
    )


def _degree3(gx, gy, gz, d, h, w):
    """Diagonal of the weighted 3-D Laplacian."""
    zx = jnp.zeros((d, h, 1), gx.dtype)
    zy = jnp.zeros((d, 1, w), gy.dtype)
    zz = jnp.zeros((1, h, w), gz.dtype)
    return (
        jnp.concatenate([gx, zx], axis=2)
        + jnp.concatenate([zx, gx], axis=2)
        + jnp.concatenate([gy, zy], axis=1)
        + jnp.concatenate([zy, gy], axis=1)
        + jnp.concatenate([gz, zz], axis=0)
        + jnp.concatenate([zz, gz], axis=0)
    )


def _coarsen_weights3(gx, gy, gz):
    """Exact Galerkin coarse conductances for 2x2x2 replication
    prolongation: sum the four fine edges crossing each coarse face."""
    # x-edges crossing coarse column boundaries sit at fine k = 1, 3, ...
    cx = gx[:, :, 1::2]                       # [d, h, w/2 - 1]
    gxc = (cx[0::2, 0::2] + cx[0::2, 1::2]
           + cx[1::2, 0::2] + cx[1::2, 1::2])
    cy = gy[:, 1::2, :]                       # [d, h/2 - 1, w]
    gyc = (cy[0::2, :, 0::2] + cy[0::2, :, 1::2]
           + cy[1::2, :, 0::2] + cy[1::2, :, 1::2])
    cz = gz[1::2, :, :]                       # [d/2 - 1, h, w]
    gzc = (cz[:, 0::2, 0::2] + cz[:, 0::2, 1::2]
           + cz[:, 1::2, 0::2] + cz[:, 1::2, 1::2])
    return gxc, gyc, gzc


def make_weighted_preconditioner_3d(d: int, h: int, w: int, gx, gy, gz,
                                    nu: int = 1):
    """Galerkin-exact V(nu, nu) cycle for the weighted Neumann lattice."""
    levels = []
    while True:
        deg = _degree3(gx, gy, gz, d, h, w)
        levels.append((gx, gy, gz, deg))
        if min(d, h, w) <= _COARSEST or d % 2 or h % 2 or w % 2:
            break
        gx, gy, gz = _coarsen_weights3(gx, gy, gz)
        d, h, w = d // 2, h // 2, w // 2

    def jacobi(x, r, lv, sweeps):
        gx_l, gy_l, gz_l, deg = lv
        dinv = _OMEGA / jnp.maximum(deg, jnp.finfo(deg.dtype).tiny)

        def sweep(x):
            return x + dinv * (
                r - weighted_laplacian_matvec_3d(x, gx_l, gy_l, gz_l)
            )

        if sweeps <= 4:
            for _ in range(sweeps):
                x = sweep(x)
            return x
        return jax.lax.fori_loop(0, sweeps, lambda _, v: sweep(v), x)

    def restrict(r):
        dd, hh, ww = r.shape
        return r.reshape(dd // 2, 2, hh // 2, 2, ww // 2, 2).sum(
            axis=(1, 3, 5)
        )

    def prolong(x):
        return jnp.repeat(
            jnp.repeat(jnp.repeat(x, 2, axis=0), 2, axis=1), 2, axis=2
        )

    def vcycle(r, i):
        lv = levels[i]
        if i == len(levels) - 1:
            x = jacobi(jnp.zeros_like(r), r - jnp.mean(r), lv,
                       _COARSE_SWEEPS)
            return x - jnp.mean(x)
        x = jacobi(jnp.zeros_like(r), r, lv, nu)
        res = r - weighted_laplacian_matvec_3d(x, lv[0], lv[1], lv[2])
        x = x + prolong(vcycle(restrict(res), i + 1))
        return jacobi(x, r, lv, nu)

    def M(r):
        out = vcycle(r, 0)
        return out - jnp.mean(out)

    return M


def weighted_lattice_solve(gx, gy, gz, b, *, tol: float = 1e-7,
                           maxiter: int | None = None, mg: bool = True):
    """Solve the weighted-lattice Neumann system ``L x = b`` (b zero-sum)
    via rank-one-regularized CG.  jit/vmap-friendly over (gx, gy, gz, b);
    the MG hierarchy is rebuilt per call from the traced weights (pure
    functions of the conductances — exactly what vmap needs).

    Differentiable with ``jax.grad`` w.r.t. every conductance and ``b``
    via an implicit-function custom VJP (same construction as the 2-D
    path, ops/grid_weighted.py): the adjoint solve reuses this solver and
    the edge cotangent is ``ḡ_e = −(x_i−x_j)(λ_i−λ_j)`` per axis.
    """

    def raw_solve(gx_, gy_, gz_, b_):
        d, h, w = b_.shape
        mean_scale = 1.0 / (d * h * w)

        def matvec(x):
            return (weighted_laplacian_matvec_3d(x, gx_, gy_, gz_)
                    + jnp.sum(x) * mean_scale)

        M = (make_weighted_preconditioner_3d(d, h, w, gx_, gy_, gz_)
             if mg else None)
        mi = maxiter if maxiter is not None else (300 if mg
                                                  else 20 * max(d, h, w))
        return cg(matvec, b_ - jnp.mean(b_), preconditioner=M, tol=tol,
                  maxiter=mi)

    @jax.custom_vjp
    def solve(gx_, gy_, gz_, b_):
        return raw_solve(gx_, gy_, gz_, b_)

    def fwd(gx_, gy_, gz_, b_):
        out = raw_solve(gx_, gy_, gz_, b_)
        return out, (gx_, gy_, gz_, out[0])

    def bwd(res, ct):
        gx_, gy_, gz_, x = res
        xbar = ct[0]  # the CGInfo cotangent is ignored (diagnostics)
        # A = L + 11ᵀ/n is symmetric and A·1 = 1, so
        # A⁻¹x̄ = A⁻¹Px̄ + mean(x̄)·1 — one more call to the same solver.
        lam = raw_solve(gx_, gy_, gz_, xbar)[0] + jnp.mean(xbar)
        gxbar = -(x[:, :, 1:] - x[:, :, :-1]) * (lam[:, :, 1:]
                                                 - lam[:, :, :-1])
        gybar = -(x[:, 1:, :] - x[:, :-1, :]) * (lam[:, 1:, :]
                                                 - lam[:, :-1, :])
        gzbar = -(x[1:, :, :] - x[:-1, :, :]) * (lam[1:, :, :]
                                                 - lam[:-1, :, :])
        # x = A⁻¹P b ⇒ b̄ = P A⁻¹ x̄ = λ − mean(λ).
        return gxbar, gybar, gzbar, lam - jnp.mean(lam)

    solve.defvjp(fwd, bwd)
    return solve(gx, gy, gz, b)


@functools.partial(jax.jit, static_argnames=("d", "h", "w", "tol"))
def weighted_equivalent_resistance_3d(d: int, h: int, w: int, gx, gy, gz,
                                      a, b, tol: float = 1e-7):
    """Two-point equivalent resistance on a weighted 3-D lattice.

    ``a``/``b`` are (layer, row, col) index triples (static or traced).
    Returns ``(R, residual)``.
    """
    rhs = (
        jnp.zeros((d, h, w), gx.dtype)
        .at[a[0], a[1], a[2]].add(1.0)
        .at[b[0], b[1], b[2]].add(-1.0)
    )
    x, info = weighted_lattice_solve(gx, gy, gz, rhs, tol=tol)
    return x[a[0], a[1], a[2]] - x[b[0], b[1], b[2]], info.residual
