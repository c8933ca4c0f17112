"""Matrix-free preconditioned Krylov solvers (CG / BiCGStab).

Replaces SuperLU reached through ``scipy.sparse.linalg.spsolve`` in the
reference (reference nodal.py:325) with accelerator-friendly iterative
methods: everything is elementwise + matvec, so it runs in f64 or f32,
jits into a single ``lax.while_loop``, and composes with ``vmap``
and ``shard_map`` (the matvec closure may contain collectives).

CG is used for SPD systems — the grounded-Laplacian systems of purely
resistive networks (reference equiv.py guards that exact case).  General MNA
systems (voltage/controlled sources make G indefinite and asymmetric) go
through BiCGStab.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp


class SolveInfo(NamedTuple):
    residual: jax.Array  # final relative residual (scalar)
    iterations: jax.Array  # iterations executed (scalar int)
    converged: jax.Array  # bool scalar


def _identity(x):
    return x


def cg(
    matvec: Callable,
    b,
    x0=None,
    *,
    preconditioner: Callable | None = None,
    tol: float = 1e-9,
    maxiter: int | None = None,
    axis_names=None,
    cond_axis_names=None,
):
    """Preconditioned conjugate gradient for SPD operators.

    ``matvec``/``preconditioner`` are closures over any array shape — a flat
    vector, a 2D grid field, or a *local shard* inside ``shard_map``.  In
    the latter case pass ``axis_names`` (e.g. ``("sp",)``): dot products are
    then ``psum``-reduced across those mesh axes, so the whole loop runs
    SPMD with the matvec's own halo exchange as the only other communication.
    Returns ``(x, SolveInfo)``.

    ``cond_axis_names``: extra mesh axes over which the loop-exit decision
    must AGREE.  When independent problems run on disjoint device groups
    (e.g. batches over ``dp``) but the loop body contains collectives, a
    group exiting early deadlocks the others' rendezvous — every device in
    the launch must execute the same collective sequence.  Groups that are
    already converged keep iterating harmlessly until the slowest one
    finishes (denominators are exact-zero-guarded).

    Convergence: ||r||_2 <= tol * ||b||_2, capped at ``maxiter``.
    """
    M = preconditioner or _identity
    if x0 is None:
        x0 = jnp.zeros_like(b)
    if maxiter is None:
        maxiter = 10 * _size(b)

    def dot(u, v):
        d = jnp.vdot(u, v, precision=jax.lax.Precision.HIGHEST)
        if axis_names:
            d = jax.lax.psum(d, axis_names)
        return d

    def safe_div(num, den):
        return num / jnp.where(den == 0, 1.0, den)

    b_norm2 = dot(b, b)
    atol2 = (tol * tol) * jnp.maximum(b_norm2, jnp.finfo(b.dtype).tiny)

    r0 = b - matvec(x0)
    z0 = M(r0)
    state = (x0, r0, z0, z0, dot(r0, z0), jnp.array(0, jnp.int32))

    def cond(state):
        _, r, *_rest, k = state
        unconverged = dot(r, r) > atol2
        if cond_axis_names:
            unconverged = (
                jax.lax.psum(unconverged.astype(jnp.float32),
                             cond_axis_names) > 0
            )
        return jnp.logical_and(unconverged, k < maxiter)

    def body(state):
        x, r, z, p, rz, k = state
        Ap = matvec(p)
        alpha = safe_div(rz, dot(p, Ap))
        x = x + alpha * p
        r = r - alpha * Ap
        z = M(r)
        rz_new = dot(r, z)
        p = z + safe_div(rz_new, rz) * p
        return (x, r, z, p, rz_new, k + 1)

    x, r, *_, k = jax.lax.while_loop(cond, body, state)
    res = jnp.sqrt(dot(r, r) / jnp.maximum(b_norm2, jnp.finfo(b.dtype).tiny))
    return x, SolveInfo(residual=res, iterations=k, converged=res <= tol)


def bicgstab(
    matvec: Callable,
    b,
    x0=None,
    *,
    preconditioner: Callable | None = None,
    tol: float = 1e-9,
    maxiter: int | None = None,
):
    """Preconditioned BiCGStab for general (nonsymmetric) operators.

    Used for MNA systems that contain branch equations.  Same interface as
    :func:`cg`.
    """
    M = preconditioner or _identity
    if x0 is None:
        x0 = jnp.zeros_like(b)
    if maxiter is None:
        maxiter = 10 * _size(b)

    def dot(u, v):
        return jnp.vdot(u, v, precision=jax.lax.Precision.HIGHEST)

    b_norm2 = dot(b, b)
    atol2 = (tol * tol) * jnp.maximum(b_norm2, jnp.finfo(b.dtype).tiny)
    eps = jnp.finfo(b.dtype).tiny

    r0 = b - matvec(x0)
    rhat = r0
    one = jnp.ones((), b.dtype)
    state = (
        x0, r0, jnp.zeros_like(b), jnp.zeros_like(b), one, one, one,
        jnp.array(0, jnp.int32), jnp.array(False),
    )
    # state: x, r, p, v, rho, alpha, omega, k, breakdown

    def cond2(state):
        _, r, _p, _v, _rho, _a, _w, k, brk = state
        return jnp.logical_and(
            jnp.logical_and(dot(r, r) > atol2, k < maxiter),
            jnp.logical_not(brk),
        )

    def body2(state):
        x, r, p, v, rho, alpha, omega, k, _ = state
        rho_new = dot(rhat, r)
        breakdown = jnp.abs(rho_new) < eps
        beta = (rho_new / _safe(rho, eps)) * (alpha / _safe(omega, eps))
        p = r + beta * (p - omega * v)
        phat = M(p)
        v = matvec(phat)
        alpha = rho_new / _safe(dot(rhat, v), eps)
        s = r - alpha * v
        shat = M(s)
        t = matvec(shat)
        tt = dot(t, t)
        omega = dot(t, s) / _safe(tt, eps)
        x = x + alpha * phat + omega * shat
        r = s - omega * t
        return (x, r, p, v, rho_new, alpha, omega, k + 1, breakdown)

    x, r, *_, k, _brk = jax.lax.while_loop(cond2, body2, state)
    res = jnp.sqrt(dot(r, r) / jnp.maximum(b_norm2, jnp.finfo(b.dtype).tiny))
    return x, SolveInfo(residual=res, iterations=k, converged=res <= tol)


def _safe(x, eps):
    return jnp.where(jnp.abs(x) < eps, jnp.where(x < 0, -eps, eps), x)


def _size(b) -> int:
    return int(b.size)
