"""Explicit-collective grid CG: shard_map + ppermute halo exchange.

The hand-scheduled counterpart to the GSPMD path
(:mod:`nodal_tpu.parallel.sharded`).  The grid's row (node) axis is sharded
over the ``sp`` mesh axis; each step of the 5-point stencil exchanges one
boundary row with each neighbor via ``lax.ppermute`` (NCCL over NVLink
on GPUs), and the CG dot products psum over ``sp``.  Everything else is
local elementwise work, so the communication volume per iteration is
2·W elements + 3 scalar all-reduces — the textbook halo-exchange CG.

Useful when the GSPMD partitioner's choices need overriding.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from nodal_tpu.ops.cg import cg


def _exchange_halos(x, sp: int, axis: str = "sp"):
    """Fetch the last row of the previous shard and the first row of the
    next shard; replicate own boundary rows at the global edges (matching
    the edge-replicate Neumann stencil in ops.grid)."""
    idx = jax.lax.axis_index(axis)
    fwd = [(i, i + 1) for i in range(sp - 1)]  # shard i -> shard i+1
    bwd = [(i + 1, i) for i in range(sp - 1)]  # shard i+1 -> shard i
    from_above = jax.lax.ppermute(x[-1:, :], axis, fwd)
    from_below = jax.lax.ppermute(x[:1, :], axis, bwd)
    top = jnp.where(idx == 0, x[:1, :], from_above)
    bottom = jnp.where(idx == sp - 1, x[-1:, :], from_below)
    return top, bottom


def halo_laplacian_matvec(x, sp: int, axis: str = "sp", weight: float = 1.0):
    """Local block of ``L x`` for a row-sharded grid field.

    ``x`` is the local [H/sp, W] block.  Vertical neighbors across the shard
    boundary come from ppermute; horizontal neighbors are local
    edge-replicate padding.
    """
    top, bottom = _exchange_halos(x, sp, axis)
    xv = jnp.concatenate([top, x, bottom], axis=0)  # [hl+2, W]
    xp = jnp.pad(xv, ((0, 0), (1, 1)), mode="edge")
    nbr = xp[:-2, 1:-1] + xp[2:, 1:-1] + xp[1:-1, :-2] + xp[1:-1, 2:]
    return weight * (4.0 * x - nbr)


# -- sharded multigrid --------------------------------------------------------

#: Gather the (tiny) coarse field onto every shard once its local row count
#: would drop below this: the remaining levels run redundantly-replicated,
#: which is far cheaper than halo exchanges on slivers.
_GATHER_ROWS = 16


def _fold_cols_restrict(f):
    """Column half of the bilinear restriction, local to a shard (full
    width is resident): weights 3/4, 3/4, 1/4, 1/4 with edge fold-back —
    the transpose of grid._prolong_bilinear's column pass."""
    a = 0.75 * (f[:, 0::2] + f[:, 1::2])
    fp = jnp.pad(f, ((0, 0), (1, 1)))
    out = a + 0.25 * (fp[:, 0:-2:2] + fp[:, 3::2])
    return out.at[:, 0].add(0.25 * f[:, 0]).at[:, -1].add(0.25 * f[:, -1])


def _expand_cols_prolong(x):
    """Column half of the bilinear prolongation (edge-replicated)."""
    xp = jnp.pad(x, ((0, 0), (1, 1)), mode="edge")
    left = 0.75 * xp[:, 1:-1] + 0.25 * xp[:, :-2]
    right = 0.75 * xp[:, 1:-1] + 0.25 * xp[:, 2:]
    return jnp.stack([left, right], axis=2).reshape(x.shape[0],
                                                    2 * x.shape[1])


def halo_restrict_bilinear(r, sp: int, axis: str = "sp"):
    """Bilinear restriction of a row-sharded field: local [hl, W] ->
    [hl/2, W/2].  The quarter weights reach one fine row past the shard,
    supplied by the same halo exchange the stencil uses; at the global
    edges the replicated halo row IS the fold-back, so boundary handling
    matches grid._restrict_bilinear exactly."""
    top, bottom = _exchange_halos(r, sp, axis)
    rv = jnp.concatenate([top, r, bottom], axis=0)  # local row i = rv[i+1]
    rows = (
        0.75 * (r[0::2, :] + r[1::2, :])
        + 0.25 * (rv[0:-2:2, :] + rv[3::2, :])
    )
    return _fold_cols_restrict(rows)


def halo_prolong_bilinear(xc, sp: int, axis: str = "sp"):
    """Bilinear prolongation of a row-sharded coarse field: local
    [hlc, Wc] -> [2*hlc, 2*Wc]; shard-crossing quarter weights come from
    the coarse halo exchange (global edges replicate = fold)."""
    top, bottom = _exchange_halos(xc, sp, axis)
    xv = jnp.concatenate([top, xc, bottom], axis=0)
    up = 0.75 * xv[1:-1, :] + 0.25 * xv[:-2, :]
    dn = 0.75 * xv[1:-1, :] + 0.25 * xv[2:, :]
    rows = jnp.stack([up, dn], axis=1).reshape(2 * xc.shape[0], xc.shape[1])
    return _expand_cols_prolong(rows)


def make_halo_mg_preconditioner(h: int, w: int, sp: int, *,
                                omega: float = 0.8, nu: int = 1,
                                coarse_sweeps: int = 96,
                                coarsest: int = 8, axis: str = "sp"):
    """Sharded geometric multigrid V(nu, nu) cycle (bilinear transfers,
    same-weight coarse operators — grid.make_mg_preconditioner's cycle,
    SPMD-ified).  Returns ``M(r_local) -> z_local`` for use inside
    shard_map.

    Fine levels smooth with the halo-exchange stencil and restrict/prolong
    with halo'd bilinear transfers; once a level's local row count drops
    below ``_GATHER_ROWS`` the field is ``all_gather``-ed and the rest of
    the hierarchy runs replicated on every shard (coarse-grid
    agglomeration — slivers are latency, not work).
    """
    from nodal_tpu.ops.grid import (_prolong_bilinear, _restrict_bilinear,
                                    laplacian_matvec)

    def local_sweep(x, r, sweeps):
        for _ in range(sweeps):
            res = r - halo_laplacian_matvec(x, sp, axis)
            x = x + (omega / 4.0) * res
        return x

    def replicated_vcycle(r):
        hh, ww = r.shape
        if min(hh, ww) <= coarsest or hh % 2 or ww % 2:
            def body(_, x):
                res = (r - jnp.mean(r)) - laplacian_matvec(x, 1.0)
                return x + (omega / 4.0) * res

            x = jax.lax.fori_loop(0, coarse_sweeps, body, jnp.zeros_like(r))
            return x - jnp.mean(x)
        x = jnp.zeros_like(r)
        for _ in range(nu):
            x = x + (omega / 4.0) * (r - laplacian_matvec(x, 1.0))
        res = r - laplacian_matvec(x, 1.0)
        x = x + _prolong_bilinear(replicated_vcycle(_restrict_bilinear(res)))
        for _ in range(nu):
            x = x + (omega / 4.0) * (r - laplacian_matvec(x, 1.0))
        return x

    def vcycle(r, hh, ww):
        hl = hh // sp
        if hl < _GATHER_ROWS or hh % (2 * sp) or ww % 2 or hl % 2:
            # Agglomerate: gather the full (small) field, finish locally.
            full = jax.lax.all_gather(r, axis, axis=0).reshape(hh, ww)
            z = replicated_vcycle(full)
            idx = jax.lax.axis_index(axis)
            return jax.lax.dynamic_slice_in_dim(z, idx * hl, hl, axis=0)
        x = local_sweep(jnp.zeros_like(r), r, nu)
        res = r - halo_laplacian_matvec(x, sp, axis)
        zc = vcycle(halo_restrict_bilinear(res, sp, axis), hh // 2, ww // 2)
        x = x + halo_prolong_bilinear(zc, sp, axis)
        return local_sweep(x, r, nu)

    n_total = h * w

    def M(r):
        out = vcycle(r, h, w)
        gmean = jax.lax.psum(jnp.sum(out), axis) / n_total
        return out - gmean

    return M


def make_halo_grid_solver(
    h: int,
    w: int,
    mesh: Mesh,
    *,
    dtype=jnp.float32,
    tol: float = 1e-6,
    maxiter: int | None = None,
    mg: bool = True,
):
    """Compile a batched grid solver with explicit collectives.

    Input ``b_batch [B, H, W]`` is sharded ``P('dp', 'sp', None)``: batches
    over dp, grid rows over sp.  Returns ``(x_batch, residuals)``.

    ``mg=True`` preconditions with the sharded bilinear multigrid cycle
    (:func:`make_halo_mg_preconditioner`) — same single-digit CG iteration
    counts as the single-device solver (ops.grid), with ppermute halo
    exchanges per level and one all_gather at the agglomerated coarse
    levels.  ``mg=False`` is the plain halo CG (the round-1 demo path).
    """
    sp = mesh.shape["sp"]
    if h % sp:
        raise ValueError(f"grid rows {h} not divisible by sp={sp}")
    n_total = h * w
    if maxiter is not None:
        iters = maxiter
    else:
        iters = 100 if mg else 20 * max(h, w)
    M = make_halo_mg_preconditioner(h, w, sp) if mg else None

    def solve_one(b_local):
        # b_local: [H/sp, W] — one system's local row block.
        def matvec(x):
            lap = halo_laplacian_matvec(x, sp)
            gmean = jax.lax.psum(jnp.sum(x), "sp") / n_total
            return lap + gmean

        gmean_b = jax.lax.psum(jnp.sum(b_local), "sp") / n_total
        x, info = cg(
            matvec,
            b_local - gmean_b,
            preconditioner=M,
            tol=tol,
            maxiter=iters,
            axis_names=("sp",),
            # The dp groups solve independent batches but share the SPMD
            # program: loop trip counts must agree or a group exiting the
            # collective-bearing loop early deadlocks the others.
            cond_axis_names=("dp",),
        )
        return x, info.residual, info.iterations

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P("dp", "sp", None),),
        out_specs=(P("dp", "sp", None), P("dp"), P("dp")),
        check_vma=False,
    )
    def solve_local(b_block):
        # b_block: [B/dp, H/sp, W]
        return jax.vmap(solve_one)(b_block)

    def solver(b_batch):
        x, res, its = jax.jit(solve_local)(jnp.asarray(b_batch, dtype=dtype))
        return x, res, its

    return solver
