"""Sharded solvers over a device mesh.

The batched solve shards its batch axis across the whole mesh (pure data
parallelism — zero communication, shard_map over BatchedSolver's tier), and
the GSPMD grid solve shards the *node axis* (grid rows) so one huge system
spans chips; XLA's SPMD partitioner turns the stencil's pad/slice ops into
halo exchanges and the CG dot products into ``all-reduce``s over the device
interconnect automatically.

For the explicit hand-written collective variant (ppermute halo exchange
inside shard_map), see :mod:`nodal_tpu.parallel.halo`.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from nodal_tpu.models.stamps import StampTensors
from nodal_tpu.ops.grid import grid_solve


def make_sharded_batch_solver(
    stamps: StampTensors, mesh: Mesh, *, dtype=jnp.float32,
    refine: bool = False, interpret: bool = False,
):
    """Compile a batch solver whose batch axis is sharded over every mesh
    axis (dp × sp treated as one data-parallel pool).

    The tiers are :class:`nodal_tpu.batch.BatchedSolver`'s own — the same
    structure-based choice, with the scalar-band kernel where the program
    is lowered for GPUs.  Its per-batch solve is wrapped in ``shard_map``
    over the batch axis, so each device solves its local shard with zero
    communication (a pallas_call is an opaque custom call GSPMD cannot
    partition).  ``refine`` is BatchedSolver's (``True``: f64 defect
    correction); ``interpret=True`` runs the kernel in the Pallas
    interpreter (tests on virtual CPU devices).

    The returned solver is differentiable with ``jax.grad`` — the adjoint
    solve runs over the same sharded kernels (see batch.make_adjoint_solver).

    Returns a function ``params_batch [B, n_components] -> solutions [B, n]``
    with B divisible by the mesh size.
    """
    from jax import shard_map

    from nodal_tpu.batch import BatchedSolver, make_adjoint_solver

    local_fwd, local_t = BatchedSolver(
        stamps, dtype=dtype, refine=refine, interpret=interpret).solve_pair
    spec = P(("dp", "sp"), None)
    solve_batch = shard_map(local_fwd, mesh=mesh, in_specs=spec,
                            out_specs=spec, check_vma=False)
    # Adjoint pass: the same per-device solve against the sharded cotangent
    # (resistive tiers are symmetric; the Schur tiers swap their border
    # blocks — see batch._make_schur_band_solver).
    solve_rhs_t = shard_map(local_t, mesh=mesh, in_specs=(spec, spec),
                            out_specs=spec, check_vma=False)
    sharding = NamedSharding(mesh, spec)
    return jax.jit(make_adjoint_solver(stamps, solve_batch, solve_rhs_t),
                   in_shardings=sharding, out_shardings=sharding)


def make_sharded_grid_solver(
    h: int,
    w: int,
    mesh: Mesh,
    *,
    dtype=jnp.float32,
    tol: float = 1e-6,
    maxiter: int | None = None,
    mg: bool = True,
):
    """Compile a batched grid solver with 2D sharding: the batch of systems
    over ``dp``, each system's row (node) axis over ``sp``.

    Returns ``b_batch [B, H, W] -> (x_batch [B, H, W], residuals [B],
    iterations [B])``, the same triple as the halo solver
    (:func:`nodal_tpu.parallel.halo.make_halo_grid_solver`).
    """
    in_sharding = NamedSharding(mesh, P("dp", "sp", None))
    out_sharding = (
        NamedSharding(mesh, P("dp", "sp", None)),
        NamedSharding(mesh, P("dp")),
        NamedSharding(mesh, P("dp")),
    )

    def single(b):
        x, info = grid_solve(h, w, b, dtype=dtype, tol=tol, maxiter=maxiter,
                             mg=mg)
        return x, info.residual, info.iterations

    return jax.jit(
        jax.vmap(single), in_shardings=(in_sharding,), out_shardings=out_sharding
    )
