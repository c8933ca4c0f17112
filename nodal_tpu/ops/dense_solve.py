"""Dense MNA solves: jitted pivoted LU.

Replaces LAPACK ``dgesv`` reached through ``np.linalg.solve`` in the
reference (reference nodal.py:327).  The accelerator factors in the
requested dtype (f64 LU is native on the GPU); pathologically conditioned
systems that fail the residual gate fall back to a native f64 LU on the
host CPU backend (:func:`solve_on_cpu`).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


def solve_dense(G, b):
    """Plain jitted dense solve in the dtype of ``G`` (vmap-friendly).

    Traced under 'highest' matmul precision: the LU's inner products would
    otherwise run in TF32 for f32 inputs on the GPU (about three decimal
    digits).
    """
    with jax.default_matmul_precision("highest"):
        return jnp.linalg.solve(G, b)


@functools.cache
def _cpu_device():
    return jax.devices("cpu")[0]


def solve_on_cpu(G, b):
    """Native f64 LU on the host CPU backend (for ill-conditioned systems
    whose accelerator solve failed the residual gate)."""
    cpu = _cpu_device()
    G_h = jax.device_put(jnp.asarray(G, dtype=jnp.float64), cpu)
    b_h = jax.device_put(jnp.asarray(b, dtype=jnp.float64), cpu)
    with jax.default_device(cpu):
        return jnp.linalg.solve(G_h, b_h)
