"""Device-mesh helpers.

The reference is strictly single-process (SURVEY.md §2.5); scaling here is
expressed the JAX way — ``jax.sharding.Mesh`` + sharding annotations,
with XLA emitting the collectives — never hand-written communication
backends.

Axis conventions used across nodal_tpu:

* ``"dp"`` — data parallel: independent systems (Monte Carlo samples,
  parameter-sweep batches) sharded across devices.
* ``"sp"`` — system parallel (the framework's sequence/context-parallel
  analogue, SURVEY.md §5.7): the *node axis* of one large system sharded
  across devices — grid rows for the stencil path.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh


def make_mesh(n_devices: int | None = None, sp: int | None = None,
              devices=None) -> Mesh:
    """A (dp, sp) mesh over the first ``n_devices`` devices.

    ``sp`` defaults to the largest power of two ≤ 4 dividing the device
    count — enough system-parallel width to exercise halo exchange while
    keeping data parallelism available.  Pass ``devices`` explicitly to
    build over a specific backend's devices (e.g. virtual CPU devices when
    another platform is the default).
    """
    if devices is None:
        devices = jax.devices()
    devices = devices[: n_devices or len(devices)]
    n = len(devices)
    if sp is None:
        sp = 1
        for cand in (2, 4):
            if n % cand == 0:
                sp = cand
    if n % sp:
        raise ValueError(f"sp={sp} does not divide device count {n}")
    dp = n // sp
    return Mesh(np.asarray(devices).reshape(dp, sp), ("dp", "sp"))
