"""Multi-host initialization (SURVEY.md §2.5: the reference has no
distributed story; ours is jax.distributed + global meshes).

Single-host multi-device needs nothing from this module — ``make_mesh``
over ``jax.devices()`` covers it.  Multi-host runs require every process
to call :func:`initialize` before any jax computation, then build meshes
over the *global* device list; GSPMD then emits collectives within a host
and across hosts, with no user-visible difference in the solver code.
"""

from __future__ import annotations

import jax

from nodal_tpu.parallel.mesh import make_mesh


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """Initialize jax.distributed for a multi-host run.

    With no arguments, defers to cluster auto-detection (which works only
    where the cluster environment publishes the coordination variables;
    elsewhere pass all three).  Call exactly once per process, before
    creating arrays.
    """
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def global_mesh(sp: int | None = None):
    """A (dp, sp) mesh spanning every device in the job (all hosts)."""
    return make_mesh(len(jax.devices()), sp=sp)
