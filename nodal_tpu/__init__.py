"""nodal_tpu — a JAX nodal-analysis framework for accelerators.

Same capabilities and API surface as the reference ``nodal`` package
(EnricoMiccoli/nodal): CSV netlists with R/A/E/VCVS/VCCS/CCVS/CCCS/OPMODEL
components, Modified Nodal Analysis, ``nodal-solver`` / ``nodal-resistance``
CLIs — rebuilt from scratch on JAX/XLA/Pallas: netlists compile to static
stamp tensors, systems assemble on-device with one scatter-add, and solves
run as jitted dense LU (vmap-batched for parameter sweeps) or
multigrid-preconditioned CG for large resistive grids, sharded across device
meshes for the largest systems.

Quick start (same shape as reference nodal.py:8-13):

    from nodal_tpu import Circuit, Netlist
    netlist = Netlist("path/to/netlist.csv")
    circuit = Circuit(netlist, sparse=True)
    print(circuit.solve())
"""

__version__ = "0.1.0"

from nodal_tpu.netlist import (  # noqa: F401
    Component,
    Netlist,
    NetlistError,
    UnconnectedCircuitError,
    build_opmodel,
    find_ground_node,
    is_connected,
)
from nodal_tpu.circuit import Circuit, Solution, default_dtype  # noqa: F401
from nodal_tpu.models.stamps import Quirks, compile_stamps  # noqa: F401


def enable_x64() -> None:
    """Enable float64 end to end (call before creating any arrays).

    Dense factorizations, elementwise work and the iterative solvers then
    all run in native f64; the batched sweeps keep their explicit f32
    default (``BatchedSolver(dtype=...)``).
    """
    import jax

    jax.config.update("jax_enable_x64", True)
