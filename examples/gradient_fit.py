"""Gradient-based circuit design: fit component values to a voltage target.

Every BatchedSolver is differentiable with ``jax.grad`` — reverse mode
runs one *adjoint solve* per backward pass through the same kernels
as the forward solve (see BatchedSolver._finalize, nodal_tpu/batch.py).
The reference framework (numpy/scipy solves) has no gradient capability;
this is what a native JAX compute path buys.

Here: a 64-node resistor ladder driven by a current source.  We perturb
every resistor, then recover values that reproduce the original node
voltages by minimizing an L2 loss with optax.adam — solver, loss,
gradient, and update step all compile into one jitted program.

Run:  python examples/gradient_fit.py        (any JAX platform; ~seconds)
"""

import os
import sys

import numpy as np

# Allow running as `python examples/gradient_fit.py` from a source
# checkout without installation.
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main(argv=None):
    import jax
    import jax.numpy as jnp
    import optax

    from nodal_tpu import Circuit, Netlist
    from nodal_tpu.batch import BatchedSolver
    from nodal_tpu.utils.gridgen import ladder_rows

    circuit = Circuit(Netlist.from_rows(ladder_rows(64)))
    solver = BatchedSolver(circuit)  # tridiag PCR path, f32
    nominal = jnp.asarray(circuit.stamps.params, jnp.float32)

    # Target: the voltage profile of the nominal design.
    target = solver._solve(nominal[None, :])[0]

    # Start from a 30%-perturbed design; optimize log-values so the
    # resistances stay positive.
    rng = np.random.default_rng(0)
    z0 = jnp.log(nominal * jnp.asarray(
        rng.uniform(0.7, 1.3, nominal.shape), jnp.float32))

    def loss(z):
        x = solver._solve(jnp.exp(z)[None, :])[0]
        return jnp.mean((x - target) ** 2)

    opt = optax.adam(3e-2)

    @jax.jit
    def step(z, state):
        val, grad = jax.value_and_grad(loss)(z)
        updates, state = opt.update(grad, state)
        return optax.apply_updates(z, updates), state, val

    z, state = z0, opt.init(z0)
    l0 = float(loss(z0))
    for i in range(400):
        z, state, val = step(z, state)
    l1 = float(val)
    err = float(jnp.max(jnp.abs(solver._solve(jnp.exp(z)[None, :])[0]
                                - target)))
    print(f"loss {l0:.3e} -> {l1:.3e} after 400 adam steps "
          f"(max node-voltage error {err:.2e} V)")
    assert l1 < 1e-9 * max(l0, 1e-30) or l1 < 1e-10, (l0, l1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
