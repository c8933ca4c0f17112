"""Multi-host path (parallel/multihost.py): 2-process localhost
jax.distributed run building a *global* mesh and executing one sharded
batch solve (VERDICT #10 — this module previously had zero execution).

Each process owns 2 virtual CPU devices; the global mesh spans all 4.  The
batch solve is pure data parallelism, so every process verifies its own
addressable output shards against a local dense solve.
"""

import os
import socket
import subprocess
import sys

import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_WORKER = """
import sys
import numpy as np
import os

import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

coordinator, pid = sys.argv[1], int(sys.argv[2])

from nodal_tpu.parallel import multihost

multihost.initialize(coordinator_address=coordinator, num_processes=2,
                     process_id=pid)
assert jax.process_count() == 2, jax.process_count()
assert len(jax.devices()) == 4, len(jax.devices())  # 2 local x 2 processes

mesh = multihost.global_mesh()
assert mesh.devices.size == 4

from nodal_tpu import Circuit, Netlist
from nodal_tpu.parallel.sharded import make_sharded_batch_solver
from nodal_tpu.utils.gridgen import ladder_rows
import jax.numpy as jnp

circuit = Circuit(Netlist.from_rows(ladder_rows(16)))
stamps = circuit.stamps
solver = make_sharded_batch_solver(stamps, mesh, dtype=jnp.float64)

B = 8
rng = np.random.default_rng(0)
batch = stamps.params * (1.0 + 0.1 * rng.standard_normal((B, len(stamps.params))))

with mesh:
    xs = solver(jnp.asarray(batch))

# Verify the shards this process owns against a local dense solve.
from nodal_tpu.ops.assemble import assemble_dense

checked = 0
for shard in xs.addressable_shards:
    rows = range(shard.index[0].start or 0,
                 shard.index[0].stop if shard.index[0].stop is not None else B)
    local = np.asarray(shard.data)
    for k, i in enumerate(rows):
        G, b = assemble_dense(stamps, jnp.asarray(batch[i], dtype=jnp.float64))
        expected = np.linalg.solve(np.asarray(G), np.asarray(b))
        np.testing.assert_allclose(local[k], expected, rtol=1e-8, atol=1e-12)
        checked += 1
assert checked > 0
print(f"MULTIHOST_OK process={pid} checked={checked}", flush=True)
"""


def test_two_process_distributed_batch_solve(tmp_path):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    coordinator = f"127.0.0.1:{port}"

    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("NODAL_TPU_TEST_PLATFORM", None)

    procs = [
        subprocess.Popen(
            [sys.executable, "-c", _WORKER, coordinator, str(pid)],
            cwd=_REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True,
        )
        for pid in (0, 1)
    ]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=240)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()

    for rc, out, err in outs:
        assert rc == 0, f"worker failed:\n{err[-3000:]}"
        assert "MULTIHOST_OK" in out
