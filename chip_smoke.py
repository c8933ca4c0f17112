"""Drive nodal_tpu's main path once on the GPU and check every result.

    python chip_smoke.py               # one GPU: every phase below
    python chip_smoke.py --four-cards  # four GPUs: the sharded paths only

Phases, in order, each printing one line — its name, the platform of the
device its result lives on, cold (first call, compile included) and warm
seconds, and its error against a plain host f64 reference with the limit
it is held to:

1. device: JAX must see a GPU; prints jax, the device kind and nvidia-smi.
2. batched: BatchedSolver sweeps at B=1024 on the four batched tiers —
   1k-node ladder (tridiag), 25×40 mesh (sband), 100×100 mesh (band),
   1k-node mesh with an E and a VCCS (schur) — each as f32 raw, f32 with
   the default 1e-6 contract, and f64.  Every sample is audited with the
   f64 COO residual; 16 sampled rows are compared with a host f64 solve.
3. monte_carlo: 10,000 samples on the 256-node ladder, 4,096 on the mesh.
4. gradient: jax.grad through BatchedSolver on the mesh at B=1024 against
   dense f64 autodiff on the host; then the f64 adjoint APIs
   (``sensitivities``, ``resistance_sensitivities``) on the same mesh,
   where the placement policy serves them and placed on the GPU.
5. grid: 1024×1024 unit-resistor grid, knight's-move resistance by
   multigrid CG, against scipy's sparse direct solve.
6. one-shot: Circuit.solve() on a 4.5k-unknown branch circuit (dense f64
   LU on the card) and ``nodal-solver -s`` on a 40k-node general netlist;
   both print the tier and the device that served them.

Any failed check raises, so the script exits non-zero and prints no
result line.  The last line is one JSON object naming the device.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

#: Error limits, each a small factor above its reading on an H100 (NVIDIA
#: H100 80GB HBM3; PERF.md), with its reason.  Relative max-norm error
#: against the host f64 reference unless stated.
LIMITS = {
    # f32 raw tiers: a backward-stable f32 solve leaves an error of about
    # eps32 · cond, and cond grows with the mesh, so each circuit has its
    # own limit.  Readings: ladder 1.3e-7, 25×40 mesh 3.4e-5, 100×100 mesh
    # 2.5e-4 (cond ~1e4: 1e-4 is below what f32 can give there), 1k branch
    # mesh 1.7e-5.
    "f32_raw": {"ladder": 5e-7, "mesh": 1e-4, "big_mesh": 5e-4,
                "branch": 5e-5},
    # Their backward error (relative COO residual): readings 2.8e-7 to
    # 7.0e-6, i.e. up to ~60 · eps32.
    "f32_residual": 1e-5,
    # refine="auto" defect-corrects until its predicted error is under the
    # package's 1e-6 contract, so the contract itself is the limit
    # (readings 2e-14 to 1.2e-7).
    "contract": 1e-6,
    # The contract tier's gradient comes back in the parameters' dtype
    # (f32), so f32 rounding of the cotangent adds ~1e-7 (readings 7.9e-7 and
    # 8.5e-7).
    "gradient": 3e-6,
    # f64 tiers solve directly in f64: readings 1.6e-16 to 3.0e-13 (the
    # 100×100 mesh, cond ~1e4).
    "f64": 1e-11,
    # f64 adjoint sensitivities against dense f64 autodiff.
    "sensitivity": 1e-11,
    # Multigrid CG stops at a 1e-6 relative residual: reading 1.05e-7.
    "grid": 1e-6,
    # Four cards against one: two CG runs to the same 1e-6 residual with
    # different reduction orders (readings 4.1e-7 halo, 5.4e-7 GSPMD).
    "sharded_grid": 2e-6,
    # Four cards against one on the batched tiers: each card runs the
    # one-card solve on its shard, and they agreed bit for bit (reading 0);
    # the limit leaves room for a different per-shard reduction order.
    "sharded_batch": 1e-6,
    # One-shot f64 solves (error, and the CLI's relative COO residual):
    # readings 3.4e-13 (dense LU, n=4501) and 1.8e-14.
    "oneshot": 1e-11,
}

FULL = {
    "batch": 1024,
    "ladder": 1000,
    "mesh": (25, 40),
    "big_mesh": (100, 100),
    "branch": 1000,
    "mc_ladder": 256,
    "mc_samples": 10_000,
    "mc_mesh_samples": 4096,
    "grid": 1024,
    "oneshot_branch": 4500,
    "cli_nodes": 40_000,
    "cli_h": 100,
    "rows": 16,
    "sharded_batch": 4096,
    # The tier each batched circuit must select.
    "tiers": {"ladder": "tridiag", "mesh": "sband", "big_mesh": "band",
              "branch": "schur"},
}


def _line(name, platform, cold, warm, err, limit, extra=""):
    print(f"{name:<26} platform={platform:<4} cold_s={cold:9.3f} "
          f"warm_s={warm:9.5f} err={err:.2e} limit={limit:.0e} {extra}",
          flush=True)


def _check(name, err, limit):
    if not np.isfinite(err) or err > limit:
        raise AssertionError(f"{name}: error {err:.3e} exceeds {limit:.0e}")


def _platform(x) -> str:
    return next(iter(x.devices())).platform


def _timed(fn, *args):
    """(result, cold seconds, warm seconds): the first call compiles."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    return out, cold, time.perf_counter() - t0


def _circuits(cfg):
    import bench

    return {
        "ladder": bench._ladder_circuit(cfg["ladder"]),
        "mesh": _mesh(*cfg["mesh"]),
        "big_mesh": _mesh(*cfg["big_mesh"]),
        "branch": bench._branch_circuit(cfg["branch"]),
    }


def _mesh(h, w, source=True):
    from nodal_tpu import Circuit, Netlist
    from nodal_tpu.utils.gridgen import grid_rows

    rows = list(grid_rows(h, w, (0, 0), (h - 1, w - 1)))
    if source:
        rows.append(["src", "A", "1", "1", "g"])
    return Circuit(Netlist.from_rows(rows))


def _perturbed(stamps, batch, seed):
    """[batch, n_params] draws, exactly representable in f32 so the f32 and
    f64 runs and the host reference all see the same values."""
    rng = np.random.default_rng(seed)
    p = stamps.params * (1.0 + 0.05 * rng.standard_normal(
        (batch, len(stamps.params))))
    return p.astype(np.float32).astype(np.float64)


def _host_solve(stamps, params):
    """Plain host f64 reference: numpy.linalg.solve on the dense MNA matrix,
    or scipy's sparse direct solve past 4096 unknowns (a dense f64 LU of a
    10k system costs seconds per row)."""
    import scipy.sparse as sps
    import scipy.sparse.linalg as spla

    from nodal_tpu.models.stamps import stamp_values_np

    g, r = stamp_values_np(stamps, params)
    b = np.zeros(stamps.n)
    np.add.at(b, stamps.rhs_rows, r)
    if stamps.n <= 4096:
        G = np.zeros((stamps.n, stamps.n))
        np.add.at(G, (stamps.g_rows, stamps.g_cols), g)
        return np.linalg.solve(G, b)
    G = sps.coo_matrix((g, (stamps.g_rows, stamps.g_cols)),
                       shape=(stamps.n, stamps.n)).tocsc()
    return spla.spsolve(G, b)


def _rel_err(got, want):
    got = np.asarray(got, np.float64)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _coo_residual(stamps, params, x):
    from nodal_tpu.models.stamps import stamp_values_np

    g, r = stamp_values_np(stamps, params)
    b = np.zeros(stamps.n)
    np.add.at(b, stamps.rhs_rows, r)
    y = np.zeros(stamps.n)
    np.add.at(y, stamps.g_rows, g * x[stamps.g_cols])
    return float(np.max(np.abs(b - y)) / max(np.max(np.abs(b)), 1.0))


# -- phases ----------------------------------------------------------------


def phase_device(require: str | None = "gpu", count: int = 1):
    """Fail unless JAX's default backend is ``require`` with ``count``
    devices; print jax's version, the device kind and nvidia-smi's card
    name and power limit.  Returns the device record for the last line."""
    import jax

    backend = jax.default_backend()
    devs = jax.devices()
    if require is not None and backend != require:
        raise SystemExit(f"chip_smoke: JAX found no {require.upper()} "
                         f"(default backend: {backend}); nothing was run")
    if len(devs) < count:
        raise SystemExit(f"chip_smoke: needs {count} devices, JAX sees "
                         f"{len(devs)}")
    print(f"jax {jax.__version__} backend={backend} "
          f"device_kind={devs[0].device_kind} count={len(devs)}", flush=True)
    if require == "gpu":
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60)
        print(smi.stdout.strip(), flush=True)
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def phase_batched(cfg):
    """BatchedSolver on every batched tier, f32 raw / f32 contract / f64."""
    import jax.numpy as jnp

    from nodal_tpu.batch import BatchedSolver

    platforms = set()
    for key, c in _circuits(cfg).items():
        st = c.stamps
        P = _perturbed(st, cfg["batch"], seed=1)
        rows = np.random.default_rng(2).choice(
            cfg["batch"], min(cfg["rows"], cfg["batch"]), replace=False)
        ref = np.stack([_host_solve(st, P[i]) for i in rows])
        variants = (
            ("f32-raw", jnp.float32, False, LIMITS["f32_raw"][key],
             LIMITS["f32_residual"]),
            ("f32-contract", jnp.float32, "auto", LIMITS["contract"],
             LIMITS["contract"]),
            ("f64", jnp.float64, "auto", LIMITS["f64"], LIMITS["f64"]))
        for tag, dtype, refine, limit, res_limit in variants:
            t0 = time.perf_counter()
            solver = BatchedSolver(c, dtype=dtype, refine=refine)
            plan_s = time.perf_counter() - t0
            want = cfg["tiers"].get(key)
            if want is not None and solver.method != want:
                raise AssertionError(
                    f"{key}: tier {solver.method}, expected {want}")
            pb = jnp.asarray(P, dtype)
            xs, cold, warm = _timed(solver._solve, pb)
            res = float(np.max(np.asarray(
                solver.residuals(P, np.asarray(xs)))))
            err = _rel_err(np.asarray(xs)[rows], ref)
            name = f"batched/{solver.method}/{tag}"
            _line(name, _platform(xs), plan_s + cold, warm, err, limit,
                  f"n={st.n} B={cfg['batch']} max_residual={res:.2e}")
            _check(name, err, limit)
            _check(name + " residual", res, res_limit)
            platforms.add(_platform(xs))
    return platforms


def phase_monte_carlo(cfg):
    """batch.monte_carlo, audited exactly (host f64 residual of every
    sample) and compared with host solves of the drawn parameters."""
    import jax
    import jax.numpy as jnp

    import bench
    from nodal_tpu.batch import monte_carlo

    platforms = set()
    for name, c, n in (
            ("monte_carlo/ladder", bench._ladder_circuit(cfg["mc_ladder"]),
             cfg["mc_samples"]),
            ("monte_carlo/mesh", _mesh(*cfg["mesh"]),
             cfg["mc_mesh_samples"])):
        st = c.stamps
        tol = {k: 0.05 for k, comp in c.netlist.components.items()
               if comp.type == "R"}
        run = lambda: monte_carlo(c, tol, n=n, seed=3,  # noqa: E731
                                  return_solutions=True, audit="exact")
        t0 = time.perf_counter()
        out = jax.block_until_ready(run())
        cold = time.perf_counter() - t0
        t0 = time.perf_counter()
        out = jax.block_until_ready(run())
        warm = time.perf_counter() - t0
        # The sampled batch exactly as the device program drew it.
        solver = c.batched_solver(dtype=jnp.float32, refine="auto")
        slots = jnp.asarray(np.array([st.param_slot[m] for m in tol]))
        sig = jnp.asarray(np.array(list(tol.values())), jnp.float32)
        base = jnp.asarray(st.params, jnp.float32)
        _, _, xs, batch, _ = solver._mc_run(
            jax.random.PRNGKey(3), base, slots, sig, n=n, want=True,
            check=False)
        xs, batch = np.asarray(xs), np.asarray(batch, np.float64)
        rows = np.random.default_rng(4).choice(n, min(cfg["rows"], n),
                                               replace=False)
        ref = np.stack([_host_solve(st, batch[i]) for i in rows])
        err = _rel_err(xs[rows], ref)
        mean_err = _rel_err(np.asarray(out["mean"]), xs.mean(axis=0))
        limit = LIMITS["contract"]
        plat = _platform(out["solutions"])
        _line(name, plat, cold, warm, err, limit,
              f"n={st.n} samples={n} max_residual="
              f"{out['max_residual']:.2e} mean_err={mean_err:.1e}")
        _check(name, err, limit)
        _check(name + " residual", out["max_residual"], limit)
        _check(name + " mean", mean_err, limit)
        platforms.add(plat)
    return platforms


def phase_gradient(cfg):
    """jax.grad through BatchedSolver (adjoint custom VJP) against dense f64
    autodiff on the host for sampled rows."""
    import jax
    import jax.numpy as jnp

    from nodal_tpu.batch import BatchedSolver
    from nodal_tpu.ops.assemble import assemble_dense

    c = _mesh(*cfg["mesh"])
    st = c.stamps
    solver = BatchedSolver(c, dtype=jnp.float32)
    P = _perturbed(st, cfg["batch"], seed=5)
    W = np.random.default_rng(6).standard_normal((cfg["batch"], st.n))
    Wd = jnp.asarray(W)
    grad = jax.jit(jax.grad(lambda p: jnp.sum(Wd * solver._solve(p))))
    g, cold, warm = _timed(grad, jnp.asarray(P, jnp.float32))
    plat = _platform(g)
    g = np.asarray(g, np.float64)

    def x_dense(p):
        G, b = assemble_dense(st, p, dtype=jnp.float64)
        return jnp.linalg.solve(G, b)

    rows = np.random.default_rng(7).choice(
        cfg["batch"], min(cfg["rows"], cfg["batch"]), replace=False)
    with jax.default_device(jax.devices("cpu")[0]):
        ref_grad = jax.jit(jax.grad(
            lambda p, w: jnp.dot(w, x_dense(p))))
        ref = np.stack([np.asarray(ref_grad(jnp.asarray(P[i]),
                                            jnp.asarray(W[i])))
                        for i in rows])
    err = _rel_err(g[rows], ref)
    limit = LIMITS["gradient"]
    _line(f"gradient/{solver.method}", plat, cold, warm, err, limit,
          f"n={st.n} B={cfg['batch']}")
    _check("gradient", err, limit)
    return {plat}


def _dense_grad(stamps, ia, ib=None):
    """d(x[ia] - x[ib]) / d params by dense f64 autodiff on the host."""
    import jax
    import jax.numpy as jnp

    from nodal_tpu.ops.assemble import assemble_dense

    def out(p):
        G, b = assemble_dense(stamps, p, dtype=jnp.float64)
        x = jnp.linalg.solve(G, b)
        return x[ia] - (x[ib] if ib is not None else 0.0)

    with jax.default_device(jax.devices("cpu")[0]):
        return np.asarray(jax.jit(jax.grad(out))(
            jnp.asarray(stamps.params, jnp.float64)))


def phase_sensitivities(cfg):
    """batch.sensitivities and equiv.resistance_sensitivities (f64 adjoint)
    on the mesh, against dense f64 autodiff on the host.  The mesh is below
    the small-system cutoff, so the Circuit's placement policy serves it on
    the host CPU; ``sensitivities`` runs a second time placed on the first
    device, where the sband solve runs the kernel."""
    import jax

    from nodal_tpu import Circuit
    from nodal_tpu.batch import sensitivities
    from nodal_tpu.equiv import resistance_sensitivities
    from nodal_tpu.models.stamps import compile_stamps

    h, w = cfg["mesh"]
    node = f"n{h // 2}_{w // 2}"
    net = _mesh(h, w).netlist
    dev = jax.devices()[0]
    # The mesh without its current source: nodal-resistance's input.
    bare = _mesh(h, w, source=False).netlist
    probed = bare.with_component([bare.fresh_name("a1"), "A", "1", "1",
                                  node])
    probed_st = compile_stamps(probed)
    cases = (
        ("sensitivities/policy", Circuit(net),
         lambda c: sensitivities(c, potential=node)),
        ("sensitivities/device", Circuit(net, device=dev),
         lambda c: sensitivities(c, potential=node)),
        ("resistance_sensitivities", Circuit(probed),
         lambda c: resistance_sensitivities(bare, "1", node)),
    )
    for name, c, run in cases:
        served = c._target_platform()
        t0 = time.perf_counter()
        got = run(c)
        cold = time.perf_counter() - t0
        t0 = time.perf_counter()
        got = run(c)
        warm = time.perf_counter() - t0
        st = c.stamps
        if name.startswith("resistance"):
            ref = _dense_grad(probed_st, probed.nodenum["1"],
                              probed.nodenum[node])
        else:
            ref = _dense_grad(st, net.nodenum[node])
        ref = np.array([ref[st.param_slot[k]] for k in got])
        err = _rel_err(np.array(list(got.values())), ref)
        limit = LIMITS["sensitivity"]
        _line(name, served, cold, warm, err, limit,
              f"n={st.n} components={len(got)} served_by={served}")
        _check(name, err, limit)
    if Circuit(net, device=dev)._target_platform() != dev.platform:
        raise AssertionError("device-placed sensitivities left the device")


def phase_grid(cfg):
    """1M-node grid: knight's-move resistance by MG-CG (f32, tol 1e-6)
    against scipy's f64 sparse direct solve of the grounded Laplacian."""
    import jax
    import jax.numpy as jnp
    import scipy.sparse as sps
    import scipy.sparse.linalg as spla

    from nodal_tpu.ops.grid import grid_equivalent_resistance

    n = cfg["grid"]
    a, b = (n // 2, n // 2), (n // 2 + 1, n // 2 + 2)
    run = jax.jit(lambda: grid_equivalent_resistance(
        n, n, a, b, dtype=jnp.float32, tol=1e-6))
    (r, info), cold, warm = _timed(run)

    # Host reference: ground node b, inject 1 A at a, R = x[a].
    e = np.ones(n)
    T = sps.diags([-e[:-1], np.r_[1.0, 2.0 * np.ones(n - 2), 1.0], -e[:-1]],
                  [-1, 0, 1])
    eye = sps.identity(n)
    L = (sps.kron(eye, T) + sps.kron(T, eye)).tocsc()
    ia, ib = a[0] * n + a[1], b[0] * n + b[1]
    keep = np.ones(n * n, bool)
    keep[ib] = False
    rhs = np.zeros(n * n)
    rhs[ia] = 1.0
    x = spla.spsolve(L[keep][:, keep], rhs[keep],
                     permc_spec="MMD_AT_PLUS_A")
    ref = float(x[ia if ia < ib else ia - 1])
    err = abs(float(r) - ref) / abs(ref)
    limit = LIMITS["grid"]
    _line("grid/mg-cg", _platform(r), cold, warm, err, limit,
          f"n={n * n} R={float(r):.8f} ref={ref:.8f} "
          f"cg_iterations={int(info.iterations)}")
    _check("grid", err, limit)


def _general_rows(n_nodes, h):
    """A general MNA netlist from utils.gridgen: resistor mesh driven by E
    sources, with VCCS and CCCS couplings (bench.bench_general_sparse)."""
    from nodal_tpu.utils.gridgen import grid_rows

    w = max(n_nodes // h, 8)
    rows = [list(r) for r in grid_rows(h, w)]
    e_cols = list(range(1, w, max(w // 32, 1)))[:32]
    d_cols = list(range(2, w, max(w // 16, 1)))[:16]
    for k, col in enumerate(e_cols):
        rows.append([f"e{k}", "E", str(1.0 + 0.1 * k), f"n0_{col}", "g"])
    for k, col in enumerate(d_cols):
        rows.append([f"d{k}", "VCCS", "0.3", f"n{h // 2}_{col}", "g",
                     f"n0_{e_cols[k % len(e_cols)]}", "g"])
    rows.append(["rdrv", "R", "2", f"n{h - 1}_5", f"n{h - 1}_6"])
    rows.append(["f1", "CCCS", "1.5", f"n{h // 3}_4", "g",
                 f"n{h - 1}_5", f"n{h - 1}_6", "rdrv"])
    return rows


def phase_oneshot(cfg):
    """Circuit.solve() on a branch circuit past the small-system cutoff,
    and the ``nodal-solver -s`` CLI on a general netlist."""
    import bench
    from nodal_tpu import Circuit, Netlist, solver_cli

    c = bench._branch_circuit(cfg["oneshot_branch"])
    c = Circuit(c.netlist, dtype=np.float64)
    t0 = time.perf_counter()
    sol = c.solve()
    cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    sol = c.solve()
    warm = time.perf_counter() - t0
    err = _rel_err(sol.result, _host_solve(c.stamps, c.stamps.params))
    limit = LIMITS["oneshot"]
    _line(f"oneshot/{sol.stats['method']}", sol.stats["device"], cold, warm,
          err, limit, f"n={c.stamps.n} served_by={sol.stats['device']}")
    _check("oneshot circuit", err, limit)

    rows = _general_rows(cfg["cli_nodes"], cfg["cli_h"])
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "general.csv")
        with open(path, "w") as fh:
            fh.write("\n".join(", ".join(r) for r in rows) + "\n")
        times, out, err_txt = [], "", ""
        for _ in range(2):
            so, se = io.StringIO(), io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(so), \
                    contextlib.redirect_stderr(se):
                solver_cli.main(["-s", "--stats", path])
            times.append(time.perf_counter() - t0)
            out, err_txt = so.getvalue(), se.getvalue()
        netlist = Netlist(path)
    stats = dict(re.findall(r"(method|device): (\S+)", err_txt))
    x = np.zeros(netlist.nums["kcl"] + netlist.nums["anomalies"])
    for kind, name, val in re.findall(r"^([ei])\((.+?)\) \t= (\S+)$", out,
                                      re.M):
        i = (netlist.nodenum[name] if kind == "e"
             else netlist.nums["kcl"] + netlist.anomnum[name])
        x[i] = float(val)
    from nodal_tpu.models.stamps import compile_stamps

    st = compile_stamps(netlist)
    res = _coo_residual(st, st.params, x)
    _line(f"oneshot-cli/{stats.get('method')}", stats.get("device", "?"),
          times[0], times[1], res, limit,
          f"n={st.n} served_by={stats.get('device')} (err = COO residual)")
    _check("oneshot cli", res, limit)


def phase_sharded(cfg, n_dev=4):
    """Four cards: the shard_map batch solver against one card's
    BatchedSolver, and both multi-card grid solvers against one card's
    grid_solve (equal CG iteration counts)."""
    import jax
    import jax.numpy as jnp

    import bench
    from nodal_tpu.batch import BatchedSolver
    from nodal_tpu.ops.grid import grid_solve
    from nodal_tpu.parallel.halo import make_halo_grid_solver
    from nodal_tpu.parallel.mesh import make_mesh
    from nodal_tpu.parallel.sharded import (make_sharded_batch_solver,
                                            make_sharded_grid_solver)

    mesh = make_mesh(n_dev)
    dev0 = jax.devices()[0]
    B = cfg["sharded_batch"]
    for key, c in (("mesh", _mesh(*cfg["mesh"])),
                   ("branch", bench._branch_circuit(cfg["branch"]))):
        st = c.stamps
        P = _perturbed(st, B, seed=8)
        pb = jnp.asarray(P, jnp.float32)
        sharded = make_sharded_batch_solver(st, mesh, dtype=jnp.float32)
        xs, cold, warm = _timed(sharded, pb)
        with jax.default_device(dev0):
            single = BatchedSolver(c, dtype=jnp.float32, refine=False)
            x1, cold1, warm1 = _timed(single._solve,
                                      jax.device_put(pb, dev0))
        diff = _rel_err(np.asarray(xs), np.asarray(x1, np.float64))
        res = float(np.max(np.asarray(single.residuals(P, np.asarray(xs)))))
        limit = LIMITS["sharded_batch"]
        plats = {d.platform for d in xs.devices()}
        _line(f"sharded-batch/{key}", ",".join(sorted(plats)), cold, warm,
              diff, limit, f"devices={len(xs.devices())} B={B} "
              f"single_card_warm_s={warm1:.5f} max_residual={res:.2e}")
        _check(f"sharded {key}", diff, limit)
        _check(f"sharded {key} residual", res, LIMITS["f32_residual"])

    n = cfg["grid"]
    dp = mesh.shape["dp"]
    probe = np.zeros((dp, n, n), np.float32)
    probe[:, n // 2, n // 2] = 1.0
    probe[:, n // 2 + 1, n // 2 + 2] = -1.0
    with jax.default_device(dev0):
        one = jax.jit(lambda b: grid_solve(n, n, b, dtype=jnp.float32,
                                           tol=1e-6))
        (x1, info1), _, warm1 = _timed(one, jnp.asarray(probe[0]))
    x1 = np.asarray(x1, np.float64)
    for name, make in (("gspmd", make_sharded_grid_solver),
                       ("halo", make_halo_grid_solver)):
        solver = make(n, n, mesh, dtype=jnp.float32, tol=1e-6)
        (xs, _res, iters), cold, warm = _timed(solver, jnp.asarray(probe))
        diff = _rel_err(np.asarray(xs)[0], x1)
        it, it1 = int(np.max(np.asarray(iters))), int(info1.iterations)
        limit = LIMITS["sharded_grid"]
        plats = {d.platform for d in xs.devices()}
        _line(f"sharded-grid/{name}", ",".join(sorted(plats)), cold, warm,
              diff, limit, f"devices={len(xs.devices())} n={n * n} "
              f"cg_iterations={it} single_card={it1} "
              f"single_card_warm_s={warm1:.5f}")
        _check(f"sharded grid {name}", diff, limit)
        if it != it1:
            raise AssertionError(f"sharded grid {name}: {it} CG iterations, "
                                 f"one card {it1}")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--four-cards", action="store_true",
                        help="run only the four-GPU sharded paths")
    args = parser.parse_args(argv)

    import jax

    jax.config.update("jax_enable_x64", True)
    from nodal_tpu.utils.cache import enable_persistent_cache

    n_dev = 4 if args.four_cards else 1
    device = phase_device("gpu", n_dev)
    enable_persistent_cache()
    t0 = time.perf_counter()
    if args.four_cards:
        phase_sharded(FULL, n_dev)
    else:
        platforms = phase_batched(FULL)
        platforms |= phase_monte_carlo(FULL)
        platforms |= phase_gradient(FULL)
        phase_sensitivities(FULL)
        phase_grid(FULL)
        phase_oneshot(FULL)
        if platforms != {"gpu"}:
            raise AssertionError(f"results on {platforms}, not the GPU")
    print(f"total_s={time.perf_counter() - t0:.1f}", flush=True)
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
