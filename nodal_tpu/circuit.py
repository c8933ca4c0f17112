"""Circuit and Solution: the user-facing solve API.

Mirrors the reference's documented entry pattern (reference nodal.py:8-13):

    from nodal_tpu import Circuit, Netlist
    circuit = Circuit(Netlist("netlist.csv"), sparse=True)
    print(circuit.solve())

but the implementation is a netlist compiler + jitted device kernels rather
than a Python stamping loop.  ``Circuit`` compiles the netlist once to static
stamp tensors; ``solve()`` assembles and solves on-device.

Error policy (uniform across dense and sparse paths — fixes reference quirk
Q3, where the sparse path silently printed NaNs on singular systems,
SURVEY.md §2.4):  after every solve the relative residual
``max|G x - b| / max(|b|, 1)`` is checked.  A non-finite or large-residual
solution triggers the connectivity diagnosis (reference nodal.py:328-335):
an unreachable-from-ground node raises :class:`UnconnectedCircuitError`,
otherwise ``numpy.linalg.LinAlgError`` propagates, same surface as the
reference.
"""

from __future__ import annotations

import contextlib
import logging
import os
from dataclasses import dataclass

import numpy as np
from numpy.linalg import LinAlgError

import jax
import jax.numpy as jnp

from nodal_tpu.models.stamps import Quirks, StampTensors, compile_stamps
from nodal_tpu.netlist import Netlist, UnconnectedCircuitError, is_connected
from nodal_tpu.ops.assemble import assemble_dense
from nodal_tpu.ops import dense_solve

logger = logging.getLogger(__name__)

# Relative-residual ceiling above which a solve is declared failed.  Scaled
# for ill-conditioned but solvable systems (the OPMODEL macromodel reaches
# cond ~1e12 in f64: residual stays ~1e-4 relative at worst).
_RESIDUAL_TOL = {np.dtype(np.float32): 3e-2, np.dtype(np.float64): 1e-3}

# Two-level gate (round-2 review "What's weak" #2): a solve that clears the
# failure ceiling but sits above this is returned WITH a logged warning —
# an f32 answer can be ~1% wrong yet pass the singularity gate silently.
_RESIDUAL_WARN = 1e-4

# Below this many unknowns a single solve runs on the host CPU backend:
# accelerator compile and dispatch latency dwarfs any device win on tiny
# systems.  Batched sweeps and grid solves target the accelerator
# explicitly regardless (nodal_tpu.batch / nodal_tpu.ops.grid).  The
# crossover has not been re-measured on the GPU.
_SMALL_SYSTEM_N = int(os.environ.get("NODAL_TPU_SMALL_SYSTEM_N", "2048"))

# Above this many unknowns the dense CPU-f64 rescue is skipped: an n^2 f64
# matrix would be enormous, and Krylov non-convergence at that scale is a
# solver-tuning problem, not evidence of singularity.
_DENSE_RESCUE_MAX_N = int(os.environ.get("NODAL_TPU_DENSE_RESCUE_MAX_N",
                                         "16384"))


def default_dtype():
    """float64 when x64 is enabled (parity/CLI mode), else float32 (the
    batched fast path)."""
    return jnp.float64 if jax.config.jax_enable_x64 else jnp.float32


class Circuit:
    """A compiled circuit: netlist lowered to stamp tensors + solver choice.

    Args:
        netlist: a finalized :class:`Netlist`.
        sparse: parity flag with the reference CLI ``-s`` — selects the
            iterative/sparse backend instead of dense LU.
        dtype: numeric dtype for assembly and solve; default follows
            :func:`default_dtype`.
        quirks: reference bit-compatibility switches.
    """

    def __init__(
        self,
        netlist: Netlist,
        sparse: bool = False,
        *,
        dtype=None,
        quirks: Quirks | None = None,
        device=None,
    ):
        if not isinstance(netlist, Netlist):
            raise TypeError("Input isn't a netlist")
        self.netlist = netlist
        self.sparse = bool(sparse)
        self.dtype = np.dtype(dtype) if dtype is not None else np.dtype(default_dtype())
        self.device = _resolve_device(device)
        self.stamps: StampTensors = compile_stamps(netlist, quirks)

    def _device_scope(self):
        """Device placement policy: explicit device wins; otherwise small
        systems solve on the host CPU backend (compile latency >> compute),
        big ones on the default accelerator."""
        dev = self._resolved_device()
        return jax.default_device(dev) if dev is not None else contextlib.nullcontext()

    def _resolved_device(self):
        dev = self.device
        if dev is None and self.stamps.n < _SMALL_SYSTEM_N:
            dev = _cpu_device_or_none()
        return dev

    def _target_platform(self) -> str:
        dev = self._resolved_device()
        return dev.platform if dev is not None else jax.default_backend()

    # -- solving ---------------------------------------------------------------

    def solve(self) -> "Solution":
        """Assemble and solve ``G e = b``; return a printable Solution.

        Raises UnconnectedCircuitError for floating subcircuits and
        numpy.linalg.LinAlgError for genuinely singular systems, like the
        reference (nodal.py:313-336).
        """
        import time

        t0 = time.perf_counter()
        stats: dict = {"dtype": str(self.dtype), "backend": jax.default_backend()}
        with self._device_scope():
            if self.sparse:
                from nodal_tpu.ops.sparse import solve_sparse_system

                # Host numpy params: the general (bordered-elimination)
                # sparse path runs entirely host-side, and pre-placing an
                # f64 array on the accelerator would force a fetch-back.
                try:
                    x, info = solve_sparse_system(
                        self.stamps, self.stamps.params, dtype=self.dtype
                    )
                except LinAlgError:
                    # Structural singularity detected inside the bordered
                    # elimination — run the same connectivity diagnosis the
                    # reference applies to its dense LinAlgError
                    # (nodal.py:328-335): floating subcircuit vs genuinely
                    # singular.
                    self._raise_singular()
                residual = info.residual
                stats["method"] = getattr(info, "method", "") or "krylov"
                stats["iterations"] = int(info.iterations)
            else:
                params = jnp.asarray(self.stamps.params, dtype=self.dtype)
                x, residual, method = self._solve_dense(params)
                stats["method"] = method

        # Where the answer was computed: a jax array names its device; the
        # host-side sparse tiers return numpy.
        stats["device"] = (next(iter(x.devices())).platform
                           if hasattr(x, "devices") else "host")
        x = np.asarray(x, dtype=np.float64)
        if not self._acceptable(float(residual)) or not np.all(np.isfinite(x)):
            x, residual = self._rescue()
            stats["method"] = "cpu_f64_rescue"
            stats["device"] = "cpu"
            if not self._acceptable(float(residual), np.float64) or not np.all(
                np.isfinite(x)
            ):
                self._raise_singular()
        stats["residual"] = float(residual)
        if float(residual) > _RESIDUAL_WARN:
            logger.warning(
                "solve residual %.2e exceeds %.0e: the %s answer is "
                "degraded (ill-conditioned system); re-run with dtype=f64 "
                "(--dtype f64) for a refined solve",
                float(residual), _RESIDUAL_WARN, stats["dtype"],
            )
            stats["accuracy_warning"] = True
        stats["solve_s"] = time.perf_counter() - t0
        return Solution(x, self.netlist, stats=stats)

    def _solve_dense(self, params):
        """One jitted program: assemble + factor + solve + residual check.

        Eager dispatch would issue dozens of tiny ops per solve, each with
        its own accelerator dispatch; one program pays that once.
        The compiled program is cached per (dtype, platform) on the Circuit
        and persisted across processes by the XLA compilation cache.

        Structure-aware: purely resistive circuits whose half-bandwidth
        after RCM reordering fits 128 skip the dense n² assembly entirely
        and solve block-tridiagonally (ops/band.py) — O(n·K²) work and
        3·K·n memory, which is what keeps a 16k-node mesh solvable without
        a gigabyte-scale dense matrix.  Returns ``(x, residual, method)``.
        """
        platform = self._target_platform()
        key = ("dense", str(self.dtype), platform)
        cache = self.__dict__.setdefault("_solve_fns", {})
        hit = cache.get(key)
        if hit is None:
            stamps = self.stamps
            dtype = self.dtype

            plan = None
            if stamps.n == stamps.n_kcl:
                from nodal_tpu.ops.band import band_plan

                plan = band_plan(stamps)
                if plan is not None and plan.nb < 2:
                    plan = None

            if plan is not None:
                from nodal_tpu.ops.band import band_matvec, band_thomas_solve

                def f(params):
                    W, b = plan.assemble(stamps, params,
                                         dtype=jnp.dtype(dtype))
                    x = band_thomas_solve(W, b)
                    r = b - band_matvec(W, x)
                    residual = jnp.max(jnp.abs(r)) / jnp.maximum(
                        jnp.max(jnp.abs(b)), 1.0
                    )
                    return plan.unpermute(x), residual

                # A SINGLE banded solve always runs on the host CPU,
                # whatever the circuit size: block-Thomas is O(n·K²) with
                # native-f64 pivoted block solves, and one solve is too
                # little work to repay an accelerator compile.  Batched
                # sweeps use the accelerator via BatchedSolver.  (Not yet
                # re-measured on the GPU.)
                cpu = _cpu_device_or_none()
                fj = jax.jit(f)
                if cpu is not None:
                    inner = fj

                    def fj(params, _inner=inner, _cpu=cpu):
                        with jax.default_device(_cpu):
                            # numpy round trip: drop any accelerator
                            # placement so the jit binds to the CPU.
                            return _inner(np.asarray(params))

                hit = (fj, "band_thomas")
            else:

                def f(params):
                    G, b = assemble_dense(stamps, params,
                                          dtype=jnp.dtype(dtype))
                    x = dense_solve.solve_dense(G, b)
                    residual = _rel_residual(
                        G.astype(x.dtype), b.astype(x.dtype), x
                    )
                    return x, residual

                hit = (jax.jit(f), "dense_lu")
            cache[key] = hit
        fn, method = hit
        x, residual = fn(params)
        return x, residual, method

    def _rescue(self):
        """Last-resort native-f64 solve on the host CPU backend, for systems
        too ill-conditioned for the primary path (e.g. f32-factored opamp
        macromodels).  Everything stays on CPU, next to the f64 LU.

        Above the dense cap the rescue is the bordered block elimination
        (ops/sparse_schur.py): AMG-CG on the resistively-grounded node
        block + dense pivoted Schur complement on the small border — the
        same direct-quality f64 machinery the sparse path uses, so circuit
        size no longer bounds what the framework can solve (round-2 review:
        the n>16,384 path previously returned NaN + error unconditionally).
        """
        if self.stamps.n > _DENSE_RESCUE_MAX_N:
            from nodal_tpu.ops.sparse_schur import solve_general_auto

            try:
                x, info = solve_general_auto(self.stamps,
                                             self.stamps.params)
                return np.asarray(x, dtype=np.float64), float(info.residual)
            except np.linalg.LinAlgError:
                return np.full(self.stamps.n, np.nan), np.inf
            except Exception:
                logger.error(
                    "iterative solve did not converge on %d unknowns and "
                    "the bordered-elimination rescue is not applicable",
                    self.stamps.n,
                )
                return np.full(self.stamps.n, np.nan), np.inf
        logger.debug("primary solve failed residual check; retrying on CPU f64")
        cpu = _cpu_device_or_none()
        scope = (
            jax.default_device(cpu) if cpu is not None
            else contextlib.nullcontext()
        )
        try:
            with scope:
                G, b = assemble_dense(
                    self.stamps, self.stamps.params, dtype=jnp.float64
                )
                x = dense_solve.solve_on_cpu(G, b)
                residual = _rel_residual(G, b, x)
            return np.asarray(x, dtype=np.float64), float(residual)
        except Exception:  # pragma: no cover - backend-specific failures
            return np.full(self.stamps.n, np.nan), np.inf

    def _acceptable(self, residual: float, dtype=None) -> bool:
        tol = _RESIDUAL_TOL[np.dtype(dtype) if dtype else self.dtype]
        return np.isfinite(residual) and residual <= tol

    def _raise_singular(self):
        if not is_connected(self.netlist):
            logger.error("Model error: unconnected circuit")
            raise UnconnectedCircuitError
        logger.error("Model error: matrix is singular")
        raise LinAlgError("Singular matrix")

    def batched_solver(self, *, dtype=None, refine: bool | str = "auto",
                       method: str = "auto"):
        """Memoized BatchedSolver for this circuit.

        Compiled solvers are cached per (dtype, refine, method), so repeated
        sweeps (e.g. successive monte_carlo calls) reuse the XLA program
        instead of re-jitting.
        """
        import jax.numpy as jnp_

        from nodal_tpu.batch import BatchedSolver

        dtype = jnp_.float32 if dtype is None else dtype
        key = (np.dtype(dtype).name, refine, method)
        cache = self.__dict__.setdefault("_batched_solvers", {})
        if key not in cache:
            cache[key] = BatchedSolver(
                self, dtype=dtype, refine=refine, method=method
            )
        return cache[key]

    # -- inspection (parity helpers) --------------------------------------------

    def build_model(self):
        """Materialize ``(G, b)`` as numpy arrays — debugging/parity helper
        mirroring the reference Circuit.build_model output (nodal.py:338-398).

        Pinned to the host CPU backend: this is f64 inspection work whose
        n² result ends up on the host anyway.
        """
        cpu = _cpu_device_or_none()
        scope = (jax.default_device(cpu) if cpu is not None
                 else contextlib.nullcontext())
        with scope:
            G, b = assemble_dense(self.stamps, self.stamps.params,
                                  dtype=jnp.float64)
            return np.asarray(G), np.asarray(b)


def _resolve_device(device):
    """Accept None, a jax Device, or a platform string ('cpu'/'gpu'/...)."""
    if device is None or not isinstance(device, str):
        return device
    return jax.devices(device)[0]


def _cpu_device_or_none():
    try:
        return jax.devices("cpu")[0]
    except RuntimeError:  # pragma: no cover - no CPU backend registered
        return None


def _rel_residual(G, b, x):
    r = b - jnp.dot(G, x, precision=jax.lax.Precision.HIGHEST)
    return jnp.max(jnp.abs(r)) / jnp.maximum(jnp.max(jnp.abs(b)), 1.0)


@dataclass
class Solution:
    """Solved circuit variables, printable in the reference's format
    (reference nodal.py:401-434).

    ``result[:kcl]`` are node potentials indexed by ``nodenum``;
    ``result[kcl:]`` are branch currents of anomalous components indexed by
    ``anomnum``.  ``stats`` carries solver observability (method, residual,
    iteration count, wall time) — SURVEY.md §5.5.

    The third positional argument matches the reference constructor
    ``Solution(e, netlist, currents)`` (reference nodal.py:414-420), where
    ``currents`` is the list collected during stamping.  The reference
    stores it write-only (its ``__str__`` reads ``anomnum`` instead —
    SURVEY.md §2.4 Q6); it is kept here purely so code constructing
    Solutions directly ports unchanged.
    """

    result: np.ndarray
    netlist: Netlist
    currents: list | None = None
    stats: dict | None = None

    def __post_init__(self):
        self.nodenum = self.netlist.nodenum
        self.anomnum = self.netlist.anomnum
        self.nums = self.netlist.nums
        self.ground = self.netlist.ground

    def potential(self, node: str) -> float:
        """Node potential in volts; ground is the 0 V reference."""
        if node == self.ground:
            return 0.0
        return float(self.result[self.nodenum[node]])

    def current(self, name: str) -> float:
        """Branch current (ampere) of an anomalous component."""
        return float(self.result[self.nums["kcl"] + self.anomnum[name]])

    def __str__(self) -> str:
        out = [f"Ground node: {self.ground}"]
        for name in sorted(self.nodenum):
            out.append(f"e({name}) \t= {self.result[self.nodenum[name]]}")
        for name in sorted(self.anomnum):
            i = self.nums["kcl"] + self.anomnum[name]
            out.append(f"i({name}) \t= {self.result[i]}")
        return "\n".join(out)
