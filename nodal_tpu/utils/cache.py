"""Persistent compile cache: make repeated runs on the same topology cheap.

SURVEY.md §7 calls for caching compiled programs "by topology hash".  The
stamp compiler already bakes each netlist topology's index tensors into the
XLA program as constants, so the serialized program *is* the topology hash —
XLA's own persistent compilation cache (keyed on program + compile options +
backend) therefore keys exactly on (topology, dtype, method, backend) with
no hand-rolled layer on top.  This module just turns it on at a stable
location.

With the cache enabled, the second `nodal-solver` invocation on the same
topology skips compilation entirely — visible in ``--stats`` as
compile+solve collapsing to the pure solve time.

Location:

* ``JAX_COMPILATION_CACHE_DIR`` when set — JAX reads it itself, and this
  module sets no other directory;
* otherwise ``<checkout>/.jax_cache`` (the directory that holds the
  ``nodal_tpu`` package; listed in ``.gitignore``).

``NODAL_TPU_NO_CACHE=1`` disables the cache entirely.
"""

from __future__ import annotations

import logging
import os

logger = logging.getLogger(__name__)

#: ``<checkout>/.jax_cache``: a fixed path, since the path is part of the
#: cache's key for every program it holds.
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))),
    ".jax_cache",
)

#: Programs cheaper than this to compile are not persisted (litter control).
_MIN_COMPILE_SECS = 0.2


def _exclude_cpu_backend() -> None:
    """Skip persistence for CPU-backend programs entirely.

    A serialized XLA:CPU executable IS an AOT result with the compile-time
    LLVM target features baked in — including tuning pseudo-features
    (+prefer-no-scatter/+prefer-no-gather) that can never appear in
    /proc/cpuinfo, so *every* cache load logs two "could lead to execution
    errors such as SIGILL" errors, even replaying on the very host that
    compiled it (the feature record lives in the executable).  CPU
    compiles are sub-second for the programs this framework routes to the
    host anyway — only accelerator executables are worth persisting.  jax
    has no per-backend knob, so wrap the one predicate its compiler
    consults (jax/_src/compiler.py `_get_cache_key` →
    `is_cache_used(backend)`).
    """
    try:
        from jax._src import compilation_cache as _cc

        orig = _cc.is_cache_used
        if getattr(orig, "_nodal_tpu_cpu_excluded", False):
            return

        def is_cache_used(backend):
            if getattr(backend, "platform", None) == "cpu":
                return False
            return orig(backend)

        is_cache_used._nodal_tpu_cpu_excluded = True
        _cc.is_cache_used = is_cache_used
    except Exception:  # pragma: no cover - private API drift: keep caching
        logger.debug("could not exclude cpu backend from persistent cache",
                     exc_info=True)

_enabled_dir: str | None = None


def enable_persistent_cache(path: str | None = None) -> str | None:
    """Enable XLA's persistent compilation cache; returns the cache dir.

    ``path`` (tests) is taken verbatim; otherwise the directory follows the
    module docstring.  Idempotent; respects ``NODAL_TPU_NO_CACHE``.  Safe
    to call before or after backends initialize (the cache is consulted
    per-compilation).
    """
    global _enabled_dir
    if os.environ.get("NODAL_TPU_NO_CACHE"):
        return None
    env_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if path is None:
        path = env_dir or DEFAULT_DIR
    if _enabled_dir == path:
        return path

    import jax

    try:
        os.makedirs(path, exist_ok=True)
        if path != env_dir:
            jax.config.update("jax_compilation_cache_dir", path)
        jax.config.update(
            "jax_persistent_cache_min_compile_time_secs", _MIN_COMPILE_SECS
        )
        # Persist small-but-slow programs too (default gates on entry size).
        jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
        _exclude_cpu_backend()
    except Exception as e:  # pragma: no cover - config drift across versions
        logger.warning("persistent compile cache unavailable: %s", e)
        return None
    _enabled_dir = path
    return path
