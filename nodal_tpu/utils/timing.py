"""Timing / profiling helpers (SURVEY.md §5.1: the reference has none).

``Phases`` is a lightweight wall-clock phase recorder used by the CLIs'
``--stats``; :func:`trace` wraps ``jax.profiler`` for device traces.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field


@dataclass
class Phases:
    """Accumulates named wall-clock phases.

    >>> phases = Phases()
    >>> with phases("parse"):
    ...     ...
    >>> print(phases)
    """

    entries: list[tuple[str, float]] = field(default_factory=list)

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.entries.append((name, time.perf_counter() - t0))

    def __str__(self) -> str:
        return "  ".join(f"{name}: {dt:.4f}s" for name, dt in self.entries)


@contextlib.contextmanager
def trace(dir: str = "/tmp/nodal_tpu_trace"):
    """jax.profiler trace context (view with xprof/tensorboard)."""
    import jax

    jax.profiler.start_trace(dir)
    try:
        yield dir
    finally:
        jax.profiler.stop_trace()
