"""Timers, steps/sec meters, and optional device profiling.

The reference has no profiling subsystem (SURVEY.md §5: PySPH's solver
prints per-iteration timing; diagnostics are print statements).  Here we
provide first-class wall-clock phase timers, a steps/sec meter used by
the Solver, and a thin wrapper over ``jax.profiler`` for device traces.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict


class PhaseTimer:
    """Accumulating wall-clock timer keyed by phase name."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> str:
        lines = []
        for k in sorted(self.totals, key=self.totals.get, reverse=True):
            lines.append(f"{k:30s} {self.totals[k]:10.3f}s "
                         f"x{self.counts[k]}")
        return "\n".join(lines)


class Throughput:
    """steps/sec + particle-steps/sec meter."""

    def __init__(self, n_particles: int):
        self.n = n_particles
        self.t0 = time.perf_counter()
        self.steps = 0

    def add(self, steps: int):
        self.steps += steps

    @property
    def steps_per_sec(self) -> float:
        return self.steps / max(time.perf_counter() - self.t0, 1e-9)

    @property
    def particle_steps_per_sec(self) -> float:
        return self.steps_per_sec * self.n


@contextlib.contextmanager
def device_trace(logdir: str):
    """Capture a jax.profiler trace (view with tensorboard/xprof)."""
    import jax

    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
