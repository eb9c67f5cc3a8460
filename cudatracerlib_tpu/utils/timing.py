"""Timers and performance counters.

Counterpart of reference ``Base/Timer.h`` (InstructionTimer, PerformanceTimer
with RAII BlockMeasure and avg/stddev stats :36-127) and the per-pass
CUDA-event timing in Tracer<>::DoPass (Kernel/Tracer.h:213,239-247). JAX
dispatches asynchronously, so accurate device timing requires
block_until_ready around the timed region.
"""
from __future__ import annotations

import math
import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict

import jax


class PerfBlock:
    """Accumulates wall-clock stats for a named block (avg ± stddev)."""

    def __init__(self):
        self.n = 0
        self.total = 0.0
        self.total_sq = 0.0
        self.last = 0.0

    def add(self, dt: float):
        self.n += 1
        self.total += dt
        self.total_sq += dt * dt
        self.last = dt

    @property
    def mean(self) -> float:
        return self.total / max(self.n, 1)

    @property
    def stddev(self) -> float:
        if self.n < 2:
            return 0.0
        m = self.mean
        return math.sqrt(max(self.total_sq / self.n - m * m, 0.0))


class PerformanceTimer:
    """Registry of named perf blocks (Base/Timer.h GET_PERF_BLOCKS)."""

    def __init__(self):
        self.blocks: Dict[str, PerfBlock] = defaultdict(PerfBlock)

    @contextmanager
    def measure(self, name: str, sync: bool = False, sync_value=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync and sync_value is not None:
                jax.block_until_ready(sync_value)
            self.blocks[name].add(time.perf_counter() - t0)

    def report(self) -> str:
        lines = []
        for name, b in sorted(self.blocks.items()):
            lines.append(
                f"{name}: n={b.n} avg={b.mean*1e3:.2f}ms ± {b.stddev*1e3:.2f}ms"
                f" last={b.last*1e3:.2f}ms"
            )
        return "\n".join(lines)


GLOBAL_TIMER = PerformanceTimer()


class RayCounter:
    """Rays/sec telemetry derived from static batch shapes (the reference's
    atomic counter Kernel/TraceHelper.h:52-53 is unnecessary under XLA —
    shapes are static, so counting is exact and free)."""

    def __init__(self):
        self.rays = 0
        self.seconds = 0.0

    def add_pass(self, n_rays: int, seconds: float):
        self.rays += n_rays
        self.seconds += seconds

    @property
    def mrays_per_sec(self) -> float:
        return self.rays / max(self.seconds, 1e-9) / 1e6
