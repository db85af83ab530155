"""Observability: stage timers and device trace annotations.

The reference instruments every pipeline stage with NVTX ranges and prints
wall-clock accumulators (SupportFunctions::markInitProfilerCPUSection,
AuxiliarFunctions.cpp:58-68; timers across CodingEngine/DecodingEngine).
Equivalents here:

- `stage(name)` — a context manager that accumulates wall-clock per stage
  and opens a `jax.profiler.TraceAnnotation` so stages show up in Perfetto
  traces captured with `jax.profiler.trace()`.
- `StageTimers.report()` — the counterpart of the reference's printed
  metrics ("time without allocation", "BPC acum time", reader/writer
  stalls).
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import jax


class StageTimers:
    """Accumulated wall-clock per named stage (thread-unsafe by design:
    one per engine thread, like the reference's per-stream accumulators)."""

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        with jax.profiler.TraceAnnotation(name):
            yield
        self.totals[name] += time.perf_counter() - t0
        self.counts[name] += 1

    def report(self) -> dict[str, dict[str, float]]:
        return {name: {"seconds": self.totals[name], "calls": self.counts[name]}
                for name in sorted(self.totals)}

    def pretty(self) -> str:
        lines = [f"{name:>24s}: {v['seconds']:.4f}s over {v['calls']} calls"
                 for name, v in self.report().items()]
        return "\n".join(lines)


GLOBAL_TIMERS = StageTimers()
stage = GLOBAL_TIMERS.stage


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Capture a Perfetto/XPlane device trace (jax.profiler.trace)."""
    with jax.profiler.trace(log_dir):
        yield
