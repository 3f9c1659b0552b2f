"""Per-phase timing and throughput counters.

The reference has a single wall-clock log around the smoothing loop
(smooth.zig:81-85,156-160); here every pipeline phase (connection check,
classify, solver setup, Picard loop) is timed and node throughput
(Mnodes/s) is reported. Device work is asynchronous: a phase that ends in
a host read of a device value (the Picard loop's per-iteration stats)
includes the device time. ``torch_trace`` captures a torch.profiler trace
(Chrome trace format) around any phase.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import time

log = logging.getLogger("turbomesh.profiling")


@dataclasses.dataclass
class PhaseTimer:
    """Accumulates wall-clock per named phase."""

    totals: dict = dataclasses.field(default_factory=dict)
    counts: dict = dataclasses.field(default_factory=dict)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self, nodes: int | None = None) -> str:
        lines = []
        for name, total in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            line = f"{name}: {total:.3f} s ({n}x, {total / n:.3f} s each)"
            if nodes is not None and n > 0:
                line += f", {nodes * n / total / 1e6:.2f} Mnodes/s"
            lines.append(line)
        return "\n".join(lines)

    def log_report(self, nodes: int | None = None) -> None:
        for line in self.report(nodes).splitlines():
            log.info(line)


@contextlib.contextmanager
def torch_trace(dirname: str | None):
    """Capture a torch.profiler trace around the enclosed phase: CPU
    activity, plus CUDA activity when a card is present, written as a
    Chrome trace (``trace.json``, viewable in chrome://tracing or
    Perfetto) into ``dirname``; no-op when dirname is None. Yields the
    profiler (None when off), whose ``events()`` the caller may read."""
    if dirname is None:
        yield None
        return
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(dirname, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(dirname, "trace.json"))
