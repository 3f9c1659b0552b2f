"""Per-phase timing, the program's spans, and throughput counters.

The reference has a single wall-clock log around the smoothing loop
(smooth.zig:81-85,156-160); here every pipeline phase (connection check,
classify, solver setup, Picard loop) is timed, and inside the phases the
program marks its stages with ``span(name)``: the front end (``load``,
``template``), the solver's set-up, the Picard loop, FGMRES and the
preconditioner. Node throughput (Mnodes/s) is reported for the phases.

A ``PhaseTimer`` records the spans of the thread it is active in
(``active()``; ``smooth_mesh`` makes its timer active, and each
``phase`` does): per name the count, the total seconds and the self
seconds (the total less what its child spans cover), the child of the
span open around it. While a ``torch.profiler`` runs, every span is also
a range named ``turbomesh.<name>`` on the profiler's clock: an operator
range (``torch._C._profiler._RecordFunctionFast``) on the host's
timeline, not a ``record_function`` annotation, which the profiler
would also mirror onto the device's timeline as a span over its
kernels, read there as busy time. With no active timer and no profiler,
a span reads no clock.

Device work is asynchronous: a span times the host's issue of its work,
and holds device time only where it waits for the device (the Picard
loop's per-iteration read, ``picard.read``; FGMRES's stop test,
``fgmres.stop_test``). ``torch_trace`` captures a torch.profiler trace
(Chrome trace format) around any phase; ``turbomesh-torch --trace DIR``
writes one of the smoothing.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import threading
import time

import torch

log = logging.getLogger("turbomesh.profiling")

class _Active(threading.local):
    #: the PhaseTimer active in this thread, if any
    timer = None


_local = _Active()
_NO_SPAN = contextlib.nullcontext()


class _Span:
    """One open span: a profiler range while a profiler runs, and a
    record in ``timer`` when one is active."""

    __slots__ = ("timer", "name", "range", "t0", "child")

    def __init__(self, timer, name):
        self.timer = timer
        self.name = name
        self.range = (torch._C._profiler._RecordFunctionFast(
            "turbomesh." + name)
            if torch.autograd._profiler_enabled() else None)

    def __enter__(self):
        if self.range is not None:
            self.range.__enter__()
        if self.timer is not None:
            self.timer._open.append(self)
            self.child = 0.0
            self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        timer = self.timer
        if timer is not None:
            dt = time.perf_counter() - self.t0
            timer._open.pop()
            parent = timer._open[-1] if timer._open else None
            if parent is not None:
                parent.child += dt
            timer._record(parent.name if parent is not None else None,
                          self.name, dt, dt - self.child)
        if self.range is not None:
            self.range.__exit__(*exc)
        return False


def span(name: str):
    """A context manager marking a stage ``name`` of the program: a span
    of the active PhaseTimer, and a ``turbomesh.<name>`` range while a
    torch profiler runs; with neither, it does nothing."""
    timer = _local.timer
    if timer is None and not torch.autograd._profiler_enabled():
        return _NO_SPAN
    return _Span(timer, name)


@dataclasses.dataclass
class PhaseTimer:
    """Accumulates wall-clock per named phase and span: ``totals``
    (seconds), ``counts`` and ``self_s`` (seconds not covered by child
    spans) by name, and ``edges``, (parent name or None, name) -> [count,
    seconds, self seconds], the tree that ``report`` prints."""

    totals: dict = dataclasses.field(default_factory=dict)
    counts: dict = dataclasses.field(default_factory=dict)
    self_s: dict = dataclasses.field(default_factory=dict)
    edges: dict = dataclasses.field(default_factory=dict)
    _open: list = dataclasses.field(default_factory=list, repr=False)

    def _record(self, parent, name, dt, own):
        self.totals[name] = self.totals.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + 1
        self.self_s[name] = self.self_s.get(name, 0.0) + own
        e = self.edges.get((parent, name))
        if e is None:
            self.edges[(parent, name)] = [1, dt, own]
        else:
            e[0] += 1
            e[1] += dt
            e[2] += own

    @contextlib.contextmanager
    def active(self):
        """Make this the timer that ``span`` records into, in this thread,
        for the enclosed code."""
        prev = _local.timer
        _local.timer = self
        try:
            yield self
        finally:
            _local.timer = prev

    @contextlib.contextmanager
    def phase(self, name: str):
        """A span ``name`` of this timer, active for the enclosed code."""
        with self.active(), _Span(self, name):
            yield

    def report(self, nodes: int | None = None) -> str:
        """The spans as a tree, largest first: count, total and self
        seconds; with ``nodes``, Mnodes/s of the top-level phases."""
        kids: dict = {}
        for (parent, name), (n, total, own) in self.edges.items():
            kids.setdefault(parent, []).append((name, n, total, own))
        lines = []

        def walk(parent, path):
            for name, n, total, own in sorted(kids.get(parent, ()),
                                              key=lambda k: -k[2]):
                line = (f"{'  ' * len(path)}{name}: {total:.3f} s ({n}x, "
                        f"{total / n:.3g} s each, self {own:.3f} s)")
                if nodes is not None and not path and total > 0:
                    line += f", {nodes * n / total / 1e6:.2f} Mnodes/s"
                lines.append(line)
                if name not in path:
                    walk(name, path + (name,))

        walk(None, ())
        return "\n".join(lines)

    def log_report(self, nodes: int | None = None) -> None:
        for line in self.report(nodes).splitlines():
            log.info(line)


@contextlib.contextmanager
def torch_trace(dirname: str | None):
    """Capture a torch.profiler trace around the enclosed phase: CPU
    activity, plus CUDA activity when a card is present, written as a
    Chrome trace (``trace.json``, viewable in chrome://tracing or
    Perfetto) into ``dirname``, with the program's spans as
    ``turbomesh.*`` ranges; no-op when dirname is None. Yields the
    profiler (None when off), whose ``events()`` the caller may read."""
    if dirname is None:
        yield None
        return
    import os

    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(dirname, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(dirname, "trace.json"))
