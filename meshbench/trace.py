"""A profiled stretch of Picard iterations, reduced to what the metrics read.

``torch.profiler`` (CPU and CUDA activity, CUPTI) runs over a few steady
iterations of one job: started after one iteration ends and stopped after
the next ones, from the job's per-iteration hook. A whole job would be
over a million kernels at T106, so no trace is exported; the events are
reduced here to a ``TraceSummary``:

- ``window_s``: from the first to the last event of the stretch;
- ``busy_s``: the union of the device's intervals (kernels, copies,
  sets) in it;
- ``device_ops``: device seconds by operation name;
- ``idle_gaps``: the device's idle seconds by the host operation that
  was running at the middle of each gap (the innermost one on the
  thread that issued the most work; runtime calls such as
  cudaLaunchKernel are not counted as operations).
"""

from __future__ import annotations

import collections
import dataclasses
import re
import sys
import time

NO_OP = "(python between operations)"


@dataclasses.dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    device_ops: dict          # name -> seconds
    idle_gaps: dict           # host operation -> idle seconds
    launches: dict            # counter name -> change over the stretch
    iterations: int

    def top(self, table: dict, n: int = 10, kernels: bool = False) -> list:
        """The ``n`` largest entries; ``kernels``: named by ``label``."""
        name = label if kernels else str
        return [[name(k), v] for k, v in sorted(table.items(),
                                                key=lambda kv: -kv[1])[:n]]


_FUNCTOR = re.compile(r"\w+Functor\w*|\w+_kernel_impl\w*|direct_copy_kernel\w*")


def label(name: str) -> str:
    """A short label of a kernel's C++ signature: its name, with the
    innermost functor of PyTorch's elementwise kernels, e.g.
    ``elementwise_kernel[MulFunctor]``; other names are kept."""
    n = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    m = re.match(r"(?:\w+::)*(\w+)(<\d+>)?(?=[<(]|$)", n)
    if m is None:
        return name
    base = m.group(1) + (m.group(2) or "")
    args = n[m.end():]
    found = _FUNCTOR.findall(args[: args.find("(")] if "(" in args else args)
    return f"{base}[{found[-1]}]" if found else base


@dataclasses.dataclass
class Event:
    name: str
    on_device: bool
    start_ns: int
    end_ns: int
    thread: int
    runtime: bool = False     # a CUDA runtime or driver call


def _raw_events(prof) -> list[Event]:
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        out.append(Event(name, e.device_type() == cuda, e.start_ns(),
                         e.start_ns() + e.duration_ns(), e.start_thread_id(),
                         name.startswith("cu")))
    return out


def merge(intervals) -> list[tuple[int, int]]:
    """Union of (start, end) intervals, sorted and disjoint."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def innermost_at(ops: list[Event], points: list[int]) -> list[str]:
    """For each time in ``points``, the name of the innermost of ``ops``
    (properly nested intervals of one thread) that contains it."""
    ops = sorted(ops, key=lambda e: (e.start_ns, -e.end_ns))
    order = sorted(range(len(points)), key=lambda i: points[i])
    names = [NO_OP] * len(points)
    stack: list[Event] = []
    k = 0
    for i in order:
        t = points[i]
        while k < len(ops) and ops[k].start_ns <= t:
            while stack and stack[-1].end_ns <= ops[k].start_ns:
                stack.pop()
            stack.append(ops[k])
            k += 1
        while stack and stack[-1].end_ns <= t:
            stack.pop()
        if stack:
            names[i] = stack[-1].name
    return names


def summarize(events: list[Event], launches: dict,
              iterations: int) -> TraceSummary:
    """Reduce the stretch's events (module docstring)."""
    if not events:
        raise RuntimeError("the profiler recorded no events")
    t0 = min(e.start_ns for e in events)
    t1 = max(e.end_ns for e in events)
    dev = [e for e in events if e.on_device]
    busy = merge((e.start_ns, e.end_ns) for e in dev)
    ops = collections.Counter()
    for e in dev:
        ops[e.name] += (e.end_ns - e.start_ns) * 1e-9
    edges = [t0] + [x for iv in busy for x in iv] + [t1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    host = [e for e in events if not e.on_device]
    idle = collections.Counter()
    if host:
        main = collections.Counter(e.thread for e in host).most_common(1)[0][0]
        ops_main = [e for e in host if e.thread == main and not e.runtime]
        names = innermost_at(ops_main, [(s + e) // 2 for s, e in gaps])
        for name, (s, e) in zip(names, gaps):
            idle[name] += (e - s) * 1e-9
    return TraceSummary(
        window_s=(t1 - t0) * 1e-9,
        busy_s=sum(e - s for s, e in busy) * 1e-9,
        device_ops=dict(ops), idle_gaps=dict(idle),
        launches=launches, iterations=iterations)


class Profiled:
    """Runs ``torch.profiler`` from the end of iteration ``after`` to the
    end of iteration ``after + count`` of a job; ``step()`` is called at
    each iteration's end and returns True once the stretch is over.
    ``counters()`` gives the program's counters, whose change over the
    stretch goes into the summary."""

    def __init__(self, after: int, count: int, counters):
        self.after, self.count, self.counters = after, count, counters
        self.n = 0
        self.prof = None
        self.summary = None
        self._c0 = None

    def step(self) -> bool:
        from torch.profiler import ProfilerActivity, profile

        self.n += 1
        if self.n == self.after:
            self._c0 = self.counters()
            self.prof = profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA])
            self.prof.start()
        elif self.prof is not None and self.n == self.after + self.count:
            t0 = time.perf_counter()
            self.prof.stop()
            c1 = self.counters()
            t1 = time.perf_counter()
            events = _raw_events(self.prof)
            t2 = time.perf_counter()
            launches = {k: c1[k] - self._c0[k] for k in c1}
            self.summary = summarize(events, launches, self.count)
            print(f"trace: {len(events)} events; profiler stop "
                  f"{t1 - t0:.1f} s, events read {t2 - t1:.1f} s, reduced "
                  f"{time.perf_counter() - t2:.1f} s", file=sys.stderr,
                  flush=True)
            self.prof = None
        return self.summary is not None
