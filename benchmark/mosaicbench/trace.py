"""One bounded span under ``torch.profiler``, reduced to what the metrics
read: the device's busy time, kernel durations by name, and where the
device sat idle.

The busy share's arithmetic (the union of kernel, copy and memset
intervals over the traced wall) is a frozen copy of ``_union_us`` and
``phase_trace`` in ``chip_smoke.py`` at commit
8b7ff0e672e454ed1a7cdb8444acc84ca8d92c55. Only CUDA activity is recorded
(the device's operations and the runtime calls that launched them), so a
sortie's trace stays small enough to read in seconds. Nothing here
imports the program.

The records are kept as the profiler gives them, never clipped to the
span, so the in-trace check (:meth:`Trace.faults`) can fail: a record
placed outside the span, a busy time longer than the span or than the
CUDA events around it, or a kernel whose durations add up to more than
those events (the smoke's check) each fail the trace, and every metric
read from it is left out.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

TOL_S = 1e-3    # the profiler's clock against the host's and the events'


def union_s(intervals) -> float:
    """Total length of the union of (start, end) intervals."""
    busy, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        busy += b - max(a, end)
        end = b
    return busy


@dataclass
class Trace:
    """A traced span: ``wall_s`` the host's clock over it (synchronised at
    both ends), ``events_s`` the CUDA events recorded at its two ends,
    ``ops`` the device operations as (name, start s, end s) relative to
    the span's start, as recorded, ``host_spans`` the host's named
    intervals as (name, start s, end s) on the same clock, ``placed``
    whether the profiler's clock could be set on the host's."""

    wall_s: float
    events_s: float
    ops: list
    host_spans: list = field(default_factory=list)
    placed: bool = True

    @property
    def busy_s(self) -> float:
        return union_s((a, b) for _, a, b in self.ops)

    def kernel_s(self, name: str) -> list:
        """Durations of the device operations whose name holds ``name``."""
        return [b - a for n, a, b in self.ops if name in n]

    def faults(self, kernels=()) -> list:
        """The in-trace check, as a list of what failed (empty: passed).
        Every record lies inside the span, to :data:`TOL_S`; the device
        was busy at all, and for no longer than the span or the events
        around it; the durations of each kernel of ``kernels`` add up to
        no more than those events."""
        out = []
        if not self.placed:
            out.append("the profiler's clock is not the host's: its "
                       "records cannot be placed on the span")
        if self.ops:
            first = min(a for _, a, _ in self.ops)
            last = max(b for _, _, b in self.ops)
            if first < -TOL_S:
                out.append(f"a record starts {-first:.6f} s before the span")
            if last > self.wall_s + TOL_S:
                out.append(f"a record ends {last - self.wall_s:.6f} s "
                           f"after the span")
        busy = self.busy_s
        if not 0.0 < busy <= min(self.wall_s, self.events_s + TOL_S):
            out.append(f"busy {busy:.6f} s against the span's "
                       f"{self.wall_s:.6f} s and the events' "
                       f"{self.events_s:.6f} s")
        for k in kernels:
            total = sum(self.kernel_s(k))
            if total > self.events_s + TOL_S:
                out.append(f"'{k}' durations add up to {total:.6f} s, "
                           f"over the events' {self.events_s:.6f} s")
        return out

    def margins(self):
        """(first record's start, last record's end - wall) in s: where
        the records sit against the span's ends."""
        if not self.ops:
            return None, None
        return (min(a for _, a, _ in self.ops),
                max(b for _, _, b in self.ops) - self.wall_s)

    def top_ops(self, k: int = 10):
        by_name: dict = {}
        for n, a, b in self.ops:
            by_name[n] = by_name.get(n, 0.0) + (b - a)
        return [[n[:96], s] for n, s in
                sorted(by_name.items(), key=lambda kv: -kv[1])[:k]]

    def idle_gaps(self, k: int = 10, min_s: float = 1e-4):
        """The ``k`` longest intervals with no device operation inside the
        span, each named by the shortest host span that holds its
        midpoint (what the host was doing), as [name, seconds]."""
        edges = sorted((a, b) for _, a, b in self.ops)
        gaps, end = [], 0.0
        for a, b in edges:
            if a - end >= min_s:
                gaps.append((end, a))
            end = max(end, b)
        if self.wall_s - end >= min_s:
            gaps.append((end, self.wall_s))
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for a, b in gaps[:k]:
            mid = 0.5 * (a + b)
            holds = [(e - s, n) for n, s, e in self.host_spans
                     if s <= mid <= e]
            out.append([min(holds)[1] if holds else "outside the spans",
                        b - a])
        return out


def _event_ns(ev):
    """(start ns, end ns) of a kineto event on the profiler's clock."""
    if hasattr(ev, "start_ns"):
        s = ev.start_ns()
        return s, s + ev.duration_ns()
    s = ev.start_us() * 1000
    return s, s + ev.duration_us() * 1000


def traced(fn, device):
    """Run ``fn(span)`` once under the profiler (CUDA activity only) and
    return (its result, :class:`Trace`). ``fn`` may call ``span(name, t0,
    t1)`` with ``time.time()`` readings to name what the host was doing."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    host = []
    torch.cuda.synchronize(device)
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize(device)
        t_wall0 = time.time()
        t0 = time.perf_counter()
        e0.record()
        out = fn(lambda name, a, b: host.append((name, a, b)))
        e1.record()
        torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
    events_s = e0.elapsed_time(e1) / 1e3
    res = prof.profiler.kineto_results
    start = (res.trace_start_ns() if hasattr(res, "trace_start_ns")
             else res.trace_start_us() * 1000)
    # the profiler's clock is the epoch's (time.time()): its records are
    # placed on the span exactly; on any other clock they cannot be
    placed = abs(start / 1e9 - t_wall0) < 60.0
    cuda = torch.autograd.DeviceType.CUDA
    ops = []
    for ev in res.events():
        if ev.device_type() == cuda:
            a, b = _event_ns(ev)
            ops.append((ev.name(), a / 1e9 - t_wall0, b / 1e9 - t_wall0))
    spans = [(n, a - t_wall0, b - t_wall0) for n, a, b in host]
    return out, Trace(wall, events_s, ops, spans, placed)
