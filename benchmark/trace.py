"""The traced window: `torch.profiler` over the card's kernels and copies
(CUPTI; no host operators, whose events would outnumber the kernels),
read into device intervals by kernel name.

Host spans (the benchmark's own, around its calls into the program) are
put on the trace's clock by a marker kernel launched right after a
synchronisation: its start on the device, less the host's clock at its
launch, is the offset (a few microseconds of launch latency in error)."""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch

MARKER = "spin_kernel"     # in the name of torch.cuda._sleep's kernel
SKIP = ("Activity Buffer", MARKER)


class Spans:
    """Host spans (name, start ns, end ns) on `time.perf_counter_ns`."""

    def __init__(self):
        self.items: List[Tuple[str, int, int]] = []

    def add(self, name: str, t0: int, t1: int) -> None:
        self.items.append((name, t0, t1))

    def durations_ms(self, name: str) -> List[float]:
        return [(t1 - t0) / 1e6 for n, t0, t1 in self.items if n == name]


class DeviceTrace:
    """Kernels and copies of one profiled window: `kernels` as (name,
    start ns, end ns) on the trace's clock, `window` (start, end) there,
    `offset` from the host's perf_counter_ns to it."""

    def __init__(self):
        self._prof = None
        self.kernels: List[Tuple[str, int, int]] = []
        self.window: Tuple[int, int] = (0, 0)
        self.offset = 0
        self.host = (0, 0)

    def start(self, device) -> None:
        from torch.profiler import ProfilerActivity, profile
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.start()
        torch.cuda.synchronize(device)
        self._marker_host = time.perf_counter_ns()
        torch.cuda._sleep(100)
        torch.cuda.synchronize(device)
        self.host = (time.perf_counter_ns(), 0)

    def stop(self, device) -> None:
        torch.cuda.synchronize(device)
        self.host = (self.host[0], time.perf_counter_ns())
        self._prof.stop()
        events = _events(self._prof)
        self._prof = None
        marker = [s for n, s, _ in events if MARKER in n]
        self.kernels = [(n, s, e) for n, s, e in events
                        if not any(k in n for k in SKIP)]
        if marker:
            self.offset = marker[0] - self._marker_host
            self.window = (self.host[0] + self.offset,
                           self.host[1] + self.offset)
        elif self.kernels:
            # no marker: the window from the first kernel to the last,
            # which leaves out the idle time at either end
            self.window = (min(s for _, s, _ in self.kernels),
                           max(e for _, _, e in self.kernels))

    # ---- readings ------------------------------------------------------
    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def busy_s(self) -> float:
        """Seconds in which at least one kernel or copy ran (the union of
        the intervals, clipped to the window)."""
        return sum(e - s for s, e in self._union()) / 1e9

    def _union(self) -> List[Tuple[int, int]]:
        lo, hi = self.window
        spans = sorted((max(s, lo), min(e, hi)) for _, s, e in self.kernels
                       if e > lo and s < hi)
        out: List[Tuple[int, int]] = []
        for s, e in spans:
            if out and s <= out[-1][1]:
                out[-1] = (out[-1][0], max(out[-1][1], e))
            else:
                out.append((s, e))
        return out

    def seconds_where(self, pred) -> Optional[float]:
        """Summed seconds of the kernels whose name satisfies pred; None
        where none ran."""
        ds = [(e - s) for n, s, e in self.kernels if pred(n)]
        return sum(ds) / 1e9 if ds else None

    def top_ops(self, k: int = 10) -> List[List]:
        by: Dict[str, int] = defaultdict(int)
        for n, s, e in self.kernels:
            by[n[:160]] += e - s
        top = sorted(by.items(), key=lambda kv: -kv[1])[:k]
        return [[n, ns / 1e9] for n, ns in top]

    def idle_gaps(self, spans: Spans, k: int = 10) -> List[List]:
        """The window's idle seconds summed by what the host was doing at
        each gap's middle: the innermost benchmark span there, else "host
        outside the benchmark's spans"."""
        lo, hi = self.window
        busy = self._union()
        gaps, at = [], lo
        for s, e in busy:
            if s > at:
                gaps.append((at, s))
            at = max(at, e)
        if hi > at:
            gaps.append((at, hi))
        host = [(n, t0 + self.offset, t1 + self.offset)
                for n, t0, t1 in spans.items]
        by: Dict[str, int] = defaultdict(int)
        count: Dict[str, int] = defaultdict(int)
        for s, e in gaps:
            mid = (s + e) // 2
            inside = [(t1 - t0, n) for n, t0, t1 in host if t0 <= mid < t1]
            name = min(inside)[1] if inside else \
                "host outside the benchmark's spans"
            by[name] += e - s
            count[name] += 1
        top = sorted(by.items(), key=lambda kv: -kv[1])[:k]
        return [[f"{n} ({count[n]} gaps)", ns / 1e9] for n, ns in top]


def _events(prof) -> List[Tuple[str, int, int]]:
    """(name, start ns, end ns) of the device events of a stopped
    profiler, from kineto's results (faster than building the operator
    tree), else from `prof.events()`."""
    from torch.autograd import DeviceType
    out = []
    try:
        raw = prof.profiler.kineto_results.events()
    except AttributeError:
        raw = None
    if raw is not None:
        for e in raw:
            if e.device_type() != DeviceType.CUDA:
                continue
            start = (e.start_ns() if hasattr(e, "start_ns")
                     else e.start_us() * 1000)
            dur = (e.duration_ns() if hasattr(e, "duration_ns")
                   else e.duration_us() * 1000)
            out.append((e.name(), int(start), int(start + dur)))
        return out
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            out.append((e.name, int(e.time_range.start * 1000),
                        int(e.time_range.end * 1000)))
    return out
