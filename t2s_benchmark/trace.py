"""The traced window: host spans of the benchmark's own, the device's timeline, and what is read from them.

Spans are ``record_function`` ranges named ``t2s:<name>``; with ``sync`` the
span waits for the device at both ends, so the device work between its ends
is the span's own. The device's timeline is every kernel, copy and set on the
card in the profiler's trace. Busy time is the union of those intervals, and
the idle share its complement over the window.
"""

import contextlib
import time
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import torch

PREFIX = "t2s:"


@dataclass
class Timeline:
    window: Tuple[int, int]                         # ns, the profiler's clock
    spans: List[Tuple[str, int, int]] = field(default_factory=list)
    device: List[Tuple[str, int, int]] = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-9

    def in_window(self):
        a, b = self.window
        return [(n, max(s, a), min(e, b)) for n, s, e in self.device if e > a and s < b]

    def busy_s(self, ops=None) -> float:
        """Seconds in which at least one device operation ran (the union)."""
        ops = sorted(self.in_window() if ops is None else ops, key=lambda o: o[1])
        total, end = 0, None
        for _, s, e in ops:
            if end is None or s > end:
                total += e - s
                end = e
            elif e > end:
                total += e - end
                end = e
        return total * 1e-9

    def idle_pct(self):
        """100 x (1 - busy / window), or None where the device ran nothing in the window."""
        if not self.in_window():
            return None
        return 100.0 * (1.0 - self.busy_s() / self.window_s)

    def spans_named(self, name: str):
        return [(s, e) for n, s, e in self.spans if n == name]

    def device_in(self, start: int, end: int):
        """Device operations that start inside [start, end]."""
        return [o for o in self.device if start <= o[1] < end]

    def top_ops(self, n: int = 10):
        """The device operations that took most time, summed by name."""
        by = {}
        for name, s, e in self.in_window():
            by[name] = by.get(name, 0) + (e - s)
        return [[k[:64], v * 1e-9] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10):
        """The longest idle stretches of the device, each named by the innermost
        benchmark span the host was in at its middle."""
        ops = sorted(self.in_window(), key=lambda o: o[1])
        gaps, end = [], self.window[0]
        for _, s, e in ops:
            if s > end:
                gaps.append((end, s))
            end = max(end, e)
        if self.window[1] > end:
            gaps.append((end, self.window[1]))
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for a, b in gaps[:n]:
            mid = (a + b) // 2
            inner = [(e - s, name) for name, s, e in self.spans if s <= mid < e]
            out.append([min(inner)[1] if inner else "outside", (b - a) * 1e-9])
        return out


class Phases(list):
    """Seconds of each named part of set-up, the device synchronized at each end."""

    def __init__(self, device: torch.device):
        super().__init__()
        self.device = device

    @contextlib.contextmanager
    def __call__(self, name: str):
        cuda = self.device.type == "cuda"
        if cuda:
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        yield
        if cuda:
            torch.cuda.synchronize(self.device)
        self.append((name, time.perf_counter() - t0))


class Tracer:
    """Spans always; the profiler only when ``enabled`` (the ``--trace 1`` run)."""

    def __init__(self, enabled: bool, device: torch.device):
        self.enabled = enabled
        self.device = device
        self.timeline: Optional[Timeline] = None

    @contextlib.contextmanager
    def span(self, name: str, sync: bool = False):
        if not self.enabled:
            yield
            return
        sync = sync and self.device.type == "cuda"
        if sync:
            torch.cuda.synchronize(self.device)
        with torch.profiler.record_function(PREFIX + name):
            yield
            if sync:
                torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def window(self):
        if not self.enabled:
            yield
            return
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if self.device.type == "cuda" else [])
        with profile(activities=acts) as prof:
            start = time.time_ns()
            yield
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            end = time.time_ns()
        self.timeline = _read(prof, start, end)


def _read(prof, start: int, end: int) -> Timeline:
    tl = Timeline((start, end))
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        s, d = e.start_ns(), e.duration_ns()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if not name.startswith(PREFIX) and not e.is_user_annotation():
                tl.device.append((name, s, s + d))
        elif name.startswith(PREFIX):
            tl.spans.append((name[len(PREFIX):], s, s + d))
    return tl
