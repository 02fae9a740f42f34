"""The device trace of a traced run, read from torch.profiler on the card.

A frozen copy of chip_smoke.device_profile's reading (device time by
kernel name from the profiler's events), with one change: the device's
busy time is the union of the device operations' intervals, not their
sum, so work on overlapping streams is not counted twice. The profiler's
clock is tied to the host's perf_counter by one marker range the harness
opens at a known host time, so idle gaps can be named by what the host
was doing (the program's spans and the harness's own stages).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

MARK = "schedbench.mark"


@dataclass
class DeviceTrace:
    """Device operations of the traced window, on the host's clock."""

    ops: list                  # [(name, start_s, dur_s)] device operations
    window: tuple              # (t0, t1) perf_counter of the traced window
    spans: list = field(default_factory=list)   # [(name, t0, t1)] host stages

    def busy_intervals(self) -> list:
        """Merged [start, end] intervals of device activity inside the window."""
        t0, t1 = self.window
        iv = sorted((max(s, t0), min(s + d, t1)) for _, s, d in self.ops)
        merged: list = []
        for a, b in iv:
            if b <= a:
                continue
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return merged

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals())

    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def by_name(self, contains: tuple = ()) -> dict:
        """{kernel name: summed device seconds}, optionally only names that
        contain one of `contains`."""
        out: dict = {}
        for name, _, d in self.ops:
            if not contains or any(x in name for x in contains):
                out[name] = out.get(name, 0.0) + d
        return out

    def idle_gaps(self) -> dict:
        """{host stage: idle device seconds}: every gap between busy
        intervals, named by the innermost host span at its midpoint."""
        t0, t1 = self.window
        edges = [t0]
        for a, b in self.busy_intervals():
            edges += [a, b]
        edges.append(t1)
        spans = sorted(self.spans, key=lambda s: s[1])
        out: dict = {}
        active: list = []
        i = 0
        for a, b in zip(edges[::2], edges[1::2]):
            if b <= a:
                continue
            mid = 0.5 * (a + b)
            while i < len(spans) and spans[i][1] <= mid:
                active.append(spans[i])
                i += 1
            active = [sp for sp in active if sp[2] >= mid]
            name = min(active, key=lambda sp: sp[2] - sp[1])[0] if active else "unlabelled"
            out[name] = out.get(name, 0.0) + (b - a)
        return out


class Tracer:
    """torch.profiler over the traced window."""

    def __init__(self, torch):
        self.torch = torch
        self.prof = None
        self.t_mark = 0.0
        self.t0 = self.t1 = 0.0

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        self.torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.__enter__()
        with self.torch.profiler.record_function(MARK):
            self.t_mark = time.perf_counter()
        self.t0 = time.perf_counter()

    def stop(self, spans: list) -> DeviceTrace:
        self.torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.prof.__exit__(None, None, None)
        return DeviceTrace(ops=self._device_ops(), window=(self.t0, self.t1), spans=spans)

    def _device_ops(self) -> list:
        """[(name, start_s, dur_s)] on the host clock, from the kineto events."""
        from torch.autograd import DeviceType

        events = self.prof.profiler.kineto_results.events()
        mark = None
        ops = []
        for e in events:
            if e.device_type() == DeviceType.CUDA:
                ops.append((e.name(), e.start_ns() * 1e-9, e.duration_ns() * 1e-9))
            elif mark is None and e.name() == MARK:
                mark = e.start_ns() * 1e-9
        if mark is None:
            raise RuntimeError("the profiler lost the clock marker")
        shift = self.t_mark - mark
        return [(n, s + shift, d) for n, s, d in ops]
