"""Arithmetic the metric readers share. `run` is a schedbench.run.RunView:
`run.rec` the run's Records, `run.trace` the DeviceTrace of a traced run
(else None), `run.launches` the kernel launches the traced window made,
with their shapes."""

from __future__ import annotations

import math

import numpy as np

from schedbench import roofline

K1_NAMES = ("masked_score_kernel",)
K3_NAMES = ("auction_bid_kernel",)


def device_cycles(run) -> list:
    """Window cycles the engine served (not the scalar path)."""
    return [c for c in run.rec.window() if not c.metrics.used_fallback]


def windows(cycles: list, batch_window: int) -> int:
    """Engine windows the cycles dispatched: a backlog cycle stacks
    ceil(pods / batch_window) windows into one call."""
    return sum(max(1, math.ceil(c.metrics.pods_in / batch_window)) for c in cycles)


def host_share(run) -> float | None:
    cyc = sum(c.metrics.cycle_seconds for c in run.rec.window())
    eng = sum(c.metrics.engine_seconds for c in run.rec.window())
    return 100.0 * (cyc - eng) / cyc if cyc > 0 else None


def engine_ms_per_window(run) -> float | None:
    cyc = device_cycles(run)
    w = windows(cyc, run.rec.batch_window)
    return 1e3 * sum(c.metrics.engine_seconds for c in cyc) / w if w else None


def launches_per_window(run) -> float | None:
    """Device kernels the profiler saw (copies and fills left out) per
    engine window, over the traced window's cycles."""
    if run.trace is None:
        return None
    w = windows(device_cycles(run), run.rec.batch_window)
    kernels = sum(1 for name, _, _ in run.trace.ops if not name.startswith(("Memcpy", "Memset")))
    return kernels / w if w and kernels else None


def device_idle(run) -> float | None:
    if run.trace is None or not run.trace.ops:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s())


def k1_roofline(run) -> float | None:
    calls = run.launches.get("masked_score", [])
    return _roofline(run, K1_NAMES, [roofline.k1_cost(*c) for c in calls])


def k3_roofline(run) -> float | None:
    calls = run.launches.get("auction_bid", [])
    return _roofline(run, K3_NAMES, [roofline.k3_cost(*c) for c in calls])


def _roofline(run, names: tuple, costs: list) -> float | None:
    """Sum of the launches' least times over the kernels' device time, %."""
    if run.trace is None or not costs:
        return None
    device_s = sum(run.trace.by_name(names).values())
    if device_s <= 0:
        return None
    least = float(np.sum([roofline.least_s(b, o) for b, o in costs]))
    return 100.0 * least / device_s


def stage_seconds(rec) -> dict:
    """{stage name: seconds inside [window_t0, window_t1]} of the
    harness's stages."""
    out: dict = {}
    for n, t0, t1 in rec.stages:
        d = min(t1, rec.window_t1) - max(t0, rec.window_t0)
        if d > 0:
            out[n] = out.get(n, 0.0) + d
    return out
