"""The window arithmetic of the end-to-end metrics, on records built by hand."""

from __future__ import annotations

import math
from types import SimpleNamespace

import numpy as np

from schedbench.loop import CycleRecord, Records
from schedbench.run import RunView, reader


def _cycle(t0, t1, bound, pids=(), phase="window", pods_in=None, engine=0.0, scalar=False):
    m = SimpleNamespace(pods_bound=bound, pods_in=bound if pods_in is None else pods_in,
                        cycle_seconds=t1 - t0, engine_seconds=engine,
                        used_fallback=scalar, pods_unschedulable=0, pods_dropped=0)
    return CycleRecord(phase, t0, t1, m, np.asarray(pids, np.int64),
                       np.zeros(len(pids), np.int64))


def _records(cycles, **kw):
    rec = Records(config={}, traffic={}, seed=0, cluster=None, cycles=cycles)
    for k, v in kw.items():
        setattr(rec, k, v)
    return rec


def test_schedbench_rate_is_all_pods_over_all_window_time():
    cycles = [_cycle(0.0, 1.0, 500, phase="warmup"),
              _cycle(10.0, 12.0, 1000), _cycle(12.5, 13.0, 100), _cycle(13.0, 20.0, 1900)]
    rec = _records(cycles, window_t0=9.5, window_t1=20.0)
    rate = reader("pods_per_s")(RunView(rec=rec, setup_s=1.0))
    # 3,000 pods over 10.5 s: not the sum of cycle times, not a median
    assert math.isclose(rate, 3000 / 10.5)


def test_schedbench_harness_stages_are_clipped_to_the_window():
    cycles = [_cycle(10.0, 12.0, 1000), _cycle(13.0, 20.0, 1900)]
    stages = [("schedbench.delete", 12.0, 13.0), ("schedbench.delete", 20.0, 22.5),
              ("schedbench.delete", 9.0, 10.0), ("schedbench.submit", 19.5, 20.5)]
    rec = _records(cycles, window_t0=10.0, window_t1=20.0, stages=stages)
    from schedbench.metrics._shared import stage_seconds

    # only the deletion between the cycles is inside [10, 20]: 1 s of 10
    assert stage_seconds(rec) == {"schedbench.delete": 1.0, "schedbench.submit": 0.5}


def test_schedbench_host_share_and_engine_per_window():
    cycles = [_cycle(0.0, 2.0, 3000, pods_in=3000, engine=0.5),
              _cycle(2.0, 3.0, 10, pods_in=10, engine=0.0, scalar=True)]
    rec = _records(cycles, batch_window=1024)
    view = RunView(rec=rec, setup_s=0.0)
    assert math.isclose(reader("host_share.saturated")(view), 100 * 2.5 / 3.0)
    # 3,000 pods stack 3 windows of 1,024; the scalar cycle dispatched none
    assert math.isclose(reader("engine_ms_per_window.saturated")(view), 500 / 3)
    assert reader("device_idle.saturated")(view) is None
