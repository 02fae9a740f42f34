"""The arithmetic of the readers of the program's own spans and round
counter (mirror_share, auction_ms_per_window, rounds_per_window), on a
RunView built by hand: the program's CycleMetrics, the harness's stages
and the traced window's spans."""

from __future__ import annotations

import math
from types import SimpleNamespace

import numpy as np

from schedbench.loop import CycleRecord, Records
from schedbench.metrics._shared import stage_seconds
from schedbench.profile import DeviceTrace
from schedbench.run import RunView, reader

WINDOW = (10.0, 20.0)


def _metrics(pods_in, rounds, scalar=False):
    from kubernetes_scheduler_tpu_torch.host.scheduler import CycleMetrics

    return CycleMetrics(pods_in=pods_in, pods_bound=pods_in, used_fallback=scalar,
                        auction_rounds=rounds)


def _view(cycles, spans=None, stages=()):
    """cycles: [(phase, metrics)]; spans: the traced window's (name, t0,
    t1), None for a run without a trace."""
    recs = [CycleRecord(phase, 0.0, 0.0, m, np.zeros(0, np.int64), np.zeros(0, np.int64))
            for phase, m in cycles]
    rec = Records(config={}, traffic={}, seed=0, cluster=None, cycles=recs,
                  stages=list(stages), batch_window=1024)
    rec.window_t0, rec.window_t1 = WINDOW
    trace = None if spans is None else DeviceTrace(ops=[], window=WINDOW, spans=list(spans))
    return RunView(rec=rec, setup_s=1.0, trace=trace)


# a warm-up cycle (not the window's), two device cycles stacking 3 + 1
# engine windows of 1,024, and a cycle the scalar path served (no windows)
CYCLES = [("warmup", _metrics(8192, 99)), ("window", _metrics(2500, 30)),
          ("window", _metrics(100, 10)), ("window", _metrics(5000, 0, scalar=True))]


def test_schedbench_mirror_share_clips_bursts_to_the_window():
    # the informer's deletions between the program's cycles
    between = [("pod_events", 8.0, 11.0), ("pod_events", 12.0, 14.0),
               ("pod_events", 19.0, 22.0), ("pod_events", 21.0, 23.0)]
    cycles = [("cycle", 11.0, 12.0), ("cycle", 14.0, 19.0)]
    # the mirror's self-apply of a cycle's binds: inside the cycle, left out
    inside = [("pod_events", 18.0, 19.0), ("pod_events", 11.5, 12.0)]
    spans = between + cycles + inside + [("schedbench.delete", 12.0, 18.0)]
    # the same intervals as the harness's own stage: the two shares agree
    stages = [("schedbench.delete", t0, t1) for _, t0, t1 in between]
    view = _view(CYCLES, spans, stages)
    share = reader("mirror_share.saturated")(view)
    # 1 + 2 + 1 + 0 s of a 10-s window
    assert math.isclose(share, 40.0)
    assert math.isclose(share, 100.0 * stage_seconds(view.rec)["schedbench.delete"] / 10.0)
    # a burst that crosses a cycle's edge counts only outside it
    crossing = _view(CYCLES, [("pod_events", 13.0, 15.0)] + cycles)
    assert math.isclose(reader("mirror_share.saturated")(crossing), 10.0)


def test_schedbench_program_span_readers_find_nothing_without_spans():
    no_trace = _view(CYCLES, None)
    other_spans = _view(CYCLES, [("cycle", 10.0, 20.0), ("engine_step", 11.0, 12.0)])
    for name in ("mirror_share.saturated", "auction_ms_per_window.saturated"):
        assert reader(name)(no_trace) is None
        assert reader(name)(other_spans) is None


def test_schedbench_auction_ms_per_window_counts_stacked_windows():
    spans = [("auction", 11.0, 11.1), ("auction", 11.2, 11.5), ("auction_round", 11.0, 11.05),
             ("engine_window", 11.0, 11.2), ("pod_events", 12.0, 14.0)]
    # 0.4 s of auctions over 3 + 1 windows; the scalar cycle stacks none
    got = reader("auction_ms_per_window.saturated")(_view(CYCLES, spans))
    assert math.isclose(got, 100.0)


def test_schedbench_rounds_per_window_reads_the_program_counter():
    read = reader("rounds_per_window.saturated")
    # 30 + 10 rounds over 3 + 1 windows; warm-up and scalar cycles left out
    assert math.isclose(read(_view(CYCLES, None)), 10.0)
    # a program built before the round counter existed
    old = [("window", SimpleNamespace(pods_in=2500, pods_bound=2500, used_fallback=False))]
    assert read(_view(old, None)) is None
    # a program that counted no round (the greedy assigner)
    assert read(_view([("window", _metrics(2500, 0))], None)) is None
    assert read(_view([], None)) is None
