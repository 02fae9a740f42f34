"""The reader of graph_round_share.saturated on RunViews built by hand:
the program's CycleMetrics.auction_graph_rounds over its auction_rounds,
over the window's device cycles; None on a program without the field."""

from __future__ import annotations

import math
from types import SimpleNamespace

import numpy as np

from schedbench.loop import CycleRecord, Records
from schedbench.run import RunView, reader

READ = "graph_round_share.saturated"


def _metrics(rounds, graphed, scalar=False):
    from kubernetes_scheduler_tpu_torch.host.scheduler import CycleMetrics

    return CycleMetrics(pods_in=1000, pods_bound=1000, used_fallback=scalar,
                        auction_rounds=rounds, auction_graph_rounds=graphed)


def _view(cycles):
    recs = [CycleRecord(phase, 0.0, 0.0, m, np.zeros(0, np.int64), np.zeros(0, np.int64))
            for phase, m in cycles]
    rec = Records(config={}, traffic={}, seed=0, cluster=None, cycles=recs, stages=[],
                  batch_window=1024)
    rec.window_t0, rec.window_t1 = 10.0, 20.0
    return RunView(rec=rec, setup_s=1.0)


def test_schedbench_graph_round_share_reads_the_program_counter():
    read = reader(READ)
    # warm-up (the capture) and scalar cycles left out: 40 + 48 of 40 + 56
    cycles = [("warmup", _metrics(48, 0)), ("window", _metrics(40, 40)),
              ("window", _metrics(56, 48)), ("window", _metrics(0, 0, scalar=True))]
    assert math.isclose(read(_view(cycles)), 100.0 * 88 / 96)
    # every round replayed
    assert math.isclose(read(_view([("window", _metrics(47, 47))])), 100.0)
    # the eager loop (the CPU, K3's head): the field is there and reads 0
    assert read(_view([("window", _metrics(8, 0))])) == 0.0


def test_schedbench_graph_round_share_finds_nothing_without_the_field():
    read = reader(READ)
    old = [("window", SimpleNamespace(pods_in=1000, pods_bound=1000, used_fallback=False,
                                      auction_rounds=47))]
    assert read(_view(old)) is None
    assert read(_view([("window", _metrics(0, 0))])) is None
    assert read(_view([])) is None
