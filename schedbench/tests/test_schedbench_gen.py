"""The generators are functions of the seed alone."""

from __future__ import annotations

import numpy as np

from schedbench.gen import traffic
from schedbench.gen.cluster import PodSource, draw_cluster
from schedbench.tests.conftest import tiny_cell

BIG = 2**31 + 987_654_321


def test_schedbench_cluster_is_a_function_of_the_seed():
    cfg = tiny_cell("basic-5k.saturated").config
    a, b, c = draw_cluster(cfg, BIG), draw_cluster(cfg, BIG), draw_cluster(cfg, BIG + 1)
    for name in ("alloc", "cpu_pct", "mem_pct", "disk_io", "net_up", "net_down"):
        assert np.array_equal(getattr(a, name), getattr(b, name))
    assert not np.array_equal(a.cpu_pct, c.cpu_pct)
    # the same values in another order: every seed gets the same work
    assert np.array_equal(np.sort(a.disk_io), np.sort(c.disk_io))
    assert a.names == b.names and len(a.names) == cfg["nodes"]
    assert (a.disk_io <= 50.0).all() and (a.cpu_pct < 100.0).all()


def test_schedbench_pod_draws_do_not_depend_on_block_boundaries():
    cfg = tiny_cell("basic-5k.saturated").config
    a, b = PodSource(cfg, BIG), PodSource(cfg, BIG)
    first = [a.disk_io(i) for i in range(70_000)]
    assert b.disk_io(69_999) == first[-1]
    a.count = 70_000
    assert np.array_equal(a.draws(), np.array(first))
    assert min(first) >= 0.1 and max(first) <= 45.0
    other = PodSource(cfg, BIG + 1)
    block = PodSource.BLOCK
    mine, theirs = a.draws()[:block], np.array([other.disk_io(i) for i in range(block)])
    assert not np.array_equal(mine, theirs)
    assert np.array_equal(np.sort(mine), np.sort(theirs))


def test_schedbench_window_submits_pods_built_in_setup():
    from schedbench.loop import CellRun

    cell = tiny_cell("antiaffinity-5k.saturated", backlog=24)
    run = CellRun(cell.config, cell.traffic, BIG, device="cpu")
    try:
        run.setup(0.3)
        built = run.pods.count
        assert built == cell.config["running_pods"] + traffic.pool_size(cell.traffic, 0.3) + 2 * 24
        run.window(0.3)
    finally:
        run.close()
    rec = run.rec
    # the window built no pod: it only submitted the pool's
    assert run.pods.count == built and rec.pool_short == 0
    assert 0 < rec.window_submitted and rec.submitted <= built
    assert rec.pod_io.shape == rec.pod_init.shape == (rec.submitted,)
    assert rec.pod_init.sum() == cell.config["running_pods"]
    assert rec.k1 is not None and rec.k1["cycle"] < len(rec.cycles)


def test_schedbench_refill_tops_up_the_backlog():
    tr = {"kind": "closed_backlog", "backlog_pods": 8192, "pool_pods_per_s": 100}
    traffic.check(tr)
    assert traffic.pool_size(tr, 2.5) == 8192 + 250
    assert traffic.refill_count(tr, 100) == 8092
    assert traffic.refill_count(tr, 9000) == 0
