"""The generators are functions of the seed alone."""

from __future__ import annotations

import numpy as np

from schedbench.gen import traffic
from schedbench.gen.cluster import PodSource, class_block, draw_cluster
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


def _card_config():
    from schedbench.tests.test_schedbench_cards import card_cell

    return card_cell("card", nodes=300).config


def test_schedbench_cards_are_a_function_of_the_seed():
    cfg = _card_config()
    a, b, c = draw_cluster(cfg, BIG), draw_cluster(cfg, BIG), draw_cluster(cfg, BIG + 1)
    assert a.cards.shape == (300, 4, 6) and a.card_healthy.shape == (300, 4)
    assert np.array_equal(a.cards, b.cards) and np.array_equal(a.card_healthy, b.card_healthy)
    assert not np.array_equal(a.cards, c.cards)
    # the same nodes' card sets in another order, every card as drawn
    def sets(cl):
        rows = np.concatenate([cl.cards.reshape(300, -1), cl.card_healthy], axis=1)
        return rows[np.lexsort(rows.T[::-1])]
    assert np.array_equal(sets(a), sets(c))
    bw, clock, core, power, free, total = np.moveaxis(a.cards, -1, 0)
    assert bw.min() >= 16 and bw.max() < 64 and set(np.unique(clock)) == {1000, 1500, 2000}
    assert core.min() >= 1024 and power.max() < 400 and free.max() < 32000
    assert (total == 32000).all() and 0.9 < a.card_healthy.mean() < 1.0
    # the node draws are those of the configuration without cards
    plain = draw_cluster({**cfg, "node": {**cfg["node"], "cards": None}}, BIG)
    assert np.array_equal(plain.cpu_pct, a.cpu_pct) and plain.cards is None


def test_schedbench_class_draws_give_every_seed_the_same_counts():
    cfg = _card_config()
    shares = np.array([c["share"] for c in cfg["pod"]["classes"]])
    shares /= shares.sum()
    block = PodSource.BLOCK
    a, b = PodSource(cfg, BIG), PodSource(cfg, BIG + 1)
    a.count = b.count = 2 * block + 5
    ca, cb = a.classes(), b.classes()
    assert not np.array_equal(ca, cb)
    for k in range(2):
        part = slice(k * block, (k + 1) * block)
        assert np.array_equal(np.bincount(ca[part]), np.bincount(cb[part]))
    assert np.allclose(np.bincount(ca[:block]) / block, shares, atol=1 / block)
    assert [a.pod_class(i) for i in range(10)] == ca[:10].tolist()
    # the diskIO draws do not move with the classes
    plain = PodSource({**cfg, "pod": {**cfg["pod"], "classes": None}}, BIG)
    plain.count = a.count
    assert np.array_equal(plain.draws(), a.draws())
    assert class_block([{"share": 1}, {"share": 2}], 4).tolist() == [0, 1, 1, 1]
