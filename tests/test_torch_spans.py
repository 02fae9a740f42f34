"""The port's spans inside the snapshot mirror, the engine's window loop
and the auction, its round counter and pending count, and its device
profiles on the span clock (host/observe.py), on the CPU.

- The mirror's pod events coalesce into `pod_events` bursts: one burst
  per run of events no more than observe.BURST_GAP_S apart, cut at each
  cycle boundary, its `events` the events applied (a cycle's binds, one
  batch, count each pod).
- `engine_window` and `auction` spans nest inside their cycle's
  `engine_step`; the `auction_round` spans, CycleMetrics.auction_rounds,
  the `auction` spans' `rounds` and auction_rounds_total agree, on both
  bid heads.
- With span_path unset nothing is collected, the rounds still count, and
  the engine's results are bitwise those of a call with no handle
  published.
- The mirror's row pass is one `mirror_rows` span inside its cycle's
  `mirror_emit`, its `nodes` summing to mirror_row_nodes_total; with
  spans off the mirror keeps no bursts, recomputes the same rows and the
  bindings are bitwise the same.
- Where the snapshot holds GPU cards, each region of the card path (the
  card policy's score, the card fit) is one `card_path` span inside its
  `engine_window`; card_cells_total{stage} and CycleMetrics.card_cells
  count its pods x nodes x card slots; without cards nothing is
  recorded; the decisions are bitwise the same with spans on and off.
- A device profile shares the span files' clock; `spans report` still
  attributes 100% of the cycle.

Test names avoid the substrings tests/conftest.py marks slow."""

import json

import pytest
import torch

from kubernetes_scheduler_tpu_torch import TorchEngine
from kubernetes_scheduler_tpu_torch.engine import stack_windows
from kubernetes_scheduler_tpu_torch.host import observe
from kubernetes_scheduler_tpu_torch.host.scheduler import Scheduler
from kubernetes_scheduler_tpu_torch.sim.host_gen import gen_host_cluster, gen_host_pods
from kubernetes_scheduler_tpu_torch.trace import analyze
from kubernetes_scheduler_tpu_torch.trace.spans import read_spans
from kubernetes_scheduler_tpu_torch.utils.config import SchedulerConfig

HEADS = {"k3": False, "affinity": True}   # head -> constraints (anti-affinity pods)


def make_sched(span_path=None, *, constraints=False, gpu=False, n_nodes=24, **kw):
    """The port's Scheduler on TorchEngine(device="cpu"), the engine path
    pinned, backlogs of 4 windows of 16 (nodes with 4 SCV cards each with
    `gpu`); returns (scheduler, running)."""
    nodes, advisor = gen_host_cluster(n_nodes, seed=0, constraints=constraints, gpu=gpu)
    running: list = []
    kw.setdefault("batch_window", 16)
    kw.setdefault("max_windows_per_cycle", 4)
    cfg = SchedulerConfig(min_device_work=1, adaptive_dispatch=False,
                          initial_backoff_seconds=3600.0, max_backoff_seconds=3600.0,
                          span_path=span_path, **kw)
    sched = Scheduler(cfg, advisor=advisor, list_nodes=lambda: nodes,
                      list_running_pods=lambda: running, engine=TorchEngine(device="cpu"))
    return sched, running


def drive(sched, running, pods, *, cycles=4, delete=0):
    """Submit `pods` and run `cycles` cycles; after each, feed the binds
    back as running pods and delete the `delete` oldest through the
    mirror (the informer's DELETED events). Returns the CycleMetrics."""
    for pod in pods:
        sched.submit(pod)
    out, seen = [], 0
    for _ in range(cycles):
        out.append(sched.run_cycle())
        running.extend(b.pod for b in sched.binder.bindings[seen:])
        seen = len(sched.binder.bindings)
        for pod in running[:delete]:
            sched.mirror.apply_pod_event("DELETED", pod)
        del running[:delete]
    return out


def spans_of(sched, path):
    sched.spans.close()
    return [e for e in read_spans(str(path)) if e.get("ph") == "X"]


def encloses(outer, inner, slack_us=0.0):
    return (outer["ts"] - slack_us <= inner["ts"]
            and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"] + slack_us)


def test_torch_spans_bursts_coalesce_by_gap_and_cycle():
    b = observe.PodEventBursts()
    gap = observe.BURST_GAP_S
    b.event(0.0, 1e-4, 1e-5, True)
    b.event(1e-4 + gap, 2e-4 + gap, 0.0, False)        # exactly the gap: same burst
    b.event(3e-4 + 2 * gap, 4e-4 + 2 * gap, 2e-5, True)  # past it: a new burst
    b.cut()
    b.event(1.0, 1.1, 0.0, True)
    b.cut()
    b.cut()                                            # nothing open: no empty burst
    got, dropped = b.drain()
    assert dropped == 0
    assert [g[0] for g in got] == ["pod_events"] * 3
    assert [(g[1], g[2]) for g in got] == [(0.0, 2e-4 + gap), (3e-4 + 2 * gap, 4e-4 + 2 * gap),
                                           (1.0, 1.1)]
    assert [g[3] for g in got] == [
        {"events": 2, "deleted": 1, "lock_wait_s": 1e-5},
        {"events": 1, "deleted": 1, "lock_wait_s": 2e-5},
        {"events": 1, "deleted": 1, "lock_wait_s": 0.0},
    ]
    assert b.drain() == ([], 0)
    for i in range(observe.MAX_PENDING_BURSTS + 3):
        b.event(10.0 * i, 10.0 * i + 1, 0.0, False)
    b.cut()
    kept, dropped = b.drain()
    assert len(kept) == observe.MAX_PENDING_BURSTS and dropped == 3
    assert b.drain() == ([], 0)
    assert kept[-1][1] == 10.0 * (observe.MAX_PENDING_BURSTS + 2)


def test_torch_spans_pod_events_one_span_per_burst(tmp_path):
    path = tmp_path / "spans"
    sched, running = make_sched(str(path))
    calls = []
    apply = sched.mirror.apply_pod_events

    def counted(etype, pods):
        # single events (apply_pod_event) come through here as well
        calls.extend([etype] * len(pods))
        apply(etype, pods)

    sched.mirror.apply_pod_events = counted
    # 64 + 64 + 32 pods: three cycles, each followed by 20 deletions
    ms = drive(sched, running, gen_host_pods(160, seed=1), cycles=3, delete=20)
    assert [m.pods_in for m in ms] == [64, 64, 32]
    # the last cycle's deletions wait for a cycle that never comes
    flushed = calls[:-20]
    assert calls[-20:] == ["DELETED"] * 20
    events = spans_of(sched, path)
    bursts = [e for e in events if e["name"] == "pod_events"]
    cycles = [e for e in events if e["name"] == "cycle"]
    assert len(cycles) == 3
    assert sum(e["args"]["events"] for e in bursts) == len(flushed) == 200
    assert sum(e["args"]["deleted"] for e in bursts) == flushed.count("DELETED") == 40
    assert all(e["args"]["lock_wait_s"] >= 0 for e in bursts)
    for e in bursts:
        for c in cycles:
            assert not (e["ts"] < c["ts"] < e["ts"] + e["dur"]), "a burst spans a cycle's start"
    # each cycle's span set holds the deletions before it and its own binds
    for c in cycles:
        own = [e for e in bursts if e["args"]["trace_id"] == c["args"]["trace_id"]]
        assert any(encloses(c, e) and e["args"]["deleted"] == 0 for e in own)


def test_torch_spans_dropped_bursts_count_as_spans_dropped(tmp_path):
    """Bursts past MAX_PENDING_BURSTS between two cycles are counted into
    the recorder's spans_dropped (and spans_dropped_total) at the next
    cycle's flush, not lost silently."""
    path = tmp_path / "spans"
    sched, running = make_sched(str(path))
    extra = 5
    for i in range(observe.MAX_PENDING_BURSTS + extra):
        sched.mirror.bursts.event(10.0 * i, 10.0 * i + 1, 0.0, True)
    drive(sched, running, gen_host_pods(16, seed=1), cycles=1)
    dropped = sched.spans.spans_dropped
    drive(sched, running, gen_host_pods(16, seed=2), cycles=1)
    assert sched.spans.spans_dropped == dropped    # counted once, then reset
    events = spans_of(sched, path)
    first = min(e["args"]["trace_id"] for e in events if e["name"] == "cycle")
    kept = [e for e in events if e["name"] == "pod_events" and e["args"]["trace_id"] == first]
    # the cycle's own burst (the self-apply of its binds) joins the full
    # list and pushes one more waiting burst out
    own = [e for e in kept if e["args"]["deleted"] == 0]
    assert len(own) == 1 and len(kept) == observe.MAX_PENDING_BURSTS
    assert dropped == extra + len(own)


@pytest.mark.parametrize("windows_per_cycle", [4, 1], ids=["backlog", "single"])
def test_torch_spans_engine_nest_in_engine_step(tmp_path, windows_per_cycle):
    path = tmp_path / "spans"
    sched, running = make_sched(str(path), max_windows_per_cycle=windows_per_cycle)
    ms = drive(sched, running, gen_host_pods(80, seed=1), cycles=6)
    events = spans_of(sched, path)
    steps = [e for e in events if e["name"] == "engine_step"]
    wins = [e for e in events if e["name"] == "engine_window"]
    auctions = [e for e in events if e["name"] == "auction"]
    assert steps and wins and len(auctions) == len(wins)
    n_windows = sum(-(-m.pods_in // 16) for m in ms if m.pods_in and windows_per_cycle > 1)
    n_windows += sum(1 for m in ms if m.pods_in and windows_per_cycle == 1)
    assert len(wins) == n_windows
    for inner in wins + auctions:
        outer = [s for s in steps if s["args"]["trace_id"] == inner["args"]["trace_id"]]
        assert len(outer) == 1 and encloses(outer[0], inner)
    for a in auctions:
        assert any(encloses(w, a) for w in wins if w["args"]["trace_id"] == a["args"]["trace_id"])
    if windows_per_cycle == 1:
        assert {w["args"]["window"] for w in wins} == {0}
    else:
        assert {w["args"]["window"] for w in wins} == set(range(4))
    assert all(w["args"]["pods"] == 16 for w in wins)


@pytest.mark.parametrize("head", list(HEADS))
def test_torch_spans_round_count_agrees(tmp_path, head):
    constraints = HEADS[head]
    path = tmp_path / "spans"
    sched, running = make_sched(str(path), constraints=constraints)
    ms = drive(sched, running, gen_host_pods(96, seed=1, constraints=constraints), cycles=4)
    events = spans_of(sched, path)
    rounds = sum(m.auction_rounds for m in ms)
    auctions = [e for e in events if e["name"] == "auction"]
    assert rounds > 0
    assert sum(e["name"] == "auction_round" for e in events) == rounds
    assert sum(e["args"]["rounds"] for e in auctions) == rounds
    # a cycle whose window holds no affinity term takes K3's head
    heads = {e["args"]["head"] for e in auctions}
    assert head in heads and heads <= set(HEADS)
    for h in heads:
        by_head = sum(e["args"]["rounds"] for e in auctions if e["args"]["head"] == h)
        assert sched.ctr_rounds.value(head=h) == by_head
        assert f'yoda_tpu_auction_rounds_total{{head="{h}"}} {by_head}' in sched.ctr_rounds.render()
    for a in auctions:
        mine = [e for e in events if e["name"] == "auction_round"
                and e["args"]["trace_id"] == a["args"]["trace_id"] and encloses(a, e)]
        assert mine


@pytest.mark.parametrize("head", list(HEADS))
def test_torch_spans_off_rounds_count_results_bitwise(tmp_path, head):
    constraints = HEADS[head]
    pods = gen_host_pods(96, seed=1, constraints=constraints)
    off, off_running = make_sched(None, constraints=constraints)
    on, on_running = make_sched(str(tmp_path / "spans"), constraints=constraints)
    ms_off = drive(off, off_running, pods, cycles=4)
    ms_on = drive(on, on_running, gen_host_pods(96, seed=1, constraints=constraints), cycles=4)
    assert off.spans is None and off.mirror.bursts is None
    assert sum(m.auction_rounds for m in ms_off) == sum(m.auction_rounds for m in ms_on) > 0
    assert ([(b.pod.name, b.node_name) for b in off.binder.bindings]
            == [(b.pod.name, b.node_name) for b in on.binder.bindings])

    # the engine alone: no handle, a handle without spans, a handle with them
    sched, _ = make_sched(None, constraints=constraints)
    window = gen_host_pods(64, seed=2, constraints=constraints)
    nodes, running, utils = sched.list_nodes(), [], sched.advisor.fetch()
    snap = sched.builder.build_snapshot(nodes, utils, running, pending_pods=window)
    batch = sched.builder.build_pod_batch(window)
    kw = sched._engine_options(window, nodes, running, batch, snap)
    assert kw["affinity_aware"] is constraints
    engine = TorchEngine(device="cpu")
    windows = stack_windows(batch, 16)
    bare = engine.schedule_windows(snap, windows, **kw)
    with observe.engine_trace(None) as counted:
        quiet = engine.schedule_windows(snap, windows, **kw)
    ss = observe.SpanSet(1)
    with observe.engine_trace(ss) as traced:
        loud = engine.schedule_windows(snap, windows, **kw)
    assert counted.auction_rounds == traced.auction_rounds > 0 and counted.head == head
    assert sum(n == "auction_round" for n, *_ in ss.spans) == traced.auction_rounds
    assert observe.ENGINE_TRACE.get() is None
    for got in (quiet, loud):
        for a, b in zip(bare, got):
            assert torch.equal(a, b)


def test_torch_spans_off_mirror_rows_decisions_bitwise(tmp_path):
    path = tmp_path / "spans"
    off, off_running = make_sched(None, constraints=True)
    on, on_running = make_sched(str(path), constraints=True)
    for sched, running in ((off, off_running), (on, on_running)):
        drive(sched, running, gen_host_pods(96, seed=1, constraints=True), cycles=4, delete=8)
    assert off.spans is None and off.mirror.bursts is None
    assert ([(b.pod.name, b.node_name) for b in off.binder.bindings]
            == [(b.pod.name, b.node_name) for b in on.binder.bindings])
    rows = on.mirror.ctr_row_nodes.value()
    assert off.mirror.ctr_row_nodes.value() == rows > 0
    events = spans_of(on, path)
    passes = [e for e in events if e["name"] == "mirror_rows"]
    emits = [e for e in events if e["name"] == "mirror_emit"]
    assert passes and sum(e["args"]["nodes"] for e in passes) == rows
    for e in passes:
        mine = [m for m in emits if m["args"]["trace_id"] == e["args"]["trace_id"]]
        assert len(mine) == 1 and encloses(mine[0], e)
    # the events after the last emit wait for a pass that never comes
    assert 0 < sum(e["args"]["events"] for e in passes) < on.mirror.ctr_events.value(kind="pod")


def test_torch_spans_queue_pending_count(tmp_path):
    path = tmp_path / "spans"
    sched, running = make_sched(str(path), max_windows_per_cycle=1)
    ms = drive(sched, running, gen_host_pods(40, seed=1), cycles=3)
    assert [m.queue_pending for m in ms] == [24, 8, 0]
    pops = [e for e in spans_of(sched, path) if e["name"] == "queue_pop"]
    assert [e["args"]["pending"] for e in pops] == [24, 8, 0]
    assert sched.gauge_pending.render()[-1] == "yoda_tpu_pending_pods_count 0"


def test_torch_spans_profile_shares_the_span_clock(tmp_path):
    rec = observe.SpanRecorder(str(tmp_path / "spans"))
    ss = rec.begin()
    with ss.span("engine_step"):
        observe.profile_device_step(lambda: torch.ones(4096).mul(2).sum(),
                                    str(tmp_path / "profile"))
    rec.flush(ss)
    rec.close()
    (step,) = [e for e in read_spans(str(tmp_path / "spans")) if e.get("ph") == "X"]
    trace = json.loads((tmp_path / "profile" / "trace.json").read_text())
    events = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    marks = [e for e in events if e["name"] == observe.PROFILE_CLOCK_MARK]
    ops = [e for e in events if e["name"].startswith("aten::")]
    assert len(marks) == 1 and ops
    for e in marks + ops:
        assert encloses(step, {"ts": e["ts"], "dur": e.get("dur", 0.0)}, slack_us=1000.0)


def test_torch_spans_report_attributes_every_cycle(tmp_path):
    path = tmp_path / "spans"
    # nodes with cards, so the card fit's `card_path` spans are written too
    sched, running = make_sched(str(path), constraints=True, gpu=True)
    drive(sched, running, gen_host_pods(96, seed=1, constraints=True), cycles=4, delete=8)
    sched.spans.close()
    report = analyze.build_report(str(path))
    assert abs(sum(report["attribution_pct"].values()) - 100.0) < 0.5
    for name in observe.PORT_SPANS:
        assert name in analyze.NON_ATTRIBUTED_STAGES
        assert name not in report["attribution_pct"]
        # captured blocks of rounds replay only on a CUDA device
        # (tests/test_torch_round_graph.py reports them with a stand-in)
        if name != "auction_block":
            assert report["stages"][name]["count"] > 0
    assert "auction_block" not in report["stages"]


# policy -> (nodes with cards, the card path's stages in each window)
CARD_CASES = {
    "card": (True, ("score", "fit")),
    "live-cards": (True, ("fit",)),
    "live": (False, ()),
}


@pytest.mark.parametrize("windows_per_cycle", [4, 1], ids=["backlog", "single"])
@pytest.mark.parametrize("case", list(CARD_CASES))
def test_torch_spans_card_path_nests_and_counts(tmp_path, case, windows_per_cycle):
    gpu, stages = CARD_CASES[case]
    path = tmp_path / "spans"
    policy = "card" if case == "card" else "balanced_cpu_diskio"
    sched, running = make_sched(str(path), gpu=gpu, policy=policy,
                                max_windows_per_cycle=windows_per_cycle)
    ms = drive(sched, running, gen_host_pods(80, seed=1, gpu=True), cycles=6)
    events = spans_of(sched, path)
    wins = [e for e in events if e["name"] == "engine_window"]
    cards = [e for e in events if e["name"] == "card_path"]
    assert wins and len(cards) == len(wins) * len(stages)
    for e in cards:
        mine = [w for w in wins if w["args"]["trace_id"] == e["args"]["trace_id"] and encloses(w, e)]
        assert len(mine) == 1
        assert e["args"]["pods"] == mine[0]["args"]["pods"] == 16
        assert e["args"]["cards"] == 4 and e["args"]["nodes"] >= 24
    for w in wins:
        inside = [e["args"]["stage"] for e in cards
                  if e["args"]["trace_id"] == w["args"]["trace_id"] and encloses(w, e)]
        assert sorted(inside) == sorted(stages)
    # the cells counted are the spans' pods x nodes x cards, stage by stage
    for stage in ("score", "fit"):
        cells = sum(e["args"]["pods"] * e["args"]["nodes"] * e["args"]["cards"]
                    for e in cards if e["args"]["stage"] == stage)
        assert sched.ctr_card_cells.value(stage=stage) == cells
        assert (stage in stages) == (cells > 0)
    assert sum(m.card_cells for m in ms) == sum(
        e["args"]["pods"] * e["args"]["nodes"] * e["args"]["cards"] for e in cards)
    # CUDA events time the regions; on the CPU there are none to read
    assert all(m.card_seconds == 0.0 for m in ms)
    assert sched.ctr_card_seconds.breakdown() == {}
    if stages:
        assert f'yoda_tpu_card_cells_total{{stage="fit"}} ' in "\n".join(sched.ctr_card_cells.render())


@pytest.mark.parametrize("windows_per_cycle", [4, 1], ids=["backlog", "single"])
def test_torch_spans_off_card_decisions_bitwise(tmp_path, windows_per_cycle):
    """Under the card policy, spans off and on: the same bindings and cell
    counts, no span collected; the engine alone, bare, under a handle
    without spans and under one with them: node_idx, feasible and
    free_after bitwise equal."""
    kw = dict(gpu=True, policy="card", max_windows_per_cycle=windows_per_cycle)
    off, off_running = make_sched(None, **kw)
    on, on_running = make_sched(str(tmp_path / "spans"), **kw)
    ms_off = drive(off, off_running, gen_host_pods(96, seed=1, gpu=True), cycles=4)
    ms_on = drive(on, on_running, gen_host_pods(96, seed=1, gpu=True), cycles=4)
    assert off.spans is None
    assert [m.card_cells for m in ms_off] == [m.card_cells for m in ms_on]
    assert sum(m.card_cells for m in ms_off) > 0
    assert ([(b.pod.name, b.node_name) for b in off.binder.bindings]
            == [(b.pod.name, b.node_name) for b in on.binder.bindings])

    sched, _ = make_sched(None, **kw)
    window = gen_host_pods(16, seed=2, gpu=True)
    nodes, running, utils = sched.list_nodes(), [], sched.advisor.fetch()
    snap = sched.builder.build_snapshot(nodes, utils, running, pending_pods=window)
    batch = sched.builder.build_pod_batch(window)
    opts = sched._engine_options(window, nodes, running, batch, snap)
    assert opts["policy"] == "card" and not opts["fused"]
    engine = TorchEngine(device="cpu")
    bare = engine.schedule_batch(snap, batch, **opts)
    with observe.engine_trace(None, 4) as counted:
        quiet = engine.schedule_batch(snap, batch, **opts)
    ss = observe.SpanSet(1)
    with observe.engine_trace(ss, 4) as traced:
        loud = engine.schedule_batch(snap, batch, **opts)
    assert counted.card_cells == traced.card_cells and set(traced.card_cells) == {"score", "fit"}
    assert not counted.card_events and not traced.card_events
    assert [n for n, *_ in ss.spans].count("card_path") == 2
    for got in (quiet, loud):
        for field in ("node_idx", "feasible", "free_after"):
            assert torch.equal(getattr(bare, field), getattr(got, field))


def test_torch_spans_card_events_fold_after_the_read():
    """The host folds an engine call's card event pairs (elapsed ms) into
    CycleMetrics.card_seconds and card_device_seconds_total{stage}, beside
    its cells and rounds."""
    from kubernetes_scheduler_tpu_torch.host.scheduler import CycleMetrics

    class Event:
        def __init__(self, ms):
            self.ms = ms

        def elapsed_time(self, end):
            return end.ms - self.ms

    sched, _ = make_sched(None)
    trace = observe.EngineTrace(None, 8)
    trace.card_cells = {"score": 40, "fit": 40}
    trace.card_events = [("score", Event(1.0), Event(4.0)), ("fit", Event(4.0), Event(4.5)),
                         ("score", Event(5.0), Event(7.0))]
    m = CycleMetrics()
    sched._fold_engine_trace(m, trace)
    assert m.card_cells == 80 and m.card_seconds == pytest.approx(5.5e-3)
    assert sched.ctr_card_seconds.value(stage="score") == pytest.approx(5e-3)
    assert sched.ctr_card_seconds.value(stage="fit") == pytest.approx(0.5e-3)
    assert sched.ctr_card_cells.breakdown() == {("score",): 40, ("fit",): 40}
    sched._fold_engine_trace(m, None)
    assert m.card_cells == 80 and m.auction_rounds == 0
