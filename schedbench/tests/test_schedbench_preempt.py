"""The preemption path on the CPU, on the test fixture preempt-fixture.json
(PreemptionBasic's shapes) cut to 48 nodes: the port comes out correct
with its preemption pass on the engine and in the host, the harness's
records of evictions equal the program's counters, each planted fault
trips the check named for it, and a low-priority pod left pending beside
a reserved node is not unplaced_with_room. The `card` case runs the
fixture at 5000Nodes on the card and prints the numbers a preemption
cell is sized from."""

from __future__ import annotations

import json
import math
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from schedbench import reference
from schedbench.gen.cluster import draw_cluster
from schedbench.loop import CycleRecord, Records
from schedbench.run import Cell
from schedbench.tests.conftest import cpu_run

FIXTURE = Path(__file__).with_name("preempt-fixture.json")
SEED = 2**31 + 29
E2E = [{"name": "pods_per_s", "unit": "pods/s"}, {"name": "setup_s", "unit": "s"}]


def preempt_cell(*, nodes: int = 48, backlog: int = 24, held: int = 24,
                 dispatch: str | None = "engine", recreate: bool = True):
    """The fixture cut to `nodes` nodes, each filled with 4 low-priority
    pods, under preemption_backlog. Dispatch "engine": every cycle takes
    the engine, in windows of 32 pods; "mixed": a cycle of 4 pods or more
    takes the engine and a smaller one the scalar path, by size alone
    (the adaptive model's choice follows the host's load, and a window
    with no engine cycle leaves K1 nothing to judge); None: the
    configuration's own (adaptive) dispatch."""
    cfg = json.loads(FIXTURE.read_text())
    cfg.update(nodes=nodes, running_pods=4 * nodes)
    if dispatch is not None:
        work = {"engine": 1, "mixed": 4 * nodes}[dispatch]
        cfg["scheduler"].update(adaptive_dispatch=False, min_device_work=work, batch_window=32)
    traffic = {"kind": "preemption_backlog", "backlog_pods": backlog, "pool_pods_per_s": 200,
               "held_pods": held, "recreate_victims": recreate}
    return Cell("preempt-fixture", 1, cfg, traffic, E2E, [])


def _run(cell, hook=None, seconds: float = 3.0):
    """cpu_run with `hook` after set-up, and the CellRun it drove."""
    runs = []

    def after(run):
        runs.append(run)
        if hook is not None:
            hook(run)

    out = cpu_run(cell, seed=SEED, seconds=seconds, after_setup=after)
    return out, runs[0]


@pytest.mark.parametrize("dispatch", ["engine", "mixed"], ids=["engine_cycles", "mixed_cycles"])
@pytest.mark.parametrize("on_engine", [True, False], ids=["engine_preempt", "host_preempt"])
def test_schedbench_preempt_fixture_is_correct(on_engine, dispatch, monkeypatch):
    from kubernetes_scheduler_tpu_torch.engine import TorchEngine

    if not on_engine:
        def preempt(self, *a, **k):
            raise NotImplementedError("the pass runs in the host (preempt_on_host)")

        monkeypatch.setattr(TorchEngine, "preempt", preempt)
    judged = []
    k1_numbers = reference._k1_numbers
    monkeypatch.setattr(reference, "_k1_numbers",
                        lambda k1, *a: judged.append(k1["cycle"]) or k1_numbers(k1, *a))
    out, run = _run(preempt_cell(dispatch=dispatch))
    assert out["correct"], out["check"]
    assert set(out["check"]) == set(reference.limits({}))
    rec = run.rec
    assert (run.sched.engine.preempt_calls > 0) == on_engine
    # the harness's records are the program's counters, cycle by cycle
    for c in rec.cycles:
        assert len(c.evicted) == c.metrics.victims_evicted
        assert len(list(reference._preemptions(c))) == c.metrics.pods_preempted
    window = rec.window()
    assert sum(c.metrics.pods_preempted for c in window) > 0
    # K1's capture is the window's last engine cycle, also where that
    # cycle's preemption pass built a batch of its preemptors after it
    engine_cycles = [i for i, c in enumerate(rec.cycles)
                     if c.phase == "window" and c.metrics.engine_seconds > 0]
    assert judged == [engine_cycles[-1]]
    # victims left the cluster and came back as pods of init_pod
    killed = np.concatenate([c.evicted[:, 0] for c in rec.cycles])
    assert rec.pod_from_init[killed].all() and (rec.pod_priority[killed] == 0).all()
    assert rec.pod_from_init.sum() > rec.config["running_pods"]
    assert not np.isnan(rec.pod_start[killed]).any()
    assert all(c.metrics.victims_evicted == 3 * c.metrics.pods_preempted for c in rec.cycles)


@pytest.mark.parametrize("preemption, kind", [
    (None, "preemption_backlog"), (True, "closed_backlog")], ids=["no_evictor", "no_kind"])
def test_schedbench_preempt_key_and_kind_go_together(preemption, kind):
    """scheduler.preemption: true and traffic of kind preemption_backlog
    are refused one without the other: the kind without an evictor would
    kill nothing, the evictor without the kind would have nobody kill."""
    from schedbench.loop import CellRun

    cell = preempt_cell()
    cfg = json.loads(json.dumps(cell.config))
    cfg["scheduler"].pop("preemption")
    if preemption is not None:
        cfg["scheduler"]["preemption"] = preemption
    traffic = {**cell.traffic, "kind": kind}
    with pytest.raises(ValueError, match="scheduler.preemption"):
        CellRun(cfg, traffic, SEED, device="cpu")


# ---- planted faults: each evictor's or kill's lie trips its check ---------


def _live(run, node: str, below: int) -> list:
    """Running pods on `node` of priority below `below`, least important
    first (lower priority, then the later start)."""
    pods = [p for p in run.kind.live.values() if p.node_name == node and p.priority < below]
    return sorted(pods, key=lambda p: (p.priority, -(p.start_time or math.inf)))


def _lie(fault: str):
    """An after_setup hook that rewrites, once, the evictions the
    harness's evictor recorded in a cycle, before the harness plays them
    out; `untold` leaves one kill out of what the reference is told."""

    def hook(run):
        kill, done = run.kind.kill, []
        if fault == "worse":
            _hole(run)

        def lying_kill(rec):
            log = run.evictor.log
            if log and not done and fault != "untold":
                done.extend(_rewrite(run, fault, log))
            killed = kill(rec)
            if fault == "untold" and len(killed) and not done:
                done.append(int(killed[0]))
                rec.evicted = rec.evicted[rec.evicted[:, 0] != killed[0]]
                killed = killed[1:]
            return killed

        run.kind.kill = lying_kill
        run.fault_done = done

    return hook


def _hole(run) -> None:
    """A low-priority pod of a full node completes before the window (a
    deletion the reference is told of): that node needs a victim less."""
    for node in run.nodes:
        pods = _live(run, node.name, 1)
        if len(pods) == 4:
            pid = int(pods[0].name[1:])
            run.kind.gone(pid)
            last = run.rec.cycles[-1]
            last.deleted_pids = np.append(last.deleted_pids, pid)
            return


def _rewrite(run, fault: str, log: list) -> list:
    """Rewrite the first preemption of `log` by `fault`; [] where this
    cycle offers nothing to rewrite."""
    victim, preemptor, t = log[0]
    first = [e for e in log if e[1] is preemptor]
    rest = log[len(first):]
    if fault == "extra":
        named = {id(v) for v, _, _ in first}
        spare = [p for p in _live(run, victim.node_name, preemptor.priority) if id(p) not in named]
        if not spare:
            return []
        first.append((spare[0], preemptor, t))
    elif fault == "equal":
        equal = [p for p in run.kind.live.values() if p.priority == preemptor.priority]
        if not equal:
            return []
        first[0] = (equal[0], preemptor, t)
    elif fault == "worse":
        need = len(first)
        for node in run.nodes:
            if node.name == victim.node_name:
                continue
            pods = _live(run, node.name, preemptor.priority)
            free = node.allocatable["cpu"] - sum(
                p.containers[0].requests["cpu"] for p in run.kind.live.values() if p.node_name == node.name)
            take = 0
            while take < len(pods) and free < 3000:
                free += pods[take].containers[0].requests["cpu"]
                take += 1
            if free >= 3000 and take > need:
                first = [(p, preemptor, t) for p in pods[:take]]
                break
        else:
            return []
    elif fault == "room":
        held = [p for p in run.kind.held if int(p.name[1:]) in run.kind.live]
        if not held:
            return []
        first = [(v, held[0], at) for v, _, at in first]
    log[:] = first + rest
    return [fault]


FAULTS = {
    "extra": "excess_victims",
    "equal": "victim_priority_breaks",
    "worse": "victim_node_breaks",
    "room": "needless_preemptions",
    "untold": "over_capacity",
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_schedbench_preempt_planted_fault_trips_its_check(fault):
    # "worse" wants a node that needs fewer victims than the others: the
    # one its hook opens, kept open by victims that do not come back
    cell = preempt_cell(recreate=fault != "worse")
    out, run = _run(cell, _lie(fault))
    assert run.fault_done, f"the run offered no preemption to plant {fault} in"
    name = FAULTS[fault]
    assert not out["correct"], (fault, out["check"])
    assert out["check"][name]["value"] > out["check"][name]["limit"], (fault, out["check"])


def test_schedbench_preempt_hole_is_taken_and_correct():
    """The "worse" fault's run left alone: the node a pod short is the
    best, the port takes it with 2 victims, and the run is correct."""
    out, run = _run(preempt_cell(recreate=False), _hole)
    assert out["correct"], out["check"]
    window = run.rec.window()
    counts = [len(rows) for c in window for _, rows, _ in reference._preemptions(c)]
    assert counts[0] == 2 and set(counts[1:]) <= {3}, counts


# ---- reservations, by hand --------------------------------------------------


def _records(last_cycle: dict) -> Records:
    """Two nodes full of low-priority pods (0-3 on node 0, 4-7 on node
    1), pod 8 of pod's template preempts pods 0-2 on node 0 at t = 100,
    then a third cycle of `last_cycle`'s unschedulable pods and start."""
    cfg = json.loads(FIXTURE.read_text())
    cfg.update(nodes=2, running_pods=8)
    size = 10
    init = np.arange(size) != 8

    def cycle(m0, bound=(), nodes=(), unsched=(), evicted=None, deleted=()):
        c = CycleRecord("window", m0, m0, SimpleNamespace(used_fallback=False),
                        np.asarray(bound, np.int64), np.asarray(nodes, np.int64),
                        deleted_pids=np.asarray(deleted, np.int64),
                        unsched_pids=np.asarray(unsched, np.int64), m0=m0)
        if evicted is not None:
            c.evicted = np.asarray(evicted, np.int64)
            c.evicted_at = np.full(len(evicted), 100.0)
        return c

    return Records(
        config=cfg, traffic={}, seed=0, cluster=draw_cluster(cfg, 0), submitted=size,
        pod_io=np.ones(size), pod_init=np.arange(size) < 8, pod_class=np.zeros(size, np.int64),
        pod_priority=np.where(init, 0, 10), pod_from_init=init,
        pod_start=np.where(np.arange(size) < 8, 50.0, np.nan), queued_at_end=2,
        effective_config={"preemption_nomination_ttl_seconds": 120.0},
        cycles=[cycle(0.0, range(8), [0, 0, 0, 0, 1, 1, 1, 1]),
                cycle(99.0, unsched=[8], evicted=[[0, 8, 0], [1, 8, 0], [2, 8, 0]],
                      deleted=[0, 1, 2]),
                cycle(**last_cycle)])


@pytest.mark.parametrize("last, unplaced", [
    (dict(m0=101.0, unsched=[9]), 0),     # 9 waits beside node 0, reserved for 8
    (dict(m0=221.0, unsched=[9]), 1),     # the nomination has run out
    (dict(m0=101.0, unsched=[8]), 1),     # the reserved room is 8's own
], ids=["reserved", "expired", "own"])
def test_schedbench_preempt_reserved_room_is_not_room(last, unplaced):
    got = reference.check(_records(last))
    assert got["unplaced_with_room"] == unplaced, got
    assert {k: got[k] for k in reference.PREEMPTION_CHECKS} == dict.fromkeys(
        reference.PREEMPTION_CHECKS, 0)
    assert got["over_capacity"] == 0 and got["lost_pods"] == 0


def test_schedbench_preempt_hand_checks():
    """Node 1 needs fewer victims once it holds a pod less; a preemption
    there with the least important victims passes, on node 0 it does
    not, nor with a victim spared upstream."""
    rec = _records(dict(m0=101.0, unsched=[9]))
    rec.cycles[0].bound_pids = np.arange(7)
    rec.cycles[0].bound_nodes = np.array([0, 0, 0, 0, 1, 1, 1])
    rec.pod_start[3] = 40.0            # pod 3 is node 0's most important
    c = rec.cycles[1]
    ok = reference.check(rec)
    assert {k: ok[k] for k in reference.PREEMPTION_CHECKS} == {
        "victim_priority_breaks": 0, "needless_preemptions": 0, "excess_victims": 0,
        "victim_node_breaks": 1}
    # node 1 (3 pods, 2 victims) is the best; pods 4 and 5 leave
    c.evicted = np.array([[4, 8, 1], [5, 8, 1]])
    c.deleted_pids = np.array([4, 5])
    got = reference.check(rec)
    assert {k: got[k] for k in reference.PREEMPTION_CHECKS} == dict.fromkeys(
        reference.PREEMPTION_CHECKS, 0), got
    # three victims on node 1: one upstream reprieves
    c.evicted = np.array([[4, 8, 1], [5, 8, 1], [6, 8, 1]])
    c.deleted_pids = np.array([4, 5, 6])
    assert reference.check(rec)["excess_victims"] == 1
    # node 0 holds pod 3, more important than 0-2: taking it is excess
    c.evicted = np.array([[3, 8, 0], [1, 8, 0], [2, 8, 0]])
    c.deleted_pids = np.array([3, 1, 2])
    got = reference.check(rec)
    assert got["excess_victims"] == 1 and got["victim_node_breaks"] == 1, got


@pytest.mark.parametrize("prio, bad, good", [
    # node 1 would give up a victim of priority 5 (criterion 1)
    ({4: 5, 5: 5}, [(1, [5, 6, 7])], [(0, [1, 2, 3])]),
    # both give up a 3, node 0 two of them (criterion 2)
    ({0: 3, 1: 3, 2: 3, 4: 3, 5: 3}, [(0, [1, 2, 3])], [(1, [5, 6, 7])]),
], ids=["highest_priority", "priority_sum"])
def test_schedbench_preempt_node_criteria_by_hand(prio, bad, good):
    """Both nodes full: the node whose upstream victims rank worse by
    pickOneNodeForPreemption's first two criteria is a node break; each
    node's own victims are upstream's (the most important reprieved)."""
    for evictions, breaks in ((bad, 1), (good, 0)):
        rec = _records(dict(m0=101.0, unsched=[9]))
        for pid, value in prio.items():
            rec.pod_priority[pid] = value
        (node, victims), = evictions
        c = rec.cycles[1]
        c.evicted = np.array([[v, 8, node] for v in victims])
        c.deleted_pids = np.array(victims)
        got = reference.check(rec)
        assert got["victim_node_breaks"] == breaks, (evictions, got)
        assert got["excess_victims"] == got["victim_priority_breaks"] == 0, (evictions, got)


@pytest.mark.card
@pytest.mark.parametrize("recreate", [False, True], ids=["source", "recreated"])
def test_schedbench_preempt_fixture_at_5000_nodes_on_the_card(recreate, cuda_card):
    """PreemptionBasic's 5000Nodes on the card: 5,000 nodes filled with
    20,000 low-priority pods and a backlog of the source's 5,000
    high-priority pods, which no completion thins (held_pods 5,000);
    victims stay dead as the source's bare pods do, or are re-created;
    prints what a preemption cell is sized from."""
    import torch

    from schedbench.run import run_cell

    cell = preempt_cell(nodes=5000, backlog=5000, held=5000, dispatch=None,
                        recreate=recreate)
    runs, lines = [], []
    out = run_cell(cell, 2**31 + 5_000, 10.0, False, device=cuda_card, torch=torch,
                   log=lambda *a, **k: lines.append(" ".join(map(str, a))),
                   after_setup=runs.append)
    rec = runs[0].rec
    window = rec.window()
    preempted = sum(c.metrics.pods_preempted for c in window)
    print(json.dumps({
        "correct": out["correct"], "check": out["check"], "metrics": out["metrics"],
        "device": out["device"], "attempted": out["attempted"],
        "window_cycles": len(window), "preemptions": preempted,
        "victims": sum(c.metrics.victims_evicted for c in window),
        "preemptions_per_cycle": preempted / max(len(window), 1),
        "pool_short": rec.pool_short, "queued_at_end": rec.queued_at_end,
        "log": [ln for ln in lines if "effective config" not in ln]}))
    assert preempted > 0
    for c in rec.cycles:
        assert len(c.evicted) == c.metrics.victims_evicted
        assert len(list(reference._preemptions(c))) == c.metrics.pods_preempted
    assert out["correct"], out["check"]
