"""The GPU-card path on the CPU, on the card test fixture
(card-fixture.json) cut to a tiny cluster, with EDGE_CLASSES beside its
classes: the port agrees with the reference under the live policy with
card fit and under the card policy, the control fails where the port
passes, and runs with the card path broken underneath come out not
correct."""

from __future__ import annotations

import copy
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from schedbench import reference
from schedbench.gen.cluster import draw_cluster
from schedbench.tests.conftest import ROOT, cpu_run

FIXTURE = Path(__file__).with_name("card-fixture.json")
POLICIES = ("balanced_cpu_diskio", "card")
SEED = 2**31 + 11
# classes the fixture's mix lacks: a clock demand, a demand label that does
# not parse (it reads 0 and the pod wants 1 card), a request of its own
EDGE_CLASSES = [
    {"name": "gpu-2-clock", "share": 0.1, "labels": {"scv/number": "2", "scv/clock": "1500"}},
    {"name": "gpu-any", "share": 0.05, "labels": {"scv/memory": "16Gi"}},
    {"name": "gpu-2-16g-big", "share": 0.15, "labels": {"scv/number": "2", "scv/memory": "16000"},
     "cpu": 500, "memory": 2147483648},
]


def card_cell(policy: str, *, nodes: int = 48, running: int = 8, backlog: int = 96,
              device_path: bool = False, extra: list = EDGE_CLASSES):
    """The card fixture under `policy`, cut to a CPU test's size, with the
    classes `extra` after the fixture's; with device_path the engine
    windows are 32 pods, so a backlog stacks several (the card path never
    takes the scalar path either way)."""
    from schedbench.run import Cell

    cfg = json.loads(FIXTURE.read_text())
    cfg.update(nodes=nodes, running_pods=running)
    cfg["scheduler"]["policy"] = policy
    cfg["pod"]["classes"] = cfg["pod"]["classes"] + list(extra)
    if device_path:
        cfg["scheduler"].update(adaptive_dispatch=False, min_device_work=1, batch_window=32)
    traffic = json.loads((ROOT / "schedbench/traffic/saturated.json").read_text())
    traffic["backlog_pods"] = backlog
    e2e = [{"name": "pods_per_s", "unit": "pods/s"}, {"name": "setup_s", "unit": "s"}]
    return Cell("card-fixture", 1, cfg, traffic, e2e, [])


def _run(cell, **kw):
    """cpu_run, and the CellRun it drove."""
    runs = []
    out = cpu_run(cell, seed=SEED, after_setup=runs.append, **kw)
    return out, runs[0]


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("device_path", [False, True])
def test_schedbench_card_port_agrees_with_the_reference(policy, device_path):
    out, run = _run(card_cell(policy, device_path=device_path))
    assert out["correct"], out["check"]
    assert set(out["check"]) == set(reference.limits({}))
    assert out["check"]["card_fit_breaks"]["value"] == 0
    assert out["check"]["k1_score_err"]["value"] < 1e-3
    rec = run.rec
    cls = reference.PodClasses(rec.config, rec.cluster)
    # the card fit excludes nodes, and pods of every class were bound
    assert not cls.fit.all()
    bound = np.concatenate([c.bound_pids for c in rec.cycles])
    assert set(rec.pod_class[bound]) == set(range(len(rec.config["pod"]["classes"])))
    # every cycle took the engine: nodes with cards never take the scalar path
    assert not any(c.metrics.used_fallback for c in rec.cycles)


def test_schedbench_card_pods_that_fit_nowhere_are_not_unplaced_with_room():
    """A class no node's cards fit is left unschedulable in every cycle
    while nodes have room for the others: a sound run, judged per class."""
    extra = EDGE_CLASSES + [{"name": "gpu-8", "share": 0.1, "labels": {"scv/number": "8"}}]
    # no running pods at the start: set-up would wait for a gpu-8 pod
    cell = card_cell("card", extra=extra, running=0, device_path=True)
    out, run = _run(cell)
    assert out["correct"], out["check"]
    unsched = np.concatenate([c.unsched_pids for c in run.rec.cycles])
    gpu_8 = len(cell.config["pod"]["classes"]) - 1
    assert not reference.PodClasses(run.rec.config, run.rec.cluster).fit[gpu_8].any()
    assert gpu_8 in set(run.rec.pod_class[unsched])
    assert out["check"]["unplaced_with_room"]["value"] == 0


def test_schedbench_card_control_fails_where_the_port_passes():
    from schedbench.control import readings, summary

    cell = card_cell("card", nodes=96, backlog=160)
    [out] = readings(cell, [5], 1.0, device="cpu", torch=torch)
    lim = reference.limits({})
    assert out["correct"], out["check"]
    assert not out["control"]["correct"]
    got = summary([out])
    assert got["k1_score_err"]["program_max"] < lim["k1_score_err"] < got["k1_score_err"]["control_min"]


@pytest.mark.parametrize("policy", POLICIES)
def test_schedbench_card_mask_dropped_is_not_correct(policy, monkeypatch):
    """The engine's card fit reads every node as fitting."""
    from kubernetes_scheduler_tpu_torch import engine

    fit = engine.card_fit

    def dropped(*a, **k):
        node_fits, per_card = fit(*a, **k)
        return torch.ones_like(node_fits), per_card

    monkeypatch.setattr(engine, "card_fit", dropped)
    # enough pods that the nodes the card policy ranks first fill up
    out, _ = _run(card_cell(policy, running=600, backlog=400, device_path=True))
    assert not out["correct"]
    assert out["check"]["card_fit_breaks"]["value"] > 0, out["check"]


def test_schedbench_card_scores_altered_are_not_correct(monkeypatch):
    """The card policy's raw scores rounded to bfloat16 where produced."""
    from kubernetes_scheduler_tpu_torch import engine

    score = engine.card_score
    monkeypatch.setattr(engine, "card_score", lambda *a, **k: score(*a, **k).bfloat16().float())
    out, _ = _run(card_cell("card", device_path=True))
    assert not out["correct"]
    err = out["check"]["k1_score_err"]
    assert err["value"] > err["limit"], out["check"]


@pytest.mark.parametrize("policy", POLICIES)
def test_schedbench_card_marked_healthy_is_not_correct(policy, monkeypatch):
    """One unhealthy card handed to the program as healthy: the one whose
    health changes the fit of the most classes on its node."""
    from schedbench import loop

    cell = card_cell(policy, device_path=True)
    cluster = draw_cluster(cell.config, SEED)
    cls = reference.PodClasses(cell.config, cluster)
    best, flip = 0, None
    for i, c in zip(*np.nonzero(~cluster.card_healthy)):
        healthy = cluster.card_healthy.copy()
        healthy[i, c] = True
        changed = sum(reference.card_fit(cluster.cards, healthy, d)[i] != f[i]
                      for d, f in zip(cls.demand, cls.fit))
        if changed > best:
            best, flip = changed, (int(i), int(c))
    assert flip is not None
    cards = loop.node_cards

    def marked(types, cl, i):
        out = cards(types, cl, i)
        if i == flip[0]:
            out[flip[1]].health = "Healthy"
        return out

    monkeypatch.setattr(loop, "node_cards", marked)
    out, _ = _run(cell)
    assert not out["correct"]
    check = out["check"]
    assert check["card_fit_breaks"]["value"] + check["k1_mask_errors"]["value"] > 0, check


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_schedbench_card_broken_path_is_not_correct(fault):
    from schedbench.tests.test_schedbench_reference import _break

    out, _ = _run(card_cell("card", device_path=True))
    assert out["correct"]
    out = cpu_run(card_cell("card", device_path=True), seed=SEED, after_setup=_break(fault))
    assert not out["correct"], (fault, out["check"])


def test_schedbench_reference_reads_card_labels_as_go_does():
    assert reference.card_demand({"scv/priority": "3"}) is None
    assert reference.card_demand({"scv/memory": "16Gi"}) == (1, 0, None)
    assert reference.card_demand({"scv/number": "2", "scv/clock": "1500"}) == (2, None, 1500)
    assert reference.card_demand({"scv/number": " 2"}) == (0, None, None)
    assert reference.card_demand({"scv/number": "+3", "scv/memory": "x"}) == (3, 0, None)
    cards = np.zeros((3, 2, 6))
    cards[..., reference.FREE_MEMORY] = [[16000, 8000], [16000, 16000], [20000, 20000]]
    cards[..., reference.CLOCK] = [[1500, 1500], [1500, 1000], [1500, 1500]]
    healthy = np.array([[True, True], [True, True], [True, False]])
    fit = reference.card_fit
    assert fit(cards, healthy, (2, 16000, None)).tolist() == [False, True, False]
    assert fit(cards, healthy, (2, None, 1500)).tolist() == [True, False, False]
    assert fit(cards, healthy, (1, 16000, 1500)).tolist() == [True, True, True]
    assert fit(cards, healthy, (3, None, None)).tolist() == [False, False, False]
    assert fit(cards, healthy, None).all()


def test_schedbench_card_scores_follow_the_go_weights():
    """One class, one fitting node: each metric over its maximum, weighted
    1, 1, 2, 1, 3, 1, summed over the cards that meet the demand."""
    cards = np.array([[[20, 1500, 4000, 200, 16000, 32000], [40, 1000, 8000, 100, 8000, 32000]],
                      [[10, 2000, 2000, 400, 30000, 32000], [10, 2000, 2000, 400, 30000, 32000]]],
                     dtype=np.float64)
    demand = (1, 10000, None)
    fit = np.array([True, False])
    got = reference.card_scores(cards, demand, fit).tolist()
    # maxima over the one card on a fitting node that meets the demand
    mx = cards[0, 0]
    per = (cards * 100.0 / mx * np.array(reference.CARD_WEIGHTS)).sum(-1)
    assert got == pytest.approx([per[0, 0], per[1].sum()])
    assert reference.min_max(torch.tensor(got)).tolist() == pytest.approx(
        [(got[0] - got[0]) * 100 / (got[1] - got[0]), 100.0])


def test_schedbench_reference_refuses_other_policies():
    cfg = copy.deepcopy(card_cell("card").config)
    for sched in ({"policy": "free_capacity"}, {"policy": "card", "normalizer": "softmax"},
                  {"score_plugins": [{"name": "card", "weight": 1}]}):
        cfg["scheduler"] = sched
        with pytest.raises(ValueError):
            reference.policy_of(cfg)
