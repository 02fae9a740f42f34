"""The gpu-5k deployment (configs/gpu-5k.json, the cell gpu-5k.saturated):
cut to 48 nodes it comes out correct on the CPU with the engine path on and
off; the card path's readers return None without the program's counters
and the right value on a hand-built run; card_cost.py's count at one
shape equals a count written out by hand. The `card` case runs the cell
whole on the card for a short traced window."""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from types import SimpleNamespace

import pytest

from schedbench import card_cost, roofline
from schedbench.tests.conftest import ROOT, cpu_run, tiny_cell

CELL = "gpu-5k.saturated"
SEED = 2**31 + 20
READERS = ("card_ms_per_window.saturated", "card_roofline.saturated")


def reader(name: str):
    path = ROOT / "schedbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"schedbench.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@pytest.mark.parametrize("device_path", [False, True], ids=["adaptive", "engine"])
def test_schedbench_gpu5k_cut_to_48_nodes_is_correct(device_path):
    runs = []
    out = cpu_run(tiny_cell(CELL, device_path=device_path), seed=SEED, after_setup=runs.append)
    assert out["correct"], out["check"]
    assert out["check"]["card_fit_breaks"]["value"] == 0
    # the configuration's own score_gap limit stands over limits.json's
    assert out["check"]["score_gap"]["limit"] == 0.011
    assert set(out["metrics"]) == {"pods_per_s", "setup_s"}
    rec = runs[0].rec
    assert rec.config["scheduler"]["policy"] == "card"
    # every cycle took the engine, and its card path counted its cells
    assert rec.window() and not any(c.metrics.used_fallback for c in rec.cycles)
    assert all(c.metrics.card_cells > 0 for c in rec.cycles)


@dataclass
class Metrics:
    pods_in: int
    used_fallback: bool = False
    card_seconds: float = 0.0


@dataclass
class Cycle:
    metrics: object
    phase: str = "window"


@dataclass
class Rec:
    cycles: list
    config: dict = field(default_factory=lambda: json.loads(
        (ROOT / "schedbench/configs/gpu-5k.json").read_text()))
    batch_window: int = 1024

    def window(self):
        return [c for c in self.cycles if c.phase == "window"]


def test_schedbench_gpu5k_readers_none_without_counters():
    old = [Cycle(SimpleNamespace(pods_in=8192, used_fallback=False))]
    untimed = [Cycle(Metrics(8192))]
    for cycles in (old, untimed, []):
        run = SimpleNamespace(rec=Rec(cycles), trace=None, launches={})
        assert [reader(r)(run) for r in READERS] == [None, None]
    no_cards = Rec([Cycle(Metrics(8192, card_seconds=0.1))])
    del no_cards.config["node"]["cards"]
    assert reader(READERS[1])(SimpleNamespace(rec=no_cards)) is None


def test_schedbench_gpu5k_readers_on_a_hand_built_run():
    # two backlog cycles of 8 windows, one cycle of 1,500 pods (2 windows),
    # one scalar cycle the readers leave out, and a set-up cycle
    cycles = [Cycle(Metrics(8192, card_seconds=0.040)), Cycle(Metrics(8192, card_seconds=0.044)),
              Cycle(Metrics(1500, card_seconds=0.012)),
              Cycle(Metrics(700, used_fallback=True, card_seconds=0.0)),
              Cycle(Metrics(8192, card_seconds=9.0), phase="setup")]
    run = SimpleNamespace(rec=Rec(cycles), trace=None, launches={})
    ms, share = (reader(r)(run) for r in READERS)
    assert ms == pytest.approx(1e3 * 0.096 / 18)
    least = (17 * roofline.least_s(*card_cost.card_cost(1024, 5000, 8))
             + roofline.least_s(*card_cost.card_cost(1500 - 1024, 5000, 8)))
    assert share == pytest.approx(100.0 * least / 0.096)
    assert 0.0 < share < 100.0


def test_schedbench_gpu5k_card_cost_by_hand():
    p, n, c = 1024, 5000, 8
    cells, pairs = p * n * c, p * n
    # cards 6 float32 a slot, presence and health a byte each, the pods'
    # number (int32), memory and clock (float32), the score (float32) and
    # fit (bool) of every (pod, node)
    nbytes = 24 * n * c + 2 * n * c + 12 * p + 5 * p * n
    # fit 10, maxima 2 x 6, score 4 x 6 + 2 per card cell; the verdict 8 a node
    ops = (10 + 12 + 26) * cells + 8 * pairs
    assert card_cost.card_cost(p, n, c) == (nbytes, ops) == (26_652_288, 2_007_040_000)
    # compute-bound: a few tens of microseconds a window
    assert roofline.least_s(nbytes, ops) == pytest.approx(ops / 33.5e12)
    assert 40e-6 < roofline.least_s(nbytes, ops) < 80e-6
    assert card_cost.window_pods(8192, 1024) == [1024] * 8
    assert card_cost.window_pods(1500, 1024) == [1024, 476]
    assert card_cost.window_pods(300, 1024) == [300]


@pytest.mark.card
def test_schedbench_gpu5k_on_the_card(cuda_card):
    import torch

    from schedbench.run import load_cell, run_cell

    out = run_cell(load_cell(CELL, ROOT), SEED, 5.0, True, device=cuda_card, torch=torch,
                   log=lambda *a, **k: None)
    assert out["correct"], out["check"]
    assert out["check"]["card_fit_breaks"]["value"] == 0
    assert out["device"]["platform"] == "gpu"
    assert out["metrics"]["card_ms_per_window.saturated"]["value"] > 0
    assert 0.0 < out["metrics"]["card_roofline.saturated"]["value"] <= 100.0
