"""Configurations without node.cards and pod.classes draw and judge as
they did before cards and classes existed: the node draws, the first
2**15 diskIO draws and the reference's numbers on one fixed tiny run of
each cell equal values taken from the harness before that change. No
configuration of the benchmark asks for preemption: none gets an
evictor, and each runs the program under the effective configuration it
had before the harness could play evictions out."""

from __future__ import annotations

import hashlib
import json

import numpy as np
import pytest

from schedbench import reference
from schedbench.gen.cluster import PodSource, draw_cluster
from schedbench.loop import CellRun
from schedbench.run import load_cell
from schedbench.tests.conftest import ROOT, tiny_cell

SEED = 2**31 + 5
CLUSTER = "5152e7e3662d3731"
PODS = "148ebc35aee1f1e7"
CHECK = {
    "basic-5k.saturated": dict(
        double_binds=0, lost_pods=0, unknown_nodes=0, over_capacity=0,
        anti_affinity_breaks=0, unplaced_with_room=0, score_gap=0.0037513621360862033,
        k1_score_err=1.6331320075835265e-05, k1_mask_errors=0),
    "antiaffinity-5k.saturated": dict(
        double_binds=0, lost_pods=0, unknown_nodes=0, over_capacity=0,
        anti_affinity_breaks=0, unplaced_with_room=0, score_gap=0.0,
        k1_score_err=1.2973247626391071e-05, k1_mask_errors=0),
}


def _digest(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()[:16]


@pytest.mark.parametrize("name", sorted(CHECK))
def test_schedbench_draws_and_checks_are_pinned(name):
    config = load_cell(name, ROOT).config
    c = draw_cluster(config, SEED)
    assert c.cards is None and c.card_healthy is None
    assert _digest(np.concatenate([c.alloc.ravel().astype(np.float64), c.cpu_pct,
                                   c.mem_pct, c.disk_io, c.net_up, c.net_down])) == CLUSTER
    pods = PodSource(config, SEED)
    pods.count = 1 << 15
    assert _digest(pods.draws()) == PODS
    assert not pods.classes().any()
    # a fixed amount of work: set-up, then one window cycle, every cycle
    # on the engine
    cell = tiny_cell(name, device_path=True)
    run = CellRun(cell.config, cell.traffic, SEED, device="cpu")
    try:
        run.setup(0.25)
        run.window(0.0)
    finally:
        run.close()
    assert len(run.rec.cycles) == 4
    assert reference.check(run.rec) == {**CHECK[name], "card_fit_breaks": 0,
                                        **dict.fromkeys(reference.PREEMPTION_CHECKS, 0)}


# sha256 of each configuration's effective SchedulerConfig (the JSON the
# run logs), taken from the harness before it could pass an evictor
EFFECTIVE = {"basic-5k": "7a611166a572f3e9", "antiaffinity-5k": "7a611166a572f3e9",
             "gpu-5k": "c23e20be5f38d173"}


@pytest.mark.parametrize("config", sorted(EFFECTIVE))
def test_schedbench_configs_get_no_evictor(config):
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = tiny_cell(next(w["name"] for w in bench["workloads"] if w["config"] == config))
    assert "preemption" not in cell.config.get("scheduler", {})
    run = CellRun(cell.config, cell.traffic, SEED, device="cpu")
    try:
        assert run.sched.evictor is None and run.evictor is None
        eff = json.dumps(run.rec.effective_config, sort_keys=True).encode()
    finally:
        run.close()
    assert hashlib.sha256(eff).hexdigest()[:16] == EFFECTIVE[config]
