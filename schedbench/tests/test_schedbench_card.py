"""On the card: every cell of BENCHMARK.json runs a short window with
--trace 0 and 1 and comes out correct, and the control comes out not
correct. Skips without a CUDA card."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from schedbench.tests.conftest import ROOT


def _cells() -> list:
    return [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("trace", [0, 1])
def test_schedbench_cells_run_on_the_card(cuda_card, trace):
    for name in _cells():
        out = subprocess.run(
            [sys.executable, "-m", "schedbench.run", "--workload", name, "--seed",
             str(2**31 + 77), "--seconds", "5", "--trace", str(trace)],
            cwd=ROOT, capture_output=True, text=True, timeout=600,
        )
        assert out.returncode == 0, out.stderr[-2000:]
        res = json.loads(out.stdout.strip().splitlines()[-1])
        assert res["correct"], res["check"]
        assert res["device"]["platform"] == "gpu"


@pytest.mark.card
def test_schedbench_control_is_not_correct_on_the_card(cuda_card):
    from schedbench import reference

    limit = reference.limits({})["k1_score_err"]
    for name in _cells():
        out = subprocess.run(
            [sys.executable, "-m", "schedbench.control", "--workload", name,
             "--seeds", "1,2,3", "--seconds", "5"],
            cwd=ROOT, capture_output=True, text=True, timeout=900,
        )
        assert out.returncode == 0, out.stderr[-2000:]
        last = json.loads(out.stdout.strip().splitlines()[-1])
        assert last["program_correct"] and not last["control_correct_any"], last
        k1 = last["k1_score_err"]
        assert k1["program_max"] < limit < k1["control_min"], last


@pytest.mark.card
@pytest.mark.parametrize("policy", ["balanced_cpu_diskio", "card"])
def test_schedbench_card_fixture_runs_correct_on_the_card(cuda_card, policy):
    """The card fixture at its size and with its classes alone, 10,000
    nodes of 4 cards and the saturated backlog, through run_cell for a
    short window; prints the set-up and the reference's seconds."""
    import torch

    from schedbench.run import run_cell
    from schedbench.tests.test_schedbench_cards import card_cell

    cell = card_cell(policy, nodes=10_000, running=2_000, backlog=8_192, extra=())
    lines = []
    out = run_cell(cell, 2**31 + 4_242, 5.0, False, device=cuda_card, torch=torch,
                   log=lambda *a, **k: lines.append(" ".join(map(str, a))))
    print(json.dumps({"policy": policy, "check": out["check"], "metrics": out["metrics"],
                      "device": out["device"], "attempted": out["attempted"],
                      "log": [ln for ln in lines if "effective config" not in ln]}))
    assert out["correct"], out["check"]
    assert out["device"]["platform"] == "gpu"


@pytest.mark.card
def test_schedbench_card_fixture_control_is_not_correct_on_the_card(cuda_card):
    """The card policy's control on the card fixture at its size fails
    where the program passes; prints each seed's readings."""
    import torch

    from schedbench import reference
    from schedbench.control import readings, summary
    from schedbench.tests.test_schedbench_cards import card_cell

    cell = card_cell("card", nodes=10_000, running=2_000, backlog=8_192, extra=())
    results = readings(cell, [2**31 + 1, 2**31 + 2, 2**31 + 3], 5.0, device=cuda_card,
                       torch=torch)
    for res in results:
        print(json.dumps({"check": res["check"], "control": res["control"]}))
    last = summary(results)
    print(json.dumps(last))
    assert last["program_correct"] and not last["control_correct_any"], last
    k1 = last["k1_score_err"]
    assert k1["program_max"] < reference.limits({})["k1_score_err"] < k1["control_min"], last
