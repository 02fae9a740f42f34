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
