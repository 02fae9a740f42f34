"""The reference against the port on a tiny cluster on the CPU, the control,
and a run with the timed path broken underneath coming out not correct."""

from __future__ import annotations

import pytest
import torch

from schedbench import reference
from schedbench.tests.conftest import cpu_run, tiny_cell

CELLS = ("basic-5k.saturated", "antiaffinity-5k.saturated")


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("device_path", [False, True])
def test_schedbench_port_agrees_with_the_reference(name, device_path):
    out = cpu_run(tiny_cell(name, device_path=device_path), seed=2**31 + 11)
    assert out["correct"], out["check"]
    assert out["attempted"] > 0
    assert list(out)[-1] == "check"
    assert set(out["check"]) == set(reference.limits({}))
    # K1's last window was read and agrees to float32 rounding
    assert out["check"]["k1_score_err"]["value"] < 1e-3


@pytest.mark.parametrize("name", CELLS)
def test_schedbench_control_fails_where_the_port_passes(name):
    from schedbench.control import readings, summary

    cell = tiny_cell(name, nodes=96, backlog=160)
    [out] = readings(cell, [5], 1.0, device="cpu", torch=torch)
    lim = reference.limits({})
    assert out["correct"]
    assert not out["control"]["correct"]
    got = summary([out])
    assert set(got) >= {"score_gap", "k1_score_err"}
    assert got["k1_score_err"]["program_max"] < lim["k1_score_err"] < got["k1_score_err"]["control_min"]


def _break(fault: str):
    """An after_setup hook that breaks the engine's answers."""

    def hook(run):
        eng = run.sched.engine
        orig = eng.schedule_windows

        def schedule_windows(snapshot, windows, **kw):
            res = orig(snapshot, windows, **kw)
            idx = res.node_idx.clone()
            if fault == "unchanged":
                idx[:] = -1
            elif fault == "half":
                idx[:, idx.shape[1] // 2:] = -1
            elif fault == "altered":
                n = snapshot.allocatable.shape[0]
                idx = torch.where(idx >= 0, (idx + 1) % max(n // 2, 1), idx)
            return res._replace(node_idx=idx)

        eng.schedule_windows = schedule_windows

    return hook


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_schedbench_broken_path_is_not_correct(name, fault):
    cell = tiny_cell(name, backlog=96, device_path=True)
    assert cpu_run(cell, seed=3)["correct"]
    out = cpu_run(cell, seed=3, after_setup=_break(fault))
    assert not out["correct"], (fault, out["check"])


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", ["bfloat16", "one_node_masked"])
def test_schedbench_broken_scores_are_not_correct(name, fault, monkeypatch):
    """K1's answer altered where it is produced (under the kernel's
    launch site, which the harness reads), with its placements left to
    the auction."""
    from kubernetes_scheduler_tpu_torch.ops import fused

    cell = tiny_cell(name, backlog=96, device_path=True)
    plain = fused.masked_score_plain

    def broken(*a, **k):
        out = plain(*a, **k)
        if fault == "bfloat16":
            return torch.where(out > reference.NEG * 0.5, out.bfloat16().float(), out)
        return torch.where(torch.arange(out.shape[1]) == 0, reference.NEG, out)

    monkeypatch.setattr(fused, "masked_score_plain", broken)
    out = cpu_run(cell, seed=3)
    assert not out["correct"], (fault, out["check"])
    name = "k1_score_err" if fault == "bfloat16" else "k1_mask_errors"
    assert out["check"][name]["value"] > out["check"][name]["limit"]
