"""The port's protocol-model layer (kubernetes_scheduler_tpu_torch.analysis.model)
case for case against the JAX package's tests/test_model.py: the checker
core (partial-order-reduction soundness against known state counts,
counterexample determinism, writes-declaration validation, budgets), the
shipped models exhausted clean with every anchor bound to the PORT's
bridge and host code, the mutation harness mutant by mutant, and the CLI.
Then both packages held to the same facts: each shared model explores as
many states, exhausts alike, and every mutant gets the reference's
verdict. Last, a dropped latch reset in a copy of the port's
bridge/client.py makes the full lint fail with a protocol-model finding.
Everything is pure Python on the CPU."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from kubernetes_scheduler_tpu.analysis.model import check_model as ref_check_model
from kubernetes_scheduler_tpu.analysis.model import mutants as ref_mutants
from kubernetes_scheduler_tpu.analysis.model.protocols import (
    build_models as ref_build_models,
)
from kubernetes_scheduler_tpu_torch.analysis.model import (
    Convergence,
    Invariant,
    ProtocolModel,
    Transition,
    check_model,
)
from kubernetes_scheduler_tpu_torch.analysis.model import mutants as mutants_mod
from kubernetes_scheduler_tpu_torch.analysis.model.__main__ import main as model_main
from kubernetes_scheduler_tpu_torch.analysis.model.checker import _explore
from kubernetes_scheduler_tpu_torch.analysis.model.protocols import build_models

ROOT = Path(__file__).resolve().parents[1]
PORT = "kubernetes_scheduler_tpu_torch"
MODEL_NAMES = [m.name for m in build_models()]

# ---- checker core ---------------------------------------------------------


def _counter_model(n=3, invariants=(), convergences=()):
    """Two independent per-process counters 0..n: exactly (n+1)^2
    reachable states."""
    t = (
        Transition(
            name="inc_x", process="px",
            guard=lambda s: s["x"] < n,
            effect=lambda s: {"x": s["x"] + 1},
            reads=frozenset({"x"}), writes=frozenset({"x"}),
        ),
        Transition(
            name="inc_y", process="py",
            guard=lambda s: s["y"] < n,
            effect=lambda s: {"y": s["y"] + 1},
            reads=frozenset({"y"}), writes=frozenset({"y"}),
        ),
    )
    return ProtocolModel(
        name="counters", description="two independent counters",
        init={"x": 0, "y": 0}, transitions=t,
        invariants=tuple(invariants), convergences=tuple(convergences),
    )


def test_torch_por_visits_every_state_of_known_lattice():
    res = check_model(_counter_model(3))
    assert res.exhausted and res.ok
    assert res.states == 16
    assert res.transitions_slept > 0


@pytest.mark.parametrize("model", build_models(), ids=lambda m: m.name)
def test_torch_por_state_set_equals_full_interleaving(model):
    full = _explore(model, por=False, record_edges=False,
                    max_states=200_000, deadline=None)
    red = _explore(model, por=True, record_edges=False,
                   max_states=200_000, deadline=None)
    assert full.exhausted and red.exhausted
    assert set(red.states) == set(full.states)


def test_torch_undeclared_write_is_an_error_not_an_unsoundness():
    lying = ProtocolModel(
        name="liar", description="", init={"x": 0, "y": 0},
        transitions=(
            Transition(
                name="sneak", process="p",
                guard=lambda s: s["x"] == 0,
                effect=lambda s: {"x": 1, "y": 1},  # y undeclared
                reads=frozenset({"x"}), writes=frozenset({"x"}),
            ),
        ),
    )
    with pytest.raises(ValueError, match="undeclared variables.*'y'"):
        check_model(lying)


def test_torch_invariant_counterexample_renders_schedule():
    res = check_model(_counter_model(2, invariants=(
        Invariant("x-bounded", lambda s: s["x"] < 2, "x reached 2"),
    )))
    (v,) = res.violations
    assert v.kind == "invariant" and v.name == "x-bounded"
    assert v.schedule[0].startswith("schedule (2 events")
    assert v.schedule[1:3] == ["1. inc_x", "2. inc_x"]
    assert "reaches {" in v.schedule[-1]


def test_torch_convergence_livelock_renders_lasso():
    toggle = ProtocolModel(
        name="toggler", description="", init={"x": 0},
        transitions=(
            Transition(
                name="flip", process="p", guard=lambda s: True,
                effect=lambda s: {"x": 1 - s["x"]},
                reads=frozenset({"x"}), writes=frozenset({"x"}),
            ),
        ),
        convergences=(
            Convergence("settles", trigger=lambda s: True, goal=lambda s: s["x"] == 2),
        ),
    )
    (v,) = check_model(toggle).violations
    assert v.kind == "convergence"
    assert any("livelock cycle" in line for line in v.schedule)


def test_torch_convergence_dead_end_renders():
    one_shot = ProtocolModel(
        name="oneshot", description="", init={"x": 0},
        transitions=(
            Transition(
                name="step", process="p", guard=lambda s: s["x"] == 0,
                effect=lambda s: {"x": 1},
                reads=frozenset({"x"}), writes=frozenset({"x"}),
            ),
        ),
        convergences=(
            Convergence("settles", trigger=lambda s: True, goal=lambda s: s["x"] == 2),
        ),
    )
    (v,) = check_model(one_shot).violations
    assert any("dead end at" in line for line in v.schedule)


def test_torch_state_budget_reports_unexhausted():
    res = check_model(_counter_model(10), max_states=5)
    assert not res.exhausted and not res.ok
    assert any(v.kind == "budget" for v in res.violations)


def test_torch_counterexample_deterministic_across_runs():
    a = mutants_mod.run_mutant("partial-probe")
    b = mutants_mod.run_mutant("partial-probe")
    assert [(v.kind, v.name, v.schedule) for v in a.violations] == [
        (v.kind, v.name, v.schedule) for v in b.violations
    ]
    assert a.states == b.states
    assert a.transitions_fired == b.transitions_fired


# ---- the shipped models hold at HEAD --------------------------------------


@pytest.mark.parametrize("model", build_models(), ids=lambda m: m.name)
def test_torch_shipped_model_exhausts_clean(model):
    res = check_model(model)
    assert res.exhausted, f"{model.name} blew its budget"
    assert res.violations == [], "\n".join(v.render() for v in res.violations)


# ---- the mutation harness: every seeded bug caught, by name ---------------

_EXPECTED_CATCH = {
    "invalidate-keeps-latches": "downgrade-relearned",
    "invalidate-keeps-wire-cache": "no-marker-without-latch",
    "partial-probe": "latches-resolved-together",
    "delta-across-layout-churn": "resident-state-faithful",
    "defer-restores-to-back": "deferred-gang-leads-next-pop",
    "fail-keeps-resident-commit": "failure-invalidates-resident",
    "dispatch-scores-stale-batch": "stale-spec-batch-never-scored",
    "unfenced-replica-bind": "no-double-bind",
    "shared-delta-unfenced": "shared-delta-fenced",
    "ladder-skips-rung": "never-skips-a-rung",
    "promote-without-probe": "recovery-re-probes",
}


def test_torch_every_mutant_has_an_expectation():
    assert set(_EXPECTED_CATCH) == set(mutants_mod.MUTANTS)


@pytest.mark.parametrize("name", list(mutants_mod.MUTANTS))
def test_torch_mutant_caught_with_rendered_schedule(name):
    res = mutants_mod.run_mutant(name)
    assert res.exhausted
    assert res.violations, f"mutant `{name}` SURVIVED"
    assert _EXPECTED_CATCH[name] in {v.name for v in res.violations}
    caught = [v for v in res.violations if v.name == _EXPECTED_CATCH[name]]
    assert any(
        line.startswith("schedule (") for v in caught for line in v.schedule
    ), f"mutant `{name}` caught without a rendered event schedule"


# ---- anchors: the drift layer, on the port's code ---------------------------


def _index():
    from kubernetes_scheduler_tpu_torch.analysis.model.runner import _index_for

    return _index_for(None)


def test_torch_shipped_anchors_bind_to_the_port():
    from kubernetes_scheduler_tpu_torch.analysis.model.anchors import (
        verify_model_anchors,
    )

    index = _index()
    paths = set()
    for model in build_models():
        vs = verify_model_anchors(index, model)
        assert vs == [], "\n".join(v.format() for v in vs)
        paths |= {a.path for t in model.transitions for a in t.anchors}
    assert paths and all(p.startswith(f"{PORT}/") for p in paths), paths


def test_torch_anchor_drift_detected():
    from kubernetes_scheduler_tpu_torch.analysis.model.anchors import (
        Anchor,
        verify_anchor,
    )

    index = _index()
    client = f"{PORT}/bridge/client.py"
    vs = verify_anchor(index, "m", "t", Anchor(client, "RemoteEngine.gone"))
    assert len(vs) == 1 and "no longer exists" in vs[0].message
    vs = verify_anchor(index, "m", "t", Anchor(
        client, "RemoteEngine._invalidate_session",
        must_contain=("FRAGMENT_THE_REFACTOR_DROPPED",),
    ))
    assert len(vs) == 1 and "no longer contains" in vs[0].message
    vs = verify_anchor(index, "m", "t", Anchor(
        client, "RemoteEngine._invalidate_session",
        calls=("helper_nobody_calls",),
    ))
    assert len(vs) == 1 and "no longer calls" in vs[0].message


def test_torch_anchor_drift_fails_the_lint_layer(monkeypatch):
    import dataclasses

    from kubernetes_scheduler_tpu_torch.analysis.model import protocols, runner
    from kubernetes_scheduler_tpu_torch.analysis.model.anchors import Anchor

    def drifted():
        m = protocols.client_session_model()
        old = m.transitions[0]
        bad = dataclasses.replace(
            old,
            anchors=(Anchor(
                f"{PORT}/bridge/client.py",
                "RemoteEngine._probe_capabilities",
                must_contain=("THE_CODE_MOVED",),
            ),),
        )
        return (protocols.replace_transition(m, old.name, bad),)

    monkeypatch.setattr(runner, "build_models", drifted)
    vs = runner.check_protocol_layer(budget_seconds=30.0)
    assert any(v.rule == "protocol-model" and "THE_CODE_MOVED" in v.message for v in vs)


# ---- the lint layer & CLI -------------------------------------------------


def test_torch_protocol_layer_clean_at_head():
    from kubernetes_scheduler_tpu_torch.analysis.model.runner import (
        check_protocol_layer,
    )

    vs = check_protocol_layer(budget_seconds=60.0)
    assert vs == [], "\n".join(v.format() for v in vs)


def test_torch_model_command_json_artifact_and_exit_codes(tmp_path, capsys):
    art = tmp_path / "model.json"
    rc = model_main(["--json-artifact", str(art), "--format", "json"])
    capsys.readouterr()
    assert rc == 0
    doc = json.loads(art.read_text())
    assert {m["name"] for m in doc["models"]} == {
        "client-session", "gang-queue-front", "gang-queue-native",
        "pipeline-slot", "replica-bind", "degradation-ladder",
    }
    assert all(m["exhausted"] and not m["violations"] for m in doc["models"])
    assert doc["mutants"] and all(d["caught"] for d in doc["mutants"].values())
    assert doc["anchor_drift"] == []


def test_torch_model_command_budget_exit_code(capsys):
    rc = model_main(["--max-states", "5", "--no-mutants"])
    out = capsys.readouterr().out
    assert rc == 3
    assert "NOT EXHAUSTED" in out


def test_torch_model_command_sarif(capsys):
    from kubernetes_scheduler_tpu_torch.analysis.sarif import validate_sarif

    rc = model_main(["--format", "sarif", "--no-mutants"])
    doc = json.loads(capsys.readouterr().out)
    validate_sarif(doc)
    assert rc == 0


def test_torch_model_module_runs_as_a_command():
    proc = subprocess.run(
        [sys.executable, "-m", f"{PORT}.analysis.model", "--no-mutants"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=str(ROOT)),
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


# ---- both packages held to the same facts ---------------------------------


@pytest.mark.parametrize("name", MODEL_NAMES)
def test_torch_model_explores_the_reference_state_space(name):
    port = {m.name: m for m in build_models()}[name]
    ref = {m.name: m for m in ref_build_models()}[name]
    a, b = check_model(port), ref_check_model(ref)
    assert (a.states, a.exhausted, a.transitions_fired, a.transitions_slept) == (
        b.states, b.exhausted, b.transitions_fired, b.transitions_slept)
    assert [(v.kind, v.name) for v in a.violations] == [
        (v.kind, v.name) for v in b.violations]


@pytest.mark.parametrize("name", list(mutants_mod.MUTANTS))
def test_torch_mutant_verdict_matches_reference(name):
    assert set(mutants_mod.MUTANTS) == set(ref_mutants.MUTANTS)
    a, b = mutants_mod.run_mutant(name), ref_mutants.run_mutant(name)
    assert (a.states, a.exhausted) == (b.states, b.exhausted)
    assert sorted((v.kind, v.name, tuple(v.schedule)) for v in a.violations) == sorted(
        (v.kind, v.name, tuple(v.schedule)) for v in b.violations)


# ---- a dropped latch reset fails the full lint ------------------------------


def port_copy(tmp_path: Path) -> Path:
    """The port's package and README in a scratch tree (the lint's root)."""
    shutil.copytree(ROOT / PORT, tmp_path / PORT,
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    shutil.copy(ROOT / "README.md", tmp_path / "README.md")
    return tmp_path


def run_copy_lint(root: Path, *args) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, "-m", f"{PORT}.analysis", "--device", "cpu", *args],
        cwd=root, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(root)),
    )


def test_torch_dropped_latch_reset_fails_lint(tmp_path):
    root = port_copy(tmp_path)
    client = root / PORT / "bridge" / "client.py"
    src = client.read_text()
    drop = ("        for attr in CAPABILITY_LATCHES.values():\n"
            "            setattr(self, attr, None)\n")
    assert src.count(drop) == 1
    client.write_text(src.replace(drop, ""))
    proc = run_copy_lint(root)
    assert proc.returncode == 1, proc.stdout + proc.stderr
    lines = [x for x in proc.stdout.splitlines() if "[protocol-model]" in x]
    assert any("_invalidate_session" in x and "CAPABILITY_LATCHES" in x
               for x in lines), proc.stdout
