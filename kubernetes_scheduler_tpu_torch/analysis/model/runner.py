"""Ties the model layer into graftlint: models + drift anchors +
mutation harness, reported as pseudo-rule `protocol-model` violations.

A full-repo lint run calls `check_protocol_layer` (the way it calls
contracts.check_contracts); `python -m
kubernetes_scheduler_tpu_torch.analysis.model` drives the same code
through the standalone CLI (__main__.py) with a JSON artifact and
richer per-model reporting. Three finding classes:

- an invariant/convergence violation at HEAD (the model caught a real
  protocol bug — the counterexample schedule is in the message);
- an anchor drift (the code moved out from under the model — update
  protocols.py to match the refactor);
- a SURVIVED mutant (the checker lost its teeth for a known bug class
  — a checker/model regression, not a code bug).

Budget handling: one wall-clock budget covers the whole layer; a model
that cannot be exhausted inside it is reported as a violation (the
bounded proof is incomplete), never silently skipped.
"""

from __future__ import annotations

import time

from kubernetes_scheduler_tpu_torch.analysis.core import (
    Context,
    Violation,
    collect_files,
    load_file,
)
from kubernetes_scheduler_tpu_torch.analysis.model import mutants as mutants_mod
from kubernetes_scheduler_tpu_torch.analysis.model.anchors import (
    RULE,
    verify_model_anchors,
)
from kubernetes_scheduler_tpu_torch.analysis.model.checker import check_model
from kubernetes_scheduler_tpu_torch.analysis.model.protocols import build_models

_MODELS_PATH = "kubernetes_scheduler_tpu_torch/analysis/model/protocols.py"

# the files whose edits can break a modeled invariant or drift an
# anchor — a changed-only lint run checks the layer only when its
# closure touches these (every anchor path in protocols.py is here)
SURFACE = (
    "kubernetes_scheduler_tpu_torch/bridge/*.py",
    "kubernetes_scheduler_tpu_torch/host/scheduler.py",
    "kubernetes_scheduler_tpu_torch/host/queue.py",
    "kubernetes_scheduler_tpu_torch/host/snapshot.py",
    "kubernetes_scheduler_tpu_torch/host/resilience.py",
    "kubernetes_scheduler_tpu_torch/host/replica.py",
    "kubernetes_scheduler_tpu_torch/host/engine_pool.py",
    "kubernetes_scheduler_tpu_torch/sim/faults.py",
    "kubernetes_scheduler_tpu_torch/analysis/model/*.py",
)


def _index_for(ctx: Context | None):
    from kubernetes_scheduler_tpu_torch.analysis import dataflow

    if ctx is None:
        files = []
        from kubernetes_scheduler_tpu_torch.analysis.core import _REPO_ROOT

        for p in collect_files(_REPO_ROOT):
            sf = load_file(p, _REPO_ROOT)
            if sf is not None:
                files.append(sf)
        ctx = Context(root=_REPO_ROOT, files=files)
    return dataflow.get_index(ctx)


def run_layer(
    *,
    ctx: Context | None = None,
    budget_seconds: float = 60.0,
    max_states: int = 200_000,
    with_mutants: bool = True,
) -> dict:
    """The whole layer: {"models": [CheckResult...], "anchor_violations":
    [Violation...], "mutants": {name: CheckResult}, "seconds": float}."""
    t0 = time.monotonic()
    deadline = t0 + budget_seconds
    index = _index_for(ctx)
    models = build_models()
    anchor_violations: list[Violation] = []
    results = []
    for m in models:
        anchor_violations.extend(verify_model_anchors(index, m))
        left = max(0.5, deadline - time.monotonic())
        results.append(
            check_model(m, max_states=max_states, max_seconds=left)
        )
    mutant_results = {}
    if with_mutants:
        for name in mutants_mod.MUTANTS:
            left = max(0.5, deadline - time.monotonic())
            mutant_results[name] = mutants_mod.run_mutant(
                name, max_states=max_states, max_seconds=left
            )
    return {
        "models": results,
        "anchor_violations": anchor_violations,
        "mutants": mutant_results,
        "seconds": time.monotonic() - t0,
    }


def layer_violations(report: dict, *, schedule_sep: str = " | ") -> list:
    """Flatten a run_layer report into lint Violations."""
    out: list[Violation] = list(report["anchor_violations"])
    for res in report["models"]:
        for v in res.violations:
            msg = f"[{v.kind}:{v.name}] {v.message}"
            if v.schedule:
                msg += schedule_sep + schedule_sep.join(v.schedule)
            out.append(Violation(RULE, _MODELS_PATH, 1, msg))
    mutants_path = "kubernetes_scheduler_tpu_torch/analysis/model/mutants.py"
    for name, res in report["mutants"].items():
        if not res.exhausted:
            # a truncated run proves nothing either way: this is a
            # budget problem, not a lost-teeth checker regression —
            # misdiagnosing it as SURVIVED would send the maintainer
            # hunting the wrong bug
            out.append(
                Violation(
                    RULE, mutants_path, 1,
                    f"seeded mutant `{name}` run NOT EXHAUSTED within "
                    "the layer budget — the bounded proof over the "
                    "mutant is incomplete; raise the budget",
                )
            )
        elif not res.violations:
            out.append(
                Violation(
                    RULE, mutants_path, 1,
                    f"seeded mutant `{name}` SURVIVED the checker — the "
                    "model layer lost its teeth for this bug class "
                    "(checker or model regression; see "
                    f"mutants.MUTANTS[{name!r}].__doc__)",
                )
            )
    return out


def check_protocol_layer(
    ctx: Context | None = None, *, budget_seconds: float = 60.0
) -> list:
    """The lint entry point: every finding of the model layer as
    `protocol-model` Violations (empty when the protocol holds, the
    anchors bind, and every mutant is caught)."""
    return layer_violations(run_layer(ctx=ctx, budget_seconds=budget_seconds))
