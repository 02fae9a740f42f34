"""graftmodel CLI: `python -m kubernetes_scheduler_tpu_torch.analysis.model`.

Exhausts every shipped protocol model's bounded state space, verifies
each transition's code anchors against the live source, and runs the
mutation harness. Exit codes: 0 = protocol holds, anchors bind, every
mutant caught; 1 = a violation (counterexample schedules printed in
full); 3 = a model could not be exhausted inside --budget-seconds /
--max-states (the bounded proof is incomplete — raise the budget or
shrink the model, never ignore it).

`--json-artifact` drops a machine report (per-model state counts,
reduction stats, mutant verdicts, findings) for CI diffing;
`--format sarif` emits the findings through the shared SARIF renderer.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m kubernetes_scheduler_tpu_torch.analysis.model",
        description="bounded model checking of the session/epoch/"
        "capability protocol (graftmodel)",
    )
    parser.add_argument(
        "--budget-seconds", type=float, default=60.0,
        help="wall budget for the whole layer (models + mutants)",
    )
    parser.add_argument(
        "--max-states", type=int, default=200_000,
        help="per-model explored-state cap",
    )
    parser.add_argument(
        "--no-mutants", action="store_true",
        help="skip the mutation harness (models + anchors only)",
    )
    parser.add_argument(
        "--format", choices=("text", "json", "sarif"), default="text",
    )
    parser.add_argument(
        "--json-artifact", metavar="PATH",
        help="also write the machine report to PATH (CI artifact)",
    )
    args = parser.parse_args(argv)

    from kubernetes_scheduler_tpu_torch.analysis.model.anchors import RULE
    from kubernetes_scheduler_tpu_torch.analysis.model.runner import (
        layer_violations,
        run_layer,
    )

    report = run_layer(
        budget_seconds=args.budget_seconds,
        max_states=args.max_states,
        with_mutants=not args.no_mutants,
    )
    violations = layer_violations(report, schedule_sep="\n        ")
    budget_blown = any(
        not res.exhausted for res in report["models"]
    ) or any(not res.exhausted for res in report["mutants"].values())

    doc = {
        "seconds": round(report["seconds"], 3),
        "models": [
            {
                "name": r.model,
                "states": r.states,
                "transitions_fired": r.transitions_fired,
                "transitions_slept": r.transitions_slept,
                "exhausted": r.exhausted,
                "seconds": round(r.seconds, 4),
                "violations": [
                    {"kind": v.kind, "name": v.name, "message": v.message,
                     "schedule": v.schedule}
                    for v in r.violations
                ],
            }
            for r in report["models"]
        ],
        "mutants": {
            name: {
                "caught": bool(res.violations) and res.exhausted,
                "states": res.states,
                "first_finding": (
                    f"{res.violations[0].kind}:{res.violations[0].name}"
                    if res.violations else None
                ),
            }
            for name, res in report["mutants"].items()
        },
        "anchor_drift": [v.__dict__ for v in report["anchor_violations"]],
    }

    if args.json_artifact:
        with open(args.json_artifact, "w", encoding="utf-8") as f:
            json.dump(doc, f, indent=2)

    if args.format == "json":
        print(json.dumps(doc, indent=2))
    elif args.format == "sarif":
        from kubernetes_scheduler_tpu_torch.analysis.sarif import (
            render_sarif,
            validate_sarif,
        )

        sarif = render_sarif(
            violations,
            {RULE: "bounded model checking of the session/epoch/"
                   "capability protocol"},
        )
        validate_sarif(sarif)
        print(json.dumps(sarif, indent=2))
    else:
        for r in report["models"]:
            red = (
                f", {r.transitions_slept} slept"
                if r.transitions_slept else ""
            )
            status = "ok" if r.ok else (
                "NOT EXHAUSTED" if not r.exhausted else "VIOLATED"
            )
            print(
                f"{r.model}: {r.states} states, "
                f"{r.transitions_fired} transitions{red}, "
                f"{r.seconds * 1e3:.0f} ms — {status}"
            )
            for v in r.violations:
                print("  " + v.render().replace("\n", "\n  "))
        if report["mutants"]:
            caught = sum(
                1 for d in doc["mutants"].values() if d["caught"]
            )
            print(
                f"mutation harness: {caught}/{len(report['mutants'])} "
                "seeded mutants caught"
            )
            for name, d in doc["mutants"].items():
                mark = "caught" if d["caught"] else "SURVIVED"
                via = f" via {d['first_finding']}" if d["caught"] else ""
                print(f"  {name}: {mark}{via}")
        for v in report["anchor_violations"]:
            print(v.format())
        print(
            f"graftmodel: {len(violations)} finding(s) in "
            f"{report['seconds']:.2f}s",
            file=sys.stderr,
        )
    if budget_blown:
        return 3
    return 1 if violations else 0


if __name__ == "__main__":
    sys.exit(main())
