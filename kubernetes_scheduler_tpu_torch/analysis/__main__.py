"""graftlint CLI for the PyTorch/CUDA package:
`python -m kubernetes_scheduler_tpu_torch.analysis`.

Exits non-zero on any unwaived violation of the fifteen AST and text
families (rules/__init__.py). A full-repo run also runs the engine-contract
layer (analysis/contracts.py: every engine entry point and kernel wrapper
called on the device `--device` names, default cuda — it raises without a
card, so a CPU run passes `--device cpu` — the sharded surfaces on a
4-shard and a 2 x 2 mesh of that device, the package's
COLLECTIVE_BUDGET.json gate, and the seeded SPMD mutant harness) unless
--no-contracts, the thread/determinism mutant harness, and the
protocol-model layer (analysis/model/: bounded model checking of the
session/epoch/capability protocol, anchor drift, mutation harness) unless
--no-models. Each layer that runs prints one `graftlint: layer ...` line
on stderr. Machine output: `--format json|sarif` (SARIF 2.1.0 — validated
structurally before printing, so a malformed artifact fails lint, not the
CI uploader), `--json-artifact PATH` to drop the findings JSON beside any
display format, `--baseline` for the package's suppression file
(analysis/LINT_BASELINE.json; stale or unexplained entries fail lint),
and `--budget-seconds` asserting the whole run's wall time. Waived sites
are listed (with their justifications) under --verbose so the allow-list
stays reviewable.

`--changed-only REF` is the fast pre-commit loop: the families still
parse the whole package (the interprocedural core needs every edge),
but findings are scoped to the files changed vs REF plus their
reverse-dependency closure from the shared call graph, and each
whole-program layer runs only when a file on its SURFACE is in that
closure.

`--write-kernel-budget` rebuilds csrc/fused.cu with nvcc into a fresh
directory and rewrites csrc/kernel_budget.json from the ptxas report
(analysis/kernel_budget.py); it needs the CUDA toolkit and raises
without it. `--write-collective-budget` rewrites
analysis/COLLECTIVE_BUDGET.json from one run of every sharded surface on
`--device` (call sites do not depend on the device).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from kubernetes_scheduler_tpu_torch.analysis.core import (
    BASELINE_NAME,
    _REPO_ROOT,
    apply_baseline,
    load_baseline,
    run_lint,
)
from kubernetes_scheduler_tpu_torch.analysis.rules import RULES

# wall budget of the protocol-model layer (models, anchors, mutation
# harness); an un-exhausted model is a violation, never a silent skip
MODEL_BUDGET_SECONDS = 60.0


def _rule_docs() -> dict:
    """rule id -> first docstring line of its module (SARIF metadata)."""
    import importlib

    docs = {}
    for name, fn in RULES.items():
        mod = importlib.import_module(fn.__module__)
        head = (mod.__doc__ or name).strip().splitlines()[0]
        docs[name] = head
    return docs


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m kubernetes_scheduler_tpu_torch.analysis",
        description="repo-native static analysis (graftlint)",
    )
    parser.add_argument(
        "paths", nargs="*",
        help="files to lint (default: the whole package)",
    )
    parser.add_argument(
        "--rules",
        help=f"comma-separated rule subset of: {', '.join(sorted(RULES))}",
    )
    parser.add_argument(
        "--format", choices=("text", "json", "sarif"), default="text",
    )
    parser.add_argument(
        "--json-artifact", metavar="PATH",
        help="also write the findings JSON to PATH (CI artifact)",
    )
    parser.add_argument(
        "--baseline", metavar="PATH", default=None,
        help=f"suppression file (default: {BASELINE_NAME} under the "
             "repo root when present); --no-baseline disables",
    )
    parser.add_argument("--no-baseline", action="store_true")
    parser.add_argument(
        "--changed-only", metavar="REF",
        help="scope findings to files changed vs the git REF plus "
             "their reverse-dependency closure (fast pre-commit loop)",
    )
    parser.add_argument(
        "--budget-seconds", type=float, default=None,
        help="fail if the whole run exceeds this wall time",
    )
    parser.add_argument(
        "--verbose", action="store_true",
        help="also list waived violations with their justifications",
    )
    parser.add_argument(
        "--no-contracts", action="store_true",
        help="skip the engine-contract layer on a full-repo lint",
    )
    parser.add_argument(
        "--no-models", action="store_true",
        help="skip the protocol-model layer on a full-repo lint",
    )
    parser.add_argument(
        "--device", default="cuda",
        help="the device the engine-contract layer runs on (default cuda; "
             "it raises without a card: pass cpu to run the plain versions)",
    )
    parser.add_argument(
        "--write-kernel-budget", action="store_true",
        help="rebuild the CUDA sources with nvcc and rewrite "
             "csrc/kernel_budget.json from ptxas (needs the CUDA toolkit)",
    )
    parser.add_argument(
        "--write-collective-budget", action="store_true",
        help="rewrite analysis/COLLECTIVE_BUDGET.json from one run of every "
             "sharded surface on --device",
    )
    args = parser.parse_args(argv)
    t0 = time.monotonic()
    if args.write_collective_budget:
        from kubernetes_scheduler_tpu_torch.analysis import contracts

        try:
            doc = contracts.write_collective_budget(device=args.device)
        except RuntimeError as e:
            parser.error(str(e))
        print(json.dumps(doc["surfaces"], sort_keys=True))
        print(
            f"graftlint: wrote {len(doc['surfaces'])} surfaces to "
            f"{contracts.COLLECTIVE_BUDGET_NAME}",
            file=sys.stderr,
        )
        return 0
    if args.write_kernel_budget:
        from kubernetes_scheduler_tpu_torch.analysis import kernel_budget

        doc = kernel_budget.measure()
        kernel_budget.write_budget(doc)
        for row in doc["kernels"]:
            print(json.dumps(row))
        print(
            f"graftlint: wrote {len(doc['kernels'])} kernel rows to "
            f"{kernel_budget.BUDGET_PATH}",
            file=sys.stderr,
        )
        return 0

    rules = (
        [r.strip() for r in args.rules.split(",") if r.strip()]
        if args.rules
        else None
    )
    if args.changed_only and args.paths:
        parser.error("--changed-only and explicit paths are exclusive")
    ctx_sink: list = []
    try:
        violations = run_lint(args.paths or None, rules=rules,
                              ctx_out=ctx_sink)
    except ValueError as e:
        parser.error(str(e))

    # --changed-only: the families parsed (and analyzed) the whole
    # package — the interprocedural core needs every edge — but the
    # findings reported are those in the changed files' reverse-
    # dependency closure. Subset-of-full-run by construction.
    scope = None
    if args.changed_only:
        from kubernetes_scheduler_tpu_torch.analysis.core import (
            changed_vs_ref,
            reverse_dependency_closure,
        )

        try:
            changed = changed_vs_ref(_REPO_ROOT, args.changed_only)
        except ValueError as e:
            parser.error(str(e))
        scope = reverse_dependency_closure(ctx_sink[0], changed)
        violations = [v for v in violations if v.path in scope]

    def _surface_hit(patterns) -> bool:
        import fnmatch

        if scope is None:
            return False
        return any(fnmatch.fnmatch(p, pat) for p in scope for pat in patterns)

    def _layer(name, run) -> None:
        t = time.monotonic()
        found = run()
        violations.extend(found)
        print(
            f"graftlint: layer {name}: {len(found)} finding(s) in "
            f"{time.monotonic() - t:.1f}s",
            file=sys.stderr,
        )

    full_repo = not args.paths and rules is None and not args.changed_only

    # layer 2: engine contracts on --device — on for a full-repo run; a
    # changed-only run checks them only when the closure touches the
    # engine / ops / parallel surface. The sharded
    # half (both meshes, the COLLECTIVE_BUDGET.json gate) and the seeded
    # SPMD mutant harness ride along: an analyzer that stops catching a
    # bug class is itself a lint violation
    run_contracts = full_repo and not args.no_contracts
    if args.changed_only and not args.no_contracts:
        from kubernetes_scheduler_tpu_torch.analysis.contracts import SURFACE

        run_contracts = run_contracts or _surface_hit(SURFACE)
    if run_contracts:
        from kubernetes_scheduler_tpu_torch.analysis.contracts import (
            check_contracts,
            check_sharded_contracts,
        )
        from kubernetes_scheduler_tpu_torch.analysis.spmd_mutants import (
            check_spmd_mutants,
        )

        try:
            _layer("engine-contract", lambda: check_contracts(args.device))
        except RuntimeError as e:
            parser.error(f"the engine-contract layer needs --device: {e}")
        _layer("sharded-contract", lambda: check_sharded_contracts(args.device))
        _layer("spmd-mutants", lambda: check_spmd_mutants(args.device))

    # layer 2b: the thread/determinism mutant harness — pure AST, so it
    # rides every full-repo run; changed-only runs re-arm it when the
    # closure touches the threaded layers or the analyzer
    run_thread_mutants = full_repo
    if args.changed_only:
        from kubernetes_scheduler_tpu_torch.analysis.thread_mutants import (
            SURFACE as THREAD_SURFACE,
        )

        run_thread_mutants = run_thread_mutants or _surface_hit(THREAD_SURFACE)
    if run_thread_mutants:
        from kubernetes_scheduler_tpu_torch.analysis.thread_mutants import (
            check_thread_mutants,
        )

        _layer("thread-mutants", check_thread_mutants)

    # layer 3: protocol models (analysis/model/), reported as pseudo-rule
    # `protocol-model`; same full-repo default / surface-keyed
    # changed-only behavior as the contracts layer
    run_models = full_repo and not args.no_models
    if args.changed_only and not args.no_models:
        from kubernetes_scheduler_tpu_torch.analysis.model.runner import (
            SURFACE as MODEL_SURFACE,
        )

        run_models = run_models or _surface_hit(MODEL_SURFACE)
    if run_models:
        from kubernetes_scheduler_tpu_torch.analysis.model.runner import (
            check_protocol_layer,
        )

        _layer("protocol-model", lambda: check_protocol_layer(
            # a path-scoped ctx would miss anchor targets: let the layer
            # build its own full-package index in that case
            ctx_sink[0] if (ctx_sink and not args.paths) else None,
            budget_seconds=MODEL_BUDGET_SECONDS,
        ))

    baseline = args.baseline
    if baseline is None and not args.no_baseline:
        default = os.path.join(_REPO_ROOT, BASELINE_NAME)
        baseline = default if os.path.exists(default) else None
    if baseline and not args.no_baseline:
        try:
            entries = load_baseline(baseline)
        except (OSError, ValueError) as e:
            parser.error(f"--baseline {baseline}: {e}")
        # scoped runs can't distinguish out-of-scope from stale — only
        # the full-repo run polices baseline liveness
        violations.extend(
            apply_baseline(
                violations, entries, baseline, check_stale=full_repo
            )
        )

    violations.sort(key=lambda v: (v.path, v.line, v.rule))
    active = [v for v in violations if not v.waived]
    waived = [v for v in violations if v.waived]

    if args.json_artifact:
        with open(args.json_artifact, "w", encoding="utf-8") as f:
            json.dump([v.__dict__ for v in violations], f, indent=2)

    if args.format == "json":
        print(json.dumps([v.__dict__ for v in violations], indent=2))
    elif args.format == "sarif":
        from kubernetes_scheduler_tpu_torch.analysis.sarif import (
            render_sarif,
            validate_sarif,
        )

        doc = render_sarif(violations, _rule_docs())
        validate_sarif(doc)
        print(json.dumps(doc, indent=2))
    else:
        for v in active:
            print(v.format())
        if args.verbose:
            for v in waived:
                print(v.format())
        print(
            f"graftlint: {len(active)} violation(s), "
            f"{len(waived)} waived",
            file=sys.stderr,
        )
    elapsed = time.monotonic() - t0
    if args.budget_seconds is not None and elapsed > args.budget_seconds:
        print(
            f"graftlint: wall time {elapsed:.1f}s exceeded the "
            f"--budget-seconds {args.budget_seconds:.1f}s gate",
            file=sys.stderr,
        )
        return 1
    return 1 if active else 0


if __name__ == "__main__":
    sys.exit(main())
