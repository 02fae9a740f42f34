"""SARIF 2.1.0 output for graftlint (`--format sarif`).

SARIF is the exchange format CI code-scanning UIs ingest (GitHub code
scanning among them), which makes lint findings diffable artifacts
instead of grepped logs. `render_sarif` emits the minimal conforming
document: one run, the registered rule families (plus the runner's
pseudo-rules) as `tool.driver.rules`, every finding as a `result` with
a physical location; waived findings ship with `suppressions` so the
reviewable allow-list survives into the artifact.

`validate_sarif` structurally checks a document against the SARIF 2.1.0
schema's required surface (the image has no network for the real JSON
schema; the checks below mirror its required properties and enum
values for the subset we emit). `--format sarif` runs it over the
fresh artifact before printing it.
"""

from __future__ import annotations

SARIF_VERSION = "2.1.0"
SARIF_SCHEMA = (
    "https://raw.githubusercontent.com/oasis-tcs/sarif-spec/master/"
    "Schemata/sarif-schema-2.1.0.json"
)

_LEVELS = {"none", "note", "warning", "error"}


def render_sarif(violations, rule_docs: dict[str, str]) -> dict:
    """One-run SARIF document. `rule_docs` maps rule id -> one-line
    description (the registry's module docstring headlines); findings
    referencing pseudo-rules (bad-waiver, docs-drift, engine-contract,
    parse, *-baseline) are added to the driver rules on the fly so every
    result's ruleId resolves."""
    ids = dict(rule_docs)
    for v in violations:
        ids.setdefault(v.rule, "graftlint runner check")
    rules = [
        {
            "id": rid,
            "shortDescription": {"text": ids[rid]},
        }
        for rid in sorted(ids)
    ]
    index = {r["id"]: i for i, r in enumerate(rules)}
    results = []
    for v in violations:
        res = {
            "ruleId": v.rule,
            "ruleIndex": index[v.rule],
            "level": "warning" if v.waived else "error",
            "message": {"text": v.message},
            "locations": [
                {
                    "physicalLocation": {
                        "artifactLocation": {"uri": v.path},
                        "region": {"startLine": max(1, int(v.line))},
                    }
                }
            ],
        }
        if v.waived:
            res["suppressions"] = [
                {
                    "kind": "inSource",
                    "justification": v.waiver_reason or "",
                }
            ]
        results.append(res)
    return {
        "$schema": SARIF_SCHEMA,
        "version": SARIF_VERSION,
        "runs": [
            {
                "tool": {
                    "driver": {
                        "name": "graftlint",
                        "informationUri": (
                            "kubernetes_scheduler_tpu_torch/analysis/"
                        ),
                        "rules": rules,
                    }
                },
                "results": results,
            }
        ],
    }


def validate_sarif(doc) -> None:
    """Raise ValueError on any departure from the SARIF 2.1.0 required
    surface (for the subset graftlint emits)."""

    def need(cond, msg):
        if not cond:
            raise ValueError(f"SARIF: {msg}")

    need(isinstance(doc, dict), "document must be an object")
    need(doc.get("version") == SARIF_VERSION,
         f"version must be '{SARIF_VERSION}'")
    need("sarif-schema-2.1.0" in str(doc.get("$schema", "")),
         "$schema must reference the 2.1.0 schema")
    runs = doc.get("runs")
    need(isinstance(runs, list) and runs, "runs must be a non-empty array")
    for run in runs:
        driver = (run.get("tool") or {}).get("driver")
        need(isinstance(driver, dict), "runs[].tool.driver required")
        need(
            isinstance(driver.get("name"), str) and driver["name"],
            "tool.driver.name must be a non-empty string",
        )
        rules = driver.get("rules", [])
        need(isinstance(rules, list), "driver.rules must be an array")
        rule_ids = set()
        for r in rules:
            need(isinstance(r.get("id"), str) and r["id"],
                 "rule.id must be a non-empty string")
            need(
                isinstance(
                    (r.get("shortDescription") or {}).get("text"), str
                ),
                f"rule {r.get('id')}: shortDescription.text required",
            )
            rule_ids.add(r["id"])
        results = run.get("results")
        need(isinstance(results, list), "run.results must be an array")
        for res in results:
            rid = res.get("ruleId")
            need(isinstance(rid, str) and rid, "result.ruleId required")
            need(rid in rule_ids,
                 f"result.ruleId `{rid}` not in driver.rules")
            need(res.get("level") in _LEVELS,
                 f"result.level must be one of {sorted(_LEVELS)}")
            need(
                isinstance((res.get("message") or {}).get("text"), str),
                "result.message.text required",
            )
            for loc in res.get("locations", ()):
                phys = loc.get("physicalLocation") or {}
                uri = (phys.get("artifactLocation") or {}).get("uri")
                need(isinstance(uri, str) and uri,
                     "physicalLocation.artifactLocation.uri required")
                start = (phys.get("region") or {}).get("startLine")
                need(isinstance(start, int) and start >= 1,
                     "region.startLine must be a positive integer")
