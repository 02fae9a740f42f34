"""Span analytics: per-stage cycle budgets and a CI-able regression gate.

The scheduler EMITS spans (trace/spans.py); this module CONSUMES them
(the port's copy of kubernetes_scheduler_tpu/trace/analyze.py). `build_report` turns a span directory (or a merged
Chrome trace, or a saved report) into per-stage latency percentiles and
a per-cycle budget attribution table — which stage owns what fraction of
the median cycle, keyed by the loop path label every `cycle` span
carries and bracketed by the flight-recorder seq range, so a report row
points straight back at journal records and Perfetto bookmarks.
`diff_reports` compares two reports with per-stage relative thresholds
and an absolute-delta floor; the `spans diff` CLI exits non-zero on any
regression, which makes a span directory a perf gate: capture a
baseline, run the candidate, diff.

Everything here is engine/torch-free — safe to run against production
span files on a laptop, like trace/inspect.py for journals.

Attribution semantics: the host stages in ATTRIBUTION_STAGES nest
inside their cycle's `cycle` span and are mutually exclusive in time,
so their totals partition the cycle wall time and the residual
("other") is genuinely unattributed host work. `host_overlap` is
deliberately NOT in the table — it runs CONCURRENTLY with the in-flight
engine step (it is the pipelined loop's hidden work, not a cycle
cost), and counting it would double-book the overlap window. Sidecar
stages (deserialize/device_step/serialize/delta_apply) nest inside
`engine_step` on the other side of the bridge, and the port's engine
stages (engine_window/auction/auction_round/auction_block) inside it on
this side; they get percentiles but never attribution rows, for the same
no-double-counting reason. So do the port's `pod_events` bursts, which
fall between cycles or inside a cycle's residual ("other"), and its
`mirror_rows` passes, inside `mirror_emit`.
"""

from __future__ import annotations

import json
import os

import numpy as np

from kubernetes_scheduler_tpu_torch.trace.spans import (
    read_span_file,
    read_spans,
    span_files,
)

# host stages that partition the cycle span's wall time (the budget
# table); names are registry-pinned (observe.SHIPPED_SPANS)
ATTRIBUTION_STAGES = (
    "queue_pop",
    "state_fetch",
    "snapshot_build",
    "delta_derive",
    "engine_step",
    "bind",
    "recorder_write",
    "scalar_cycle",
    "reconstruct",
)
# reported (percentiles) but never attributed: concurrent with the
# engine step, nested inside it (across the bridge, or the port's
# engine_window / auction / auction_round / auction_block / card_path),
# or between cycles (the port's pod_events bursts), or inside mirror_emit
# (the port's mirror_rows)
NON_ATTRIBUTED_STAGES = (
    "host_overlap",
    "deserialize",
    "delta_apply",
    "device_step",
    "serialize",
    "pod_events",
    "mirror_rows",
    "engine_window",
    "auction",
    "auction_round",
    "auction_block",
    "card_path",
)


class AnalyzeError(RuntimeError):
    """Unusable span input (no files, no events, not span data)."""


def _load_events(path: str) -> tuple[list[dict], int]:
    """(complete events, file count) from a span DIRECTORY, a merged
    Chrome trace JSON (`spans merge --out`), or one span file."""
    if os.path.isdir(path):
        files = span_files(path)
        if not files:
            raise AnalyzeError(f"{path}: no span files (spans-*.trace.json)")
        return read_spans(path), len(files)
    if not os.path.exists(path):
        raise AnalyzeError(f"{path}: no such file or directory")
    try:
        with open(path, encoding="utf-8") as f:
            data = json.load(f)
    except json.JSONDecodeError:
        # a bare span file: the writer's crash-tolerant JSON-array
        # format has no closing bracket, so json.load refuses it
        return read_span_file(path), 1
    if isinstance(data, dict) and "traceEvents" in data:
        return list(data["traceEvents"]), 1
    raise AnalyzeError(
        f"{path}: not span data (expected a span directory, a merged "
        "Chrome trace, or a spans-*.trace.json file)"
    )


def _pctl(vals: list[float], q: float) -> float:
    return round(float(np.percentile(vals, q)), 4)


def _dist(vals: list[float]) -> dict:
    return {
        "count": len(vals),
        "p50_ms": _pctl(vals, 50),
        "p95_ms": _pctl(vals, 95),
        "p99_ms": _pctl(vals, 99),
        "total_ms": round(float(np.sum(vals)), 4),
    }


def build_report(path: str) -> dict:
    """Aggregate a span source into the analytics report `spans report`
    prints and `spans diff` consumes. Raises AnalyzeError when there is
    nothing to report on (no files / no complete spans) — an empty
    report exiting 0 would let a silently-dead telemetry pipeline pass
    a perf gate."""
    events, n_files = _load_events(path)
    complete = [ev for ev in events if ev.get("ph") == "X"]
    if not complete:
        raise AnalyzeError(f"{path}: span files hold no complete spans")
    by_name: dict[str, list[float]] = {}
    cycles_by_path: dict[str, list[float]] = {}
    seqs: list[int] = []
    cycles_with_seq = 0
    for ev in complete:
        dur_ms = float(ev.get("dur", 0.0)) / 1e3
        name = ev.get("name", "?")
        by_name.setdefault(name, []).append(dur_ms)
        args = ev.get("args") or {}
        if name == "cycle":
            cycles_by_path.setdefault(
                str(args.get("path", "?")), []
            ).append(dur_ms)
            if "seq" in args:
                cycles_with_seq += 1
        if "seq" in args:
            seqs.append(int(args["seq"]))
    cycle_durs = by_name.get("cycle", [])
    report: dict = {
        "source": path,
        "files": n_files,
        "events": len(complete),
        "cycles": len(cycle_durs),
        "by_path": {
            p: _dist(v) for p, v in sorted(cycles_by_path.items())
        },
        "stages": {
            name: _dist(v)
            for name, v in sorted(by_name.items())
            if name != "cycle"
        },
    }
    if cycle_durs:
        report["cycle_ms"] = _dist(cycle_durs)
        # the budget table: each attributed stage's share of total cycle
        # wall time, residual as "other" — the row set sums to 100 by
        # construction, so a reader can trust the table is exhaustive
        cycle_total = float(np.sum(cycle_durs))
        attribution: dict[str, float] = {}
        accounted = 0.0
        for stage in ATTRIBUTION_STAGES:
            vals = by_name.get(stage)
            if not vals:
                continue
            pct = 100.0 * float(np.sum(vals)) / max(cycle_total, 1e-12)
            attribution[stage] = round(pct, 2)
            accounted += pct
        attribution["other"] = round(100.0 - accounted, 2)
        report["attribution_pct"] = attribution
    if seqs:
        report["seq"] = {
            "first": int(min(seqs)),
            "last": int(max(seqs)),
            "cycles_with_seq": cycles_with_seq,
        }
    return report


def load_report(path: str) -> dict:
    """A report for `spans diff`'s sides: a saved `spans report` JSON
    passes through; span directories / trace files build fresh."""
    if os.path.isfile(path):
        try:
            with open(path, encoding="utf-8") as f:
                data = json.load(f)
        except json.JSONDecodeError:
            return build_report(path)
        if isinstance(data, dict) and "stages" in data and "cycles" in data:
            return data
    return build_report(path)


def diff_reports(
    base: dict,
    cand: dict,
    *,
    threshold_pct: float = 25.0,
    min_ms: float = 0.05,
    stage_thresholds: dict | None = None,
) -> dict:
    """Per-stage p50 regression check: candidate vs baseline. A stage
    regresses when its p50 grew by MORE than min_ms (absolute floor —
    sub-tick jitter on micro-stages must not fail builds) AND by more
    than its relative threshold (stage_thresholds[stage], default
    threshold_pct; the whole-cycle row uses the "cycle" key). `clean`
    is the gate: the CLI exits non-zero when it is False."""
    stage_thresholds = stage_thresholds or {}
    rows = []
    regressions = []

    def compare(stage: str, b_p50: float, c_p50: float) -> None:
        thr = float(stage_thresholds.get(stage, threshold_pct))
        delta = c_p50 - b_p50
        pct = 100.0 * delta / b_p50 if b_p50 > 0 else (
            float("inf") if delta > 0 else 0.0
        )
        bad = delta > min_ms and pct > thr
        rows.append(
            {
                "stage": stage,
                "base_p50_ms": b_p50,
                "cand_p50_ms": c_p50,
                "delta_ms": round(delta, 4),
                "delta_pct": round(pct, 2) if pct != float("inf") else None,
                "threshold_pct": thr,
                "regression": bad,
            }
        )
        if bad:
            regressions.append(stage)

    if base.get("cycle_ms") and cand.get("cycle_ms"):
        compare(
            "cycle", base["cycle_ms"]["p50_ms"], cand["cycle_ms"]["p50_ms"]
        )
    missing = []
    for stage, b in sorted(base.get("stages", {}).items()):
        c = cand.get("stages", {}).get(stage)
        if c is None or not c.get("count"):
            # absent stages are a CONTRACT question (span-hygiene lint,
            # SHIPPED_SPANS), not a latency regression — surfaced, never
            # silently ignored, but they do not fail the perf gate
            missing.append(stage)
            continue
        compare(stage, b["p50_ms"], c["p50_ms"])
    # stages only the CANDIDATE has (e.g. delta_derive appearing when
    # the resident variant is the candidate): no baseline to diff
    # against, but a new cost center must be visible in the report —
    # its weight shows in the candidate's attribution table
    new_stages = sorted(
        stage
        for stage, c in cand.get("stages", {}).items()
        if c.get("count") and stage not in base.get("stages", {})
    )
    return {
        "baseline": base.get("source"),
        "candidate": cand.get("source"),
        "baseline_cycles": base.get("cycles", 0),
        "candidate_cycles": cand.get("cycles", 0),
        "threshold_pct": threshold_pct,
        "min_ms": min_ms,
        "compared": rows,
        "missing_stages": missing,
        "new_stages": new_stages,
        "regressions": regressions,
        "clean": not regressions,
    }


def perturb_spans(
    src: str, dst: str, *, stage: str = "engine_step", factor: float = 2.0
) -> int:
    """Copy span directory `src` to `dst` with every `stage` span's
    duration scaled by `factor`, and the owning cycle span stretched by
    the added time (so the perturbed directory stays self-consistent).
    This is the smoke/test harness for the diff gate — "a synthetically
    slowed stage trips the threshold" — NOT a production tool. Returns
    the number of events perturbed."""
    os.makedirs(dst, exist_ok=True)
    touched = 0
    for i, fp in enumerate(span_files(src)):
        events = read_span_file(fp)
        added: dict = {}  # trace_id -> extra us from slowed stages
        for ev in events:
            if ev.get("ph") != "X" or ev.get("name") != stage:
                continue
            extra = float(ev.get("dur", 0.0)) * (factor - 1.0)
            ev["dur"] = float(ev.get("dur", 0.0)) * factor
            tid = (ev.get("args") or {}).get("trace_id")
            if tid is not None:
                added[tid] = added.get(tid, 0.0) + extra
            touched += 1
        for ev in events:
            if ev.get("ph") != "X" or ev.get("name") != "cycle":
                continue
            tid = (ev.get("args") or {}).get("trace_id")
            if tid in added:
                ev["dur"] = float(ev.get("dur", 0.0)) + added[tid]
        out = os.path.join(dst, "spans-%08d.trace.json" % i)
        with open(out, "w", encoding="utf-8") as f:
            f.write("[\n")
            for ev in events:
                f.write(json.dumps(ev, separators=(",", ":")) + ",\n")
    return touched
