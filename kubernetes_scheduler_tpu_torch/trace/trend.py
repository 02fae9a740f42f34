"""Soak-length trend and leak detection: windowed regression slopes
over span series and journal metrics, with CI-able exit codes.

A pairwise `spans diff` answers "is the candidate slower than the
baseline"; a soak run asks a different question — "is ANYTHING slowly
getting worse": p99 creep from a resident-state leak, delta hit-rate
decay from layout churn accumulating, queue depth ratcheting because
drain never quite catches arrivals. One threshold comparison cannot see
those; a monotone slope over a windowed series can.

The gate: a series regresses when its least-squares slope points the
wrong way, the end-to-end rise clears the absolute floor (the `spans
diff --min-ms` floor reused — sub-tick jitter must not fail builds) AND
the relative threshold, and the movement is MONOTONE enough
(`monotone_frac` of consecutive deltas in the trend direction) — noise
is jagged, leaks are not. Everything here is engine/torch-free, like the
rest of the journal/span read tooling.

Three front ends share the gate:
- `trend_over_reports`: N `spans report` snapshots in time order
  (`spans diff --trend base cand more...`).
- `build_trend`: ONE span source split into equal-time windows
  (`spans report --trend` — the soak gate).
- `journal_trend`: leak signals straight from a journal's per-cycle
  metrics (`trace trend`): delta hit-rate decay, cycle p99 creep,
  queue-depth runaway, resident-state byte growth.
"""

from __future__ import annotations

import json
import os

import numpy as np

from kubernetes_scheduler_tpu_torch.trace.analyze import (
    AnalyzeError,
    _dist,
    _load_events,
)

TREND_METRICS = ("p50_ms", "p99_ms")


class TrendError(RuntimeError):
    """Unusable trend input (too few points/windows to fit a slope)."""


def _fit(values: list[float]) -> dict:
    """Least-squares slope per step plus the monotonicity of the raw
    series (fraction of consecutive deltas that do not move against
    the fitted direction)."""
    v = np.asarray(values, dtype=float)
    n = v.shape[0]
    x = np.arange(n, dtype=float)
    slope = float(np.polyfit(x, v, 1)[0]) if n >= 2 else 0.0
    deltas = np.diff(v)
    if deltas.size and slope != 0.0:
        agree = (deltas >= 0) if slope > 0 else (deltas <= 0)
        monotone = float(agree.mean())
    else:
        monotone = 0.0
    return {
        "slope": round(slope, 6),
        "rise": round(float(v[-1] - v[0]), 4) if n else 0.0,
        "monotone_frac": round(monotone, 4),
    }


def gate_series(
    name: str,
    values: list[float],
    *,
    direction: str = "up",
    min_abs: float = 0.05,
    threshold_pct: float = 25.0,
    monotone_frac: float = 0.6,
    min_points: int = 3,
) -> dict:
    """One series through the regression gate. direction="up" flags
    growth (latency creep, queue runaway, byte leaks); "down" flags
    decay (delta hit-rate). Returns the row; `regression` is the CI
    bit."""
    row: dict = {
        "series": name,
        "direction": direction,
        "points": len(values),
        "values": [round(float(v), 4) for v in values],
        "regression": False,
    }
    if len(values) < min_points:
        row["reason"] = f"too few points (<{min_points})"
        return row
    fit = _fit(values)
    row.update(fit)
    sign = 1.0 if direction == "up" else -1.0
    move = sign * fit["rise"]
    base = abs(values[0])
    pct = 100.0 * move / base if base > 0 else (
        float("inf") if move > 0 else 0.0
    )
    row["rise_pct"] = round(pct, 2) if pct != float("inf") else None
    row["regression"] = bool(
        sign * fit["slope"] > 0
        and move > min_abs
        and pct > threshold_pct
        and fit["monotone_frac"] >= monotone_frac
    )
    return row


def trend_over_reports(
    reports: list[dict],
    *,
    metrics: tuple = TREND_METRICS,
    threshold_pct: float = 25.0,
    min_ms: float = 0.05,
    monotone_frac: float = 0.6,
) -> dict:
    """Monotone-slope gate over N report snapshots in time order: every
    stage's p50/p99 series, plus the whole-cycle series. A stage absent
    from some snapshots is skipped (a contract question for the
    span-hygiene lint, not a latency trend)."""
    if len(reports) < 3:
        raise TrendError(
            f"trend needs >= 3 report snapshots in time order, got "
            f"{len(reports)}"
        )
    rows: list[dict] = []
    stage_names = sorted(
        set().union(*(r.get("stages", {}).keys() for r in reports))
    )
    for metric in metrics:
        # a per-window p99 is estimated from few samples and behaves
        # like a max — give the tail series a 10x wider absolute floor
        # so micro-stage jitter cannot fail a soak
        floor = min_ms * (10.0 if metric == "p99_ms" else 1.0)
        if all(r.get("cycle_ms") for r in reports):
            rows.append(
                gate_series(
                    f"cycle.{metric}",
                    [r["cycle_ms"][metric] for r in reports],
                    min_abs=floor,
                    threshold_pct=threshold_pct,
                    monotone_frac=monotone_frac,
                )
            )
        for stage in stage_names:
            dists = [r.get("stages", {}).get(stage) for r in reports]
            if any(d is None or not d.get("count") for d in dists):
                continue
            rows.append(
                gate_series(
                    f"{stage}.{metric}",
                    [d[metric] for d in dists],
                    min_abs=floor,
                    threshold_pct=threshold_pct,
                    monotone_frac=monotone_frac,
                )
            )
    regressions = [r["series"] for r in rows if r["regression"]]
    return {
        "points": len(reports),
        "threshold_pct": threshold_pct,
        "min_ms": min_ms,
        "monotone_frac": monotone_frac,
        "rows": rows,
        "regressions": regressions,
        "clean": not regressions,
    }


def _window_reports(events: list[dict], windows: int) -> list[dict]:
    """Split one span stream into `windows` time-ordered, equal-
    POPULATION slices (quantile edges over event start ts) and build a
    per-slice stage/cycle distribution table — the report shape
    trend_over_reports expects. Equal-population beats equal-duration
    here: a smoke-scale soak's wall clock is dominated by compile
    pauses, which would leave most equal-duration windows empty and
    the survivors unevenly filled."""
    complete = [ev for ev in events if ev.get("ph") == "X"]
    if not complete:
        raise AnalyzeError("span source holds no complete spans")
    ts = np.asarray([float(ev.get("ts", 0.0)) for ev in complete])
    t0, t1 = float(ts.min()), float(ts.max())
    if t1 <= t0:
        raise TrendError(
            "span source covers a single instant — cannot window a trend"
        )
    edges = np.quantile(ts, np.linspace(0.0, 1.0, windows + 1))
    out = []
    for w in range(windows):
        lo, hi = edges[w], edges[w + 1]
        sel = (ts >= lo) & ((ts < hi) | (w == windows - 1))
        by_name: dict[str, list[float]] = {}
        for ev in (complete[i] for i in np.flatnonzero(sel)):
            by_name.setdefault(ev.get("name", "?"), []).append(
                float(ev.get("dur", 0.0)) / 1e3
            )
        cyc = by_name.get("cycle", [])
        rep: dict = {
            "cycles": len(cyc),
            "stages": {
                n: _dist(v) for n, v in by_name.items() if n != "cycle"
            },
        }
        if cyc:
            rep["cycle_ms"] = _dist(cyc)
        out.append(rep)
    return out


def build_trend(
    source: str,
    *,
    windows: int = 8,
    warmup: int = 1,
    threshold_pct: float = 25.0,
    min_ms: float = 0.05,
    monotone_frac: float = 0.6,
) -> dict:
    """The soak gate: one span directory/trace, windowed in time,
    through the monotone-slope trend. A window with no samples for a
    stage drops that stage's series (short soaks), never errors.

    The first `warmup` non-empty windows are excluded when enough
    points remain: the opening slice carries one-time costs (kernel
    builds, cold caches) orders of magnitude above steady state,
    which would mask any genuine upward drift behind a huge falling
    first step."""
    events, _ = _load_events(source)
    reports = _window_reports(events, windows)
    # windows with no cycles at all (a paused soak) would poison every
    # series with zeros; keep only windows that saw work
    reports = [r for r in reports if r["cycles"] or r["stages"]]
    dropped = min(max(warmup, 0), max(len(reports) - 3, 0))
    reports = reports[dropped:]
    if len(reports) < 3:
        raise TrendError(
            f"{source}: fewer than 3 non-empty windows — soak too short "
            "for a trend"
        )
    out = trend_over_reports(
        reports,
        threshold_pct=threshold_pct,
        min_ms=min_ms,
        monotone_frac=monotone_frac,
    )
    out["source"] = source
    out["windows"] = windows
    out["warmup_windows_dropped"] = dropped
    return out


def journal_trend(
    path: str,
    *,
    windows: int = 6,
    threshold_pct: float = 25.0,
    min_ms: float = 0.05,
    monotone_frac: float = 0.6,
) -> dict:
    """Leak signals straight from the journal's per-cycle metrics,
    windowed by record order:

    - delta_hit_ratio (DOWN gate): delta/(delta+full) uploads decaying
      means resident-state churn is accumulating.
    - cycle_p99_ms (UP gate): end-to-end latency creep.
    - queue_depth_mean (UP gate): pods_in per cycle ratcheting — drain
      never catching arrivals.
    - state_bytes_mean (UP gate): mean snapshot/delta tensor payload
      growing — the resident-state memory-leak proxy.
    """
    from kubernetes_scheduler_tpu_torch.trace.recorder import read_journal

    recs = [r for r in read_journal(path) if r.get("metrics")]
    if len(recs) < windows * 2:
        raise TrendError(
            f"{path}: {len(recs)} records for {windows} windows — journal "
            "too short for a trend"
        )
    slices = np.array_split(np.arange(len(recs)), windows)
    delta_hit, p99, depth, nbytes = [], [], [], []
    for sl in slices:
        ms, du, fu, pods, sizes = [], 0, 0, [], []
        for i in sl:
            m = recs[i].get("metrics") or {}
            ms.append(float(m.get("cycle_seconds", 0.0)) * 1e3)
            du += int(m.get("delta_uploads", 0))
            fu += int(m.get("full_uploads", 0))
            pods.append(float(m.get("pods_in", 0)))
            for key in ("snapshot", "delta"):
                t = recs[i].get(key)
                if t:
                    sizes.append(
                        float(sum(np.asarray(a).nbytes for a in t.values()))
                    )
        if du + fu:
            delta_hit.append(du / (du + fu))
        p99.append(float(np.percentile(ms, 99)) if ms else 0.0)
        depth.append(float(np.mean(pods)) if pods else 0.0)
        nbytes.append(float(np.mean(sizes)) if sizes else 0.0)
    rows = [
        gate_series(
            "cycle_p99_ms", p99, min_abs=min_ms,
            threshold_pct=threshold_pct, monotone_frac=monotone_frac,
        ),
        gate_series(
            "queue_depth_mean", depth, min_abs=1.0,
            threshold_pct=threshold_pct, monotone_frac=monotone_frac,
        ),
        gate_series(
            "state_bytes_mean", nbytes, min_abs=1024.0,
            threshold_pct=threshold_pct, monotone_frac=monotone_frac,
        ),
    ]
    if len(delta_hit) >= 3:
        rows.append(
            gate_series(
                "delta_hit_ratio", delta_hit, direction="down",
                min_abs=0.05, threshold_pct=threshold_pct,
                monotone_frac=monotone_frac,
            )
        )
    regressions = [r["series"] for r in rows if r["regression"]]
    return {
        "source": path,
        "windows": windows,
        "records": len(recs),
        "rows": rows,
        "regressions": regressions,
        "clean": not regressions,
    }


def perturb_trend(
    src: str, dst: str, *, stage: str = "engine_step", factor: float = 3.0
) -> int:
    """Copy span directory `src` to `dst` with `stage` durations grown
    by a LINEAR DRIFT from +0 (earliest event) to +(factor-1)x the
    stage's median duration (latest) — the seeded-leak harness for the
    trend gate, the way perturb_spans seeds the pairwise diff gate.
    The drift is additive and linear in POPULATION RANK (the event's
    position in the ts-sorted stage stream), not multiplicative or
    wall-clock: the gate windows by equal population, a wall-clock ramp
    collapses to a flat step when one kernel build eats most of the
    run's duration, and multiplying a noisy baseline (a mid-run
    recompile hump) yields a non-monotone product the gate rightly
    rejects. Owning cycle spans stretch by the added time so the
    directory stays self-consistent. Returns events perturbed."""
    from kubernetes_scheduler_tpu_torch.trace.spans import (
        read_span_file,
        span_files,
    )

    files = span_files(src)
    if not files:
        raise AnalyzeError(f"{src}: no span files (spans-*.trace.json)")
    per_file = [read_span_file(fp) for fp in files]
    hits = sorted(
        (float(ev.get("ts", 0.0)), float(ev.get("dur", 0.0)))
        for events in per_file
        for ev in events
        if ev.get("ph") == "X" and ev.get("name") == stage
    )
    if not hits:
        raise AnalyzeError(f"{src}: no {stage!r} spans to perturb")
    rank = {ts: j for j, (ts, _) in enumerate(hits)}
    denom = max(len(hits) - 1, 1)
    base = sorted(d for _, d in hits)[len(hits) // 2]
    os.makedirs(dst, exist_ok=True)
    touched = 0
    for i, events in enumerate(per_file):
        added: dict = {}
        for ev in events:
            if ev.get("ph") != "X" or ev.get("name") != stage:
                continue
            frac = rank[float(ev.get("ts", 0.0))] / denom
            extra = base * (factor - 1.0) * frac
            ev["dur"] = float(ev.get("dur", 0.0)) + extra
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
