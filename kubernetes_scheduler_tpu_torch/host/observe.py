"""Observability: metrics export, per-cycle spans, device profiling (the
port's copy of kubernetes_scheduler_tpu/host/observe.py, with
`profile_device_step` on torch.profiler).

The reference *consumes* metrics but exports none — its own metrics
endpoint is disabled (MetricsBindAddress: "", scheduler.go:64) and its
only introspection is leveled klog spam (SURVEY.md §5). This module
provides what that design was missing, around the north-star numbers in
BASELINE.json:

- `render_prometheus` / `MetricsExporter`: scheduling throughput, bind
  latency p50/p99, batch sizes, engine (device) step time, fallback
  count, in Prometheus text exposition format on /metrics — so the same
  Prometheus the advisor scrapes from can scrape the scheduler back.
- `Histogram`/`Counter`/`Gauge`: real labeled Prometheus series beside
  the legacy window-quantile gauges (`path=serial|pipelined|fallback`,
  `upload=delta|full`, `rpc=schedule_batch|...`).
- `SpanRecorder`: per-cycle structured spans with a monotonically-
  assigned trace id, emitted as Chrome-trace-event JSON to a rotating,
  disk-budgeted directory (trace/spans.py).
- `profile_device_step`: wraps one engine call in a torch.profiler trace
  (kernels, memcpys and host ops on one timeline) — armed on demand
  through /debug/profile?cycles=N.

Metric-name contract: every exported name carries a HELP entry, ends in
a unit (or `_total`) suffix, and is pinned in SHIPPED_METRICS —
dashboards and alerts reference metrics by name, so a shipped name is
never removed.
"""

from __future__ import annotations

import bisect
import contextlib
import http.server
import json
import logging
import os
import threading
import time

log = logging.getLogger("yoda_tpu.observe")

PREFIX = "yoda_tpu"


def _quantile(sorted_vals: list[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    i = min(int(q * (len(sorted_vals) - 1) + 0.5), len(sorted_vals) - 1)
    return sorted_vals[i]


def summarize(metrics, totals: dict | None = None) -> dict:
    """Aggregate host.scheduler.CycleMetrics.

    `totals` (Scheduler.totals) supplies the monotonic run counters when
    given; the metrics window is a bounded deque, so summing it would
    make the *_total Prometheus counters decrease after eviction (every
    decrease reads as a counter reset to rate()/increase()). Quantiles
    and rates always come from the recent window — that is what a
    latency percentile should mean on a long-lived process anyway."""
    cycles = [m for m in metrics if m.pods_in > 0]
    lat = sorted(m.cycle_seconds for m in cycles)
    eng = sorted(m.engine_seconds for m in cycles if m.engine_seconds > 0)
    total_s = sum(lat)
    bound = sum(m.pods_bound for m in cycles)
    if totals is None:
        totals = {
            "cycles": len(cycles),
            "pods_bound": bound,
            "pods_unschedulable": sum(m.pods_unschedulable for m in cycles),
            "pods_dropped": sum(m.pods_dropped for m in cycles),
            "pods_preempted": sum(
                getattr(m, "pods_preempted", 0) for m in cycles
            ),
            "victims_evicted": sum(
                getattr(m, "victims_evicted", 0) for m in cycles
            ),
            "fallback_cycles": sum(1 for m in cycles if m.used_fallback),
            "fetch_failures": sum(
                1 for m in cycles if getattr(m, "fetch_failed", False)
            ),
            "fallback_policy_mismatch": sum(
                1 for m in cycles if getattr(m, "policy_mismatch", False)
            ),
            "pipeline_flushes": sum(
                getattr(m, "pipeline_flushes", 0) for m in cycles
            ),
            "host_overlap_seconds": sum(
                getattr(m, "host_overlap_seconds", 0.0) for m in cycles
            ),
            "delta_uploads": sum(
                getattr(m, "delta_uploads", 0) for m in cycles
            ),
            "full_uploads": sum(
                getattr(m, "full_uploads", 0) for m in cycles
            ),
            "delta_bytes_saved": sum(
                getattr(m, "delta_bytes_saved", 0) for m in cycles
            ),
            "sharded_cycles": sum(
                getattr(m, "sharded_cycles", 0) for m in cycles
            ),
            "shard_delta_bytes": sum(
                sum(getattr(m, "shard_delta_bytes", ()) or ())
                for m in cycles
            ),
            "gangs_admitted": sum(
                getattr(m, "gangs_admitted", 0) for m in cycles
            ),
            "gangs_deferred": sum(
                getattr(m, "gangs_deferred", 0) for m in cycles
            ),
            "gang_pods_masked": sum(
                getattr(m, "gang_pods_masked", 0) for m in cycles
            ),
            "advisor_stale_cycles": sum(
                1 for m in cycles if getattr(m, "advisor_stale", False)
            ),
            "degraded_cycles": sum(
                1 for m in cycles if getattr(m, "degraded", ())
            ),
        }
    return {
        "cycles_total": totals["cycles"],
        "pods_bound_total": totals["pods_bound"],
        "pods_unschedulable_total": totals["pods_unschedulable"],
        "pods_dropped_total": totals.get("pods_dropped", 0),
        "pods_preempted_total": totals.get("pods_preempted", 0),
        "victims_evicted_total": totals.get("victims_evicted", 0),
        "fallback_cycles_total": totals["fallback_cycles"],
        "fetch_failures_total": totals.get("fetch_failures", 0),
        "fallback_policy_mismatch_total": totals.get(
            "fallback_policy_mismatch", 0
        ),
        # pipelined loop (config.pipeline_depth): flush count is the
        # hazard-rate signal (speculative state discarded for informer
        # churn / engine failure / non-device cycles); overlap seconds
        # is the host work hidden under in-flight engine calls — the
        # win the pipeline exists for, observable in production
        "pipeline_flushes_total": totals.get("pipeline_flushes", 0),
        "host_overlap_seconds_total": totals.get("host_overlap_seconds", 0.0),
        # resident cluster state (config.resident_state): delta vs full
        # uploads and the payload bytes the deltas avoided shipping —
        # the delta hit rate IS the steady-state health signal (full
        # uploads after warmup mean layout churn or engine flapping)
        "delta_uploads_total": totals.get("delta_uploads", 0),
        "full_uploads_total": totals.get("full_uploads", 0),
        "delta_bytes_saved_total": totals.get("delta_bytes_saved", 0),
        # mesh-sharded engine (config.sharded_engine): device cycles
        # served shard-local across the mesh — the per-shard routed
        # byte split rides the {shard}-labeled shard_delta_bytes_total
        # counter (Scheduler.ctr_shard_bytes) beside this aggregate
        "sharded_cycles_total": totals.get("sharded_cycles", 0),
        # gang co-scheduling (config.gang_scheduling; ops/gang.py):
        # all-or-nothing admissions, unit deferrals, and the tentative
        # placements the rule rescinded — deferred/admitted is the
        # gang-health ratio, masked is the capacity the rule protected
        "gangs_admitted_total": totals.get("gangs_admitted", 0),
        "gangs_deferred_total": totals.get("gangs_deferred", 0),
        "gang_pods_masked_total": totals.get("gang_pods_masked", 0),
        # resilience layer (host/resilience.py): cycles served the
        # last-good utilization snapshot under the advisor stale-TTL
        # grace mode, and cycles that ran with ANY degradation-ladder
        # subsystem below its top rung — the composed-degradation
        # health signal chaos runs assert bounds on
        "advisor_stale_cycles_total": totals.get("advisor_stale_cycles", 0),
        "degraded_cycles_total": totals.get("degraded_cycles", 0),
        "scheduling_pods_per_sec": bound / total_s if total_s > 0 else 0.0,
        "bind_latency_p50_seconds": _quantile(lat, 0.50),
        "bind_latency_p99_seconds": _quantile(lat, 0.99),
        "engine_step_p50_seconds": _quantile(eng, 0.50),
        "engine_step_p99_seconds": _quantile(eng, 0.99),
        "batch_size_mean": (sum(m.pods_in for m in cycles) / len(cycles))
        if cycles
        else 0.0,
    }


_HELP = {
    "cycles_total": "Scheduling cycles with at least one pending pod",
    "pods_bound_total": "Pods bound to nodes",
    "pods_unschedulable_total": "Pod placements rejected (requeued with backoff)",
    "pods_dropped_total": "Pods forgotten after a bind-time lifecycle race (404/409)",
    "pods_preempted_total": "Unschedulable pods that triggered a preemption (PostFilter)",
    "victims_evicted_total": "Running pods evicted to make room for preemptors",
    "fallback_cycles_total": "Cycles served by the scalar fallback path",
    "fetch_failures_total": "Cycles aborted by a cluster-source/advisor fetch failure (window requeued)",
    "fallback_policy_mismatch_total": "Fallback cycles scored with the yoda formula because config.policy has no scalar mirror",
    "pipeline_flushes_total": "Speculative pipeline state discarded (informer/layout churn, engine failure, non-device cycle)",
    "host_overlap_seconds_total": "Host work overlapped with in-flight engine calls (pipelined loop)",
    "delta_uploads_total": "Resident-state cycles served by a SnapshotDelta applied on the engine",
    "full_uploads_total": "Resident-state cycles that shipped the full snapshot (first upload, churn, or flush)",
    "delta_bytes_saved_total": "Snapshot payload bytes delta uploads avoided shipping to the engine",
    "sharded_cycles_total": "Device cycles served by the mesh-sharded engine (config.sharded_engine)",
    "gangs_admitted_total": "Gangs whose every member bound in one cycle (all-or-nothing admission)",
    "gangs_deferred_total": "Gangs requeued as a unit (members missing, partial device fit, or a scalar-fallback cycle)",
    "gang_pods_masked_total": "Tentative placements rescinded by the gang all-or-nothing rule",
    "scheduling_pods_per_sec": "Bound pods per second of cycle time",
    "bind_latency_p50_seconds": "Median end-to-end cycle latency",
    "bind_latency_p99_seconds": "p99 end-to-end cycle latency",
    "engine_step_p50_seconds": "Median device (engine) step time",
    "engine_step_p99_seconds": "p99 device (engine) step time",
    "batch_size_mean": "Mean pods per scheduling window",
    "advisor_stale_served_total": (
        "Cycles served a utilization snapshot older than twice the "
        "advisor refresh interval (BackgroundAdvisor brown-out signal)"
    ),
    # cycle flight recorder (config.trace_path; trace/recorder.py)
    "cycles_recorded_total": "Scheduling cycles journaled by the flight recorder",
    "trace_bytes_total": "Journal bytes written by the flight recorder",
    "trace_records_dropped_total": (
        "Cycle records the flight recorder failed to journal "
        "(encode/IO error — the scheduling loop never pays for these)"
    ),
    # per-cycle span telemetry (config.span_path; trace/spans.py)
    "spans_written_total": "Span events written to the Chrome-trace files",
    "span_bytes_total": "Bytes written to the Chrome-trace span files",
    "spans_dropped_total": (
        "Cycle span sets the recorder failed to encode/write "
        "(the scheduling loop never pays for these)"
    ),
    # resilience layer (host/resilience.py; sim/faults.py chaos runs)
    "advisor_stale_cycles_total": (
        "Cycles served the last-good utilization snapshot under the "
        "advisor stale-TTL grace mode (config.advisor_stale_ttl_s)"
    ),
    "degraded_cycles_total": (
        "Cycles that ran with any degradation-ladder subsystem below "
        "its top rung"
    ),
}


# every metric name this process has EVER exported, pinned: dashboards
# and alerts reference metrics by name, so a shipped name is never
# removed; the reference's metric-hygiene lint checks its own copy of
# this registry against the declared surfaces both ways.
SHIPPED_METRICS = (
    "cycles_total",
    "pods_bound_total",
    "pods_unschedulable_total",
    "pods_dropped_total",
    "pods_preempted_total",
    "victims_evicted_total",
    "fallback_cycles_total",
    "fetch_failures_total",
    "fallback_policy_mismatch_total",
    "pipeline_flushes_total",
    "host_overlap_seconds_total",
    "delta_uploads_total",
    "full_uploads_total",
    "delta_bytes_saved_total",
    "sharded_cycles_total",
    "gangs_admitted_total",
    "gangs_deferred_total",
    "gang_pods_masked_total",
    "scheduling_pods_per_sec",
    "bind_latency_p50_seconds",
    "bind_latency_p99_seconds",
    "engine_step_p50_seconds",
    "engine_step_p99_seconds",
    "batch_size_mean",
    "advisor_stale_served_total",
    "cycles_recorded_total",
    "trace_bytes_total",
    "trace_records_dropped_total",
    "spans_written_total",
    "span_bytes_total",
    "spans_dropped_total",
    # labeled histogram layer (host, fed by Scheduler._record)
    "cycle_duration_seconds",
    "engine_step_duration_seconds",
    "snapshot_uploads_total",
    # streaming state ingestion (host/mirror.SnapshotMirror): events
    # applied by kind, flush-to-full rebuilds labeled by flush cause
    # (`reason`: seed / node-churn / selector-drift / layout-drift /
    # port-churn / verify-mismatch), and verification mismatches (the
    # mirror<->rebuild bitwise cross-check)
    "events_applied_total",
    "mirror_full_rebuilds_total",
    "mirror_verify_failures_total",
    # layout drifts absorbed in place (selector column fill / hostPort
    # remap) instead of flushing to a full rebuild
    "mirror_incremental_extensions_total",
    # mesh-sharded resident engine: routed delta payload per owning
    # shard (host labels shard index; the sharded sidecar's twin does
    # too)
    "shard_delta_bytes_total",
    # SLO watchdog (config.cycle_slo_ms; host labels by loop path,
    # the sidecar's own breach counter labels by rpc)
    "slo_breaches_total",
    # resilience layer (host/resilience.py): stale-grace cycle counts,
    # composed-degradation cycle counts, the per-subsystem ladder rung
    # gauge, circuit-breaker state transitions (labeled by breaker +
    # state entered), and the bridge client's health-probe failure
    # split (transport-down vs deadline-exceeded)
    "advisor_stale_cycles_total",
    "degraded_cycles_total",
    "degradation_rung",
    "breaker_transitions_total",
    "engine_health_failures_total",
    # sidecar exporter (bridge/server.EngineService)
    "device_step_duration_seconds",
    "rpcs_served_total",
    "resident_applies_total",
    "resident_sessions_count",
    # replicated fleet (host/replica.py): CAS wins per replica and
    # cross-replica conflicts resolved first-bind-wins (each one is a
    # loser requeued through restore_window, never a lost pod)
    "replica_binds_total",
    "bind_conflicts_total",
    # fleet-shared device engine (host/engine_pool.SharedEnginePool):
    # device dispatches that carried >= 2 replicas' windows in one
    # coalesced super-batch, windows per dispatch, and snapshot uploads
    # by kind (`upload`: full = base resync, delta = changed rows once
    # per fleet, dedup = zero-row epoch advance)
    "coalesced_dispatches_total",
    "coalesce_batch_window_count",
    "shared_engine_uploads_total",
    # shadow-mode serving (host/shadow.py): the candidate exporter's
    # decision/latency-diff series — journal records tailed and scored
    # (cycles labeled by `result`: scored / skipped / unanchored /
    # breaker_open / error), binding divergence vs the recorded primary,
    # gang admission flips, candidate wall-time vs recorded engine time,
    # tail-follow health (rotations followed, torn-tail recoveries),
    # and how far behind the live writer the shadow is running
    "shadow_records_applied_total",
    "shadow_cycles_total",
    "shadow_bindings_changed_total",
    "shadow_pods_compared_total",
    "shadow_gangs_diverged_total",
    "shadow_candidate_errors_total",
    "shadow_breaker_skips_total",
    "shadow_rotations_followed_total",
    "shadow_tail_recoveries_total",
    "shadow_divergence_ratio",
    "shadow_latency_ratio",
    "shadow_score_delta_mean",
    "shadow_lag_seconds",
    "shadow_candidate_step_duration_seconds",
)


def render_prometheus(
    metrics, totals: dict | None = None, extra: dict | None = None
) -> str:
    rows = summarize(metrics, totals)
    if extra:
        rows = {**rows, **extra}
    out = []
    for key, value in rows.items():
        name = f"{PREFIX}_{key}"
        kind = "counter" if key.endswith("_total") else "gauge"
        # an extra key without a registered HELP entry still renders (an
        # empty HELP line) — a metrics endpoint must never 500 over one
        # undocumented sample (the KeyError regression)
        out.append(f"# HELP {name} {_HELP.get(key, '')}".rstrip())
        out.append(f"# TYPE {name} {kind}")
        out.append(f"{name} {value}")
    return "\n".join(out) + "\n"


# ---- labeled Prometheus series (histograms / counters / gauges) -----------

# sub-second-to-seconds ladder covering everything from a colocated
# sidecar's ~1ms device step to a tunneled dev chip's multi-second tail
DURATION_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0,
)


def _fmt_labels(names: tuple, values: tuple, extra: str = "") -> str:
    parts = [
        '%s="%s"' % (n, str(v).replace("\\", "\\\\").replace('"', '\\"'))
        for n, v in zip(names, values)
    ]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


class Histogram:
    """Thread-safe labeled Prometheus histogram (cumulative buckets in
    the exposition, per-bucket counts internally). Appends/observes come
    from the scheduling (or RPC worker) thread while /metrics scrapes
    render concurrently — every touch of the series map holds the
    lock."""

    def __init__(
        self,
        name: str,
        help: str,
        *,
        labels: tuple = (),
        buckets: tuple = DURATION_BUCKETS,
    ):
        self.name = name
        self.help = help
        self.labels = tuple(labels)
        self.buckets = tuple(sorted(buckets))
        self._lock = threading.Lock()
        # label values -> [per-bucket counts..., +Inf count], sum
        self._series: dict[tuple, list] = {}

    def observe(self, value: float, **labels) -> None:
        key = tuple(str(labels[name]) for name in self.labels)
        i = bisect.bisect_left(self.buckets, value)
        with self._lock:
            s = self._series.get(key)
            if s is None:
                s = [[0] * (len(self.buckets) + 1), 0.0]
                self._series[key] = s
            s[0][i] += 1
            s[1] += value

    def render(self, prefix: str = PREFIX) -> list[str]:
        name = f"{prefix}_{self.name}"
        out = [f"# HELP {name} {self.help}", f"# TYPE {name} histogram"]
        with self._lock:
            series = {k: (list(v[0]), v[1]) for k, v in self._series.items()}
        for key in sorted(series):
            counts, total = series[key]
            running = 0
            for bound, c in zip(self.buckets, counts):
                running += c
                lbl = _fmt_labels(self.labels, key, 'le="%g"' % bound)
                out.append(f"{name}_bucket{lbl} {running}")
            running += counts[-1]
            lbl = _fmt_labels(self.labels, key, 'le="+Inf"')
            out.append(f"{name}_bucket{lbl} {running}")
            plain = _fmt_labels(self.labels, key)
            out.append(f"{name}_sum{plain} {total}")
            out.append(f"{name}_count{plain} {running}")
        return out


class Counter:
    """Thread-safe labeled monotonic counter (name must end `_total`)."""

    def __init__(self, name: str, help: str, *, labels: tuple = ()):
        self.name = name
        self.help = help
        self.labels = tuple(labels)
        self._lock = threading.Lock()
        self._series: dict[tuple, float] = {}

    def inc(self, n: float = 1, **labels) -> None:
        key = tuple(str(labels[name]) for name in self.labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0) + n

    def value(self, **labels) -> float:
        """Current count for one label tuple (label-free counters:
        value()) — the public read surface for summaries and tests, so
        nothing couples to the internal series layout."""
        key = tuple(str(labels[name]) for name in self.labels)
        with self._lock:
            return self._series.get(key, 0)

    def total(self) -> float:
        """Sum across every label tuple — what the label-free ancestor
        of a counter reported before it grew labels (the bench rows sum
        `mirror_full_rebuilds_total` over its `reason` breakdown)."""
        with self._lock:
            return sum(self._series.values())

    def breakdown(self) -> dict:
        """label-values tuple -> count snapshot (single-label counters:
        {("seed",): 1, ...}); for bench rows and tests that assert the
        per-reason split without reaching into `_series`."""
        with self._lock:
            return dict(self._series)

    def render(self, prefix: str = PREFIX) -> list[str]:
        name = f"{prefix}_{self.name}"
        out = [f"# HELP {name} {self.help}", f"# TYPE {name} counter"]
        with self._lock:
            series = dict(self._series)
        for key in sorted(series):
            out.append(
                f"{name}{_fmt_labels(self.labels, key)} {series[key]}"
            )
        return out


class Gauge:
    """Set-at-render scalar sample (the sidecar sets it from live state
    inside its render callback). With `labels`, one sample per label
    tuple (the degradation ladder's `degradation_rung{subsystem}`
    surface); label-free construction keeps the legacy single-sample
    shape."""

    def __init__(self, name: str, help: str, *, labels: tuple = ()):
        self.name = name
        self.help = help
        self.labels = tuple(labels)
        # label values -> current sample; label-free gauges live under ()
        self._series: dict[tuple, float] = {(): 0.0} if not labels else {}
        self._lock = threading.Lock()

    def set(self, value: float, **labels) -> None:
        key = tuple(str(labels[name]) for name in self.labels)
        with self._lock:
            self._series[key] = value

    def render(self, prefix: str = PREFIX) -> list[str]:
        name = f"{prefix}_{self.name}"
        out = [f"# HELP {name} {self.help}", f"# TYPE {name} gauge"]
        with self._lock:
            series = dict(self._series)
        for key in sorted(series):
            out.append(
                f"{name}{_fmt_labels(self.labels, key)} {series[key]}"
            )
        return out


# ---- per-cycle spans (Chrome trace events, merged across the bridge) ------


# every span (stage) name this package has EVER emitted, pinned: span
# names are a CONTRACT now — `spans report`'s attribution tables,
# `spans diff`'s regression gate, and Perfetto bookmarks all reference
# stages by name, so a shipped name is never removed and a new stage is
# registered consciously. Every name here is the reference's
# (kubernetes_scheduler_tpu/host/observe.py), so span files of either
# package feed the same reports.
SHIPPED_SPANS = (
    # host cycle stages (host/scheduler.py, both loops)
    "queue_pop",
    "state_fetch",
    "snapshot_build",
    "delta_derive",
    # streaming ingestion (config.snapshot_mirror): advisor changed-node
    # drain applied as mirror events, and the mirror's O(events) emit —
    # the stage that REPLACES snapshot_build + delta_derive on the hot
    # path (those names survive for mirror-off runs and the ~0-cost
    # delta_derive evidence under the mirror)
    "event_apply",
    "mirror_emit",
    "engine_step",
    "bind",
    "recorder_write",
    "host_overlap",
    "scalar_cycle",
    "cycle",
    # sidecar RPC stages (bridge/server.py), joined on trace id
    "deserialize",
    "delta_apply",
    "device_step",
    "serialize",
    # post-hoc replay stages (trace/replay.py --spans)
    "reconstruct",
    # shadow-mode serving (host/shadow.py --spans): the candidate
    # engine's re-score of a tailed cycle and the decision-diff verdict
    # (bindings changed / gangs flipped vs the recorded primary)
    "candidate_step",
    "decision_diff",
)


class SpanSet:
    """One cycle's spans: (name, start, end, args) perf_counter pairs
    plus the cycle's trace id. Collection appends two floats per span —
    cheap enough for the dispatch path; Chrome-event encoding happens in
    SpanRecorder.flush, from the cycle's completion stage (the flight-
    recorder discipline: telemetry never costs the device dispatch)."""

    __slots__ = ("trace_id", "spans")

    def __init__(self, trace_id: int):
        self.trace_id = trace_id
        self.spans: list[tuple] = []

    def add(self, name: str, t0: float, t1: float, **args) -> None:
        self.spans.append((name, t0, t1, args))

    @contextlib.contextmanager
    def span(self, name: str, **args):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(name, t0, time.perf_counter(), **args)


class SpanRecorder:
    """Monotonic trace ids + Chrome-event encoding over the rotating
    span files (trace/spans.py).

    The host assigns ids (`begin()`); the sidecar opens its SpanSets
    under the id it received over gRPC metadata (`begin(trace_id=...)`),
    which is what makes `spans merge` able to join the two timelines.
    Timestamps are mapped to epoch microseconds through one wall/perf
    anchor pair taken at construction, so both processes share the wall
    clock domain without per-span time.time() calls."""

    def __init__(
        self,
        path: str,
        *,
        file_bytes: int = 32 << 20,
        max_bytes: int = 128 << 20,
        process: str = "host",
    ):
        from kubernetes_scheduler_tpu_torch.trace.spans import SpanWriter

        self._writer = SpanWriter(
            path,
            file_bytes=file_bytes,
            max_bytes=max_bytes,
            process_name=process,
        )
        self.path = path
        self.process = process
        self._wall0 = time.time()
        self._perf0 = time.perf_counter()
        self._next_id = 1
        self._id_lock = threading.Lock()
        self.spans_dropped = 0

    @property
    def spans_written(self) -> int:
        return self._writer.events_written

    @property
    def bytes_written(self) -> int:
        return self._writer.bytes_written

    def begin(self, trace_id: int | None = None) -> SpanSet:
        if trace_id is None:
            with self._id_lock:
                trace_id = self._next_id
                self._next_id += 1
        return SpanSet(trace_id)

    def _ts_us(self, t_perf: float) -> float:
        return (self._wall0 + (t_perf - self._perf0)) * 1e6

    def flush(self, ss: SpanSet, *, seq: int | None = None, tid: int = 0) -> None:
        """Encode and write one cycle's spans. Every event carries the
        trace id; `seq` cross-links the cycle to its flight-recorder
        record so a replayed cycle can be found in the timeline. Never
        raises into the scheduling loop — a failed write logs, counts,
        and drops the set."""
        try:
            events = []
            for name, t0, t1, args in ss.spans:
                a = {"trace_id": ss.trace_id}
                if seq is not None:
                    a["seq"] = seq
                if args:
                    a.update(args)
                events.append(
                    {
                        "name": name,
                        "ph": "X",
                        "cat": self.process,
                        "ts": round(self._ts_us(t0), 3),
                        "dur": round((t1 - t0) * 1e6, 3),
                        "pid": self._writer.pid,
                        "tid": tid,
                        "args": a,
                    }
                )
            self._writer.append(events)
        except Exception:
            log.exception("spans: cycle flush failed; dropping span set")
            # the sidecar's recorder is shared by concurrent RPC workers
            with self._id_lock:
                self.spans_dropped += 1

    def close(self) -> None:
        self._writer.close()


# ---- HTTP exporters -------------------------------------------------------


class HttpMetricsServer:
    """Minimal threaded HTTP exporter: /metrics from a render callable,
    /healthz, and (when armed with a profile callable) the on-demand
    /debug/profile?cycles=N endpoint. The host's MetricsExporter and
    the sidecar's exporter (bridge/server.py) are both this class with
    different render sources."""

    def __init__(self, render, *, profile=None):
        self._render = render      # () -> str (Prometheus exposition)
        self._profile = profile    # (cycles: int) -> dict, or None
        self._server: http.server.ThreadingHTTPServer | None = None

    def serve(self, port: int, host: str = "0.0.0.0") -> int:
        """Bind `host`:`port` (0 = ephemeral) and serve on a daemon
        thread; returns the bound port. The bind host is configurable
        (SchedulerConfig.metrics_bind_host) — tests bind loopback, the
        deploy manifests bind all interfaces for the scrape."""
        exporter = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):
                path, _, query = self.path.partition("?")
                if path == "/metrics":
                    try:
                        body = exporter._render().encode()
                    except Exception:
                        log.exception("metrics render failed")
                        self.send_error(500)
                        return
                    ctype = "text/plain; version=0.0.4"
                elif path == "/healthz":
                    body, ctype = b"ok\n", "text/plain"
                elif path == "/debug/profile":
                    if exporter._profile is None:
                        self.send_error(404)
                        return
                    from urllib.parse import parse_qs

                    try:
                        cycles = int(
                            parse_qs(query).get("cycles", ["1"])[0]
                        )
                    except ValueError:
                        self.send_error(400, "cycles must be an integer")
                        return
                    cycles = max(1, min(cycles, 1000))
                    try:
                        report = exporter._profile(cycles)
                    except Exception as e:
                        log.exception("profile arm failed")
                        report = {"armed": 0, "error": str(e)}
                    body = (json.dumps(report) + "\n").encode()
                    ctype = "application/json"
                else:
                    self.send_error(404)
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, fmt, *args):
                log.debug("metrics http: " + fmt, *args)

        self._server = http.server.ThreadingHTTPServer((host, port), Handler)
        threading.Thread(target=self._server.serve_forever, daemon=True).start()
        return self._server.server_address[1]

    def close(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None


class MetricsExporter(HttpMetricsServer):
    """Serves /metrics (Prometheus text format), /healthz, and
    /debug/profile for a live Scheduler, on a daemon thread. The
    exposition is the legacy summarize() gauges plus the scheduler's
    labeled collectors (prom_collectors) and the recorder/span-writer
    running totals."""

    def __init__(self, scheduler):
        super().__init__(self._render_scheduler, profile=self._arm_profile)
        self.scheduler = scheduler

    def _arm_profile(self, cycles: int) -> dict:
        armer = getattr(self.scheduler, "arm_profile", None)
        if armer is None:
            return {"armed": 0, "error": "scheduler has no profile surface"}
        return armer(cycles)

    def _render_scheduler(self) -> str:
        sched = self.scheduler
        if hasattr(sched, "metrics_snapshot"):
            window, totals = sched.metrics_snapshot()
        else:
            window, totals = list(sched.metrics), None
        stale = getattr(
            getattr(sched, "advisor", None), "stale_served", None
        )
        extra = {}
        if stale is not None:
            extra["advisor_stale_served_total"] = stale
        rec = getattr(sched, "recorder", None)
        if rec is not None:
            extra.update(
                cycles_recorded_total=rec.cycles_recorded,
                trace_bytes_total=rec.bytes_written,
                trace_records_dropped_total=rec.records_dropped,
            )
        spans = getattr(sched, "spans", None)
        if spans is not None:
            extra.update(
                spans_written_total=spans.spans_written,
                span_bytes_total=spans.bytes_written,
                spans_dropped_total=spans.spans_dropped,
            )
        body = render_prometheus(window, totals, extra or None)
        for collector in getattr(sched, "prom_collectors", ()):
            body += "\n".join(collector.render()) + "\n"
        return body


def profile_device_step(engine_call, out_dir: str):
    """Run one engine call under torch.profiler, wait for the device, and
    write the call's Chrome trace to <out_dir>/trace.json (kernels, memcpys
    and host ops on one timeline). Returns the call's result."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(out_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        result = engine_call()
        if cuda:
            # graftlint: disable=host-sync -- profiling needs the device barrier; never on the cycle path
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))
    return result
