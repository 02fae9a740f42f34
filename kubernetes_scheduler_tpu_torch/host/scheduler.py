"""The scheduling loop: queue -> snapshot -> engine -> bind.

This is the layer the reference gets for free from the embedded upstream
kube-scheduler (SURVEY.md §1: queue, node snapshot, binding cycle, leader
election) — rebuilt around batching: instead of one pod per cycle with a
per-node plugin fan-out, each cycle pops a priority-ordered window of
pending pods, builds one dense snapshot, runs one device program, and
emits all bindings.

Fallback: with feature gate tpu_batch_score=False (the design's
`--feature-gates=TPUBatchScore=false`) the loop runs the scalar per-pod
plugin path (host/plugins.py) — same scheduling decisions, no device —
which is also the recovery path if the device is unreachable: an engine
failure flips one cycle to scalar rather than stalling scheduling.

The port's copy of kubernetes_scheduler_tpu/host/scheduler.py: the same
loop, with TorchEngine (on cuda unless the caller passes an engine) as
the default engine and one explicit device-to-host read per engine
result (device.to_host); policy="learned" builds a LearnedEngine and
sharded_engine a ShardedEngine (default_engine).
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, NamedTuple

import numpy as np

from kubernetes_scheduler_tpu_torch.device import to_host
from kubernetes_scheduler_tpu_torch.host.advisor import NodeUtil
from kubernetes_scheduler_tpu_torch.host.plugins import ScalarYodaPlugin, scalar_schedule_one
from kubernetes_scheduler_tpu_torch.host.queue import (
    break_gang,
    make_queue,
    pod_gang,
    pod_priority,
)
from kubernetes_scheduler_tpu_torch.ops.constraints import (
    PREFER_NO_SCHEDULE as _PREFER_NO_SCHEDULE,
)
from kubernetes_scheduler_tpu_torch.host.snapshot import (
    FLAG_PLAIN as _FLAG_PLAIN,
    FLAG_SOFT as _FLAG_SOFT,
    _SCAL_DT,
    SnapshotBuilder,
    pod_batch_record,
    pod_flags as _pod_flags,
    pod_resource_request,
    suffix_record,
    suffix_start,
)
from kubernetes_scheduler_tpu_torch.host.types import Node, Pod
from kubernetes_scheduler_tpu_torch.utils.config import SchedulerConfig

log = logging.getLogger("yoda_tpu.scheduler")


def _pod_key(pod: Pod) -> str:
    """Identity that survives delete-and-recreate under the same name
    (kube.source.pod_key semantics)."""
    return pod.uid or f"{pod.namespace}/{pod.name}"


class Binding(NamedTuple):
    # NamedTuple (not dataclass): RecordingBinder.bind_many constructs
    # one per bind — tuple __new__ measured ~2x faster than dataclass
    # __init__ at 8k binds/cycle, and bindings are immutable records
    pod: Pod
    node_name: str


class RecordingBinder:
    """Binder for simulation/tests; a k8s binder would POST
    pods/<p>/binding here (the process boundary at SURVEY.md §3.2)."""

    def __init__(self):
        self.bindings: list[Binding] = []

    def bind(self, pod: Pod, node_name: str) -> None:
        pod.node_name = node_name
        self.bindings.append(Binding(pod, node_name))

    def bind_many(self, pods: list[Pod], node_names: list[str]) -> None:
        """Bulk surface the cycle's bind loop uses when available (must
        not raise — a binder with per-pod failure modes, like the live
        KubeBinder's 404/409 handling, should NOT define it and keep the
        per-pod path)."""
        for pod, nm in zip(pods, node_names):
            pod.node_name = nm
        self.bindings.extend(map(Binding, pods, node_names))


@dataclass
class Eviction:
    victim: Pod
    preemptor: Pod


class RecordingEvictor:
    """Evictor for simulation/tests; the live equivalent is
    kube.KubeEvictor (DELETE the victim pod with a UID precondition).
    Passing an evictor to Scheduler enables the preemption pass
    (upstream PostFilter parity, ops/preempt.py)."""

    def __init__(self):
        self.evictions: list[Eviction] = []

    def evict(self, victim: Pod, *, preemptor: Pod) -> None:
        self.evictions.append(Eviction(victim, preemptor))


@dataclass
class CycleMetrics:
    """Per-cycle observability (SURVEY.md §5: the reference exports
    nothing; we track the north-star numbers)."""

    pods_in: int = 0
    pods_bound: int = 0
    pods_unschedulable: int = 0
    # pods forgotten after a bind-time lifecycle race (deleted -> 404,
    # bound by a racer -> 409) — routine churn, NOT scheduling failures,
    # so they get their own counter and never pollute pods_unschedulable
    pods_dropped: int = 0
    # preemption pass (upstream PostFilter parity): preemptors that got a
    # candidate this cycle, and the victims evicted for them
    pods_preempted: int = 0
    victims_evicted: int = 0
    cycle_seconds: float = 0.0
    engine_seconds: float = 0.0
    used_fallback: bool = False
    # cluster-source/advisor fetch failed; window requeued, nothing ran.
    # Distinct from used_fallback so an advisor outage cannot masquerade
    # as scalar-fallback (device-path) degradation on dashboards
    fetch_failed: bool = False
    # the scalar fallback could not score config.policy (e.g. "learned")
    # and used the yoda formula instead — a POLICY change under
    # degradation, distinct from benign same-policy fallback
    policy_mismatch: bool = False
    # advisor stale-TTL grace (config.advisor_stale_ttl_s): this cycle
    # was served the LAST-GOOD cluster state because the advisor fetch
    # failed (or was held by the outage backoff) — scheduling flowed on
    # marked-stale utilization instead of stalling the window
    advisor_stale: bool = False
    # degradation ladder (host/resilience.DegradationLadder): the
    # subsystems sitting below their top rung when this cycle
    # completed — journaled with the cycle, so chaos runs are
    # replay-auditable ("which cycles ran degraded, and on what")
    degraded: tuple = ()
    # pipelined loop (config.pipeline_depth >= 1): host work done while
    # the engine call was in flight (the overlap win — next-cycle pop,
    # record warming, speculative pod-batch build), and speculative-state
    # discards (informer/layout churn, engine failure, non-device paths)
    host_overlap_seconds: float = 0.0
    pipeline_flushes: int = 0
    # resident cluster state (config.resident_state): how this cycle's
    # snapshot reached the engine — a SnapshotDelta applied to the
    # device-retained state (delta_uploads) or a full upload
    # (full_uploads; also counts resident cycles whose delta the engine
    # had to reject — epoch/shape mismatch degrades to full
    # transparently). delta_bytes_saved is the payload the delta avoided
    # shipping vs. the full snapshot.
    delta_uploads: int = 0
    full_uploads: int = 0
    delta_bytes_saved: int = 0
    # mesh-sharded engine (config.sharded_engine): device cycles served
    # by the sharded engine, and — for resident delta cycles — the
    # per-shard routed SnapshotDelta payload bytes (tuple indexed by
    # shard; empty when the cycle shipped no routed delta). The
    # {shard}-labeled byte counter and the flat-bytes bench gate read
    # these.
    sharded_cycles: int = 0
    shard_delta_bytes: tuple = ()
    # gang co-scheduling (config.gang_scheduling; ops/gang.py): gangs
    # whose every member bound this cycle, gangs deferred as a unit
    # (short of members in the window, partial device fit, or a scalar-
    # fallback cycle — gangs never bind through the scalar path), and
    # the tentative placements the all-or-nothing rule rescinded
    gangs_admitted: int = 0
    gangs_deferred: int = 0
    gang_pods_masked: int = 0


@dataclass
class _CycleStart:
    """State the cycle front-end (_begin_cycle: pop/fetch/eligibility)
    hands the path back-ends — one struct, so the serial and pipelined
    loops cannot diverge on what a cycle knows."""

    window: list
    nodes: list
    running: list
    utils: dict
    eph_running: bool
    scalar_eligible: bool
    use_device: bool
    backlog: bool
    cells: int
    t_path: float


@dataclass
class _InFlight:
    """One dispatched-but-unforced engine call (the 1-deep pipeline)."""

    handle: object       # .result() -> ScheduleResult (engine.PendingSchedule)
    pods_batch: object   # the dispatched PodBatch (validation + deltas)
    t_eng: float         # dispatch timestamp (engine wall time)
    # resident-state accounting: was this a resident dispatch, did the
    # host send a delta, and how many bytes the delta saved vs. the full
    # snapshot (attributed in _complete_window once the engine reports
    # which path actually served the call)
    resident: bool = False
    delta_sent: bool = False
    delta_bytes_saved: int = 0
    # flight-recorder context for this dispatch (config.trace_path):
    # snapshot/pods/kw references plus, after the force, the node_idx —
    # host numpy only, so holding them costs nothing on the device path
    trace_ctx: dict | None = None


class _PendingCycle:
    """Handle from Scheduler.run_cycle_split(): the dispatch half has
    run; .complete() forces the in-flight engine call (with the full
    fallback chain) and finishes the cycle. Cycles that never reached
    the device (scalar, backlog, empty queue, failed dispatch) arrive
    already completed and .complete() just returns their metrics.
    Complete every handle exactly once, before the next run_cycle/
    run_cycle_split on the same scheduler."""

    __slots__ = ("_sched", "_m", "_flight")

    def __init__(self, sched, m, flight):
        self._sched = sched
        self._m = m
        self._flight = flight  # None => cycle already finished

    @property
    def dispatched(self) -> bool:
        """True while an engine call is in flight for this cycle."""
        return self._flight is not None

    def complete(self):
        if self._flight is None:
            return self._m
        start, infl, t0 = self._flight
        self._flight = None
        return self._sched._complete_cycle_split(self._m, start, infl, t0)


def default_engine(config: SchedulerConfig, *, device=None):
    """The in-process engine `config` asks for, on `device` (cuda unless
    given; RuntimeError without CUDA): a LearnedEngine for
    policy="learned" (restored from config.learned_checkpoint, else
    untrained parameters seeded from generator seed 0, with a warning),
    a ShardedEngine for sharded_engine (config.mesh_devices shards; by
    default sharded_device_count() CUDA devices, or one shard on an
    explicit device), else TorchEngine."""
    check_engine_options(config)
    if config.policy == "learned":
        from kubernetes_scheduler_tpu_torch.models.learned import (
            LearnedEngine,
            init_train_state,
            load_learned_engine,
        )

        if config.learned_checkpoint:
            return load_learned_engine(config.learned_checkpoint, device=device)
        log.warning(
            "policy='learned' with no learned_checkpoint: scheduling "
            "with freshly initialized (UNTRAINED) scorer parameters"
        )
        state, model, _ = init_train_state(0, device=device)
        return LearnedEngine(state.params, model=model, device=device)
    if config.sharded_engine:
        from kubernetes_scheduler_tpu_torch.parallel import (
            ShardedEngine,
            make_mesh,
            sharded_device_count,
        )

        if device is None:
            mesh = make_mesh(config.mesh_devices or sharded_device_count())
        else:
            mesh = make_mesh(config.mesh_devices or 1, device=device)
        return ShardedEngine(mesh)
    from kubernetes_scheduler_tpu_torch.engine import TorchEngine

    return TorchEngine(device=device)


def check_engine_options(config: SchedulerConfig) -> None:
    """ValueError for engine options that cannot be served together."""
    if config.sharded_engine and config.policy == "learned":
        raise ValueError(
            "sharded_engine has no learned-policy path yet; use a "
            "sharded sidecar with --learned-checkpoint instead"
        )
    if config.policy == "learned" and not config.feature_gates.tpu_batch_score:
        raise ValueError(
            "policy='learned' requires the engine path "
            "(feature_gates.tpu_batch_score=True); the scalar "
            "fallback only implements the yoda formula"
        )


class Scheduler:
    def __init__(
        self,
        config: SchedulerConfig,
        *,
        advisor,
        binder=None,
        evictor=None,
        list_nodes: Callable[[], list[Node]],
        list_running_pods: Callable[[], list[Pod]],
        list_pdbs: Callable[[], list] | None = None,
        controller_replicas: Callable[[str, str, str], int | None] | None = None,
        engine=None,
        queue_clock: Callable[[], float] | None = None,
        queue=None,
    ):
        self.config = config
        self.advisor = advisor
        check_engine_options(config)
        if config.policy == "learned" and engine is not None:
            from kubernetes_scheduler_tpu_torch.models.learned import LearnedEngine

            if not isinstance(engine, LearnedEngine):
                # a heuristic engine has no parameters to evaluate the
                # learned policy with; failing loud beats every cycle
                # erroring into the scalar yoda fallback forever
                raise ValueError(
                    "policy='learned' requires a LearnedEngine; got "
                    f"{type(engine).__name__} (remote sidecars do not serve "
                    "the learned policy)"
                )
        if engine is None:
            # the card by default: raises RuntimeError without CUDA
            engine = default_engine(config)
        self.engine = engine
        # auction knobs ride only engines whose call surface takes them
        # (TorchEngine's **kw and RemoteEngine's explicit params both do;
        # the knobs ride the ScheduleRequest wire fields) — gating on the
        # SIGNATURE so an engine predating the wire fields degrades to
        # defaults instead of TypeError-ing every cycle into the scalar
        # fallback
        import inspect

        try:
            params = inspect.signature(self.engine.schedule_batch).parameters
            self._engine_takes_auction_kw = "auction_price_frac" in params or any(
                p.kind is inspect.Parameter.VAR_KEYWORD
                for p in params.values()
            )
        except (TypeError, ValueError):
            self._engine_takes_auction_kw = False
        # deep-queue batching needs the windows surface; flips False at
        # runtime if a version-skewed sidecar answers UNIMPLEMENTED
        self._engine_windows_ok = hasattr(self.engine, "schedule_windows")
        self.binder = binder or RecordingBinder()
        self.evictor = evictor
        self._cycle_unsched: list[Pod] = []
        self._cycle_bound: list[Pod] = []
        # victims whose DELETE was issued but that still appear in
        # list_running_pods (termination grace): never re-evicted, and
        # their nodes are off-limits to further preemption until the
        # capacity actually frees (poor-man's nominatedNodeName)
        self._pending_evictions: dict[str, str] = {}  # pod key -> node name
        # preemptor key -> (nominated node, preemptor pod, expiry):
        # a pod that already triggered evictions waits for that node's
        # capacity — reserved via a virtual running pod — instead of
        # evicting more victims elsewhere every retry cycle (upstream
        # nominatedNodeName semantics)
        self._nominations: dict[str, tuple[str, Pod, float]] = {}
        self.list_nodes = list_nodes
        self.list_running_pods = list_running_pods
        # PodDisruptionBudgets for the preemption pass (None = no budgets
        # consulted, e.g. simulated clusters without PDBs)
        self.list_pdbs = list_pdbs
        # (kind, namespace, name) -> spec.replicas resolver for the PDB
        # percentage math's expected count (upstream disruption-controller
        # semantics); None = current-count fallback
        self.controller_replicas = controller_replicas
        if config.feature_gates.native_host:
            from kubernetes_scheduler_tpu_torch import native

            self._native_ok = native.available()
            if not self._native_ok:
                log.warning(
                    "native_host enabled but libyoda_host unavailable; "
                    "using pure-Python host paths"
                )
        else:
            self._native_ok = False
        # queue_clock: injectable retry-backoff clock (default wall
        # monotonic) — the scenario harness passes a virtual clock so
        # backoffs resolve in simulated ticks, deterministically.
        # queue: injectable pre-built queue (any SchedulingQueue-surface
        # object) — the replicated fleet (host/replica.py) hands each
        # replica its ReplicaCoordinator, a partition of the shared
        # queue fenced by the bind table, through this seam
        self.queue = queue if queue is not None else make_queue(
            initial_backoff=config.initial_backoff_seconds,
            max_backoff=config.max_backoff_seconds,
            prefer_native=self._native_ok,
            **({"clock": queue_clock} if queue_clock is not None else {}),
        )
        self.builder = SnapshotBuilder(
            extended_resources=list(config.extended_resources),
            gang_scheduling=config.gang_scheduling,
            # warm-restart pre-size (`trace stats` peak_selector_slots):
            # start the selector bucket at the prior run's peak so the
            # early power-of-two crossings never flush the mirror
            initial_selectors=config.mirror_initial_selectors,
        )
        # event-driven cycle triggering (config.cycle_trigger="event"):
        # queue pushes and mirror events notify the trigger the host
        # loops sleep on; "tick" (default) keeps the fixed-poll waits
        if config.cycle_trigger not in ("tick", "event"):
            raise ValueError(
                f"unknown cycle_trigger {config.cycle_trigger!r}; "
                "expected 'tick' or 'event'"
            )
        from kubernetes_scheduler_tpu_torch.host.mirror import (
            CycleTrigger,
            SnapshotMirror,
        )

        self.trigger = (
            CycleTrigger() if config.cycle_trigger == "event" else None
        )
        # streaming state ingestion (config.snapshot_mirror): the
        # event-sourced mirror replaces the per-cycle build_snapshot/
        # snapshot_delta pair on the hot path; the advisor is wrapped
        # for changed-node fetches unless it already coalesces
        self.mirror = None
        if config.snapshot_mirror:
            self.mirror = SnapshotMirror(
                self.builder,
                verify_interval=config.mirror_verify_interval,
                on_dirty=(
                    self.trigger.notify if self.trigger is not None else None
                ),
            )
            if not hasattr(self.advisor, "fetch_changed"):
                from kubernetes_scheduler_tpu_torch.host.advisor import (
                    CoalescingAdvisor,
                )

                self.advisor = CoalescingAdvisor(self.advisor)
        if config.adaptive_dispatch:
            from kubernetes_scheduler_tpu_torch.utils.adaptive import AdaptiveDispatch

            self._dispatch = AdaptiveDispatch(config.min_device_work)
        else:
            self._dispatch = None
        self._scalar_cycler = None
        # gang co-scheduling (config.gang_scheduling): gang key ->
        # consecutive front-of-queue deferrals; cleared on admission,
        # resolved per config.gang_defer_policy when the budget runs out
        if config.gang_defer_policy not in ("split", "drop"):
            raise ValueError(
                f"unknown gang_defer_policy {config.gang_defer_policy!r}; "
                "expected 'split' or 'drop'"
            )
        self._gang_defers: dict[str, int] = {}
        # bounded: a long-lived process keeps the last window of cycle
        # metrics (latency quantiles), while monotonic run totals live in
        # self.totals — Prometheus counters must never decrease, and the
        # rolling window alone would make them sawtooth after eviction
        from collections import deque

        self.metrics: deque[CycleMetrics] = deque(maxlen=8192)
        self.totals = {
            "cycles": 0,
            "pods_bound": 0,
            "pods_unschedulable": 0,
            "pods_dropped": 0,
            "pods_preempted": 0,
            "victims_evicted": 0,
            "fallback_cycles": 0,
            "fetch_failures": 0,
            "fallback_policy_mismatch": 0,
            "pipeline_flushes": 0,
            "host_overlap_seconds": 0.0,
            "delta_uploads": 0,
            "full_uploads": 0,
            "delta_bytes_saved": 0,
            "sharded_cycles": 0,
            "shard_delta_bytes": 0,
            "gangs_admitted": 0,
            "gangs_deferred": 0,
            "gang_pods_masked": 0,
            "advisor_stale_cycles": 0,
            "degraded_cycles": 0,
        }
        # resident cluster state (config.resident_state): the last full
        # snapshot the engine confirmed retaining (the delta base), the
        # epoch the next upload will be tagged with, and whether the
        # engine-side state is trusted — flipped False on engine
        # failure, epoch desync, or preemption so the next dispatch
        # flushes to a full upload
        self._resident_prev = None
        self._resident_epoch = 0
        self._resident_ok = False
        # pipelined loop state (config.pipeline_depth >= 1): the window
        # prefetched while the previous cycle's engine call was in
        # flight, and the speculative pod batch prebuilt for it (kept at
        # dispatch time only if the layout fingerprint still matches)
        self._prefetched: list[Pod] | None = None
        self._spec_batch: tuple | None = None  # (window, fingerprint, batch)
        # appends/reads cross threads (scheduling loop vs /metrics scrape;
        # deque raises on mutation during iteration, unlike list)
        self._metrics_lock = threading.Lock()
        # cycle flight recorder (config.trace_path; trace/recorder.py):
        # one record per cycle appended from the completion stage —
        # never from the dispatch path
        self.recorder = None
        if config.trace_path:
            from kubernetes_scheduler_tpu_torch.trace.recorder import CycleRecorder

            self.recorder = CycleRecorder(
                config.trace_path,
                file_bytes=config.trace_file_bytes,
                max_bytes=config.trace_max_bytes,
            )
        # per-cycle dispatch contexts the recorder reads in _finish_cycle
        self._trace_cycle: list[dict] = []
        # per-cycle span telemetry (config.span_path; observe.SpanRecorder
        # over trace/spans.py): collection appends perf_counter pairs on
        # the cycle path; Chrome-event encoding and the file write happen
        # in _finish_cycle AFTER the cycle's bookkeeping — the same
        # off-the-critical-path discipline as the flight recorder. The
        # cycle's trace id also rides gRPC metadata (engine.set_trace_id)
        # so sidecar-side spans join the host timeline.
        self.spans = None
        self._cycle_span = None
        if config.span_path:
            from kubernetes_scheduler_tpu_torch.host.observe import SpanRecorder

            self.spans = SpanRecorder(
                config.span_path,
                file_bytes=config.span_file_bytes,
                max_bytes=config.span_max_bytes,
                process="host",
            )
        # labeled Prometheus collectors, rendered by MetricsExporter
        # beside the legacy quantile gauges: real histograms (bucketed,
        # labeled by loop path) instead of window quantiles, and the
        # upload counter the resident-state dashboards key on
        from kubernetes_scheduler_tpu_torch.host.observe import Counter, Histogram

        self.hist_cycle = Histogram(
            "cycle_duration_seconds",
            "End-to-end cycle latency by loop path",
            labels=("path",),
        )
        self.hist_engine = Histogram(
            "engine_step_duration_seconds",
            "Device (engine) step time by loop path",
            labels=("path",),
        )
        self.ctr_uploads = Counter(
            "snapshot_uploads_total",
            "Snapshot uploads to the engine (resident delta vs full)",
            labels=("upload",),
        )
        self.ctr_shard_bytes = Counter(
            "shard_delta_bytes_total",
            "Routed SnapshotDelta payload bytes per owning node shard "
            "(mesh-sharded resident engine)",
            labels=("shard",),
        )
        self.ctr_slo = Counter(
            "slo_breaches_total",
            "Cycles that blew the configured cycle_slo_ms latency budget",
            labels=("path",),
        )
        self.prom_collectors = (
            self.hist_cycle, self.hist_engine, self.ctr_uploads,
            self.ctr_shard_bytes, self.ctr_slo,
        ) + (self.mirror.collectors if self.mirror is not None else ())
        # SLO watchdog state (config.cycle_slo_ms): run totals, the last
        # breach's identity (trace id + flight-recorder seq — the two
        # handles that find the cycle in the span timeline and journal),
        # and the self-arm window countdown (config.slo_profile_cycles):
        # a breach storm arms the profiler once per window, not once per
        # breach — re-arming every cycle would profile forever and keep
        # resetting the dump the operator wants to read
        self.slo_breaches = 0
        self.last_slo_breach: dict | None = None
        self._slo_profile_pending = 0
        # resilience layer (host/resilience.py): the degradation-ladder
        # state machine (single owner of every subsystem's rung), the
        # circuit breakers guarding the engine dispatch and advisor
        # fetch, and the shared deterministic-jitter backoff policy the
        # advisor outage path retries on. All of it observes and gates —
        # with no failures the breakers stay closed, every rung stays at
        # top, and the loop is bit-identical to the pre-resilience
        # scheduler (PARITY round 17).
        from kubernetes_scheduler_tpu_torch.host.resilience import (
            BackoffPolicy,
            CircuitBreaker,
            DegradationLadder,
        )

        # the retry/backoff clock of record is the QUEUE's clock (the
        # injectable queue_clock; the scenario harness's virtual
        # SimClock) — the breakers and the advisor backoff hold read it
        # LIVE through the queue so virtual-clock runs are
        # tick-deterministic and test clock pokes stay coherent
        self._clock = lambda: self.queue._clock()
        self.ladder = DegradationLadder()
        self.ctr_breaker = Counter(
            "breaker_transitions_total",
            "Circuit-breaker state transitions (state entered), by "
            "breaker (engine dispatch vs advisor fetch)",
            labels=("breaker", "state"),
        )
        # ONE breaker governs the engine path. An engine that owns a
        # breaker (RemoteEngine: one per sidecar target, gating its own
        # RPCs) is adopted and retuned with the config knobs + queue
        # clock + transition hook — two stacked breakers would each
        # need their half-open windows to line up before a probe could
        # reach the wire. Engines without one (local/sharded) get a
        # scheduler-owned breaker, and the dispatch gate below is the
        # only enforcement point.
        eng_brk = getattr(self.engine, "breaker", None)
        self._engine_owns_breaker = isinstance(eng_brk, CircuitBreaker)
        if self._engine_owns_breaker:
            self.engine_breaker = eng_brk.configure(
                failure_threshold=config.breaker_failure_threshold,
                recovery_window_s=config.breaker_recovery_window_s,
                clock=self._clock,
                on_transition=self._on_breaker_transition,
            )
        else:
            self.engine_breaker = CircuitBreaker(
                "engine",
                failure_threshold=config.breaker_failure_threshold,
                recovery_window_s=config.breaker_recovery_window_s,
                clock=self._clock,
                on_transition=self._on_breaker_transition,
            )
        self.advisor_breaker = CircuitBreaker(
            "advisor",
            failure_threshold=config.breaker_failure_threshold,
            recovery_window_s=config.breaker_recovery_window_s,
            clock=self._clock,
            on_transition=self._on_breaker_transition,
        )
        self._backoff = BackoffPolicy()
        # advisor outage bookkeeping: consecutive failures, the
        # backoff-held next-attempt time, and the last-good UTILIZATION
        # snapshot the stale-TTL grace mode serves (utils only — the
        # node/running lists are re-read LIVE under grace, so the
        # scheduler's own binds stay visible and capacity is never
        # double-booked against a frozen running set)
        self._advisor_fails = 0
        self._advisor_retry_at = float("-inf")
        self._last_good_utils: tuple | None = None  # (utils, ts)
        # kernel-rung latch: has this config ever served a fused cycle?
        # (only then is coming back unfused a capability downgrade)
        self._kernel_fused_seen = False
        self.prom_collectors = (
            self.prom_collectors
            + (self.ctr_breaker,)
            + self.ladder.collectors
            # engines owning exported collectors (RemoteEngine's
            # engine_health_failures_total) ride the host exporter too
            + tuple(getattr(self.engine, "collectors", ()))
        )

    def _on_breaker_transition(self, name: str, state: str) -> None:
        """Breaker state change hook: count the transition and keep the
        ladder coupled — an OPEN engine breaker implies the engine
        subsystem sits below its top rung (the `degradation-ladder`
        protocol model's breaker-open-implies-degraded invariant).
        Everything but the advisor breaker IS the engine breaker (an
        adopted bridge-client breaker keeps its per-target name)."""
        self.ctr_breaker.inc(breaker=name, state=state)
        if name != "advisor" and state == "open":
            self.ladder.demote(
                "engine", reason="breaker-open",
                seq=self.totals["cycles"],
            )

    def _engine_failure(self, reason: str) -> None:
        """One engine-dispatch failure: feed the breaker and walk the
        ladder down — engine (remote->local), plus sharded->dense when
        the failed engine was the mesh-sharded one (its fallback is the
        dense scalar path). With a SHARED client-owned breaker the
        client already recorded the terminal outcome per call — a
        second record here would restart the open window every cycle
        and recovery would never come."""
        if not self._engine_owns_breaker:
            self.engine_breaker.record_failure()
        seq = self.totals["cycles"]
        self.ladder.demote("engine", reason=reason, seq=seq)
        if getattr(self.engine, "n_shards", 0):
            self.ladder.demote("sharding", reason=reason, seq=seq)

    def _ladder_cycle_end(self, m: CycleMetrics) -> None:
        """Completion-stage ladder bookkeeping: a clean device cycle IS
        the recovery probe for the engine-side rungs (the dispatch
        re-attempted the degraded path and it served), so probe+promote
        climb them back; the policy rung follows policy_mismatch."""
        seq = self.totals["cycles"]
        lad = self.ladder
        device_ok = m.engine_seconds > 0 and not m.used_fallback
        if device_ok:
            if not self._engine_owns_breaker:
                # a shared client breaker already recorded per call
                self.engine_breaker.record_success()
            for sub in ("engine", "sharding"):
                if lad.depth(sub) > 0:
                    lad.probe(sub, seq=seq)
                    lad.promote(sub, seq=seq)
        if m.policy_mismatch:
            lad.demote("policy", reason="no-scalar-mirror", seq=seq)
        elif device_ok and lad.depth("policy") > 0:
            lad.probe("policy", seq=seq)
            lad.promote("policy", seq=seq)

    def _cycle_path(self, m: CycleMetrics) -> str:
        """The histogram `path` label: which loop served the cycle."""
        if m.used_fallback or m.fetch_failed:
            return "fallback"
        return "pipelined" if self.config.pipeline_depth > 0 else "serial"

    def _span(self, name: str, t0: float, t1: float | None = None, **args):
        """Record one span on the current cycle's SpanSet (no-op with
        spans off — one attribute read on the hot path)."""
        sp = self._cycle_span
        if sp is not None:
            sp.add(name, t0, time.perf_counter() if t1 is None else t1, **args)

    def arm_profile(self, cycles: int) -> dict:
        """Arm torch.profiler capture of the next `cycles` engine calls
        (the /debug/profile?cycles=N endpoint). A local engine dumps
        under config.profile_path (default <span_path>/profiles, else a
        tempdir), one dump per call named after the trace id it covers;
        a RemoteEngine forwards the arm to the sidecar over metadata."""
        armer = getattr(self.engine, "arm_profile", None)
        if armer is None:
            return {"armed": 0, "error": "engine has no profile surface"}
        out_dir = self.config.profile_path
        if out_dir is None and self.config.span_path:
            import os

            out_dir = os.path.join(self.config.span_path, "profiles")
        return armer(int(cycles), out_dir)

    def _record(self, m: CycleMetrics) -> None:
        # mesh-sharded engine: a device cycle (engine_seconds only
        # accrues after a successful force) through a sharded engine is
        # a sharded cycle, whatever dispatch surface served it
        if m.engine_seconds > 0 and getattr(self.engine, "n_shards", 0):
            m.sharded_cycles = 1
        # degradation-ladder audit: the rungs below top as this cycle
        # lands (journaled with the cycle's metrics; the same-mutation
        # precedent as the sharded_cycles attribution above)
        m.degraded = self.ladder.degraded()
        path = self._cycle_path(m)
        self.hist_cycle.observe(m.cycle_seconds, path=path)
        if m.engine_seconds > 0:
            self.hist_engine.observe(m.engine_seconds, path=path)
        if m.delta_uploads:
            self.ctr_uploads.inc(m.delta_uploads, upload="delta")
        if m.full_uploads:
            self.ctr_uploads.inc(m.full_uploads, upload="full")
        for shard, nbytes in enumerate(m.shard_delta_bytes):
            if nbytes:
                self.ctr_shard_bytes.inc(nbytes, shard=str(shard))
        with self._metrics_lock:
            self.metrics.append(m)
            self.totals["cycles"] += 1
            self.totals["pods_bound"] += m.pods_bound
            self.totals["pods_unschedulable"] += m.pods_unschedulable
            self.totals["pods_dropped"] += m.pods_dropped
            self.totals["pods_preempted"] += m.pods_preempted
            self.totals["victims_evicted"] += m.victims_evicted
            self.totals["fallback_cycles"] += int(m.used_fallback)
            self.totals["fetch_failures"] += int(m.fetch_failed)
            self.totals["fallback_policy_mismatch"] += int(m.policy_mismatch)
            self.totals["pipeline_flushes"] += m.pipeline_flushes
            self.totals["host_overlap_seconds"] += m.host_overlap_seconds
            self.totals["delta_uploads"] += m.delta_uploads
            self.totals["full_uploads"] += m.full_uploads
            self.totals["delta_bytes_saved"] += m.delta_bytes_saved
            self.totals["sharded_cycles"] += m.sharded_cycles
            self.totals["shard_delta_bytes"] += sum(m.shard_delta_bytes)
            self.totals["gangs_admitted"] += m.gangs_admitted
            self.totals["gangs_deferred"] += m.gangs_deferred
            self.totals["gang_pods_masked"] += m.gang_pods_masked
            self.totals["advisor_stale_cycles"] += int(m.advisor_stale)
            self.totals["degraded_cycles"] += int(bool(m.degraded))

    def metrics_snapshot(self) -> tuple[list[CycleMetrics], dict]:
        """Point-in-time copy for exporters (safe against the scheduling
        thread appending mid-iteration)."""
        with self._metrics_lock:
            return list(self.metrics), dict(self.totals)

    def submit(self, pod: Pod) -> None:
        """Enqueue + admission-time precompute. Pod specs are immutable,
        so the per-pod derived values every cycle probes — dispatch flags,
        the request row, priority — are computed HERE, on the informer/
        submission path, not inside the scheduling loop. This mirrors
        upstream's scheduling queue doing its preprocessing at Add time:
        the cycle then sees only warm per-pod caches (a fresh 8k-pod
        backlog otherwise pays ~100ms of first-touch attribute walks
        inside its first cycle)."""
        try:
            pod_batch_record(pod, self.builder.resource_names_tuple())
        except Exception:
            # a malformed spec must surface in the cycle's error
            # handling (requeue/backoff), not kill the informer thread
            pass
        self.queue.push(pod)
        if self.trigger is not None:
            # event-driven loops wake on arrival instead of the next tick
            self.trigger.notify()

    # ---- one cycle -----------------------------------------------------

    def run_cycle(self) -> CycleMetrics:
        """One scheduling cycle. With config.pipeline_depth >= 1 the
        batched device path runs 1-deep pipelined — async engine
        dispatch with next-cycle host work overlapped against the
        in-flight call; depth 0 is the strictly alternating host/device
        loop. Bindings are bit-identical between the two for the same
        arrival order (PARITY.md)."""
        if self.config.pipeline_depth > 0:
            return self._run_cycle_pipelined()
        return self._run_cycle_serial()

    def _run_cycle_serial(self) -> CycleMetrics:
        m = CycleMetrics()
        t0 = time.perf_counter()
        start = self._begin_cycle(m, t0)
        if start is None:
            return m
        self._run_paths(start, m)
        self._finish_cycle(start, m, t0)
        return m

    def _window_cap(self) -> int:
        return self.config.batch_window * (
            max(1, self.config.max_windows_per_cycle)
            if self._engine_windows_ok
            else 1
        )

    def _mirror_state(self) -> tuple[list, list, dict]:
        """Cluster state off the event-sourced mirror (config.
        snapshot_mirror): the full list/fetch callables run ONCE to
        seed; afterwards the per-cycle state fetch reduces to draining
        the advisor's changed-node records and applying them as
        utilization events (span event_apply) — O(events), not
        O(nodes). Pod/node events arrive out of band (informer hooks,
        ScenarioWorld, the scheduler's own post-bind self-apply)."""
        mir = self.mirror
        if not mir.seeded:
            mir.seed(
                self.list_nodes(),
                self.list_running_pods(),
                self.advisor.fetch(),
            )
        else:
            fetch_changed = getattr(self.advisor, "fetch_changed", None)
            if fetch_changed is not None:
                t_e = time.perf_counter()
                changed = fetch_changed()
                if changed:
                    mir.apply_util_events(changed)
                self._span("event_apply", t_e, events=len(changed))
        return mir.state()

    def _advisor_ready(self) -> bool:
        """May this cycle attempt a state fetch? False while the
        deterministic backoff hold from the last failure is pending or
        the advisor breaker is open (its half-open probe is the ONE
        fetch attempt per recovery window)."""
        if self._clock() < self._advisor_retry_at:
            return False
        return self.advisor_breaker.allow()

    def _advisor_failed(self) -> None:
        """One failed fetch attempt: feed the breaker and arm the next
        attempt at the shared BackoffPolicy's deterministic-jitter
        exponential delay (never a fixed per-cycle hammer)."""
        self.advisor_breaker.record_failure()
        self._advisor_retry_at = self._clock() + self._backoff.delay(
            self._advisor_fails, key="advisor"
        )
        self._advisor_fails += 1

    def _advisor_recovered(self, state: tuple) -> None:
        """A successful fetch: clear the outage bookkeeping and adopt
        this cycle's utilization as the stale-grace fallback payload."""
        if self._advisor_fails or self.advisor_breaker.state() != "closed":
            self.advisor_breaker.record_success()
        self._advisor_fails = 0
        self._advisor_retry_at = float("-inf")
        self._last_good_utils = (state[2], self._clock())

    def _stale_state(self) -> tuple | None:
        """(nodes, running, utils) for a grace-mode cycle: LIVE cluster
        lists (the scheduler's own binds must stay visible — serving a
        frozen running set would double-book node capacity) joined with
        the last-good utilization while the stale TTL
        (config.advisor_stale_ttl_s) still covers it. None when the TTL
        is off/expired or the cluster source itself is down (then the
        requeue outage path owns the cycle)."""
        ttl = self.config.advisor_stale_ttl_s
        lg = self._last_good_utils
        if ttl <= 0 or lg is None or self._clock() - lg[1] > ttl:
            return None
        try:
            if self.mirror is not None:
                # the mirror's lists are event-sourced and live; its
                # utilization is simply frozen at the last applied
                # advisor events — exactly the grace semantics
                if not self.mirror.seeded:
                    return None
                return self.mirror.state()
            return self.list_nodes(), self.list_running_pods(), lg[0]
        except Exception:
            log.exception("stale-grace cluster-list fetch failed")
            return None

    def _cycle_snapshot(
        self, window, nodes, running, utils, *, ephemeral: bool,
    ):
        """(snapshot, mirror delta | None) for one dispatch — the ONE
        place the two state paths fork: mirror.emit serves the
        persistent arrays plus a ready-made delta in O(events) (span
        mirror_emit); the classic build_snapshot path (span
        snapshot_build) covers mirror-off and ephemeral builds (a
        reservation-concatenated running list is throwaway and must
        never touch the mirror's state)."""
        t_build = time.perf_counter()
        plain = self._window_flags(window)[0]
        if self.mirror is not None and not ephemeral:
            snapshot, delta, rebuilt = self.mirror.emit(
                window,
                pending_all_plain=plain,
                prev=self._resident_prev if self._resident_ok else None,
            )
            self._span(
                "mirror_emit", t_build,
                rebuilt=rebuilt, delta=delta is not None,
            )
            # ladder: a flush-to-full rebuild IS the mirror->rebuild
            # rung (verify resync, churn); a mirror-served emit while
            # degraded is the recovery probe that climbs back
            seq = self.totals["cycles"]
            if rebuilt:
                self.ladder.demote(
                    "mirror",
                    reason=getattr(
                        self.mirror, "last_rebuild_reason", "flush"
                    ),
                    seq=seq,
                )
            elif self.ladder.depth("mirror") > 0:
                self.ladder.probe("mirror", seq=seq)
                self.ladder.promote("mirror", seq=seq)
            return snapshot, delta
        snapshot = self.builder.build_snapshot(
            nodes, utils, running, pending_pods=window,
            ephemeral=ephemeral, pending_all_plain=plain,
        )
        self._span("snapshot_build", t_build)
        return snapshot, None

    def _begin_cycle(
        self, m: CycleMetrics, t0: float, window: list | None = None,
    ) -> _CycleStart | None:
        """Cycle front-end shared by the serial and pipelined loops:
        pop (or adopt a prefetched) window, fetch cluster state, apply
        the ReadWriteOncePod filter and nomination reservations, and
        decide the path. Returns None after finishing the cycle itself
        on the terminal paths (empty window, fetch failure, everything
        filtered)."""
        self._cycle_unsched = []
        self._cycle_bound = []
        self._trace_cycle = []
        self._cycle_span = (
            self.spans.begin() if self.spans is not None else None
        )
        t_pop = time.perf_counter()
        if window is None:
            window = self.queue.pop_window(self._window_cap())
        m.pods_in = len(window)
        if not window:
            # empty cycles (backoff waits, idle polls) are not recorded:
            # a serve-forever loop would otherwise grow self.metrics
            # without bound on pure idle time — and not spanned (the
            # same unbounded-idle concern applies to span files)
            self._cycle_span = None
            m.cycle_seconds = time.perf_counter() - t0
            return None
        self._span("queue_pop", t_pop)

        # gang admission control BEFORE any state fetch: gangs short of
        # members (or too big to ever fit a window) defer as a unit —
        # scheduling a knowingly-partial gang would only burn a device
        # dispatch to mask it out again
        if self.config.gang_scheduling:
            window = self._gang_screen(window, m)
            if not window:
                m.cycle_seconds = time.perf_counter() - t0
                self._record(m)
                self._flush_spans(t0, m)
                return None

        t_fetch = time.perf_counter()
        state = None
        if self._advisor_ready():
            try:
                if self.mirror is not None:
                    state = self._mirror_state()
                else:
                    state = (
                        self.list_nodes(),
                        self.list_running_pods(),
                        self.advisor.fetch(),
                    )
            except Exception:
                # a cluster-source or advisor outage (API server blip,
                # Prometheus restart): feed the advisor breaker and arm
                # the deterministic-jitter backoff hold, so retry
                # attempts pace out instead of paying the fetch timeout
                # every cycle
                log.exception("cycle state fetch failed")
                self._advisor_failed()
        if state is not None:
            self._advisor_recovered(state)
            nodes, running, utils = state
        else:
            # outage (or a backoff hold between retry attempts): the
            # stale-TTL grace mode serves the last-good cluster state,
            # marked, so scheduling keeps flowing on slightly stale
            # utilization (config.advisor_stale_ttl_s)
            stale = self._stale_state()
            if stale is None:
                # past the TTL (or grace off): the outage must not LOSE
                # the popped window — requeue it with backoff and
                # surface a failed cycle (the reference's PreScore error
                # path makes pods retriable the same way,
                # scheduler.go:106-109)
                for pod in window:
                    self.queue.requeue_unschedulable(pod)
                m.pods_unschedulable = len(window)
                m.fetch_failed = True
                m.cycle_seconds = time.perf_counter() - t0
                self._record(m)
                self._flush_spans(t0, m)
                return None
            nodes, running, utils = stale
            m.advisor_stale = True
        self._span("state_fetch", t_fetch)

        # VolumeRestrictions (ReadWriteOncePod): at most one pod
        # cluster-wide may use an exclusive claim. Enforced HERE, against
        # this cycle's running set plus earlier window positions, because
        # any admission-time check races (two pods pending together both
        # look unconstrained before either binds).
        if any(pod.exclusive_claims for pod in window):
            held = {
                f"{pd.namespace}/{c}"
                for pd in running
                for c in pd.volume_claims
            }
            kept = []
            for pod in window:
                exc = set(pod.exclusive_claims)
                if exc & held:
                    log.info(
                        "pod %s/%s waits: exclusive claim in use",
                        pod.namespace, pod.name,
                    )
                    self._requeue_unschedulable(pod, m)
                else:
                    held |= exc
                    kept.append(pod)
            window = kept
            if not window:
                m.cycle_seconds = time.perf_counter() - t0
                self._record(m)
                self._flush_spans(t0, m)
                return None

        # nominated-capacity reservations (upstream nominatedNodeName):
        # a preemptor whose victims were evicted holds its nominated
        # node's capacity as a virtual running pod, so the freed space
        # cannot be consumed by lower-priority arrivals during the
        # preemptor's retry backoff — which would otherwise re-trigger
        # eviction loops under a steady low-priority trickle. The
        # reservation is skipped while the preemptor itself is in the
        # window (it is about to consume the capacity for real).
        reservations = self._nomination_reservations(window)
        if reservations:
            # NB: only copy when there ARE reservations — the copy would
            # otherwise defeat every downstream prefix-identity cache
            # (running-features, snapshot accumulation) every cycle
            running = running + reservations

        # adaptive dispatch: tiny cycles are device-latency-bound; the
        # scalar host path (C++ when native) wins below the crossover.
        # Only when the scalar path's decisions match — it implements the
        # live yoda formula + resource fit, so any other policy or any
        # taint/affinity/GPU constraint family stays on the engine. The
        # crossover itself is learned from observed per-path latencies
        # when adaptive_dispatch is on (utils/adaptive.py); cells below
        # min_device_work route scalar until both models are fitted.
        cells = len(window) * len(nodes)
        # with reservations, `running` is a per-cycle throwaway
        # concatenation: probes must not record prefix caches on it
        eph_running = bool(reservations)
        scalar_eligible = (
            self.config.policy in ("balanced_cpu_diskio", "free_capacity")
            and self._scalar_sufficient(
                window, nodes, running, record=not eph_running
            )
        )
        if not scalar_eligible:
            use_device = True
        elif self._dispatch is not None:
            use_device = self._dispatch.decide(cells)
        else:
            use_device = cells >= self.config.min_device_work
        if use_device and self.config.feature_gates.tpu_batch_score:
            # breaker open: the engine is not dispatched at all — the
            # scalar path serves this window, so the outage costs one
            # probe per recovery window instead of a timeout per call.
            # Scheduler-owned breakers enforce HERE via allow() (one
            # half-open probe per window takes the device path below);
            # a breaker SHARED with the bridge client is only peek()ed
            # — the client's allow() at send time is the consuming
            # gate, and eating its probe here would fail every probe
            # cycle spuriously.
            if self._engine_owns_breaker:
                use_device = self.engine_breaker.peek()
            else:
                use_device = self.engine_breaker.allow()
        t_path = time.perf_counter()
        backlog = (
            len(window) > self.config.batch_window and self._engine_windows_ok
        )
        return _CycleStart(
            window=window, nodes=nodes, running=running, utils=utils,
            eph_running=eph_running, scalar_eligible=scalar_eligible,
            use_device=use_device, backlog=backlog, cells=cells,
            t_path=t_path,
        )

    def _run_paths(self, start: _CycleStart, m: CycleMetrics) -> None:
        """Serial path dispatch: device (single-window or backlog) with
        scalar fallback, or the scalar path outright — plus the adaptive
        crossover observations."""
        window, nodes, running, utils = (
            start.window, start.nodes, start.running, start.utils,
        )
        eph_running = start.eph_running
        scalar_eligible = start.scalar_eligible
        use_device = start.use_device
        backlog = start.backlog
        cells = start.cells
        t_path = start.t_path
        if self.config.feature_gates.tpu_batch_score and nodes and use_device:
            try:
                # deep backlog: schedule all popped windows in ONE engine
                # dispatch when the engine serves the windows surface
                if backlog:
                    try:
                        self._run_backlog(
                            window, nodes, running, utils, m,
                            ephemeral=eph_running,
                        )
                    except NotImplementedError:
                        # version-skewed sidecar without the windows RPC:
                        # degrade to per-window dispatches (same
                        # decisions, one RPC each), never to the scalar
                        # fallback, and stop popping deep windows
                        log.warning(
                            "engine lacks the windows surface; falling "
                            "back to per-window dispatch"
                        )
                        self._engine_windows_ok = False
                        bw = self.config.batch_window
                        for i in range(0, len(window), bw):
                            chunk = window[i : i + bw]
                            # each chunk must see the capacity consumed
                            # by earlier chunks' binds (the one-dispatch
                            # path carries it on device; the one-window-
                            # per-cycle shape re-lists between cycles)
                            run_now = (
                                running + self._cycle_bound
                                if self._cycle_bound
                                else running
                            )
                            try:
                                self._run_batched(
                                    chunk, nodes, run_now, utils, m,
                                    ephemeral=eph_running
                                    or run_now is not running,
                                )
                            except Exception:
                                # chunk-local fallback: earlier chunks'
                                # binds are final and must NOT be
                                # re-scheduled by a whole-window fallback
                                log.exception(
                                    "chunk failed; scalar fallback for "
                                    "this chunk only"
                                )
                                m.used_fallback = True
                                self._engine_failure("chunk-failed")
                                self._run_scalar(
                                    chunk, nodes, run_now, utils, m
                                )
                else:
                    self._run_batched(
                        window, nodes, running, utils, m,
                        ephemeral=eph_running,
                    )
                # backlog cycles amortize dispatch over many windows — a
                # different cost curve than the single-dispatch cycles
                # the scalar/device crossover model is about, so only
                # single-window cycles feed it
                if self._dispatch is not None and scalar_eligible and not backlog:
                    self._dispatch.observe(
                        True, cells, time.perf_counter() - t_path
                    )
            except Exception:
                log.exception(
                    "engine cycle failed; falling back to scalar path "
                    "(policy=%r; unsupported policies degrade to the "
                    "yoda formula and bump fallback_policy_mismatch)",
                    self.config.policy,
                )
                m.used_fallback = True
                self._engine_failure("engine-cycle-failed")
                self._invalidate_resident()
                self._run_scalar(window, nodes, running, utils, m)
                # a failed device cycle is a device observation priced at
                # its FULL cost: the failed attempt (timeout or fast
                # connect error) plus the scalar fallback that had to
                # run. Pricing only the time-to-exception would teach the
                # model that a fast-failing path is cheap and keep
                # routing to it; pricing nothing would never re-model a
                # degraded path at all.
                if self._dispatch is not None and scalar_eligible and not backlog:
                    self._dispatch.observe(
                        True, cells, time.perf_counter() - t_path
                    )
        else:
            m.used_fallback = True
            self._run_scalar(window, nodes, running, utils, m)
            if self._dispatch is not None and scalar_eligible and not backlog:
                self._dispatch.observe(
                    False, cells, time.perf_counter() - t_path
                )

    def _finish_cycle(
        self, start: _CycleStart, m: CycleMetrics, t0: float
    ) -> None:
        # successful binds clear their retry counters in ONE batch (the
        # native path pays one foreign call instead of one per bind);
        # the 404/409 drop path inside _bind still marks immediately
        if self._cycle_bound:
            self.queue.mark_scheduled_many(self._cycle_bound)
            if self.mirror is not None:
                # the assume-cache equivalent: this cycle's binds enter
                # the mirror as pod events NOW (every loop path —
                # device, backlog, scalar), so the next emit's delta
                # carries their rows; a later informer echo of the SAME
                # Pod object coalesces by identity in the mirror
                for pod in self._cycle_bound:
                    self.mirror.apply_pod_event("BOUND", pod)

        # PostFilter parity: unschedulable pods may preempt strictly-
        # lower-priority running pods (ops/preempt.py). A failure here
        # must never lose the cycle's bindings — preemptors are already
        # requeued and simply retry without preemption next cycle. On
        # the pipelined loop this runs in the COMPLETION stage, after
        # the engine result was forced and this cycle's binds applied —
        # preemption always sees real, never speculative, capacity.
        if (
            self._cycle_unsched
            and self.evictor is not None
            and self.config.preemption
        ):
            try:
                self._run_preemption(
                    self._cycle_unsched, start.nodes, start.running,
                    start.utils, m, ephemeral=start.eph_running,
                )
            except Exception:
                log.exception("preemption pass failed; retrying next cycle")
            if m.victims_evicted and self.config.resident_state:
                # evictions change the running set out-of-band of the
                # binding flow; flush the resident contract so the next
                # dispatch re-uploads in full rather than trusting a
                # delta base that predates the kills
                self._invalidate_resident()

        # resilience completion stage: breaker outcome + ladder
        # probe/promote climbs, BEFORE _record so the cycle journals
        # the rungs it actually ended on
        self._ladder_cycle_end(m)
        m.cycle_seconds = time.perf_counter() - t0
        self._record(m)
        seq = None
        if self.recorder is not None:
            # AFTER the cycle's own bookkeeping: journal serialization
            # time never inflates cycle_seconds, and the record carries
            # the final metrics. The seq is read BEFORE the append — the
            # value this cycle's record is journaled under, and the same
            # value the dispatch propagated to the sidecar.
            seq = self.recorder._seq
            dropped_before = self.recorder.records_dropped
            t_rec = time.perf_counter()
            self._record_trace(start, m)
            self._span("recorder_write", t_rec)
            if self.recorder.records_dropped != dropped_before:
                # the record was NOT journaled under the predicted seq —
                # the next cycle's record will own it. Omit the
                # cross-link rather than point at the wrong record (the
                # sidecar's copy of the prediction cannot be retracted).
                seq = None
        # watchdog AFTER the recorder (it logs the seq the cycle was
        # journaled under) and BEFORE the span flush (it reads the
        # cycle's trace id off the still-open span set) — all of it on
        # the completion stage, never the device-dispatch path
        self._check_slo(m, seq)
        self._flush_spans(t0, m, seq=seq)

    def _check_slo(self, m: CycleMetrics, seq: int | None) -> None:
        """Live SLO watchdog (config.cycle_slo_ms): a cycle over budget
        logs the handles that FIND it again — trace id (span timeline),
        flight-recorder seq (journal record) — increments
        slo_breaches_total{path}, and, with config.slo_profile_cycles
        set, self-arms the torch.profiler hook for the next N engine calls
        so the follow-up slow cycles leave a device-level profile dump
        beside the spans. Pure observation: never touches a decision,
        so watchdog-on/off bindings are bit-identical (PARITY.md)."""
        slo = self.config.cycle_slo_ms
        if slo <= 0 or m.pods_in == 0:
            return
        # the self-arm window drains one per watched cycle (~one engine
        # call each), approximating "the armed dumps were taken"
        if self._slo_profile_pending > 0:
            self._slo_profile_pending -= 1
        cycle_ms = m.cycle_seconds * 1e3
        if cycle_ms <= slo:
            return
        path = self._cycle_path(m)
        sp = self._cycle_span
        trace_id = sp.trace_id if sp is not None else None
        self.slo_breaches += 1
        self.ctr_slo.inc(path=path)
        armed = 0
        if self.config.slo_profile_cycles > 0 and self._slo_profile_pending <= 0:
            try:
                report = self.arm_profile(self.config.slo_profile_cycles)
                armed = int(report.get("armed", 0))
            except Exception:
                # the profiler is a bonus artifact; failing to arm it
                # must not cost the breach record (or the cycle)
                log.debug("slo: profile self-arm failed", exc_info=True)
            if armed > 0:
                self._slo_profile_pending = armed
        self.last_slo_breach = {
            "cycle_ms": round(cycle_ms, 3),
            "slo_ms": slo,
            "path": path,
            "trace_id": trace_id,
            "seq": seq,
            "pods_in": m.pods_in,
            "profile_armed": armed,
        }
        log.warning(
            "SLO breach: cycle took %.1f ms (budget %.1f ms, path=%s, "
            "pods_in=%d) trace_id=%s journal_seq=%s%s",
            cycle_ms, slo, path, m.pods_in,
            trace_id if trace_id is not None else "-",
            seq if seq is not None else "-",
            f"; armed profiler for next {armed} engine calls" if armed
            else "",
        )

    def _flush_spans(
        self, t0: float, m: CycleMetrics, seq: int | None = None
    ) -> None:
        """Close out the cycle's span set: add the whole-cycle span and
        hand it to the recorder for encoding + write (completion stage —
        the device dispatch never pays for serialization). `seq`
        cross-links every span to the cycle's flight-recorder record so
        a replayed cycle can be found in the timeline."""
        sp = self._cycle_span
        if sp is None:
            return
        self._cycle_span = None
        sp.add(
            "cycle",
            t0,
            time.perf_counter(),
            path=self._cycle_path(m),
            pods_in=m.pods_in,
            pods_bound=m.pods_bound,
        )
        self.spans.flush(sp, seq=seq)

    def _trace_fingerprint(self, start: _CycleStart) -> dict:
        """Config + layout identity summary riding every full record —
        enough for `trace stats`/`diff` to flag a replay against the
        wrong build or cluster shape, cheap enough to never matter."""
        c = self.config
        return {
            "policy": c.policy,
            "assigner": c.assigner,
            "normalizer": c.normalizer,
            "batch_window": c.batch_window,
            "resident_state": c.resident_state,
            "pipeline_depth": c.pipeline_depth,
            "nodes": len(start.nodes),
            "resource_columns": len(self.builder.resource_names),
            "selectors": len(self.builder.selectors),
        }

    def _record_trace(self, start: _CycleStart, m: CycleMetrics) -> None:
        """Append this cycle's journal record (config.trace_path). One
        clean device/backlog dispatch records in full (replayable);
        scalar cycles, failed dispatches, and the rare multi-dispatch
        degraded paths record decision/metrics only."""
        ctxs, self._trace_cycle = self._trace_cycle, []
        bindings = [
            (p.namespace, p.name, p.node_name) for p in self._cycle_bound
        ]
        node_names = [nd.name for nd in start.nodes]
        try:
            if len(ctxs) == 1 and ctxs[0].get("node_idx") is not None:
                ctx = ctxs[0]
                self.recorder.record_cycle(
                    path=ctx["path"],
                    metrics=m,
                    node_names=node_names,
                    pod_keys=[
                        (p.namespace, p.name) for p in ctx["window"]
                    ],
                    bindings=bindings,
                    snapshot=ctx["snapshot"],
                    delta=ctx.get("delta"),
                    delta_base=ctx.get("delta_base"),
                    pods=ctx["pods"],
                    engine_kw=ctx["kw"],
                    node_idx=ctx["node_idx"],
                    resident_epoch=ctx.get("epoch", 0),
                    delta_sent=bool(ctx.get("delta_sent")),
                    batch_window=ctx.get("batch_window", 0),
                    fingerprint=self._trace_fingerprint(start),
                )
            else:
                self.recorder.record_cycle(
                    path="mixed" if len(ctxs) > 1 else "scalar",
                    metrics=m,
                    node_names=node_names,
                    pod_keys=[(p.namespace, p.name) for p in start.window],
                    bindings=bindings,
                )
        except Exception:
            # the recorder is an observer: it must never cost a cycle —
            # but a cycle missing from the journal must still COUNT
            # (trace_records_dropped_total is the "journal is not the
            # whole story" signal `trace diff` readers check first)
            log.exception("trace: cycle record failed")
            self.recorder.records_dropped += 1

    # ---- pipelined loop (config.pipeline_depth >= 1) -------------------

    def _run_cycle_pipelined(self) -> CycleMetrics:
        """One cycle of the 1-deep pipeline: dispatch this cycle's
        engine call asynchronously, do next-cycle host work (window pop,
        record warming, speculative pod-batch build) while it is in
        flight, then force, validate, and bind. Non-device paths
        (scalar, deep backlog, fetch failure) run the serial back-end
        unchanged and flush any speculative state; an engine failure
        mid-flight drains the pipeline and falls back to scalar for this
        window exactly once; the preemption pass runs in the completion
        stage against real — never speculative — capacity."""
        return self.run_cycle_split().complete()

    def run_cycle_split(self) -> "_PendingCycle":
        """The dispatch half of a pipelined cycle as a first-class seam:
        begin the cycle, launch the engine call asynchronously, overlap
        the prefetch, and return a handle whose .complete() forces the
        result and finishes the cycle. run_cycle_split().complete() is
        exactly _run_cycle_pipelined().

        This is the fleet-shared-engine dispatch seam
        (host/engine_pool.SharedEnginePool): a round-robin fleet drain
        calls run_cycle_split() on EVERY replica before completing any,
        so all N windows sit in the pool's queue when the first force
        arrives and the round coalesces into one device invocation —
        deterministically, without relying on thread timing. Non-device
        paths (scalar, deep backlog, empty queue, dispatch failure)
        finish inside this call and return an already-completed handle.

        Between dispatch and complete() the scheduler must not start
        another cycle: builder/mirror state snapshotted at dispatch is
        what the in-flight call scores."""
        m = CycleMetrics()
        t0 = time.perf_counter()
        start = self._begin_cycle(m, t0, window=self._take_prefetched())
        if start is None:
            return _PendingCycle(self, m, None)
        if not (
            self.config.feature_gates.tpu_batch_score
            and start.nodes
            and start.use_device
            and not start.backlog
        ):
            # scalar and multi-window backlog cycles keep their serial
            # semantics; speculative state never survives into them
            self._discard_speculative(m)
            self._run_paths(start, m)
            self._finish_cycle(start, m, t0)
            return _PendingCycle(self, m, None)
        try:
            infl = self._dispatch_window(
                start.window, start.nodes, start.running, start.utils, m,
                ephemeral=start.eph_running, use_async=True,
            )
        except Exception:
            log.exception(
                "engine dispatch failed; falling back to scalar path "
                "(policy=%r; unsupported policies degrade to the yoda "
                "formula and bump fallback_policy_mismatch)",
                self.config.policy,
            )
            m.used_fallback = True
            self._engine_failure("engine-dispatch-failed")
            self._invalidate_resident()
            self._discard_speculative(m)
            self._run_scalar(
                start.window, start.nodes, start.running, start.utils, m
            )
            self._observe_dispatch(start, m)
            self._finish_cycle(start, m, t0)
            return _PendingCycle(self, m, None)
        # overlap: next-cycle host work while the engine runs — this is
        # the serialized host time the strictly alternating loop paid
        # on the critical path (BENCH_r05: ~65 ms of a 168 ms cycle)
        t_prep = time.perf_counter()
        self._prefetch_next()
        m.host_overlap_seconds = time.perf_counter() - t_prep
        self._span("host_overlap", t_prep, t_prep + m.host_overlap_seconds)
        return _PendingCycle(self, m, (start, infl, t0))

    def _complete_cycle_split(self, m, start, infl, t0) -> CycleMetrics:
        """The force half of run_cycle_split (shared with the inline
        pipelined loop through _PendingCycle.complete)."""
        try:
            self._complete_window(
                infl, start.window, start.nodes, m,
                ephemeral=start.eph_running,
            )
            self._observe_dispatch(start, m)
        except Exception:
            log.exception(
                "engine cycle failed; draining pipeline and falling back "
                "to scalar path (policy=%r; unsupported policies degrade "
                "to the yoda formula and bump fallback_policy_mismatch)",
                self.config.policy,
            )
            m.used_fallback = True
            self._engine_failure("engine-force-failed")
            self._invalidate_resident()
            self._discard_speculative(m)
            self._run_scalar(
                start.window, start.nodes, start.running, start.utils, m
            )
            # failed device cycle priced at FULL cost — same rationale
            # as the serial fallback's observation
            self._observe_dispatch(start, m)
        self._finish_cycle(start, m, t0)
        return m

    def _observe_dispatch(self, start: _CycleStart, m: CycleMetrics) -> None:
        """Adaptive-crossover observation for a pipelined device cycle
        (single-window by construction; the serial back-end keeps its
        own inline observations)."""
        if self._dispatch is not None and start.scalar_eligible:
            self._dispatch.observe(
                True, start.cells, time.perf_counter() - start.t_path
            )

    def _layout_fingerprint(self) -> tuple:
        """Everything a prebuilt PodBatch depends on besides the window
        itself: column layout, selector-table size, node set (target_node
        indices), port mapping, image vocabulary. The speculative batch
        built while the engine is in flight is used at dispatch time only
        if this fingerprint still matches — an informer event in between
        (node add/remove, selector-minting churn) discards it, forcing a
        serial rebuild so a stale snapshot is never scored."""
        b = self.builder
        sc = b.__dict__.get("_node_static")
        return (
            b.resource_names_tuple(),
            len(b.selectors),
            sc["ids"] if sc is not None else None,
            tuple(sorted(b._port_index.items())),
            len(b.images),
        )

    def _take_prefetched(self) -> list[Pod] | None:
        w = self._prefetched
        self._prefetched = None
        return w

    def _discard_speculative(self, m: CycleMetrics) -> None:
        """Flush the speculative pod batch (never the prefetched WINDOW
        — those are real popped pods and dispatch next cycle on whatever
        path then applies)."""
        if self._spec_batch is not None:
            self._spec_batch = None
            m.pipeline_flushes += 1

    def drain_pipeline(self) -> None:
        """Hand a prefetched-but-undispatched window back to the queue
        (front, exact order on the Python queue) and drop speculative
        state. Call when abandoning the scheduler mid-backlog so
        len(queue) reflects reality and a restart reschedules the pods;
        run_cycle/run_until_empty drain naturally otherwise."""
        self._spec_batch = None
        w = self._prefetched
        self._prefetched = None
        if w:
            self.queue.restore_window(w)

    def _prefetch_next(self) -> None:
        """Host work overlapped with the in-flight engine call: pop the
        next window, warm its per-pod records/flags, and pre-build its
        pod batch. The batch is speculative — kept at dispatch time only
        if the layout fingerprint still matches.

        Skipped entirely at zero backoff: a requeue from THIS cycle
        could then legally re-enter the very next window, and a
        prefetched pop would misorder it against serial mode (with the
        default >= 1 s backoff, a requeued pod is never ready within one
        cycle's flight time)."""
        if self._prefetched is not None:
            return
        if self.config.initial_backoff_seconds <= 0:
            return
        window = self.queue.pop_window(self._window_cap())
        if not window:
            return
        self._prefetched = window
        if len(window) > self.config.batch_window:
            return  # backlog windows take the serial multi-window path
        try:
            self._window_flags(window)  # warms records + the flag cache
            batch = self.builder.build_pod_batch(
                window, recs=self._window_recs(window)
            )
            fp = self._layout_fingerprint()
        except Exception:
            # e.g. a hostPort outside the table (build_snapshot has not
            # seen this window yet): the serial build at dispatch time
            # surfaces it inside the cycle's normal error handling
            log.debug("speculative pod-batch build failed; will rebuild")
            return
        self._spec_batch = (window, fp, batch)

    def _dispatch_window(
        self, window, nodes, running, utils, m: CycleMetrics,
        *, ephemeral: bool, use_async: bool,
    ) -> _InFlight:
        """Build the snapshot, adopt or rebuild the pod batch, dispatch
        the engine — ONE implementation for the serial path (use_async=
        False: synchronous call, forced in _complete_window right after)
        and the pipelined path (use_async=True: the call goes out
        unforced so host work can overlap it).

        Snapshot FIRST: build_snapshot registers every selector the
        cycle needs — the window's terms AND running pods' anti terms
        (reverse anti-affinity) — so build_pod_batch computes
        pod_matches against the complete table. Reversed, a selector
        first introduced by a running avoider would be missing from
        pod_matches and the reverse check would silently pass. (The
        speculative prebuild respects this through the layout
        fingerprint: a selector minted between prebuild and here
        discards the prebuilt batch.)"""
        snapshot, mirror_delta = self._cycle_snapshot(
            window, nodes, running, utils, ephemeral=ephemeral
        )
        pods_batch = None
        spec = self._spec_batch
        if spec is not None and spec[0] is window:
            self._spec_batch = None
            if spec[1] == self._layout_fingerprint():
                pods_batch = spec[2]
            else:
                # informer/selector churn since the prebuild: the batch
                # could carry stale selector ids, node indices, or port
                # columns — never score it
                m.pipeline_flushes += 1
        if pods_batch is None:
            pods_batch = self.builder.build_pod_batch(
                window, recs=self._window_recs(window)
            )
        kw = self._engine_options(
            window, nodes, running, pods_batch, snapshot,
            record=not ephemeral,
        )
        self._set_engine_trace_id()
        tctx = None
        if self.recorder is not None:
            # references only — serialization happens in _finish_cycle,
            # after the force, off the dispatch path
            tctx = {
                "path": "device", "window": window, "snapshot": snapshot,
                "pods": pods_batch, "kw": kw,
            }
            self._trace_cycle.append(tctx)
        infl = self._dispatch_resident(
            snapshot, pods_batch, kw, ephemeral=ephemeral, use_async=use_async,
            tctx=tctx, mirror_delta=mirror_delta,
        )
        if infl is not None:
            infl.trace_ctx = tctx
            return infl
        t_eng = time.perf_counter()
        submit = (
            getattr(self.engine, "schedule_batch_async", None)
            if use_async
            else None
        )
        if submit is not None:
            handle = submit(snapshot, pods_batch, **kw)
        else:
            # serial mode, and engines without the async surface:
            # synchronous dispatch (the pipeline still interleaves
            # correctly around it, with no overlap)
            from kubernetes_scheduler_tpu_torch.engine import PendingSchedule

            handle = PendingSchedule(
                self.engine.schedule_batch(snapshot, pods_batch, **kw)
            )
        return _InFlight(
            handle=handle, pods_batch=pods_batch, t_eng=t_eng, trace_ctx=tctx,
        )

    def _set_engine_trace_id(self) -> None:
        """Hand the cycle's trace id + predicted flight-recorder seq to
        the engine before dispatch: RemoteEngine ships them as gRPC
        metadata (sidecar spans join the host timeline on the id), a
        local engine names on-demand profile dumps with them. One
        getattr when spans are off."""
        sp = self._cycle_span
        if sp is None:
            return
        setter = getattr(self.engine, "set_trace_id", None)
        if setter is not None:
            setter(
                sp.trace_id,
                self.recorder._seq if self.recorder is not None else -1,
            )

    def _dispatch_resident(
        self, snapshot, pods_batch, kw, *, ephemeral: bool, use_async: bool,
        tctx: dict | None = None, mirror_delta=None,
    ) -> "_InFlight | None":
        """Resident-state dispatch (config.resident_state): ship a
        SnapshotDelta against the engine-retained snapshot when the
        cycle-over-cycle change is delta-expressible, a tagged full
        upload otherwise. Returns None when the resident path does not
        apply (knob off, engine without the surface, ephemeral builds —
        a throwaway reservation-concatenated snapshot must never become
        the delta base) and the caller runs the ordinary dispatch.

        The full snapshot always accompanies a delta down the engine
        surface, so an epoch/shape mismatch degrades to a full upload
        INSIDE the call (local: transparently; remote: INVALID_ARGUMENT
        resend) and never costs the cycle."""
        if not self.config.resident_state or ephemeral:
            return None
        supports = getattr(self.engine, "supports_resident", None)
        if supports is None or not supports():
            return None
        delta, epoch, saved = self._derive_resident_delta(
            snapshot, tctx, mirror_delta=mirror_delta
        )
        t_eng = time.perf_counter()
        submit = (
            getattr(self.engine, "schedule_resident_async", None)
            if use_async
            else None
        )
        if submit is not None:
            handle = submit(snapshot, pods_batch, delta=delta, epoch=epoch, **kw)
        else:
            from kubernetes_scheduler_tpu_torch.engine import PendingSchedule

            handle = PendingSchedule(
                self.engine.schedule_resident(
                    snapshot, pods_batch, delta=delta, epoch=epoch, **kw
                )
            )
        # optimistic commit: the dispatched snapshot is the next delta
        # base. A failure before the result forces flips _resident_ok
        # False (the completion/fallback paths call
        # _invalidate_resident), flushing the next cycle to full.
        self._commit_resident(snapshot, epoch)
        return _InFlight(
            handle=handle, pods_batch=pods_batch, t_eng=t_eng,
            resident=True, delta_sent=delta is not None,
            delta_bytes_saved=saved, trace_ctx=tctx,
        )

    def _invalidate_resident(self) -> None:
        """Flush the resident-state contract: the next resident dispatch
        uploads in full (engine failure, preemption, epoch desync)."""
        if self.config.resident_state:
            # ladder: resident -> full until a delta applies again
            self.ladder.demote(
                "resident", reason="resident-flush",
                seq=self.totals["cycles"],
            )
        self._resident_ok = False
        self._resident_prev = None
        inval = getattr(self.engine, "invalidate_resident", None)
        if inval is not None:
            try:
                inval()
            except Exception:
                log.debug("engine invalidate_resident failed", exc_info=True)

    def _complete_window(
        self, infl: _InFlight, window, nodes, m: CycleMetrics,
        *, ephemeral: bool,
    ) -> None:
        """Force the (possibly in-flight) result, validate (BEFORE any
        bind, so the scalar fallback re-schedules the window exactly
        once), apply assignments, and fold the binds into the snapshot
        accumulator. Shared by the serial and pipelined paths — the
        validation and bind semantics cannot drift between them."""
        res = infl.handle.result()
        idx = to_host(res.node_idx)
        t_done = time.perf_counter()
        m.engine_seconds += t_done - infl.t_eng
        self._span(
            "engine_step", infl.t_eng, t_done,
            resident=infl.resident, delta=infl.delta_sent,
        )
        if infl.resident:
            # attribute AFTER the force: the engine reports whether the
            # delta actually applied or it degraded to a full upload
            # (epoch/shape mismatch) inside the call
            self._account_resident(m, infl.delta_sent, infl.delta_bytes_saved)
        p_padded = int(np.asarray(infl.pods_batch.request).shape[0])
        if (
            idx.shape != (p_padded,)
            or p_padded < len(window)
            or (idx[: len(window)] >= len(nodes)).any()
        ):
            raise RuntimeError(
                f"engine returned node_idx shape {idx.shape} (max "
                f"{idx.max() if idx.size else 'n/a'}) for a {len(window)}-pod "
                f"window padded to {p_padded} over {len(nodes)} nodes"
            )
        if infl.trace_ctx is not None:
            # the replay comparison target: engine decisions over the
            # real window rows (copy — idx may view an engine buffer)
            infl.trace_ctx["node_idx"] = self._trace_node_idx(
                infl.pods_batch, idx, len(window)
            )
        pre = len(self._cycle_bound)
        t_bind = time.perf_counter()
        self._apply_assignments(window, nodes, idx, m)
        self._span("bind", t_bind)
        bound = self._cycle_bound[pre:]
        if bound and not ephemeral:
            # incremental snapshot carry: fold this cycle's binds into
            # the builder's accumulated `requested` matrix now (one
            # vectorized scatter-add), so the next dispatch's build
            # skips re-walking them when the informer appends these pods
            try:
                if (
                    len(bound) == len(window)
                    and bound[0] is window[0]
                    and bound[-1] is window[-1]
                ):
                    # every pod bound in window order (the steady-state
                    # drain shape): rows are the identity — skip the
                    # 8k-entry id map
                    rows = np.arange(len(window))
                else:
                    pos = {id(pod): i for i, pod in enumerate(window)}
                    rows = [pos[id(pod)] for pod in bound]
                self.builder.apply_assignment_deltas(
                    bound, idx[rows], np.asarray(infl.pods_batch.request)[rows]
                )
            except Exception:
                # the delta is an optimization: on any surprise the next
                # build's suffix scan recomputes from scratch
                log.exception("assignment-delta fold failed; next build rescans")

    def _trace_node_idx(self, pods_batch, idx, n: int) -> np.ndarray:
        """The journaled node_idx over the real window rows, with the
        gang mask applied: against a gang-capable engine this is the
        identity (sentinels already present), but a gang-blind engine
        (capability-downgraded sidecar, mesh-sharded path) replies with
        RAW placements — recording those would make the journal
        unreplayable (local replay re-masks and diffs). The np mirror
        is test-pinned bitwise-equal to the device op, so the recorded
        vector is exactly what any gang-capable replay produces."""
        out = np.array(np.asarray(idx).reshape(-1)[:n], np.int32)
        if self.config.gang_scheduling:
            from kubernetes_scheduler_tpu_torch.ops.gang import (
                mask_partial_gangs_np,
            )

            gid = np.asarray(pods_batch.gang_id).reshape(-1)[:n]
            if (gid >= 0).any():
                out, _ = mask_partial_gangs_np(
                    gid,
                    np.asarray(pods_batch.gang_size).reshape(-1)[:n],
                    out,
                )
        return out

    def _pdb_expected_count(self, matching: list[Pod]) -> int | None:
        """The upstream disruption controller's expected count for
        percentage budgets: the summed spec.replicas of the DISTINCT
        controllers owning the matching pods (via ownerReferences).
        None — the documented current-count fallback — when there is no
        resolver, any pod is controller-less, or a controller is
        unknown to the informer."""
        if self.controller_replicas is None or not matching:
            return None
        owners: set[tuple] = set()
        for pd in matching:
            if pd.owner is None:
                return None
            owners.add((pd.owner[0], pd.namespace, pd.owner[1]))
        total = 0
        for kind, ns, name in owners:
            replicas = self.controller_replicas(kind, ns, name)
            if replicas is None:
                return None
            total += replicas
        return total

    def _run_preemption(
        self, pods, nodes, running, utils, m: CycleMetrics,
        *, ephemeral: bool = False,
    ):
        """Select and evict victims for this cycle's unschedulable pods.

        Device pass (ops/preempt.py) proposes (node, victims) per
        preemptor; the host applies proposals in priority order, one
        preemptor per node per cycle (two proposals for one node were
        each computed assuming the other's victims still hold capacity).
        Victims are evicted through self.evictor; the preemptor is
        already requeued and binds on a later cycle once the victims'
        capacity is actually released — upstream's nominated-node flow
        has the same asynchrony (preemption never binds in-cycle).
        """
        from kubernetes_scheduler_tpu_torch.ops.preempt import VictimArrays

        k_cap = self.config.preemption_max_victims
        if k_cap <= 0 or not nodes:
            return
        cap = self.config.preemption_max_candidates
        if cap > 0 and len(pods) > cap:
            # highest-priority preemptors first; the rest retry next
            # cycle (the device pass's candidate tensors scale with the
            # preemptor count, and only one proposal lands per node per
            # cycle anyway)
            pods = sorted(pods, key=pod_priority, reverse=True)[:cap]
        # THIS cycle's bindings must be part of the capacity model: the
        # `running` list was read before they happened, and a preemption
        # computed against pre-bind free capacity can kill victims for a
        # preemptor that still won't fit (upstream simulates PostFilter
        # against the assume-cache for the same reason)
        if self._cycle_bound:
            running = running + self._cycle_bound
        if not running:
            return
        # drop eviction records whose victim has actually terminated;
        # a still-terminating victim keeps occupying snapshot capacity
        # (it is in `running`) and is excluded from the victim tables
        # below, so its node is naturally unattractive — no explicit
        # node blocking needed
        live_keys = {_pod_key(pd) for pd in running}
        self._pending_evictions = {
            k: v for k, v in self._pending_evictions.items() if k in live_keys
        }
        # snapshot with requests zeroed: compute_feasibility's resource
        # term then checks against FULL allocatable — "could this pod
        # ever fit here after evictions" — while every other constraint
        # family applies unchanged (see ops/preempt.py for the
        # documented affinity-recheck deviation)
        # ephemeral: when this cycle bound pods (or held nomination
        # reservations), `running` here is a
        # throwaway concatenation — recording it would clobber the
        # steady-state prefix caches the main cycle build relies on,
        # silently re-enabling full O(running) rescans every cycle in
        # exactly the saturated regime preemption runs in
        snapshot = self.builder.build_snapshot(
            nodes, utils, running, pending_pods=pods,
            ephemeral=bool(self._cycle_bound) or ephemeral,
        )
        pend = self.builder.build_pod_batch(pods)
        vics = self.builder.build_pod_batch(running)
        # PodDisruptionBudgets: preemption NEVER violates one (stricter
        # than upstream's last-resort violation ordering — documented in
        # ops/preempt.py). Victims under an exhausted budget are excluded
        # from the tables; remaining budgets cap the apply loop below.
        pdbs = list(self.list_pdbs()) if self.list_pdbs is not None else []
        budgets: list[int] = []
        victim_budgets: dict[int, list[int]] = {}
        if pdbs:
            real = [
                pd for pd in running
                # neither nomination reservations (not real pods) nor
                # terminating victims (already being disrupted) count as
                # healthy — otherwise consecutive cycles each see the
                # full count and re-spend the same disruption budget
                if _pod_key(pd) not in self._nominations
                and _pod_key(pd) not in self._pending_evictions
            ]
            for pdb in pdbs:
                matching = [pd for pd in real if pdb.selects(pd)]
                allowed = pdb.allowed(
                    len(matching),
                    expected_count=self._pdb_expected_count(matching),
                )
                if pdb.disruptions_allowed is not None:
                    # the server-computed status predates our in-flight
                    # evictions (informer/TTL lag): a victim still
                    # terminating must be charged against it, or two
                    # consecutive cycles spend the same budget (ADVICE
                    # r3). The spec-math path needs no correction — its
                    # healthy count (`real`) already excludes
                    # pending-eviction victims.
                    pending_matching = sum(
                        1
                        for pd in running
                        if _pod_key(pd) in self._pending_evictions
                        and pdb.selects(pd)
                    )
                    allowed = max(0, allowed - pending_matching)
                budgets.append(allowed)
            for i, pd in enumerate(running):
                sel = [b for b, pdb in enumerate(pdbs) if pdb.selects(pd)]
                if sel:
                    victim_budgets[i] = sel
        node_index = {nd.name: j for j, nd in enumerate(nodes)}
        m_slots = np.asarray(vics.request).shape[0]
        vnode = np.full(m_slots, -1, np.int32)
        # relative start seconds (int32-safe): later = less important =
        # evicted first among equal priority; a pod without
        # status.startTime counts as just-started (upstream
        # GetPodStartTime's nil-means-now)
        starts = [pd.start_time for pd in running if pd.start_time is not None]
        base = min(starts) if starts else 0.0
        vstart = np.full(m_slots, 2**30, np.int32)
        for i, pd in enumerate(running):
            if pd.start_time is not None:
                vstart[i] = int(min(pd.start_time - base, 2**30 - 1))
        for i, pd in enumerate(running):
            key = _pod_key(pd)
            # terminating victims and nomination reservations occupy
            # capacity but are not evictable (a reservation is not a
            # real pod; a terminating victim is already dying)
            if key in self._pending_evictions or key in self._nominations:
                continue
            if any(budgets[b] <= 0 for b in victim_budgets.get(i, ())):
                continue  # an exhausted budget protects this victim
            vnode[i] = node_index.get(pd.node_name, -1)
        # victim selector data for the RemovePod re-simulation
        # (ops/preempt.affinity_after_evictions): matches = the victims'
        # pod_matches rows; anti = one-hot union of their REQUIRED anti
        # terms. Column count pinned to the SNAPSHOT's selector axis —
        # building the victim batch can mint selector ids the snapshot
        # tables never saw (running pods' required attract terms), and
        # no pending pod references those.
        s_cols = int(np.asarray(snapshot.domain_counts).shape[1])
        vmatches = np.zeros((m_slots, s_cols), bool)
        vanti = np.zeros((m_slots, s_cols), bool)
        pm = np.asarray(vics.pod_matches)
        take = min(s_cols, pm.shape[1])
        vmatches[:, :take] = pm[: m_slots, :take]
        asel = np.asarray(vics.anti_affinity_sel)
        rows, cols = np.nonzero((asel >= 0) & (asel < s_cols))
        vanti[rows, asel[rows, cols]] = True
        victims = VictimArrays(
            node=vnode,
            prio=vics.priority,
            req=vics.request,
            mask=vics.pod_mask,
            start=vstart,
            matches=vmatches,
            anti=vanti,
        )
        # the pass runs on the engine — on a bridged deployment that is
        # the sidecar's Preempt RPC, keeping PostFilter on the compute
        # side of the bridge like every other phase; a version-skewed or
        # unreachable sidecar degrades to the in-host evaluation (the
        # same pass on CPU tensors), never to no-preemption
        res = None
        # breaker state() (never allow()): preemption must not consume
        # the half-open recovery probe the next cycle's schedule
        # dispatch is entitled to — while the breaker is anything but
        # closed, the pass runs in-host outright
        if hasattr(self.engine, "preempt") and (
            self.engine_breaker.state() == "closed"
        ):
            try:
                res = self.engine.preempt(snapshot, pend, victims, k_cap=k_cap)
            except NotImplementedError:
                log.warning(
                    "engine lacks the Preempt surface; running the "
                    "preemption pass in-host"
                )
            except Exception:
                log.exception(
                    "engine preemption pass failed; running in-host"
                )
                if not self._engine_owns_breaker:
                    # a shared client breaker already recorded the
                    # terminal outcome inside the call (same guard as
                    # _engine_failure — double-feeding would count one
                    # outage twice toward the threshold)
                    self.engine_breaker.record_failure()
        if res is None:
            from kubernetes_scheduler_tpu_torch.engine import preempt_on_host

            res = preempt_on_host(snapshot, pend, victims, k_cap=k_cap)
        # the pass's one device-to-host read: node and victims together
        chosen_node, victim_ids = to_host(res.node, res.victims)
        prio = np.asarray(pend.priority)
        order = sorted(range(len(pods)), key=lambda i: (-int(prio[i]), i))
        claimed_nodes: set[int] = set()
        ttl = self.config.preemption_nomination_ttl_seconds
        for i in order:
            j = int(chosen_node[i])
            if (
                j < 0
                or j >= len(nodes)
                or j in claimed_nodes
                or _pod_key(pods[i]) in self._nominations
            ):
                continue
            claimed_nodes.add(j)
            vset = [int(v) for v in victim_ids[i] if 0 <= int(v) < len(running)]
            # a proposal that would overdraw any disruption budget is
            # skipped whole (never partially violate): the preemptor
            # retries next cycle against recomputed budgets
            if victim_budgets:
                need: dict[int, int] = {}
                for v in vset:
                    for b in victim_budgets.get(v, ()):
                        need[b] = need.get(b, 0) + 1
                if any(budgets[b] < k for b, k in need.items()):
                    continue
            n_evicted = 0
            for v in vset:
                try:
                    self.evictor.evict(running[v], preemptor=pods[i])
                except Exception:
                    # partial proposal: victims already deleted are
                    # tracked below either way; stop killing more for a
                    # proposal that may no longer complete
                    log.exception(
                        "evicting %s for %s failed; abandoning the rest "
                        "of this proposal",
                        running[v].name, pods[i].name,
                    )
                    break
                self._pending_evictions[_pod_key(running[v])] = nodes[j].name
                for b in victim_budgets.get(v, ()):
                    budgets[b] -= 1
                n_evicted += 1
            if n_evicted:
                # the nomination must be recorded even for a PARTIAL
                # eviction round: capacity was destroyed on this node
                # for this preemptor, and an un-nominated preemptor
                # would evict again elsewhere next cycle
                self._nominations[_pod_key(pods[i])] = (
                    nodes[j].name, pods[i], time.monotonic() + ttl,
                )
                m.pods_preempted += 1
                m.victims_evicted += n_evicted
                log.info(
                    "preempting %d pod(s) on %s for %s",
                    n_evicted, nodes[j].name, pods[i].name,
                )

    # ---- gang co-scheduling (config.gang_scheduling; ops/gang.py) ------

    def _window_gang_groups(self, window) -> dict:
        """gang key -> [declared size, member row indices] over a
        window. Empty for gang-free traffic (one memoized label probe
        per pod — the cost profile of the existing flag scans).
        Members declaring inconsistent sizes (malformed labels) take
        the MAX: the conservative all-or-nothing reading."""
        groups: dict[str, list] = {}
        for i, pod in enumerate(window):
            g = pod_gang(pod)
            if g is not None:
                ent = groups.get(g[0])
                if ent is None:
                    groups[g[0]] = ent = [g[1], []]
                elif g[1] > ent[0]:
                    ent[0] = g[1]
                ent[1].append(i)
        return groups

    def _gang_screen(self, window: list, m: CycleMetrics) -> list:
        """Pre-dispatch gang admission control: defer gangs that cannot
        possibly bind this cycle (members missing from the window, or a
        declared size no window can hold), and keep gangs from
        STRADDLING a stacked-window stride (each scan step checks
        completeness against its own window, so a boundary-crossing
        gang would always read as partial) — stride-aligned gangs ride
        the deep multi-window dispatch untouched. Returns the window to
        dispatch."""
        groups = self._window_gang_groups(window)
        if not groups:
            return window
        drop: set[int] = set()
        for key, (size, rows) in groups.items():
            if len(rows) >= size and size <= self.config.batch_window:
                continue
            drop.update(rows)
            self._defer_gang(key, size, [window[i] for i in rows], m)
        if drop:
            window = [pd for i, pd in enumerate(window) if i not in drop]
        bw = self.config.batch_window
        if len(window) > bw:
            # deep pop: a gang fully inside ONE stacked-window stride is
            # fine (each scan step applies its own all-or-nothing mask),
            # but a gang STRADDLING a stride boundary would always read
            # as partial in both strides. Cut the pop at the first
            # straddling gang's first member (pulling in any gang a
            # naive cut would itself split) and hand the suffix back —
            # gang-free deep backlogs and stride-aligned gangs keep the
            # full multi-window dispatch.
            groups = self._window_gang_groups(window)
            straddle = [
                rows[0]
                for _, rows in groups.values()
                if rows[0] // bw != rows[-1] // bw
            ]
            if straddle:
                cut = min(straddle)
                while True:
                    new_cut = min(
                        (
                            rows[0]
                            for _, rows in groups.values()
                            if rows[-1] >= cut
                        ),
                        default=cut,
                    )
                    if new_cut == cut:
                        break
                    cut = new_cut
                if cut > 0:
                    self.queue.restore_window(window[cut:])
                    window = window[:cut]
                else:
                    # the straddling gang starts at row 0: a prefix cut
                    # cannot make progress. Trim to one stride instead,
                    # moving any stride-crossing gang out whole — the
                    # head gangs then schedule in a single window and
                    # the tail leads the next pop.
                    move = {
                        key
                        for key, (_, rows) in groups.items()
                        if rows[-1] >= bw
                    }
                    kept, restored = [], []
                    for i, pd in enumerate(window):
                        g = pod_gang(pd)
                        if i >= bw or (g is not None and g[0] in move):
                            restored.append(pd)
                        else:
                            kept.append(pd)
                    self.queue.restore_window(restored)
                    window = kept
        return window

    def _defer_gang(
        self, key: str, size: int, members: list, m: CycleMetrics,
        *, masked: int = 0,
    ) -> None:
        """All-or-nothing deferral: the whole gang returns to the queue
        as a unit. Within the defer budget it goes back to the FRONT
        (queue.restore_window — order preserved, re-pops next cycle,
        picking up members that arrive in between). A gang that exhausts
        config.gang_max_defers — or could never fit a window — resolves
        per config.gang_defer_policy: "split" drops the gang identity
        (members schedule as individuals), "drop" keeps it and retries
        all-or-nothing at ordinary backoff cadence."""
        m.gangs_deferred += 1
        m.gang_pods_masked += masked
        n = self._gang_defers.get(key, 0) + 1
        oversize = size > self.config.batch_window
        if oversize or n > self.config.gang_max_defers:
            self._gang_defers.pop(key, None)
            split = oversize or self.config.gang_defer_policy == "split"
            if split:
                for pod in members:
                    break_gang(pod)
            log.warning(
                "gang %s (%d/%d members) %s after %d deferral(s)%s",
                key, len(members), size,
                "split into individuals" if split else "dropped to backoff",
                n,
                " (gang larger than any window)" if oversize else "",
            )
            for pod in members:
                self.queue.requeue_unschedulable(pod)
            m.pods_unschedulable += len(members)
            return
        self._gang_defers[key] = n
        # atomic requeue, matched to the queue's restore semantics so
        # serial and pipelined pop orders stay identical per queue type:
        # - front-restoring queue (pure Python): hand the prefetched
        #   window back FIRST, then the gang — the next pop yields
        #   gang + prefetched pods exactly as serial would have popped
        #   them (newest restore wins the front);
        # - back-restoring queue (native heap): KEEP the prefetch — the
        #   gang goes behind the waiting pods on both loops, and
        #   flushing the prefetch would re-push it behind pods the
        #   serial loop pops later.
        if getattr(self.queue, "RESTORES_TO_FRONT", False):
            pf = self._take_prefetched()
            if pf is not None:
                self._discard_speculative(m)
                self.queue.restore_window(pf)
        self.queue.restore_window(members)

    def _resolve_gangs(self, window, idx, m: CycleMetrics):
        """Post-result gang resolution: bind fully-placed gangs, defer
        the rest as units. The host-side all-or-nothing BACKSTOP is
        ops.gang.mask_partial_gangs_np — the numpy mirror test-pinned
        bitwise-equal to the device op — applied to EVERY reply:
        against a gang-capable engine it is the identity (the device
        already rescinded partial placements, sentinels <= -2); against
        a gang-blind one (old sidecar after a capability downgrade, the
        mesh-sharded fast path) it produces the same masked vector, so
        no partial gang can ever reach mark_scheduled on ANY path.
        Admission mirrors the device rule exactly: assigned-member
        count >= declared size (an over-submitted gang's surplus
        members fall through to the ordinary requeue loop).
        Returns the (window, idx) remainder for the ordinary bind loop."""
        from kubernetes_scheduler_tpu_torch.ops.gang import (
            GANG_MASKED_BASE,
            mask_partial_gangs_np,
        )

        groups = self._window_gang_groups(window)
        if not groups:
            return window, idx
        n_win = len(window)
        gang_id = np.full(n_win, -1, np.int32)
        gang_size = np.zeros(n_win, np.int32)
        for slot, (size, rows) in enumerate(groups.values()):
            gang_id[rows] = slot
            gang_size[rows] = size
        idx, _ = mask_partial_gangs_np(
            gang_id, gang_size, np.asarray(idx)[:n_win]
        )
        drop: set[int] = set()
        for key, (size, rows) in groups.items():
            got = idx[rows]
            if int((got >= 0).sum()) >= size > 0:
                m.gangs_admitted += 1
                self._gang_defers.pop(key, None)
                continue
            drop.update(rows)
            self._defer_gang(
                key, size, [window[i] for i in rows], m,
                masked=int((got <= GANG_MASKED_BASE).sum()),
            )
        if drop:
            keep = [i for i in range(n_win) if i not in drop]
            window = [window[i] for i in keep]
            idx = idx[keep]
        return window, idx

    def _nomination_reservations(self, window) -> list[Pod]:
        """Virtual running pods holding nominated capacity (see
        run_cycle). Prunes expired nominations; a nomination is also
        dropped when its preemptor binds (Scheduler._bind)."""
        import dataclasses

        now = time.monotonic()
        self._nominations = {
            k: v for k, v in self._nominations.items() if v[2] > now
        }
        if not self._nominations:
            return []
        in_window = {_pod_key(pd) for pd in window}
        return [
            dataclasses.replace(pod, node_name=node)
            for key, (node, pod, _) in self._nominations.items()
            if key not in in_window
        ]

    def _running_features(self, running, *, record: bool = True) -> tuple[bool, bool]:
        """(any pod with (anti)affinity terms, any PREFERRED term) over
        the running set, with a prefix-identity cache: the cluster source
        passes the SAME append-only list cycle after cycle, so only pods
        added since the last probe are walked (two O(running) scans per
        cycle otherwise — a visible cost at 20k+ running pods). A rebuilt
        or shrunk list falls back to a full scan.

        record=False probes without storing the prefix record — for
        throwaway concatenations (nomination reservations, per-chunk
        running + cycle_bound): recording those would evict the
        steady-state record and force a full rescan next cycle (the same
        rule as the snapshot builder's ephemeral=True)."""
        rf = self.__dict__.get("_run_feat")
        start = suffix_start(rf[0] if rf else None, running)
        any_aff, any_pref = (rf[1], rf[2]) if start else (False, False)
        if start < len(running):
            for pd in running[start:]:
                fl = pd.__dict__.get("_flags_cache")
                if fl is not None and fl & _FLAG_PLAIN:
                    continue  # plain pods carry no pod_affinity terms
                pa = pd.pod_affinity
                if pa:
                    any_aff = True
                    if not any_pref and any(t.preferred for t in pa):
                        any_pref = True
            if record:
                self.__dict__["_run_feat"] = (
                    suffix_record(running), any_aff, any_pref,
                )
        return any_aff, any_pref

    def _window_flags(self, window) -> tuple[bool, bool]:
        """(every pod FLAG_PLAIN, any pod FLAG_SOFT) over the window,
        computed in ONE pass and identity-cached on the window list:
        _scalar_sufficient and _engine_options otherwise each ran their
        own full-window flag scan per cycle (~13ms each at 8k pods).

        The pass assembles the window's batch records (warmed at submit)
        and reduces their packed flag column vectorized; the records are
        kept for build_pod_batch so the window is only walked once."""
        wf = self.__dict__.get("_wflags")
        if wf is not None and wf[0] is window:
            return wf[1], wf[2]
        if not window:
            res = (window, True, False)
        else:
            names_t = self.builder.resource_names_tuple()
            recs = [
                rc
                if (rc := pd.__dict__.get("_batch_rec_cache")) is not None
                and rc[0] is names_t
                else pod_batch_record(pd, names_t)
                for pd in window
            ]
            flags = np.frombuffer(
                b"".join([rc[7] for rc in recs]), _SCAL_DT
            )["fl"]
            res = (
                window,
                bool(((flags & _FLAG_PLAIN) != 0).all()),
                bool((flags & _FLAG_SOFT).any()),
            )
            self.__dict__["_wrecs"] = (window, recs)
        self.__dict__["_wflags"] = res
        return res[1], res[2]

    def _window_recs(self, window):
        """The batch records _window_flags assembled for this window, or
        None when a different window was flagged last."""
        wr = self.__dict__.get("_wrecs")
        return wr[1] if wr is not None and wr[0] is window else None

    def _scalar_sufficient(
        self, window, nodes, running, *, record: bool = True
    ) -> bool:
        """True when this cycle uses no constraint family beyond the scalar
        path's surface (live score + resource fit).

        Running pods matter too: a running pod's REQUIRED anti-affinity
        forbids matching pending pods from its domain (the reverse
        direction upstream InterPodAffinity enforces), and its PREFERRED
        terms contribute score — both engine-only capabilities, so any
        running pod with pod_affinity terms forces the engine path."""
        if any(nd.taints or nd.cards for nd in nodes):
            return False
        if not self._window_flags(window)[0]:
            return False
        any_aff, _ = self._running_features(running, record=record)
        return not any_aff

    def _bind(self, pod, node_name: str, m: CycleMetrics) -> None:
        """Bind with upstream error semantics: a 404/409 from the API
        server means the pod is gone or already bound (routine lifecycle
        races) — forget it; any other bind failure requeues with backoff.
        A binder error must never escape the cycle (it would kill the
        serve-forever loop on one racing pod)."""
        try:
            self.binder.bind(pod, node_name)
        except Exception as e:
            status = getattr(e, "status", None)
            if status in (404, 409):
                log.warning(
                    "bind %s -> %s rejected (HTTP %s); dropping pod",
                    pod.name, node_name, status,
                )
                self.queue.mark_scheduled(pod)
                m.pods_dropped += 1
            else:
                log.warning(
                    "bind %s -> %s failed (%s); requeueing", pod.name, node_name, e
                )
                self.queue.requeue_unschedulable(pod)
                m.pods_unschedulable += 1
            return
        # retry-counter clearing is deferred to the cycle-end batch
        # (queue.mark_scheduled_many over _cycle_bound)
        m.pods_bound += 1
        self._cycle_bound.append(pod)
        if self._nominations:  # skip the key build on the common path
            self._nominations.pop(_pod_key(pod), None)

    def _requeue_unschedulable(self, pod: Pod, m: CycleMetrics) -> None:
        """Nothing fit this pod this cycle: requeue with backoff and
        remember it as a preemption candidate for this cycle's PostFilter
        pass (upstream: unschedulable pods enter PostFilter)."""
        self.queue.requeue_unschedulable(pod)
        m.pods_unschedulable += 1
        self._cycle_unsched.append(pod)

    def _engine_options(
        self, window, nodes, running, pods_batch, snapshot=None,
        *, record: bool = True,
    ) -> dict:
        """Per-cycle engine options, shared by the single-window and
        backlog device paths so their semantics cannot diverge.

        Both assigners enforce window-internal (anti)affinity exactly
        (greedy: live counts in the scan; auction: per-round dynamic
        masks + same-round conflict eviction — ops/assign.py). The
        dynamic machinery is only needed when placements inside this
        cycle can interact: some pod matches a selector AND some pod
        constrains on one; otherwise static pre-window counts are exact
        and ~2x cheaper. Preferred (soft) constraints become score terms
        only when present (window preferences, running pods' preferred
        terms, soft taints). The fused kernel path is an optimization
        with identical decisions; silently unavailable outside its
        (policy, normalizer) domain."""
        if snapshot is not None:
            # vectorized soft-taint probe over the already-built arrays
            # (taints[..., 2] is the encoded effect column); the nested
            # generator scan over 4k nodes measured ~1ms/cycle
            tmask = np.asarray(snapshot.taint_mask)
            soft_taints = bool(tmask.any()) and bool(
                (
                    (np.asarray(snapshot.taints)[..., 2] == _PREFER_NO_SCHEDULE)
                    & tmask
                ).any()
            )
        else:
            soft_taints = any(
                t.effect == "PreferNoSchedule" for nd in nodes for t in nd.taints
            )
        soft = (
            self._window_flags(window)[1]
            or self._running_features(running, record=record)[1]
            or soft_taints
        )
        affinity_aware = bool(
            np.asarray(pods_batch.pod_matches).any()
            and (
                (np.asarray(pods_batch.affinity_sel) >= 0).any()
                or (np.asarray(pods_batch.anti_affinity_sel) >= 0).any()
                or (np.asarray(pods_batch.spread_sel) >= 0).any()
            )
        )
        score_plugins = self.config.score_plugins_tuple()
        # the fused kernels' domain (engine.check_fused_contract with
        # min_max_ok): "none" masked-raw, or "min_max" via the kernel's
        # normalize epilogue — which puts the DEPLOYED DEFAULT
        # (normalizer="min_max") on the fused path on engines whose
        # capability probe says so (_fused_min_max_ok); softmax stays
        # unfused
        fused = (
            self.config.feature_gates.fused_kernel
            and score_plugins is None
            and self.config.policy == "balanced_cpu_diskio"
            and (
                self.config.normalizer == "none"
                or (
                    self.config.normalizer == "min_max"
                    and self._fused_min_max_ok()
                )
            )
        )
        self._ladder_kernel(fused)
        kw = dict(
            policy=self.config.policy,
            assigner=self.config.assigner,
            normalizer=self.config.normalizer,
            fused=fused,
            affinity_aware=affinity_aware,
            soft=soft,
        )
        if score_plugins is not None:
            # multi-plugin weighted scoring (upstream RunScorePlugins);
            # gated on the engine accepting the kw so a version-skewed
            # remote degrades loud (TypeError -> scalar fallback) rather
            # than silently scoring single-policy
            kw["score_plugins"] = score_plugins
        if self._engine_takes_auction_kw:
            kw.update(
                auction_rounds=self.config.auction_rounds,
                auction_price_frac=self.config.auction_price_frac,
            )
        return kw

    def _ladder_kernel(self, fused: bool) -> None:
        """fused->unfused rung tracking: only a CAPABILITY downgrade —
        a config that HAS served fused cycles coming back unfused
        (mid-stream sidecar downgrade dropping the fused_min_max latch)
        — demotes; configurations that never fuse (softmax, CPU-local
        min_max, plugin scoring) are not degraded, they are simply not
        on the fused path."""
        lad = self.ladder
        seq = self.totals["cycles"]
        if fused:
            self._kernel_fused_seen = True
            if lad.depth("kernel") > 0:
                lad.probe("kernel", seq=seq)
                lad.promote("kernel", seq=seq)
        elif self._kernel_fused_seen and lad.depth("kernel") == 0:
            lad.demote("kernel", reason="capability-downgrade", seq=seq)

    def _run_backlog(
        self, window, nodes, running, utils, m: CycleMetrics,
        *, ephemeral: bool = False,
    ):
        """Deep-queue cycle: schedule the whole backlog as stacked
        windows in ONE engine dispatch (engine.schedule_windows /
        the ScheduleWindows RPC), capacity and (anti)affinity carried
        between windows on device instead of one dispatch per window."""
        from kubernetes_scheduler_tpu_torch.engine import stack_windows
        from kubernetes_scheduler_tpu_torch.utils.padding import pad_pod_batch

        bw = self.config.batch_window
        snapshot, mirror_delta = self._cycle_snapshot(
            window, nodes, running, utils, ephemeral=ephemeral
        )
        pods_batch = self.builder.build_pod_batch(
            window, recs=self._window_recs(window)
        )
        n_padded = -(-len(window) // bw) * bw
        p_have = int(np.asarray(pods_batch.request).shape[0])
        if p_have < n_padded:
            pods_batch = pad_pod_batch(pods_batch, n_padded)
        elif p_have > n_padded:
            # bucket padding overshot the window multiple: drop only
            # pod_mask=False padding rows
            pods_batch = type(pods_batch)(
                # graftlint: disable=host-sync -- builder leaves are host numpy; trimming pad rows, no device sync
                *[np.asarray(a)[:n_padded] for a in pods_batch]
            )
        windows = stack_windows(pods_batch, bw)
        kw = self._engine_options(
            window, nodes, running, pods_batch, snapshot,
            record=not ephemeral,
        )
        self._set_engine_trace_id()
        tctx = None
        if self.recorder is not None:
            tctx = {
                "path": "backlog", "window": window, "snapshot": snapshot,
                "pods": pods_batch, "kw": kw, "batch_window": bw,
            }
            self._trace_cycle.append(tctx)
        res, t_eng = self._dispatch_windows(
            snapshot, windows, kw, m, ephemeral=ephemeral, tctx=tctx,
            mirror_delta=mirror_delta,
        )
        idx = to_host(res.node_idx).reshape(-1)
        t_done = time.perf_counter()
        m.engine_seconds += t_done - t_eng
        self._span("engine_step", t_eng, t_done, backlog=True)
        if (
            idx.shape[0] < len(window)
            or (idx[: len(window)] >= len(nodes)).any()
        ):
            raise RuntimeError(
                f"engine returned node_idx shape {tuple(res.node_idx.shape)} "
                f"for a {len(window)}-pod backlog over {len(nodes)} nodes"
            )
        if tctx is not None:
            tctx["node_idx"] = self._trace_node_idx(
                pods_batch, idx, len(window)
            )
        t_bind = time.perf_counter()
        self._apply_assignments(window, nodes, idx, m)
        self._span("bind", t_bind)

    def _dispatch_windows(
        self, snapshot, windows, kw, m: CycleMetrics,
        *, ephemeral: bool, tctx: dict | None, mirror_delta=None,
    ):
        """Backlog engine dispatch, resident-aware: with
        config.resident_state and an engine serving the windows-resident
        surface, the multi-window backlog path ships SnapshotDeltas too
        (the ROADMAP follow-up — previously full-upload only). Flushes
        to full exactly like the single-window path: snapshot_delta
        returns None on any cross-window layout churn (node/column/
        selector drift), and an ephemeral build is never a delta base.

        Returns (result, engine dispatch timestamp): the host-side
        delta derivation happens BEFORE the timestamp, so the caller's
        engine_seconds measures the engine call + force only — the same
        attribution the single-window _dispatch_resident uses."""
        resident = (
            self.config.resident_state
            and not ephemeral
            and bool(
                getattr(self.engine, "supports_windows_resident", None)
                and self.engine.supports_windows_resident()
            )
        )
        if not resident:
            t_eng = time.perf_counter()
            return self.engine.schedule_windows(snapshot, windows, **kw), t_eng
        delta, epoch, saved = self._derive_resident_delta(
            snapshot, tctx, mirror_delta=mirror_delta
        )
        t_eng = time.perf_counter()
        res = self.engine.schedule_windows_resident(
            snapshot, windows, delta=delta, epoch=epoch, **kw
        )
        # commit AFTER success (the call is synchronous — a failure
        # falls to the caller's scalar fallback, which invalidates)
        self._commit_resident(snapshot, epoch)
        self._account_resident(m, delta is not None, saved)
        return res, t_eng

    def _derive_resident_delta(
        self, snapshot, tctx: dict | None, mirror_delta=None,
    ) -> tuple:
        """(delta, epoch, bytes_saved) for a resident dispatch, with the
        trace context filled — ONE derivation shared by the single-
        window and backlog dispatchers so the two resident surfaces
        cannot drift on delta-base, epoch, or recorder-chain semantics.

        With the snapshot mirror on, the delta was emitted WITH the
        snapshot (already validated against the engine-retained base by
        identity, flush rules applied) — the O(nodes) row diff never
        runs; the delta_derive span survives at ~0 as the before/after
        evidence in `spans report`."""
        from kubernetes_scheduler_tpu_torch.engine import snapshot_nbytes
        from kubernetes_scheduler_tpu_torch.host.snapshot import snapshot_delta

        t_d = time.perf_counter()
        if self.mirror is not None:
            delta = mirror_delta
        else:
            delta = None
            if self._resident_ok and self._resident_prev is not None:
                delta = snapshot_delta(self._resident_prev, snapshot)
        self._span("delta_derive", t_d, sent=delta is not None)
        epoch = self._resident_epoch + 1
        saved = 0
        if delta is not None:
            saved = max(0, snapshot_nbytes(snapshot) - snapshot_nbytes(delta))
        if tctx is not None:
            tctx["delta"] = delta
            # the delta's base identity — the recorder's chain rule
            # (trace/recorder.py) only records a delta whose base IS the
            # previous device record's snapshot
            tctx["delta_base"] = (
                self._resident_prev if delta is not None else None
            )
            tctx["epoch"] = epoch
            tctx["delta_sent"] = delta is not None
        return delta, epoch, saved

    def _commit_resident(self, snapshot, epoch: int) -> None:
        """The dispatched snapshot becomes the next delta base."""
        self._resident_prev = snapshot
        self._resident_epoch = epoch
        self._resident_ok = True

    def _account_resident(
        self, m: CycleMetrics, delta_sent: bool, saved: int
    ) -> None:
        """Attribute a resident dispatch AFTER the engine reports which
        path actually served it (delta applied vs degraded to full) —
        the ONE implementation both resident surfaces and the pipelined
        completion stage use."""
        used_delta = delta_sent and bool(
            getattr(self.engine, "resident_used_delta", False)
        )
        if used_delta:
            m.delta_uploads += 1
            m.delta_bytes_saved += saved
            if self.ladder.depth("resident") > 0:
                # the delta attempt was the recovery probe, and the
                # engine confirmed applying it: climb back to the top
                seq = self.totals["cycles"]
                self.ladder.probe("resident", seq=seq)
                self.ladder.promote("resident", seq=seq)
        else:
            m.full_uploads += 1
        # mesh-sharded engine (config.sharded_engine): which shards this
        # cycle's delta actually reached, read AFTER the force like
        # resident_used_delta (the 1-deep pipeline completes a cycle
        # before the next dispatch overwrites the engine's attributes)
        if used_delta and getattr(self.engine, "n_shards", 0):
            per_shard = getattr(self.engine, "shard_delta_bytes", ())
            if per_shard:
                m.shard_delta_bytes = tuple(int(b) for b in per_shard)

    def _apply_assignments(self, window, nodes, idx, m: CycleMetrics) -> None:
        """Apply engine results: bind assigned pods, requeue the rest.

        Bulk path: when the binder exposes bind_many (RecordingBinder;
        the live KubeBinder keeps per-pod POSTs with their 404/409
        semantics), all assigned pods go through ONE call — the per-pod
        _bind dispatch (try/except + counters) measured ~4.5us x 8k pods
        per cycle, a visible slice of the host loop."""
        if self.config.gang_scheduling:
            window, idx = self._resolve_gangs(window, idx, m)
            if not window:
                return
        p_real = len(window)
        bind_many = getattr(self.binder, "bind_many", None)
        if bind_many is None or p_real < 256:
            for i, pod in enumerate(window):
                j = int(idx[i])
                if j >= 0:
                    self._bind(pod, nodes[j].name, m)
                else:
                    self._requeue_unschedulable(pod, m)
            return
        idxw = np.asarray(idx)[:p_real]
        assigned_at = np.nonzero(idxw >= 0)[0]
        if assigned_at.size == p_real:
            assigned = list(window)
        else:
            assigned = [window[i] for i in assigned_at.tolist()]
            for i in np.nonzero(idxw < 0)[0].tolist():
                self._requeue_unschedulable(window[i], m)
        names = [nodes[j].name for j in idxw[assigned_at].tolist()]
        bind_many(assigned, names)
        m.pods_bound += len(assigned)
        self._cycle_bound.extend(assigned)
        if self._nominations:
            for pod in assigned:
                self._nominations.pop(_pod_key(pod), None)

    def _fused_min_max_ok(self) -> bool:
        """Whether the min_max->fused widening applies for THIS engine:
        the engine's supports_fused_min_max() capability probe
        (TorchEngine: True on every device, K1 runs the min-max epilogue
        with K2's bounds). Engines without the probe keep the unfused
        min_max path. normalizer="none" configurations are fused either
        way."""
        probe = getattr(self.engine, "supports_fused_min_max", None)
        return bool(probe()) if probe is not None else False

    def _run_batched(
        self, window, nodes, running, utils, m: CycleMetrics,
        *, ephemeral: bool = False,
    ):
        """Serial single-window device cycle: the same dispatch/complete
        pair the pipelined loop uses, back to back — one
        implementation of snapshot ordering, engine-result validation,
        and bind application, so the two modes cannot drift."""
        infl = self._dispatch_window(
            window, nodes, running, utils, m,
            ephemeral=ephemeral, use_async=False,
        )
        self._complete_window(infl, window, nodes, m, ephemeral=ephemeral)

    def _run_scalar(self, window, nodes, running, utils, m: CycleMetrics):
        if self.config.gang_scheduling:
            groups = self._window_gang_groups(window)
            if groups:
                # gangs never bind through the scalar path: all-or-
                # nothing needs the batched view (the per-pod loop binds
                # as it goes). Defer each gang as a unit; the rest of
                # the window scalar-schedules normally.
                drop: set[int] = set()
                for key, (size, rows) in groups.items():
                    drop.update(rows)
                    self._defer_gang(
                        key, size, [window[i] for i in rows], m
                    )
                window = [
                    pd for i, pd in enumerate(window) if i not in drop
                ]
                if not window:
                    return
        t_s = time.perf_counter()
        try:
            self._run_scalar_inner(window, nodes, running, utils, m)
        finally:
            self._span("scalar_cycle", t_s)

    def _run_scalar_inner(
        self, window, nodes, running, utils, m: CycleMetrics
    ):
        from kubernetes_scheduler_tpu_torch.host.plugins import SCALAR_POLICIES

        policy = self.config.policy
        score_plugins = self.config.score_plugins_tuple()
        if score_plugins is not None:
            # weighted multi-plugin mode: every heuristic plugin has a
            # scalar mirror; truncate=False matches the engine's
            # combination (its yoda term never truncates)
            bad = [n for n, _ in score_plugins if n not in SCALAR_POLICIES]
            if bad:
                log.warning(
                    "scalar fallback cannot score plugins %r; scoring "
                    "with balanced_cpu_diskio (fallback_policy_mismatch)",
                    bad,
                )
                m.policy_mismatch = True
                score_plugins = None
            else:
                plugin = ScalarYodaPlugin(
                    utils, score_plugins=score_plugins, truncate=False
                )
                self._scalar_window(plugin, window, nodes, running, m)
                return
        if policy == "balanced_cpu_diskio" and nodes and self._native_ok:
            self._run_scalar_native(window, nodes, running, utils, m)
            return
        if policy not in SCALAR_POLICIES:
            # e.g. "learned": the scalar path has no faithful mirror —
            # degrade to the yoda formula and SAY SO, both in the log and
            # in a dedicated counter (a policy change under degradation
            # must be distinguishable from benign same-policy fallback)
            log.warning(
                "scalar fallback cannot score policy %r; scoring with "
                "balanced_cpu_diskio (fallback_policy_mismatch)",
                policy,
            )
            m.policy_mismatch = True
            policy = "balanced_cpu_diskio"
        plugin = ScalarYodaPlugin(utils, policy=policy)
        self._scalar_window(plugin, window, nodes, running, m)

    def _scalar_window(self, plugin, window, nodes, running, m: CycleMetrics):
        free = {
            n.name: {
                res: n.allocatable.get(res, 0.0) for res in self.builder.resource_names
            }
            for n in nodes
        }
        for pod in running:
            if pod.node_name in free:
                for res in free[pod.node_name]:
                    free[pod.node_name][res] -= pod_resource_request(pod, res)
        # scores read the PRE-window capacity state (the engine computes
        # a window's score matrices before any in-window bind; only
        # feasibility is dynamic) — freeze a copy for the scorers while
        # `free` keeps live bookkeeping
        score_free = {name: dict(res) for name, res in free.items()}
        for pod in window:
            plugin.cache.flush()
            best = (
                scalar_schedule_one(
                    plugin, pod, nodes, free, score_free=score_free
                )
                if nodes
                else None
            )
            if best is not None:
                self._bind(pod, best, m)
            else:
                self._requeue_unschedulable(pod, m)

    def _run_scalar_native(self, window, nodes, running, utils, m: CycleMetrics):
        """The scalar fallback in C++ (native/scalar.cc): same decisions
        as the Python plugin path, one library call per window."""
        from kubernetes_scheduler_tpu_torch import native
        from kubernetes_scheduler_tpu_torch.host.snapshot import parse_float_or_zero

        names = self.builder.resource_names
        req = np.array(
            [[pod_resource_request(p, r) for r in names] for p in window],
            np.float32,
        )
        r_io = np.array(
            [parse_float_or_zero(p.annotations.get("diskIO")) for p in window],
            np.float32,
        )
        free = np.array(
            [[n.allocatable.get(r, 0.0) for r in names] for n in nodes],
            np.float32,
        )
        node_index = {n.name: j for j, n in enumerate(nodes)}
        for pod in running:
            j = node_index.get(pod.node_name)
            if j is not None:
                free[j] -= [pod_resource_request(pod, r) for r in names]
        util = [utils.get(n.name, NodeUtil()) for n in nodes]
        disk_io = np.array([u.disk_io for u in util], np.float32)
        cpu_pct = np.array([u.cpu_pct for u in util], np.float32)

        # prebound cycler, reused while the cycle shape is stable (steady
        # state for a fixed window size on a fixed cluster): one foreign
        # call per cycle instead of per-call pointer marshaling
        cyc = self._scalar_cycler
        if cyc is None or cyc.shape != (len(window), len(nodes), len(names)):
            cyc = native.ScalarCycler(req, r_io, free, disk_io, cpu_pct)
            self._scalar_cycler = cyc
        else:
            cyc.update(
                pod_req=req, r_io=r_io, free=free, disk_io=disk_io,
                cpu_pct=cpu_pct,
            )
        cyc.run()
        idx = cyc.node_idx
        for i, pod in enumerate(window):
            j = int(idx[i])
            if j >= 0:
                self._bind(pod, nodes[j].name, m)
            else:
                self._requeue_unschedulable(pod, m)

    # ---- loop ----------------------------------------------------------

    def run_until_empty(self, *, max_cycles: int = 1000) -> list[CycleMetrics]:
        out = []
        for _ in range(max_cycles):
            # a prefetched window lives outside the queue (popped while
            # the previous engine call was in flight) — the drain is not
            # done until it has been dispatched too
            if len(self.queue) == 0 and self._prefetched is None:
                break
            out.append(self.run_cycle())
        return out
