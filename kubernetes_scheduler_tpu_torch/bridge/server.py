"""The engine sidecar: a gRPC server wrapping the batched engine.

This process owns the device. The host scheduler (Python or native) sends
one ScheduleBatch RPC per cycle; the sidecar runs the engine and returns
bindings — the stateless, restartable device worker of SURVEY.md §5
("sidecar restart = stateless recovery"). The gRPC stubs are
hand-written against the method paths in schedule.proto.

The port's copy of kubernetes_scheduler_tpu/bridge/server.py: the engine
is one TorchEngine on `device` (cuda unless the caller passes another;
it raises without CUDA), every reply reads its result with one
device.to_host, and on-demand profiles run under torch.profiler.
--learned-checkpoint serves a LearnedEngine on `device`; --mesh-devices
N > 1 serves parallel.engine.ShardedEngine (scored by the learned towers
with a checkpoint), its options fixed at startup; with --mesh-hosts H > 1
over a (dcn, node) mesh of H host groups.

Run:  python -m kubernetes_scheduler_tpu_torch.bridge.server --port 50051
"""

from __future__ import annotations

import argparse
import logging
import threading
import time
from collections import OrderedDict
from concurrent import futures

import grpc
import numpy as np
import torch

from kubernetes_scheduler_tpu_torch import engine
from kubernetes_scheduler_tpu_torch.bridge import codec
from kubernetes_scheduler_tpu_torch.bridge import schedule_pb2 as pb
from kubernetes_scheduler_tpu_torch.device import resolve_device, to_host
from kubernetes_scheduler_tpu_torch.ops.gang import GANG_MASKED_BASE

log = logging.getLogger("yoda_tpu.bridge.server")

SERVICE = "yodatpu.Engine"
_DECISION_FIELDS = ("node_idx", "free_after", "n_assigned")
# wire field cache: per-session last-value tensors (Tensor.same_as_last).
# One deep-backlog session is ~a few MB; 8 sessions bound the sidecar's
# exposure to clients that churn session ids.
_MAX_CACHE_SESSIONS = 8

def _auction_kw(request: pb.ScheduleRequest) -> dict:
    """Auction knobs from the wire; proto3 zero means "engine default"."""
    kw = {}
    if request.auction_price_frac > 0:
        kw["auction_price_frac"] = request.auction_price_frac
    if request.auction_rounds > 0:
        kw["auction_rounds"] = int(request.auction_rounds)
    return kw


def _score_plugins(request: pb.ScheduleRequest) -> tuple | None:
    """Weighted multi-plugin config from the wire (None = single-policy);
    proto3 zero weight means 1."""
    if not request.score_plugins:
        return None
    return tuple(
        (e.name, e.weight if e.weight else 1.0) for e in request.score_plugins
    )


def _engine_kw(
    request: pb.ScheduleRequest, *, assigner: str, normalizer: str
) -> dict:
    """The engine call's options from the wire; proto3 empty strings take
    the RPC's defaults (`assigner`, `normalizer`)."""
    kw = dict(
        policy=request.policy or "balanced_cpu_diskio",
        assigner=request.assigner or assigner,
        normalizer=request.normalizer or normalizer,
        fused=request.fused,
        affinity_aware=request.affinity_aware,
        soft=request.soft,
        **_auction_kw(request),
    )
    sp = _score_plugins(request)
    if sp is not None:
        kw["score_plugins"] = sp
    return kw


# PodBatch leaves newer than an old client's wire schema, backfilled
# with their neutral defaults (codec.unpack_fields callable defaults):
# gang_id=-1 / gang_size=0 is exactly "no gangs", and the gang mask is
# bitwise the identity then. Shapes derive from the request tensor so
# one table serves both [p, r] batch and [w, p, r] windows requests.
_POD_WIRE_DEFAULTS = {
    "gang_id": lambda kw: np.full(kw["request"].shape[:-1], -1, np.int32),
    "gang_size": lambda kw: np.zeros(kw["request"].shape[:-1], np.int32),
}

# Matrices are ~P*N*4 bytes; 10k nodes x 4k pods of f32 scores is ~160 MB.
MAX_MESSAGE_BYTES = 512 * 1024 * 1024

# HealthReply capability bit -> the EngineService switch attribute that
# answers it. THE canonical server-side table (the twin of
# bridge/client.CAPABILITY_LATCHES): health() renders every advertised
# capability through it, and tests/canaries flip individual switches to
# impersonate older builds.
CAPABILITY_SWITCHES = {
    "field_cache": "field_cache_enabled",
    "resident_state": "resident_enabled",
    "windows_resident": "windows_resident_enabled",
    "gang_scheduling": "gang_enabled",
    "fused_min_max": "fused_min_max_enabled",
}


class EngineService:
    """Unary handlers for the RPCs. A device lock serializes device access
    (the batched design needs no cross-request locking — contrast the
    reference's RWMutex around Score, scheduler.go:147-149)."""

    def __init__(
        self,
        *,
        device=None,
        engine_override=None,
        field_cache: bool = True,
        resident_state: bool = True,
        span_path: str | None = None,
        profile_path: str | None = None,
        step_slo_ms: float = 0.0,
        pinned_options: dict | None = None,
    ):
        # serve a custom engine (an object with TorchEngine's surface,
        # e.g. models.learned.LearnedEngine or parallel.engine.ShardedEngine)
        # instead of a TorchEngine of our own; fixed for the server's
        # lifetime
        if engine_override is None:
            engine_override = engine.TorchEngine(device=device)
        self._engine = engine_override
        self.device = self._engine.device or resolve_device(device)
        # the dense engine Preempt falls back to where the served one
        # does not run the pass (built on first need)
        self._dense_engine = None
        # the engine options a mesh sidecar fixes at startup (policy,
        # assigner, normalizer, fused, score_plugins; auction knobs as
        # defaults): requests asking for anything else fail loud, as the
        # reference's sidecar fails them against its prebuilt programs
        self._pinned = pinned_options
        self.cycles_served = 0
        # capability switches, read dynamically by the handlers (so a
        # test — or a canary rollout — can downgrade a live server and
        # exercise the client's invalidate-together recovery)
        self.field_cache_enabled = field_cache
        self.resident_enabled = resident_state
        # resident deltas on the ScheduleWindows RPC (multi-window
        # backlog path; HealthReply.windows_resident) — its own switch
        # so a canary can downgrade it independently of batch-resident
        self.windows_resident_enabled = resident_state
        # gang co-scheduling (HealthReply.gang_scheduling): this build's
        # PodBatch knows the gang tensors and finish_cycle rescinds
        # partial gangs on device. The switch exists so a test/canary
        # can impersonate an OLD sidecar and exercise the client's
        # strip-and-degrade path (host-side all-or-nothing backstop).
        self.gang_enabled = True
        # fused min-max epilogue (HealthReply.fused_min_max): advertised
        # where it pays, on the card (K1's epilogue fed by K2); on the
        # CPU the bit stays off and hosts keep min_max unfused, as the
        # JAX sidecar's bit is off on its CPU backend. Tests/canaries
        # flip the switch to exercise the latch on the CPU.
        self.fused_min_max_enabled = self.device.type == "cuda"
        # resident-state observability (tests + ops): how many cycles
        # were served from an applied delta vs. a full resident upload
        self.resident_deltas_served = 0
        self.resident_fulls_served = 0
        self._lock = threading.Lock()
        # serializes DEVICE access explicitly (schedule/windows/preempt
        # bodies), so the executor may run more than one worker without
        # ever interleaving two device programs: with a pipelined host
        # keeping a ScheduleBatch in flight most of the time, a
        # single-worker executor would queue Health probes (liveness,
        # field-cache capability re-probes) behind the cycle
        self._device_lock = threading.Lock()
        # session id -> {"<rpc>:<map>": {field: ndarray}} (LRU-bounded)
        self._field_cache: "OrderedDict[str, dict]" = OrderedDict()
        # sidecar telemetry (host/observe primitives) on its own
        # /metrics: labeled device-step histogram, per-RPC counters,
        # resident delta-vs-full applies, live resident session count
        from kubernetes_scheduler_tpu_torch.host import observe

        self.metrics_step = observe.Histogram(
            "device_step_duration_seconds",
            "Device (engine) step time by RPC",
            labels=("rpc",),
        )
        self.metrics_rpcs = observe.Counter(
            "rpcs_served_total", "RPCs served by the sidecar", labels=("rpc",)
        )
        self.metrics_resident = observe.Counter(
            "resident_applies_total",
            "Resident-state cluster uploads applied (delta vs full)",
            labels=("upload",),
        )
        # mesh-sharded serving (--mesh-devices > 1): RPCs served by the
        # sharded programs, and each applied delta's routed per-shard
        # payload (the sidecar twin of the host's shard_delta_bytes)
        self.mesh_devices = int(self._engine.n_shards)
        self.metrics_sharded = observe.Counter(
            "sharded_cycles_total",
            "RPCs served by this sidecar's mesh-sharded engine",
            labels=("rpc",),
        )
        self.metrics_shard_bytes = observe.Counter(
            "shard_delta_bytes_total",
            "Routed SnapshotDelta payload bytes per owning node shard "
            "(mesh-sharded resident sessions)",
            labels=("shard",),
        )
        self.metrics_sessions = observe.Gauge(
            "resident_sessions_count",
            "Sessions currently holding resident device state",
        )
        # the sidecar-side half of the gang counters (the host exports
        # admit/defer totals; the device is where placements are
        # rescinded, so the masked count is surfaced HERE too)
        self.metrics_gang_masked = observe.Counter(
            "gang_pods_masked_total",
            "Tentative placements rescinded on device by the gang "
            "all-or-nothing rule (ops/gang.py)",
        )
        # sidecar-side SLO watchdog (--step-slo-ms): the host's
        # cycle_slo_ms detector cannot tell a slow device step from a
        # slow host stage; this counter is the device half, so
        # slo_breaches_total exists on BOTH exporters and an alert can
        # attribute a breach to the right side of the bridge. 0 = off.
        self.step_slo_ms = float(step_slo_ms)
        self.metrics_slo = observe.Counter(
            "slo_breaches_total",
            "Device steps that blew the configured --step-slo-ms budget",
            labels=("rpc",),
        )
        # server-side spans (trace/spans.py): opened under the trace id
        # the host shipped as gRPC metadata, so `spans merge` joins the
        # two timelines; requests without an id are not spanned (a
        # sidecar-assigned id could collide with a host id and fake a
        # join)
        self.spans = None
        if span_path:
            self.spans = observe.SpanRecorder(span_path, process="sidecar")
        # on-demand torch.profiler capture (/debug/profile, or forwarded
        # from the host over the yoda-profile-cycles metadata key)
        self._profile_left = 0
        self._profile_dir = profile_path

    def _session(self, request) -> dict | None:
        """The per-session state dict (field caches + resident state),
        LRU-bounded; None when the request carries no session id."""
        sid = request.session_id
        if not sid:
            return None
        with self._lock:
            sess = self._field_cache.get(sid)
            if sess is None:
                sess = {}
                self._field_cache[sid] = sess
                while len(self._field_cache) > _MAX_CACHE_SESSIONS:
                    self._field_cache.popitem(last=False)
            else:
                self._field_cache.move_to_end(sid)
        return sess

    def _session_caches(self, request, which: str):
        """(snapshot_cache, pods_cache) for this request's session, or
        (None, None) when the client did not opt into the field cache
        (or this server does not serve it)."""
        sess = self._session(request) if self.field_cache_enabled else None
        if sess is None:
            return None, None
        return (
            sess.setdefault(f"{which}:snapshot", {}),
            sess.setdefault(f"{which}:pods", {}),
        )

    # ---- telemetry ----------------------------------------------------

    def _request_telemetry(self, context):
        """(trace_id, seq, span_set) from the call's gRPC metadata
        (bridge/schedule.proto documents the keys). Also arms the
        profiler when the host forwarded a /debug/profile ask."""
        md = {}
        try:
            md = {k: v for k, v in (context.invocation_metadata() or ())}
        except Exception:
            pass
        try:
            tid = int(md.get("yoda-trace-id", 0))
        except (TypeError, ValueError):
            tid = 0
        try:
            seq = int(md.get("yoda-trace-seq", -1))
        except (TypeError, ValueError):
            seq = -1
        ask = md.get("yoda-profile-cycles")
        if ask:
            try:
                self.arm_profile(int(ask))
            except (TypeError, ValueError):
                pass
        ss = (
            self.spans.begin(tid)
            if self.spans is not None and tid > 0
            else None
        )
        return tid, seq, ss

    def arm_profile(self, cycles: int, out_dir: str | None = None) -> dict:
        """Capture the next `cycles` device steps under torch.profiler;
        each dump is named after the trace id it covers (step-<id>) so
        a profile pairs with its spans and flight-recorder record."""
        with self._lock:
            if out_dir is None:
                out_dir = self._profile_dir
            if out_dir is None:
                import tempfile

                out_dir = tempfile.mkdtemp(prefix="yoda-sidecar-profile-")
            self._profile_dir = out_dir
            self._profile_left = int(cycles)
        return {"armed": int(cycles), "out_dir": out_dir}

    def _maybe_profile(self, call, trace_id: int):
        """One device dispatch, under torch.profiler when an arm is
        outstanding (zero cost otherwise). Runs inside _device_lock —
        the profiler session must never interleave two programs."""
        with self._lock:
            armed = self._profile_left > 0
            if armed:
                self._profile_left -= 1
            out_dir = self._profile_dir
        if not armed:
            return call()
        import os

        from kubernetes_scheduler_tpu_torch.host.observe import profile_device_step

        tag = "step-%08d" % trace_id if trace_id > 0 else "step-unlabeled"
        return profile_device_step(call, os.path.join(out_dir, tag))

    def render_metrics(self) -> str:
        """Prometheus exposition for the sidecar's own /metrics."""
        with self._lock:
            sessions = sum(
                1 for s in self._field_cache.values() if "resident" in s
            )
        self.metrics_sessions.set(sessions)
        collectors = [
            self.metrics_rpcs,
            self.metrics_step,
            self.metrics_resident,
            self.metrics_sessions,
            self.metrics_gang_masked,
            self.metrics_slo,
            self.metrics_sharded,
            self.metrics_shard_bytes,
        ]
        out = []
        for c in collectors:
            out.extend(c.render())
        return "\n".join(out) + "\n"

    def _finish_call(self, rpc: str, dt: float, tid: int, seq: int, ss) -> None:
        """Per-RPC telemetry epilogue, OFF the device section: histogram
        + counter feeds, the step-SLO watchdog, and the span flush (the
        handler added its stage spans — deserialize, device_step,
        serialize, plus delta_apply from _resident_snapshot — before
        calling here; the names are a registry-pinned contract, see
        observe.SHIPPED_SPANS)."""
        self.metrics_step.observe(dt, rpc=rpc)
        self.metrics_rpcs.inc(rpc=rpc)
        if self.mesh_devices:
            self.metrics_sharded.inc(rpc=rpc)
        if self.step_slo_ms > 0 and dt * 1e3 > self.step_slo_ms:
            self.metrics_slo.inc(rpc=rpc)
            log.warning(
                "SLO breach: %s device step took %.1f ms (budget %.1f "
                "ms) trace_id=%s journal_seq=%s",
                rpc, dt * 1e3, self.step_slo_ms,
                tid if tid > 0 else "-", seq if seq >= 0 else "-",
            )
        if ss is not None:
            self.spans.flush(ss, seq=seq if seq >= 0 else None)

    def _resident_snapshot(self, request, context, snap_cache, ss=None):
        """Resolve the request's cluster state under the resident-state
        protocol: a delta applies to the session's retained snapshot
        (INVALID_ARGUMENT "resident-epoch-mismatch" when inapplicable —
        the client resends in full), a resident_full upload replaces it,
        and either path retags the session to request.resident_epoch.
        Plain requests (no delta, no resident_full) pass through
        untouched. The session holds host arrays; the engine uploads the
        folded snapshot through its uniform cache."""
        delta_present = bool(request.snapshot_delta.tensors)
        if not (delta_present or request.resident_full):
            return codec.unpack_fields(
                engine.SnapshotArrays, request.snapshot, cache=snap_cache
            )
        if not self.resident_enabled:
            context.abort(
                grpc.StatusCode.INVALID_ARGUMENT,
                "resident-epoch-mismatch: this sidecar does not serve "
                "resident cluster state",
            )
        sess = self._session(request)
        if sess is None:
            context.abort(
                grpc.StatusCode.INVALID_ARGUMENT,
                "resident cluster state requires a session_id",
            )
        if delta_present:
            st = sess.get("resident")
            if st is None or st["epoch"] != request.resident_epoch - 1:
                context.abort(
                    grpc.StatusCode.INVALID_ARGUMENT,
                    f"resident-epoch-mismatch: session holds epoch "
                    f"{None if st is None else st['epoch']}, delta wants "
                    f"{request.resident_epoch - 1}",
                )
            delta = codec.unpack_fields(
                engine.SnapshotDelta, request.snapshot_delta
            )
            if (
                delta.node_mask.shape != st["snapshot"].node_mask.shape
                or delta.req_vals.shape[1:]
                != st["snapshot"].requested.shape[1:]
                or delta.dom_vals.shape[1]
                != st["snapshot"].domain_counts.shape[1]
            ):
                context.abort(
                    grpc.StatusCode.INVALID_ARGUMENT,
                    "resident-epoch-mismatch: delta shape does not match "
                    "the retained snapshot (layout churn)",
                )
            # applied in numpy BY VALUE: bitwise the snapshot the client
            # would have shipped in full, so delta cycles cannot diverge
            # from full-upload cycles (PARITY.md)
            t_apply = time.perf_counter()
            snapshot = engine.apply_snapshot_delta_np(st["snapshot"], delta)
            if ss is not None:
                ss.add("delta_apply", t_apply, time.perf_counter())
            with self._lock:
                self.resident_deltas_served += 1
            self.metrics_resident.inc(upload="delta")
            if self.mesh_devices and delta.node_mask.shape[0] % self.mesh_devices == 0:
                self._count_shard_bytes(st["snapshot"].node_mask, delta)
        else:
            snapshot = codec.unpack_fields(
                engine.SnapshotArrays, request.snapshot, cache=snap_cache
            )
            with self._lock:
                self.resident_fulls_served += 1
            self.metrics_resident.inc(upload="full")
        sess["resident"] = {
            "snapshot": snapshot, "epoch": int(request.resident_epoch),
        }
        return snapshot

    def _count_shard_bytes(self, prev_mask, delta) -> None:
        """Per-shard routed payload of the delta just applied, measured as
        ShardedEngine measures it (steady-state mask bytes excluded: a
        shard's retained mask ships nothing)."""
        from kubernetes_scheduler_tpu_torch.host.snapshot import shard_snapshot_delta

        prev_mask = np.asarray(prev_mask, bool)
        mask_changed = not np.array_equal(prev_mask, np.asarray(delta.node_mask, bool))
        for shard, routed in shard_snapshot_delta(
            delta, self.mesh_devices, prev_node_mask=prev_mask
        ).items():
            self.metrics_shard_bytes.inc(
                engine.snapshot_nbytes(routed)
                - (0 if mask_changed else routed.node_mask.nbytes),
                shard=str(shard),
            )

    def _pin(self, request, context, kw: dict) -> dict:
        """`kw` under the startup options of a mesh sidecar (unchanged
        without them): a request's policy, assigner, normalizer or
        score-plugin list other than the fixed one aborts
        INVALID_ARGUMENT; empty fields and `fused` take the fixed values,
        and the auction knobs stay per request."""
        pin = self._pinned
        if pin is None:
            return kw
        for key in ("policy", "assigner", "normalizer"):
            want = getattr(request, key)
            if want and want != pin[key]:
                context.abort(
                    grpc.StatusCode.INVALID_ARGUMENT,
                    f"sidecar's sharded engine is fixed to {key}={pin[key]!r}; "
                    f"request asked for {want!r}",
                )
        if _score_plugins(request) != pin["score_plugins"]:
            context.abort(
                grpc.StatusCode.INVALID_ARGUMENT,
                f"sidecar's sharded engine is built with score_plugins="
                f"{pin['score_plugins']!r}; request asked for {_score_plugins(request)!r}",
            )
        fixed = {k: pin[k] for k in ("policy", "assigner", "normalizer", "fused",
                                     "score_plugins")}
        knobs = {k: pin[k] for k in ("auction_rounds", "auction_price_frac")}
        return {**knobs, **kw, **fixed}

    def _run(self, call, tid: int | None, spans=None):
        """One engine call under the device lock (and under the profiler
        when armed, unless tid is None); the result comes back to the
        host with ONE device.to_host read, inside the timed section.
        `spans`, the RPC's SpanSet, is published to the engine
        (observe.engine_trace) for its window and auction spans."""
        from kubernetes_scheduler_tpu_torch.host.observe import engine_trace

        with self._device_lock, engine_trace(spans):
            res = call() if tid is None else self._maybe_profile(call, tid)
            return type(res)(*to_host(*res))

    def _count_masked(self, res) -> None:
        # gang sentinels (<= GANG_MASKED_BASE, ops/gang.py) are
        # placements the device rescinded under the all-or-nothing rule
        # — surfaced on the sidecar's own /metrics beside the host's
        # admit/defer totals
        masked = int((np.asarray(res.node_idx) <= GANG_MASKED_BASE).sum())
        if masked:
            self.metrics_gang_masked.inc(masked)

    def schedule_batch(self, request: pb.ScheduleRequest, context) -> pb.ScheduleReply:
        tid, seq, ss = self._request_telemetry(context)
        snap_cache, pods_cache = self._session_caches(request, "batch")
        t_des = time.perf_counter()
        try:
            snapshot = self._resident_snapshot(
                request, context, snap_cache, ss
            )
            pods = codec.unpack_fields(
                engine.PodBatch, request.pods, cache=pods_cache,
                defaults=_POD_WIRE_DEFAULTS,
            )
            kw = _engine_kw(request, assigner="greedy", normalizer="min_max")
        except codec.FieldCacheMiss as e:
            # sidecar restarted or the session was evicted: the client
            # clears its cache and resends everything in full
            context.abort(grpc.StatusCode.FAILED_PRECONDITION, str(e))
        except (ValueError, TypeError) as e:
            context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(e))
        t0 = time.perf_counter()
        try:
            kw = self._pin(request, context, kw)
            res = self._run(
                lambda: self._engine.schedule_batch(snapshot, pods, **kw),
                tid, ss,
            )
        except ValueError as e:  # unknown policy/assigner/normalizer
            context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(e))
        t1 = time.perf_counter()
        dt = t1 - t0
        with self._lock:
            self.cycles_served += 1
        self._count_masked(res)
        reply = pb.ScheduleReply(engine_seconds=dt)
        only = set(_DECISION_FIELDS) if request.decisions_only else None
        codec.pack_fields(res, reply.result, only=only)
        if ss is not None:
            ss.add("deserialize", t_des, t0, rpc="schedule_batch")
            ss.add("device_step", t0, t1, rpc="schedule_batch")
            ss.add("serialize", t1, time.perf_counter(), rpc="schedule_batch")
        self._finish_call("schedule_batch", dt, tid, seq, ss)
        return reply

    def schedule_windows(
        self, request: pb.ScheduleRequest, context
    ) -> pb.ScheduleReply:
        """Whole-backlog RPC: pods carry a leading [w, p, ...] window
        axis; the reply holds engine.WindowsResult fields. One engine
        call schedules every window with capacity + (anti)affinity
        carries threaded between them."""
        tid, seq, ss = self._request_telemetry(context)
        snap_cache, pods_cache = self._session_caches(request, "windows")
        if (
            bool(request.snapshot_delta.tensors) or request.resident_full
        ) and not self.windows_resident_enabled:
            context.abort(
                grpc.StatusCode.INVALID_ARGUMENT,
                "resident-epoch-mismatch: this sidecar does not serve "
                "resident cluster state on ScheduleWindows",
            )
        t_des = time.perf_counter()
        try:
            # the resident protocol is shared with ScheduleBatch — same
            # session-retained snapshot, same epoch sequence (backlog
            # and single-window cycles interleave on one counter)
            snapshot = self._resident_snapshot(
                request, context, snap_cache, ss
            )
            pods_w = codec.unpack_fields(
                engine.PodBatch, request.pods, cache=pods_cache,
                defaults=_POD_WIRE_DEFAULTS,
            )
            kw = _engine_kw(request, assigner="auction", normalizer="none")
        except codec.FieldCacheMiss as e:
            context.abort(grpc.StatusCode.FAILED_PRECONDITION, str(e))
        except (ValueError, TypeError) as e:
            context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(e))
        t0 = time.perf_counter()
        try:
            kw = self._pin(request, context, kw)
            res = self._run(
                lambda: self._engine.schedule_windows(snapshot, pods_w, **kw),
                tid, ss,
            )
        except ValueError as e:
            context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(e))
        t1 = time.perf_counter()
        dt = t1 - t0
        with self._lock:
            self.cycles_served += 1
        self._count_masked(res)
        reply = pb.ScheduleReply(engine_seconds=dt)
        codec.pack_fields(res, reply.result)
        if ss is not None:
            ss.add("deserialize", t_des, t0, rpc="schedule_windows")
            ss.add("device_step", t0, t1, rpc="schedule_windows")
            ss.add(
                "serialize", t1, time.perf_counter(), rpc="schedule_windows"
            )
        self._finish_call("schedule_windows", dt, tid, seq, ss)
        return reply

    def _preempt(self, snapshot, pods, victims, k_cap: int):
        """The served engine's preempt; where it does not run the pass
        (the sharded and learned engines answer None), the dense engine
        of the same device does, as the reference's mesh sidecar runs it
        on its dense engine. Called under the device lock."""
        res = self._engine.preempt(snapshot, pods, victims, k_cap=k_cap)
        if res is None:
            if self._dense_engine is None:
                self._dense_engine = engine.TorchEngine(device=self.device)
            res = self._dense_engine.preempt(snapshot, pods, victims, k_cap=k_cap)
        return res

    def preempt(self, request: pb.ScheduleRequest, context) -> pb.ScheduleReply:
        """Preemption pass (upstream PostFilter) on the device: pending
        preemptors + victim arrays in, (node, victims, n_victims) out —
        the engine's preempt (engine.preempt_batch)."""
        from kubernetes_scheduler_tpu_torch.ops.preempt import VictimArrays

        try:
            snapshot = codec.unpack_fields(engine.SnapshotArrays, request.snapshot)
            pods = codec.unpack_fields(
                engine.PodBatch, request.pods, defaults=_POD_WIRE_DEFAULTS
            )
            victims = codec.unpack_fields(VictimArrays, request.victims)
            k_cap = int(request.preempt_k_cap)
            if k_cap <= 0:
                raise ValueError("preempt_k_cap must be positive")
        except codec.FieldCacheMiss as e:
            # the Preempt surface is uncached (victims churn per pass);
            # a marker here is a skewed/confused client — same recovery
            context.abort(grpc.StatusCode.FAILED_PRECONDITION, str(e))
        except (ValueError, TypeError) as e:
            context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(e))
        t0 = time.perf_counter()
        res = self._run(lambda: self._preempt(snapshot, pods, victims, k_cap), None)
        dt = time.perf_counter() - t0
        with self._lock:
            self.cycles_served += 1
        reply = pb.ScheduleReply(engine_seconds=dt)
        codec.pack_fields(res, reply.result)
        self.metrics_step.observe(dt, rpc="preempt")
        self.metrics_rpcs.inc(rpc="preempt")
        return reply

    def health(self, request: pb.HealthRequest, context) -> pb.HealthReply:
        self.metrics_rpcs.inc(rpc="health")
        # every capability bit rides the one CAPABILITY_SWITCHES table:
        # a bit that exists in the proto but not in the table would be
        # silently False forever
        caps = {
            fieldname: bool(getattr(self, attr))
            for fieldname, attr in CAPABILITY_SWITCHES.items()
        }
        with self._lock:
            served = self.cycles_served
        cuda = self.device.type == "cuda"
        return pb.HealthReply(
            status="SERVING",
            # "gpu" is the platform name jax reports for the same card
            device_count=torch.cuda.device_count() if cuda else 1,
            platform="gpu" if cuda else self.device.type,
            cycles_served=served,
            **caps,
        )


def make_server(
    address: str = "127.0.0.1:0",
    *,
    device=None,
    engine_override=None,
    max_workers: int = 2,
    span_path: str | None = None,
    profile_path: str | None = None,
    step_slo_ms: float = 0.0,
    pinned_options: dict | None = None,
) -> tuple[grpc.Server, int, EngineService]:
    """Build (server, bound_port, service) for an engine on `device`
    (cuda unless given; raises without CUDA), or for `engine_override`
    with requests held to `pinned_options` (EngineService._pin). Device access stays
    single-writer regardless of max_workers (EngineService._device_lock
    serializes the compute sections); the default of 2 workers keeps
    Health answering while a pipelined host's ScheduleBatch is in
    flight — with 1 worker every probe queues behind the cycle."""
    service = EngineService(
        device=device,
        engine_override=engine_override,
        span_path=span_path,
        profile_path=profile_path,
        step_slo_ms=step_slo_ms,
        pinned_options=pinned_options,
    )
    handlers = grpc.method_handlers_generic_handler(
        SERVICE,
        {
            "ScheduleBatch": grpc.unary_unary_rpc_method_handler(
                service.schedule_batch,
                request_deserializer=pb.ScheduleRequest.FromString,
                response_serializer=pb.ScheduleReply.SerializeToString,
            ),
            "ScheduleWindows": grpc.unary_unary_rpc_method_handler(
                service.schedule_windows,
                request_deserializer=pb.ScheduleRequest.FromString,
                response_serializer=pb.ScheduleReply.SerializeToString,
            ),
            "Preempt": grpc.unary_unary_rpc_method_handler(
                service.preempt,
                request_deserializer=pb.ScheduleRequest.FromString,
                response_serializer=pb.ScheduleReply.SerializeToString,
            ),
            "Health": grpc.unary_unary_rpc_method_handler(
                service.health,
                request_deserializer=pb.HealthRequest.FromString,
                response_serializer=pb.HealthReply.SerializeToString,
            ),
        },
    )
    server = grpc.server(
        futures.ThreadPoolExecutor(max_workers=max_workers),
        options=[
            ("grpc.max_receive_message_length", MAX_MESSAGE_BYTES),
            ("grpc.max_send_message_length", MAX_MESSAGE_BYTES),
        ],
    )
    server.add_generic_rpc_handlers((handlers,))
    port = server.add_insecure_port(address)
    if port == 0:
        raise RuntimeError(f"could not bind {address}")
    return server, port, service


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=50051)
    parser.add_argument(
        "--device", default="cuda",
        help="torch device the engine runs on (default cuda; it raises "
        "without CUDA, pass cpu to serve the plain PyTorch path)",
    )
    parser.add_argument(
        "--mesh-devices",
        type=int,
        default=0,
        help="shard the node axis over this many devices (0 = single "
        "device): with --device cuda the first N cards, with cpu or "
        "cuda:K that one device N times",
    )
    parser.add_argument(
        "--mesh-hosts", type=int, default=1,
        help="with --mesh-devices: split the mesh into this many host "
        "groups, a (dcn, node) mesh whose collectives run within each "
        "group first (--mesh-devices must divide by it)",
    )
    parser.add_argument("--policy", default="balanced_cpu_diskio")
    parser.add_argument(
        "--assigner", default="greedy", choices=["greedy", "auction"],
        help="assignment algorithm baked into the sharded engine when "
        "--mesh-devices is set (the dense engine honors the per-request "
        "assigner field instead)",
    )
    parser.add_argument(
        "--auction-rounds", type=int, default=1024,
        help="max auction rounds for the sharded auction assigner",
    )
    parser.add_argument(
        "--auction-price-frac", type=float, default=1.0,
        help="price step (fraction of the unit row range) for the sharded "
        "auction assigner",
    )
    parser.add_argument(
        "--normalizer", default="min_max", choices=["min_max", "softmax", "none"],
        help="score normalizer baked into the sharded engine when "
        "--mesh-devices is set",
    )
    parser.add_argument(
        "--fused", action="store_true",
        help="score + resource fit through kernel K1 on each shard of the "
        "sharded engine (requires --normalizer none and the "
        "balanced_cpu_diskio policy)",
    )
    parser.add_argument(
        "--score-plugins", default=None,
        help='JSON list of {"name": ..., "weight": N}: weighted multi-plugin '
        "scoring baked into the sharded engine when --mesh-devices is set "
        "(the dense engine honors the request's score_plugins instead)",
    )
    parser.add_argument(
        "--learned-checkpoint",
        default=None,
        help="serve the learned two-tower policy restored from this "
        "checkpoint (models/learned.save_checkpoint's directory, not "
        "orbax; policy becomes 'learned'; shards over the mesh when "
        "--mesh-devices is set)",
    )
    parser.add_argument(
        "--metrics-port", type=int, default=0,
        help="serve the sidecar's own /metrics + /healthz + "
        "/debug/profile on this HTTP port (0 = disabled)",
    )
    parser.add_argument(
        "--metrics-host", default="0.0.0.0",
        help="bind host for --metrics-port",
    )
    parser.add_argument(
        "--span-path", default=None,
        help="write server-side Chrome-trace spans (deserialize, device "
        "step, delta apply, serialize) under this directory, joined to "
        "host spans by the trace id on gRPC metadata",
    )
    parser.add_argument(
        "--profile-path", default=None,
        help="where on-demand /debug/profile torch.profiler dumps land "
        "(default: a tempdir)",
    )
    parser.add_argument(
        "--step-slo-ms", type=float, default=0.0,
        help="device-step SLO budget in ms: steps slower than this bump "
        "slo_breaches_total{rpc} on the sidecar's /metrics and log the "
        "offending trace id (0 = off)",
    )
    return parser


def server_from_args(args) -> tuple[grpc.Server, int, EngineService]:
    """make_server for parsed command-line options: the learned engine of
    --learned-checkpoint on --device, and with --mesh-devices N > 1 a
    ShardedEngine over N shards (the first N cards for --device cuda,
    else that one device N times; the learned towers score each shard
    with a checkpoint) with the mesh options pinned; --mesh-hosts H > 1
    makes it make_mesh_multihost(H, N // H) with the node axis over
    (dcn, node). Raises SystemExit for conflicting options."""
    engine_override = None
    policy = args.policy
    if args.learned_checkpoint:
        if policy not in ("balanced_cpu_diskio", "learned"):
            raise SystemExit(
                f"--policy {policy!r} conflicts with --learned-checkpoint "
                "(which serves policy 'learned')"
            )
        from kubernetes_scheduler_tpu_torch.models.learned import load_learned_engine

        engine_override = load_learned_engine(args.learned_checkpoint, device=args.device)
        policy = "learned"
    score_plugins = None
    if args.score_plugins:
        import json

        from kubernetes_scheduler_tpu_torch.utils.config import SchedulerConfig

        try:
            score_plugins = SchedulerConfig.from_dict(
                {"score_plugins": json.loads(args.score_plugins)}
            ).score_plugins_tuple()
        except ValueError as e:
            raise SystemExit(f"--score-plugins: {e}") from None
        if args.fused:
            raise SystemExit("--score-plugins is incompatible with --fused")
        if args.learned_checkpoint:
            raise SystemExit(
                "--score-plugins is incompatible with --learned-checkpoint "
                "(the learned scorer replaces the policy)"
            )
        if args.mesh_devices <= 1:
            raise SystemExit(
                "--score-plugins only configures the sharded engine "
                "(--mesh-devices > 1); the dense engine honors the "
                "request-carried score_plugins field instead"
            )
    pinned = None
    if args.mesh_devices > 1:
        from kubernetes_scheduler_tpu_torch.parallel.engine import ShardedEngine, check_options
        from kubernetes_scheduler_tpu_torch.parallel.mesh import (
            DCN_AXIS,
            NODE_AXIS,
            make_mesh,
            make_mesh_multihost,
        )

        # --device cuda: the first cards; cpu or cuda:K: that device repeated
        device = None if args.device is None or str(args.device) == "cuda" else args.device
        if args.mesh_hosts > 1:
            if args.mesh_devices % args.mesh_hosts:
                raise SystemExit("--mesh-devices must divide by --mesh-hosts")
            mesh = make_mesh_multihost(args.mesh_hosts, args.mesh_devices // args.mesh_hosts,
                                       device=device)
            node_axes = (DCN_AXIS, NODE_AXIS)
        else:
            mesh = make_mesh(args.mesh_devices, device=device)
            node_axes = NODE_AXIS
        score_fn = None
        if engine_override is not None:
            from kubernetes_scheduler_tpu_torch.models.learned import sharded_learned_score_fn

            score_fn = sharded_learned_score_fn(engine_override.params, mesh,
                                                model=engine_override.model)
        pinned = dict(policy=policy, assigner=args.assigner, normalizer=args.normalizer,
                      fused=args.fused, score_plugins=score_plugins)
        try:
            # the options a request may not change fail here, at startup
            check_options(score_fn=score_fn, **pinned)
        except ValueError as e:
            raise SystemExit(f"--mesh-devices: {e}") from None
        pinned.update(auction_rounds=args.auction_rounds,
                      auction_price_frac=args.auction_price_frac)
        engine_override = ShardedEngine(mesh, node_axes=node_axes, score_fn=score_fn)
    return make_server(
        f"{args.host}:{args.port}",
        device=args.device,
        engine_override=engine_override,
        span_path=args.span_path,
        profile_path=args.profile_path,
        step_slo_ms=args.step_slo_ms,
        pinned_options=pinned,
    )


def serve(server, port: int, service: EngineService, args) -> int:
    """Run a built server until SIGTERM / ctrl-c, with its /metrics when
    --metrics-port is set; drains in-flight RPCs on the way out."""
    exporter = None
    if args.metrics_port:
        from kubernetes_scheduler_tpu_torch.host.observe import HttpMetricsServer

        exporter = HttpMetricsServer(
            service.render_metrics, profile=service.arm_profile
        )
        mport = exporter.serve(args.metrics_port, host=args.metrics_host)
        log.info("sidecar metrics on %s:%d", args.metrics_host, mport)
    server.start()
    log.info(
        "engine sidecar serving on %s:%d (device=%s, mesh devices %d)",
        args.host, port, service.device, service.mesh_devices,
    )
    try:
        server.wait_for_termination()
    except (KeyboardInterrupt, SystemExit):
        # drain in-flight RPCs before exiting (SIGTERM arrives via the
        # CLI's handler as SystemExit); a cut-off cycle would flip the
        # host to its scalar fallback for one window, which is fine but
        # unnecessary when shutdown can just finish the RPC
        log.info("shutting down; draining in-flight RPCs")
        server.stop(grace=10).wait(timeout=15)
    finally:
        if exporter is not None:
            exporter.close()
        if service.spans is not None:
            service.spans.close()
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    server, port, service = server_from_args(args)
    return serve(server, port, service, args)


if __name__ == "__main__":
    import sys

    sys.exit(main())
