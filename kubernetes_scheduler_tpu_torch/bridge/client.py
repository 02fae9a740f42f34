"""Host-side client for the engine sidecar.

`RemoteEngine` exposes the same call surface as the in-process engine
(`schedule_batch(snapshot, pods, policy=..., ...) -> ScheduleResult`), so
host/scheduler.py can swap between LocalEngine and RemoteEngine behind
the TPUBatchScore feature gate. Deadline + bounded retry + health check
implement the failure-detection contract of SURVEY.md §5: an unreachable
sidecar raises EngineUnavailable and the scheduler's cycle falls back to
the scalar path instead of stalling.

The port's copy of kubernetes_scheduler_tpu/bridge/client.py: results
come back as numpy arrays (the host's device.to_host reads them as it
reads TorchEngine's tensors), and LocalEngine is engine.TorchEngine.
"""

from __future__ import annotations

import logging
import time
import uuid

import grpc
import numpy as np

from kubernetes_scheduler_tpu_torch import engine
from kubernetes_scheduler_tpu_torch.bridge import codec
from kubernetes_scheduler_tpu_torch.bridge import schedule_pb2 as pb
from kubernetes_scheduler_tpu_torch.bridge.server import MAX_MESSAGE_BYTES, SERVICE
from kubernetes_scheduler_tpu_torch.host.observe import Counter
from kubernetes_scheduler_tpu_torch.host.resilience import (
    BackoffPolicy,
    CircuitBreaker,
)

log = logging.getLogger("yoda_tpu.bridge.client")

_RETRYABLE = (
    grpc.StatusCode.UNAVAILABLE,
    grpc.StatusCode.DEADLINE_EXCEEDED,
)


class EngineUnavailable(RuntimeError):
    """The sidecar could not serve the cycle (after retries)."""


def _noop_state(state) -> None:
    """Connectivity-subscription callback for _kick_reconnect (module
    level so subscribe/unsubscribe always see the same object)."""


# gang co-scheduling tensors (ops/gang.py), stripped off the wire when
# the sidecar does not advertise HealthReply.gang_scheduling: an old
# build's strict unpack rejects unknown PodBatch fields, so sending them
# would error every cycle into the scalar fallback. The host's
# _resolve_gangs backstop then enforces all-or-nothing host-side.
_GANG_FIELDS = ("gang_id", "gang_size")
_PODS_SANS_GANGS = frozenset(engine.PodBatch._fields) - set(_GANG_FIELDS)

# HealthReply capability bit -> the RemoteEngine latch attribute holding
# it. THE canonical table: _probe_capabilities resolves every unresolved
# latch from one Health reply through it, _invalidate_session drops the
# whole set back to unknown through it. The protocol: a probe fills ALL
# unresolved latches together; any failure invalidates ALL of them
# together with the wire field cache.
CAPABILITY_LATCHES = {
    "field_cache": "_field_cache_ok",
    "resident_state": "_resident_cap",
    "windows_resident": "_windows_resident_cap",
    "gang_scheduling": "_gang_cap",
    "fused_min_max": "_fused_min_max_cap",
}


class _FutureSchedule:
    """RemoteEngine's in-flight ScheduleBatch handle: the whole RPC
    (pack, send, server compute, unpack) runs on the client's dedicated
    worker thread so the pipelined host overlaps it with next-cycle
    host work. Same one-method surface as engine.PendingSchedule."""

    __slots__ = ("_future",)

    def __init__(self, future):
        self._future = future

    def result(self):
        return self._future.result()


LocalEngine = engine.TorchEngine  # re-export; defined grpc-free in engine.py


class RemoteEngine:
    def __init__(
        self,
        target: str,
        *,
        deadline_seconds: float = 30.0,
        retries: int = 1,
        decisions_only: bool = False,
        breaker: CircuitBreaker | None = None,
    ):
        self.target = target
        self.deadline_seconds = deadline_seconds
        self.retries = retries
        self.decisions_only = decisions_only
        # unified resilience (host/resilience.py): the circuit breaker
        # gating EVERY RPC on this client (schedule, preempt, health) —
        # a down sidecar costs one half-open probe per recovery window
        # instead of a deadline timeout per call — and the deterministic-
        # jitter backoff between in-call retries (replacing the old bare
        # min(0.1 * 2**attempt, 1.0) sleep). The breaker is injectable
        # so the host can share one instance across clients of the same
        # sidecar.
        self.breaker = breaker or CircuitBreaker(f"bridge:{target}")
        self._backoff = BackoffPolicy(
            initial=0.1, max_delay=1.0, multiplier=2.0
        )
        # transport-down vs deadline-exceeded health failures, counted
        # SEPARATELY (a saturated-but-alive sidecar and a dead one need
        # different operator responses); "breaker-open" counts probes
        # the breaker answered without touching the wire. Exported via
        # the host exporter (Scheduler folds engine `collectors` into
        # prom_collectors).
        self.ctr_health_failures = Counter(
            "engine_health_failures_total",
            "Sidecar health-probe failures by kind (transport-down vs "
            "deadline-exceeded vs answered-by-open-breaker)",
            labels=("kind",),
        )
        self.collectors = (self.ctr_health_failures,)
        self._channel = grpc.insecure_channel(
            target,
            options=[
                ("grpc.max_receive_message_length", MAX_MESSAGE_BYTES),
                ("grpc.max_send_message_length", MAX_MESSAGE_BYTES),
                # cap the channel's reconnect backoff: grpc's default
                # grows to ~2 minutes, so a client that rode out a
                # sidecar outage could keep failing long AFTER the
                # sidecar recovered — the circuit breaker's half-open
                # probe cadence (seconds) is the recovery clock here,
                # and the transport must not out-wait it
                ("grpc.max_reconnect_backoff_ms", 5000),
            ],
        )
        self._schedule = self._channel.unary_unary(
            f"/{SERVICE}/ScheduleBatch",
            request_serializer=pb.ScheduleRequest.SerializeToString,
            response_deserializer=pb.ScheduleReply.FromString,
        )
        self._schedule_windows = self._channel.unary_unary(
            f"/{SERVICE}/ScheduleWindows",
            request_serializer=pb.ScheduleRequest.SerializeToString,
            response_deserializer=pb.ScheduleReply.FromString,
        )
        self._preempt = self._channel.unary_unary(
            f"/{SERVICE}/Preempt",
            request_serializer=pb.ScheduleRequest.SerializeToString,
            response_deserializer=pb.ScheduleReply.FromString,
        )
        self._health = self._channel.unary_unary(
            f"/{SERVICE}/Health",
            request_serializer=pb.HealthRequest.SerializeToString,
            response_deserializer=pb.HealthReply.FromString,
        )
        self.last_engine_seconds = 0.0
        # wire field cache (Tensor.same_as_last): most snapshot leaves
        # are bytewise identical cycle after cycle — after the sidecar
        # advertises HealthReply.field_cache, unchanged leaves ride the
        # wire as one-bit markers. Keyed per (rpc, map) so batch and
        # windows shapes never flap each other's slots.
        self._session_id = uuid.uuid4().hex
        self._wire_cache: dict[str, dict] = {}
        self._field_cache_ok: bool | None = None
        # resident-cluster-state capability (HealthReply.resident_state),
        # latched like the field cache and INVALIDATED TOGETHER with it:
        # a mid-stream downgrade (sidecar replaced by an older build)
        # otherwise leaves one latch trusting a dead sidecar's
        # advertisement while the other re-probes
        self._resident_cap: bool | None = None
        # windows-resident capability (HealthReply.windows_resident):
        # resident deltas on the ScheduleWindows RPC — probed, latched,
        # and invalidated together with the other two
        self._windows_resident_cap: bool | None = None
        # gang-scheduling capability (HealthReply.gang_scheduling):
        # whether the sidecar's PodBatch knows the gang tensors — same
        # latch/invalidate discipline as the other capability bits
        self._gang_cap: bool | None = None
        # fused min-max capability (HealthReply.fused_min_max): the
        # sidecar serves the fused megakernel's min-max epilogue AND
        # sits on a backend that profits from it (the card) — the host's
        # min_max->fused widening keys off this latch; same discipline
        self._fused_min_max_cap: bool | None = None
        # did the LAST schedule_resident call apply a delta server-side?
        # (mirrors LocalEngine.resident_used_delta for the host's
        # delta/full upload metrics)
        self.resident_used_delta = False
        # lazy single-worker pool for schedule_batch_async: ONE worker
        # because the wire field cache and capability latch are mutated
        # per call, and the pipelined host forces result() before the
        # next dispatch — at most one RPC is ever in flight per client
        self._async_pool = None
        # span/profile context, shipped as gRPC METADATA (no message
        # changes): the host cycle's trace id + flight-recorder seq ride
        # every schedule call so the sidecar's spans join the host
        # timeline; a /debug/profile arm forwards on the next call (the
        # sidecar owns the device, so the dump lands on its side)
        self._trace_md: list | None = None
        self._profile_ask = 0

    def set_trace_id(self, trace_id: int, seq: int = -1) -> None:
        """Span context for subsequent calls (mirrors
        LocalEngine.set_trace_id): attached to the wire as metadata keys
        `yoda-trace-id` / `yoda-trace-seq` (bridge/schedule.proto)."""
        self._trace_md = [
            ("yoda-trace-id", str(int(trace_id))),
            ("yoda-trace-seq", str(int(seq))),
        ]

    def arm_profile(self, cycles: int, out_dir: str | None = None) -> dict:
        """Forward a /debug/profile arm to the sidecar over metadata on
        the next schedule call (best effort: a call that never reaches
        the server drops the ask). The dump lands under the sidecar's
        --profile-path — the device lives there."""
        self._profile_ask = int(cycles)
        return {
            "armed": self._profile_ask,
            "forwarded_to": self.target,
            "note": "dump lands under the sidecar's --profile-path",
        }

    def _call_metadata(self, *, profile_ok: bool = True) -> list | None:
        md = list(self._trace_md or ())
        # the ask rides only schedule calls: the Preempt handler never
        # reads the key, and consuming the arm there would lose it
        # silently after /debug/profile already reported it armed
        if profile_ok and self._profile_ask > 0:
            md.append(("yoda-profile-cycles", str(self._profile_ask)))
            self._profile_ask = 0
        return md or None

    def _probe_capabilities(self) -> None:
        """ONE Health RPC resolves BOTH capability latches (field cache
        and resident state): they ride the same reply, and a down
        sidecar must not pay the probe timeout once per latch per cycle
        on the outage path. Only a positive reply resolves them; an
        unreachable sidecar leaves both unknown to be probed again next
        call."""
        info = self.health_info()
        if info is not None:
            # fill only UNRESOLVED latches, and fill every unresolved
            # one from this ONE reply: a latch someone already resolved
            # (or pinned) stays put until _invalidate_session drops the
            # whole set back to unknown together. Table-driven so a new
            # HealthReply bit cannot be probed without also being
            # invalidated.
            # getattr default False: a reply from a build older than
            # the field reads as "capability absent".
            for fieldname, attr in CAPABILITY_LATCHES.items():
                if getattr(self, attr) is None:
                    setattr(
                        self, attr, bool(getattr(info, fieldname, False))
                    )

    def _field_cache_enabled(self) -> bool:
        """Resolve the sidecar's field-cache capability ONCE per client
        (older sidecars would read a marker as a malformed empty
        tensor). Called once per schedule call, never inside the
        per-map packing."""
        if self._field_cache_ok is None:
            self._probe_capabilities()
        return bool(self._field_cache_ok)

    def supports_resident(self) -> bool:
        """Resolve the sidecar's resident-cluster-state capability, once
        per client (re-probed after any failure — see
        _invalidate_session). Clients must never send delta uploads to a
        sidecar that has not advertised HealthReply.resident_state."""
        if self._resident_cap is None:
            self._probe_capabilities()
        return bool(self._resident_cap)

    def supports_windows_resident(self) -> bool:
        """Resolve the sidecar's windows-resident capability (resident
        deltas on the ScheduleWindows backlog RPC) — same latch
        discipline as supports_resident."""
        if self._windows_resident_cap is None:
            self._probe_capabilities()
        return bool(self._windows_resident_cap)

    def supports_gangs(self) -> bool:
        """Resolve the sidecar's gang-scheduling capability
        (HealthReply.gang_scheduling) — same latch discipline. False
        flips every schedule call into degraded mode: the gang tensors
        are stripped off the wire (_PODS_SANS_GANGS) and the host's
        _resolve_gangs backstop enforces all-or-nothing instead of the
        device op, with identical bindings."""
        if self._gang_cap is None:
            self._probe_capabilities()
        return bool(self._gang_cap)

    def supports_fused_min_max(self) -> bool:
        """Resolve the sidecar's fused min-max epilogue capability
        (HealthReply.fused_min_max) — same latch discipline. False
        keeps the host's normalizer="min_max" cycles on the unfused
        path (exactly the pre-widening behavior), so a version-skewed
        or CPU-backed sidecar is never asked for a fused contract it
        would reject or serve slowly."""
        if self._fused_min_max_cap is None:
            self._probe_capabilities()
        return bool(self._fused_min_max_cap)

    def _pods_wire_fields(self) -> frozenset | None:
        """The PodBatch fields to put on the wire: everything, or
        everything minus the gang tensors against a gang-blind sidecar."""
        return None if self.supports_gangs() else _PODS_SANS_GANGS

    def _invalidate_session(self) -> None:
        """Reset everything scoped to the sidecar behind this target:
        the wire field cache AND every capability latch — always
        together, through the one canonical latch table. A failed
        send means the sidecar may have been replaced (restart,
        rollback to an older build): clearing only the field cache
        would leave the other latches trusting the dead sidecar's
        advertisement, so the client would keep shipping deltas/gang
        tensors/fused contracts an older build cannot serve. The next
        call re-probes Health and re-learns the whole set."""
        self._wire_cache.clear()
        for attr in CAPABILITY_LATCHES.values():
            setattr(self, attr, None)

    def _cache_for(self, key: str, enabled: bool):
        if not enabled:
            return None
        return self._wire_cache.setdefault(key, {})

    def _call_cached(self, method, build_request):
        """Send with field-cache recovery: on FAILED_PRECONDITION
        "field-cache-miss" (sidecar restart / session eviction), clear
        the local cache and resend ONE full request. Any OTHER failure
        also clears the cache — packing commits values the server may
        never have processed, and a desynced cache would silently
        resolve later markers to stale server-side tensors — AND drops
        the latched capability back to unknown: the sidecar behind this
        target may have been replaced by an older build without
        field_cache support (its INVALID_ARGUMENT on a marker-bearing
        send would otherwise repeat forever), so the next call re-probes
        health instead of trusting a dead sidecar's advertisement. A
        resend that itself fails gets the same treatment — its
        build_request() just repopulated the cache with values the
        server never stored."""
        try:
            return self._call_with_retry(method, build_request())
        except EngineUnavailable as e:
            cause = e.__cause__
            if (
                isinstance(cause, grpc.RpcError)
                and cause.code() == grpc.StatusCode.FAILED_PRECONDITION
                and "field-cache-miss" in (cause.details() or "")
            ):
                log.warning(
                    "sidecar %s lost the wire field cache (restart?); "
                    "resending in full", self.target,
                )
                self._wire_cache.clear()
                try:
                    return self._call_with_retry(method, build_request())
                except Exception:
                    self._invalidate_session()
                    raise
            self._invalidate_session()
            raise
        except Exception:
            self._invalidate_session()
            raise

    def _base_request(
        self,
        *,
        policy: str = "balanced_cpu_diskio",
        assigner: str = "greedy",
        normalizer: str = "min_max",
        fused: bool = False,
        affinity_aware: bool = True,
        soft: bool = False,
        auction_price_frac: float = 0.0,
        auction_rounds: int = 0,
        score_plugins: tuple | None = None,
    ) -> pb.ScheduleRequest:
        """The option skeleton shared by ScheduleBatch-shaped calls
        (plain and resident), so the two cannot drift on how cycle
        options ride the wire."""
        request = pb.ScheduleRequest(
            policy=policy,
            assigner=assigner,
            normalizer=normalizer,
            decisions_only=self.decisions_only,
            fused=fused,
            affinity_aware=affinity_aware,
            soft=soft,
            # 0 = sidecar default; nonzero rides the wire so remote
            # engines honor the host's auction config instead of
            # silently degrading to defaults
            auction_price_frac=auction_price_frac,
            auction_rounds=auction_rounds,
        )
        for name, weight in score_plugins or ():
            request.score_plugins.add(name=name, weight=float(weight))
        return request

    def schedule_batch(self, snapshot, pods, **kw) -> engine.ScheduleResult:
        request = self._base_request(**kw)

        def build_request():
            req = pb.ScheduleRequest()
            req.CopyFrom(request)
            enabled = self._field_cache_enabled()
            snap_cache = self._cache_for("batch:snapshot", enabled)
            pods_cache = self._cache_for("batch:pods", enabled)
            if enabled:
                req.session_id = self._session_id
            codec.pack_fields(snapshot, req.snapshot, cache=snap_cache)
            codec.pack_fields(
                pods, req.pods, cache=pods_cache,
                only=self._pods_wire_fields(),
            )
            return req

        reply = self._call_cached(self._schedule, build_request)
        return self._unpack_result(reply, snapshot, pods)

    def schedule_resident(
        self, snapshot, pods, *, delta=None, epoch: int = 0, **kw
    ) -> engine.ScheduleResult:
        """ScheduleBatch against sidecar-resident cluster state:
        `snapshot` is always the full host build (the fallback payload);
        when `delta` is given it ships INSTEAD of the snapshot map and
        the sidecar applies it to the state retained under this client's
        session. An inapplicable delta (sidecar restart, session
        eviction, epoch desync, layout churn) aborts INVALID_ARGUMENT
        "resident-epoch-mismatch" and this method transparently resends
        the full snapshot — the cycle never pays a fallback for it. A
        sidecar that does not advertise the capability is served a plain
        ScheduleBatch."""
        if not self.supports_resident():
            self.resident_used_delta = False
            return self.schedule_batch(snapshot, pods, **kw)
        request = self._base_request(**kw)

        def build_request(with_delta: bool):
            req = pb.ScheduleRequest()
            req.CopyFrom(request)
            enabled = self._field_cache_enabled()
            pods_cache = self._cache_for("batch:pods", enabled)
            # resident state is session-keyed regardless of the field
            # cache: the id always rides resident requests
            req.session_id = self._session_id
            req.resident_epoch = epoch
            if with_delta:
                # the snapshot map stays EMPTY — the sidecar resolves it
                # from its retained state; only the delta crosses the wire
                codec.pack_fields(delta, req.snapshot_delta)
            else:
                req.resident_full = True
                snap_cache = self._cache_for("batch:snapshot", enabled)
                codec.pack_fields(snapshot, req.snapshot, cache=snap_cache)
            codec.pack_fields(
                pods, req.pods, cache=pods_cache,
                only=self._pods_wire_fields(),
            )
            return req

        reply = self._resident_call(
            self._schedule, build_request, delta, "resident"
        )
        return self._unpack_result(reply, snapshot, pods)

    def _resident_call(self, method, build_request, delta, what: str):
        """Delta-first resident send with the transparent full resend on
        INVALID_ARGUMENT "resident-epoch-mismatch" (sidecar restart,
        session eviction, epoch desync, layout churn) — ONE
        implementation of the recovery protocol for both resident
        surfaces (ScheduleBatch and ScheduleWindows), so the
        string-matched detail contract cannot drift between them.
        Leaves `resident_used_delta` reporting which path served the
        call."""
        if delta is not None:
            try:
                reply = self._call_cached(
                    method, lambda: build_request(True)
                )
                self.resident_used_delta = True
                return reply
            except EngineUnavailable as e:
                cause = e.__cause__
                if not (
                    isinstance(cause, grpc.RpcError)
                    and cause.code() == grpc.StatusCode.INVALID_ARGUMENT
                    and "resident-epoch-mismatch" in (cause.details() or "")
                ):
                    raise
                log.warning(
                    "sidecar %s cannot apply the %s delta "
                    "(restart/eviction/churn); resending in full",
                    self.target, what,
                )
        self.resident_used_delta = False
        return self._call_cached(method, lambda: build_request(False))

    def schedule_resident_async(
        self, snapshot, pods, *, delta=None, epoch: int = 0, **kw
    ) -> _FutureSchedule:
        """In-flight twin of schedule_resident on the dedicated worker
        thread (see schedule_batch_async); errors surface from
        handle.result()."""
        if self._async_pool is None:
            import concurrent.futures

            self._async_pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="yoda-bridge-async"
            )
        return _FutureSchedule(
            self._async_pool.submit(
                self.schedule_resident, snapshot, pods,
                delta=delta, epoch=epoch, **kw,
            )
        )

    def schedule_batch_async(self, snapshot, pods, **kw) -> _FutureSchedule:
        """Concurrent in-flight ScheduleBatch (the pipelined host loop's
        async surface): submits the full synchronous call — retries,
        field-cache recovery and all — to the dedicated worker thread
        and returns immediately. Errors (EngineUnavailable included)
        surface from `handle.result()`, where the scheduler's existing
        fallback handling catches them."""
        if self._async_pool is None:
            import concurrent.futures

            self._async_pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="yoda-bridge-async"
            )
        return _FutureSchedule(
            self._async_pool.submit(self.schedule_batch, snapshot, pods, **kw)
        )

    def schedule_windows(
        self,
        snapshot,
        pods_windows,
        *,
        policy: str = "balanced_cpu_diskio",
        assigner: str = "auction",
        normalizer: str = "none",
        fused: bool = False,
        affinity_aware: bool = True,
        soft: bool = False,
        auction_price_frac: float = 0.0,
        auction_rounds: int = 0,
        score_plugins: tuple | None = None,
    ) -> "engine.WindowsResult":
        """Whole-backlog RPC: pods_windows carries a leading [w, p, ...]
        window axis (engine.stack_windows); one sidecar dispatch
        schedules every window with capacity and (anti)affinity carries
        threaded between them, and the reply is engine.WindowsResult."""
        request = pb.ScheduleRequest(
            policy=policy,
            assigner=assigner,
            normalizer=normalizer,
            fused=fused,
            affinity_aware=affinity_aware,
            soft=soft,
            auction_price_frac=auction_price_frac,
            auction_rounds=auction_rounds,
        )
        def build_request():
            req = pb.ScheduleRequest()
            req.CopyFrom(request)
            enabled = self._field_cache_enabled()
            snap_cache = self._cache_for("windows:snapshot", enabled)
            pods_cache = self._cache_for("windows:pods", enabled)
            if enabled:
                req.session_id = self._session_id
            codec.pack_fields(snapshot, req.snapshot, cache=snap_cache)
            codec.pack_fields(
                pods_windows, req.pods, cache=pods_cache,
                only=self._pods_wire_fields(),
            )
            return req

        for name, weight in score_plugins or ():
            request.score_plugins.add(name=name, weight=float(weight))
        reply = self._call_cached(self._schedule_windows, build_request)
        return codec.unpack_fields(engine.WindowsResult, reply.result)

    def schedule_windows_resident(
        self, snapshot, pods_windows, *, delta=None, epoch: int = 0, **kw
    ) -> "engine.WindowsResult":
        """ScheduleWindows against sidecar-resident cluster state (the
        backlog twin of schedule_resident, same session-retained
        snapshot and epoch sequence). `snapshot` is always the full host
        build; a given `delta` ships instead of the snapshot map, and an
        inapplicable delta (restart, eviction, epoch desync, churn)
        aborts INVALID_ARGUMENT "resident-epoch-mismatch" — this method
        transparently resends the full snapshot. A sidecar without the
        windows_resident capability is served a plain ScheduleWindows."""
        if not self.supports_windows_resident():
            self.resident_used_delta = False
            return self.schedule_windows(snapshot, pods_windows, **kw)
        request = self._base_request(**kw)

        def build_request(with_delta: bool):
            req = pb.ScheduleRequest()
            req.CopyFrom(request)
            enabled = self._field_cache_enabled()
            pods_cache = self._cache_for("windows:pods", enabled)
            req.session_id = self._session_id
            req.resident_epoch = epoch
            if with_delta:
                codec.pack_fields(delta, req.snapshot_delta)
            else:
                req.resident_full = True
                snap_cache = self._cache_for("windows:snapshot", enabled)
                codec.pack_fields(snapshot, req.snapshot, cache=snap_cache)
            codec.pack_fields(
                pods_windows, req.pods, cache=pods_cache,
                only=self._pods_wire_fields(),
            )
            return req

        reply = self._resident_call(
            self._schedule_windows, build_request, delta, "windows-resident"
        )
        return codec.unpack_fields(engine.WindowsResult, reply.result)

    def preempt(self, snapshot, pods, victims, *, k_cap: int):
        """Preemption pass on the sidecar (engine.preempt_batch): `pods`
        = this cycle's unschedulable preemptors, `victims` an
        ops.preempt.VictimArrays. Raises NotImplementedError against a
        version-skewed sidecar without the RPC — the host then runs the
        pass in-process (host/scheduler._run_preemption)."""
        from kubernetes_scheduler_tpu_torch.ops.preempt import PreemptResult

        request = pb.ScheduleRequest(preempt_k_cap=k_cap)
        codec.pack_fields(snapshot, request.snapshot)
        codec.pack_fields(pods, request.pods)
        codec.pack_fields(victims, request.victims)
        try:
            reply = self._call_with_retry(
                self._preempt, request, profile_ok=False
            )
        except EngineUnavailable:
            # same session hygiene as every schedule path: a failed
            # Preempt means the sidecar behind this target may have
            # been replaced, so the latched capabilities and the wire
            # field cache must not outlive it. (A clean UNIMPLEMENTED
            # degrade keeps the session: the sidecar answered.)
            self._invalidate_session()
            raise
        return codec.unpack_fields(PreemptResult, reply.result)

    def _call_with_retry(self, method, request, *, profile_ok: bool = True):
        if not self.breaker.allow():
            # open breaker: fail the cycle in microseconds instead of a
            # deadline timeout — the scheduler's scalar fallback serves
            # it, and ONE half-open probe per recovery window retests
            # the sidecar
            raise EngineUnavailable(
                f"sidecar {self.target} circuit open (one probe per "
                f"{self.breaker.recovery_window_s:g}s window)"
            )
        last_err = None
        metadata = self._call_metadata(profile_ok=profile_ok)
        # the kwarg is attached only when telemetry context exists:
        # metadata-free calls keep the bare (request, timeout) surface
        # (injectable test doubles and old stubs depend on it)
        kw = {"metadata": metadata} if metadata else {}
        for attempt in range(self.retries + 1):
            try:
                reply = method(request, timeout=self.deadline_seconds, **kw)
                self.last_engine_seconds = reply.engine_seconds
                self.breaker.record_success()
                return reply
            except grpc.RpcError as e:
                last_err = e
                if e.code() == grpc.StatusCode.UNIMPLEMENTED:
                    # version-skewed sidecar without this RPC: callers
                    # (host backlog mode) degrade to the per-window
                    # surface rather than treating it as an outage —
                    # the sidecar ANSWERED, so the breaker reads it as
                    # alive
                    self.breaker.record_success()
                    raise NotImplementedError(
                        f"sidecar {self.target} does not serve this RPC"
                    ) from e
                if e.code() not in _RETRYABLE:
                    # an explicit rejection (INVALID_ARGUMENT epoch
                    # mismatch, FAILED_PRECONDITION cache miss) is a
                    # live sidecar speaking — not an outage
                    self.breaker.record_success()
                    raise EngineUnavailable(
                        f"sidecar rejected cycle: {e.code().name}: {e.details()}"
                    ) from e
                log.warning(
                    "sidecar %s unavailable (attempt %d/%d): %s",
                    self.target, attempt + 1, self.retries + 1, e.code().name,
                )
                if e.code() == grpc.StatusCode.UNAVAILABLE:
                    self._kick_reconnect()
                if attempt < self.retries:
                    # deterministic-jitter exponential backoff
                    # (host/resilience.BackoffPolicy): same growth as
                    # the old bare sleep, de-phased across targets
                    time.sleep(
                        self._backoff.delay(attempt, key=self.target)
                    )
        self.breaker.record_failure()
        raise EngineUnavailable(
            f"sidecar {self.target} unreachable after {self.retries + 1} attempts"
        ) from last_err

    def _unpack_result(self, reply, snapshot, pods) -> engine.ScheduleResult:
        p = np.asarray(pods.request).shape[0]
        n = np.asarray(snapshot.allocatable).shape[0]
        # decisions_only replies omit the [p, n] matrices; fill with empties
        defaults = {
            "scores": np.zeros((p, n), np.float32),
            "raw_scores": np.zeros((p, n), np.float32),
            "feasible": np.zeros((p, n), bool),
        }
        return codec.unpack_fields(
            engine.ScheduleResult, reply.result, defaults=defaults
        )

    def _kick_reconnect(self) -> None:
        """Nudge the channel to actually re-dial after a transport
        failure. grpc-python's fail-fast RPCs on a TRANSIENT_FAILURE
        channel return immediately WITHOUT requesting a new connection
        — observed on this grpc build: a client created while the
        sidecar was down keeps failing for minutes after the sidecar
        recovers, while a fresh client connects instantly. A
        try_to_connect subscription (immediately unsubscribed) forces
        the re-dial, so the breaker's half-open probe cadence — not the
        transport's stuck state — is the recovery clock."""
        cb = _noop_state
        try:
            self._channel.subscribe(cb, try_to_connect=True)
            self._channel.unsubscribe(cb)
        except Exception:
            log.debug("reconnect kick failed", exc_info=True)

    def _health_failed(self, e: grpc.RpcError) -> None:
        """Classify one health-probe failure — deadline-exceeded (the
        sidecar exists but could not answer in time: saturation, GC,
        device wedge) vs transport-down (connection refused/reset: the
        process or network is gone) — count them SEPARATELY and feed
        the breaker. Previously both were swallowed identically, so
        dashboards could not tell a saturated sidecar from a dead one
        and the outage never tripped the breaker."""
        kind = (
            "deadline"
            if e.code() == grpc.StatusCode.DEADLINE_EXCEEDED
            else "transport"
        )
        self.ctr_health_failures.inc(kind=kind)
        self.breaker.record_failure()
        if kind == "transport":
            self._kick_reconnect()
        log.debug(
            "sidecar %s health probe failed (%s): %s",
            self.target, kind, e.code().name,
        )

    def healthy(self, *, timeout: float = 2.0) -> bool:
        if not self.breaker.allow():
            self.ctr_health_failures.inc(kind="breaker-open")
            return False
        try:
            reply = self._health(pb.HealthRequest(), timeout=timeout)
        except grpc.RpcError as e:
            self._health_failed(e)
            return False
        self.breaker.record_success()
        return reply.status == "SERVING"

    def health_info(self, *, timeout: float = 2.0) -> pb.HealthReply | None:
        if not self.breaker.allow():
            self.ctr_health_failures.inc(kind="breaker-open")
            return None
        try:
            reply = self._health(pb.HealthRequest(), timeout=timeout)
        except grpc.RpcError as e:
            self._health_failed(e)
            return None
        self.breaker.record_success()
        return reply

    def close(self) -> None:
        if self._async_pool is not None:
            # wait=True: an in-flight RPC owns the channel — closing it
            # under the worker would surface a spurious cycle failure
            self._async_pool.shutdown(wait=True)
            self._async_pool = None
        self._channel.close()
