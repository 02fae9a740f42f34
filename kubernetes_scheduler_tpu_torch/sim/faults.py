"""Seeded, deterministic fault injection at every boundary (the port's
copy of kubernetes_scheduler_tpu/sim/faults.py).

A `FaultPlan` is a small program of tick-scheduled `FaultWindow`s on the
scenario VIRTUAL clock (sim/scenarios/base.SimClock): each window names
a subsystem boundary ("advisor", "informer", "engine", "journal",
"mirror"), a fault kind (error / latency / timeout / corruption /
flapping / partition), and a [start, end) tick range. Everything is
derived from the window table and the clock — no RNG — so the same
(scenario, seed, plan) always produces the same failures at the same
ticks, the same degradation events, and the same journal: chaos runs
are REPLAY-PINNED exactly like clean ones.

Injection happens through thin wrappers around objects the Scheduler
and CLI already own, never through monkey-patched internals:

- `FaultyAdvisor` wraps the advisor's `fetch()` (host/advisor.py) —
  the scheduler's fetch-failure/stale-grace path is the consumer;
- `FaultyEngine` wraps any engine's call surface (TorchEngine's whole
  surface: the stateless, resident, async and fleet dispatches, whose
  async calls hand back the inner engine's PendingSchedule, and the
  health probes), and simulates a sidecar crash-restart by dropping
  retained resident state when a `crash`-tagged window closes;
- `FaultInjector.wrap_journal` wraps the flight recorder's
  `JournalWriter.append` (trace/recorder.py) with disk-full faults —
  the recorder's never-raise-into-the-loop contract absorbs them as
  `trace_records_dropped_total`;
- informer-stream faults gate ScenarioWorld's event delivery into the
  snapshot mirror (partition = buffered then flushed, error = dropped
  until RESYNC semantics reseed);
- mirror corruption goes through `SnapshotMirror.inject_corruption`
  (host/mirror.py) — the periodic bitwise verify cross-check must
  detect and resync it.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable

BOUNDARIES = ("advisor", "informer", "engine", "journal", "mirror")
FAULT_KINDS = (
    "error", "latency", "timeout", "corrupt", "flap", "partition",
)


class FaultError(RuntimeError):
    """Injected hard failure at a boundary."""


class FaultTimeout(TimeoutError):
    """Injected deadline expiry at a boundary."""


class FaultPartition(ConnectionError):
    """Injected network partition: the peer is unreachable."""


class FaultDiskFull(OSError):
    """Injected ENOSPC on a journal/span write."""


@dataclass(frozen=True)
class FaultWindow:
    """One scheduled fault: `kind` at `boundary` over virtual-clock
    [start, end). `flap` alternates per whole tick with `period` (fails
    on phase 0); `latency` adds `latency_s` of (bounded) real delay;
    `detail` tags windows for wrapper-specific behavior (e.g. "crash"
    on an engine window drops retained resident state at close)."""

    boundary: str
    kind: str
    start: float
    end: float
    latency_s: float = 0.0
    period: int = 2
    detail: str = ""

    def __post_init__(self):
        if self.boundary not in BOUNDARIES:
            raise ValueError(f"unknown fault boundary {self.boundary!r}")
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}")
        if not self.end > self.start:
            raise ValueError("fault window must have end > start")

    def active(self, now: float) -> bool:
        if not (self.start <= now < self.end):
            return False
        if self.kind == "flap":
            return int(now - self.start) % max(1, self.period) == 0
        return True


@dataclass(frozen=True)
class FaultPlan:
    """The program: a tuple of windows, queried by (boundary, now)."""

    windows: tuple = ()

    def active(self, boundary: str, now: float) -> list[FaultWindow]:
        return [
            w for w in self.windows
            if w.boundary == boundary and w.active(now)
        ]

    def last_end(self) -> float:
        return max((w.end for w in self.windows), default=0.0)


_RAISES = {
    "error": FaultError,
    "flap": FaultError,
    "timeout": FaultTimeout,
    "partition": FaultPartition,
}

# real-sleep ceiling for latency faults: the DECISIONS are unaffected
# either way (replay parity holds), so the wall delay only needs to be
# visible in latency telemetry, not realistic
_MAX_REAL_SLEEP_S = 0.05


@dataclass
class FaultInjector:
    """Evaluates a FaultPlan against the scenario clock and injects at
    each boundary. `injected` counts every fault fired, keyed
    (boundary, kind) — the scenario summary's audit surface."""

    plan: FaultPlan
    clock: Callable[[], float]
    sleep: Callable[[float], None] = time.sleep
    injected: dict = field(default_factory=dict)

    def _count(self, boundary: str, kind: str) -> None:
        key = (boundary, kind)
        self.injected[key] = self.injected.get(key, 0) + 1

    def check(self, boundary: str, *, error_cls=None) -> None:
        """Apply the active windows at `boundary`: latency sleeps (and
        counts), every failing kind raises its exception class
        (`error_cls` overrides for boundary-specific types, e.g. the
        journal's OSError)."""
        now = self.clock()
        for w in self.plan.active(boundary, now):
            if w.kind == "latency":
                self._count(boundary, "latency")
                if w.latency_s > 0:
                    self.sleep(min(w.latency_s, _MAX_REAL_SLEEP_S))
            elif w.kind in _RAISES:
                self._count(boundary, w.kind)
                cls = error_cls or _RAISES[w.kind]
                raise cls(
                    f"injected {w.kind} at {boundary} "
                    f"(window [{w.start}, {w.end}) @ t={now})"
                )

    def blocked(self, boundary: str) -> bool:
        """Would check() raise right now (latency/corrupt excluded)?"""
        now = self.clock()
        return any(
            w.kind in _RAISES for w in self.plan.active(boundary, now)
        )

    def quiesced(self) -> bool:
        """Past every window — the recovery tail has begun."""
        return self.clock() >= self.plan.last_end()

    def summary(self) -> dict:
        return {f"{b}:{k}": n for (b, k), n in sorted(self.injected.items())}

    def check_health_observed(self) -> None:
        """Count a health probe that observed an injected outage (no
        raise — health probes report, they don't fail)."""
        self._count("engine", "health-observed")

    # -- journal boundary -------------------------------------------------

    def wrap_journal(self, recorder) -> None:
        """Wrap the flight recorder's JournalWriter.append with
        disk-full faults (raised BEFORE any bytes hit the file, so no
        torn frames — the injected failure mode is a full disk
        rejecting the write, and the recorder's catch-count-drop
        contract absorbs it)."""
        if recorder is None:
            return
        writer = recorder._writer
        orig = writer.append
        inj = self

        def append(payload, *, rotate: bool = False):
            inj.check("journal", error_cls=FaultDiskFull)
            return orig(payload, rotate=rotate)

        writer.append = append


# ---- boundary wrappers -----------------------------------------------------


class FaultyAdvisor:
    """Advisor-fetch boundary wrapper: `fetch()` (and the coalescing
    `fetch_changed` when the inner advisor has one) raises/delays per
    the plan; everything else delegates. The scheduler's consumer side
    is the fetch-failure path (requeue + backoff hold) and the
    stale-utilization grace mode (config.advisor_stale_ttl_s)."""

    def __init__(self, inner, injector: FaultInjector):
        self.inner = inner
        self._inj = injector
        self._last: dict = {}

    def fetch(self):
        self._inj.check("advisor")
        return self.inner.fetch()

    def fetch_changed(self):
        """Changed-node coalescing surface, faulted: delegates when the
        inner advisor coalesces, otherwise diffs like CoalescingAdvisor
        (host/advisor.util_delta) — either way the injected failure
        fires BEFORE any data moves."""
        self._inj.check("advisor")
        fc = getattr(self.inner, "fetch_changed", None)
        if fc is not None:
            return fc()
        from kubernetes_scheduler_tpu_torch.host.advisor import util_delta

        return util_delta(self._last, self.inner.fetch())

    def __getattr__(self, name):
        return getattr(self.inner, name)


class FaultyEngine:
    """Engine/bridge boundary wrapper: every schedule/preempt dispatch
    checks the plan first (so an in-window call fails the way a dead or
    partitioned sidecar would), the async surfaces check at dispatch
    time, and the health probes report the injected outage instead of
    raising (a health check's job is to OBSERVE the failure). A window
    tagged detail="crash" simulates a sidecar crash-restart: when it
    closes, the retained resident state is dropped (the restarted
    process never had it), forcing the epoch-mismatch full-resend
    recovery path."""

    def __init__(self, inner, injector: FaultInjector):
        self.inner = inner
        self._inj = injector
        self._crash_armed = False

    def _gate(self) -> None:
        now = self._inj.clock()
        crashing = any(
            w.detail == "crash"
            for w in self._inj.plan.active("engine", now)
        )
        if crashing:
            self._crash_armed = True
        elif self._crash_armed:
            # the crash window closed: the "restarted" engine lost its
            # retained resident state exactly once per crash
            self._crash_armed = False
            self.inner.invalidate_resident()
        self._inj.check("engine")

    # -- dispatch surfaces ------------------------------------------------

    def schedule_batch(self, snapshot, pods, **kw):
        self._gate()
        return self.inner.schedule_batch(snapshot, pods, **kw)

    def schedule_resident(self, snapshot, pods, **kw):
        self._gate()
        return self.inner.schedule_resident(snapshot, pods, **kw)

    def schedule_batch_async(self, snapshot, pods, **kw):
        self._gate()
        return self.inner.schedule_batch_async(snapshot, pods, **kw)

    def schedule_resident_async(self, snapshot, pods, **kw):
        self._gate()
        return self.inner.schedule_resident_async(snapshot, pods, **kw)

    def schedule_windows(self, snapshot, pods_windows, **kw):
        self._gate()
        return self.inner.schedule_windows(snapshot, pods_windows, **kw)

    def schedule_windows_resident(self, snapshot, pods_windows, **kw):
        self._gate()
        return self.inner.schedule_windows_resident(
            snapshot, pods_windows, **kw
        )

    def schedule_batch_fleet(self, snapshot, requests, **kw):
        self._gate()
        return self.inner.schedule_batch_fleet(snapshot, requests, **kw)

    def preempt(self, snapshot, pods, victims, **kw):
        self._gate()
        return self.inner.preempt(snapshot, pods, victims, **kw)

    # -- health -----------------------------------------------------------

    def healthy(self, **kw) -> bool:
        if self._inj.blocked("engine"):
            self._inj.check_health_observed()
            return False
        return bool(self.inner.healthy(**kw))

    def health_info(self, **kw):
        if self._inj.blocked("engine"):
            self._inj.check_health_observed()
            return None
        return self.inner.health_info(**kw)

    def __getattr__(self, name):
        return getattr(self.inner, name)


# ---- informer-stream gating (ScenarioWorld -> mirror) ----------------------


class InformerGate:
    """The informer-event boundary for scenario runs: ScenarioWorld
    routes its mirror deliveries (node/pod events) through here. During
    a partition window, events BUFFER (the watch stream is cut, the
    world keeps moving); `flush()` — called at each tick boundary —
    delivers the backlog in arrival order once the window closes, the
    same late-but-ordered delivery a re-established watch gives. An
    `error` window DROPS events (a crashed informer misses them
    outright); the consumer's RESYNC/verify machinery is what must
    absorb that."""

    def __init__(self, injector: FaultInjector):
        self._inj = injector
        self._buffer: list[tuple] = []
        self.dropped = 0

    def deliver(self, apply: Callable, *args) -> None:
        now = self._inj.clock()
        wins = self._inj.plan.active("informer", now)
        for w in wins:
            if w.kind == "partition":
                self._inj._count("informer", "partition")
                self._buffer.append((apply, args))
                return
            if w.kind in ("error", "flap"):
                self._inj._count("informer", w.kind)
                self.dropped += 1
                return
        apply(*args)

    def flush(self) -> int:
        """Deliver buffered events if no partition window is active;
        returns how many were delivered."""
        now = self._inj.clock()
        if any(
            w.kind == "partition"
            for w in self._inj.plan.active("informer", now)
        ):
            return 0
        buffered, self._buffer = self._buffer, []
        for apply, args in buffered:
            apply(*args)
        return len(buffered)
