"""Unified resilience: deterministic backoff, circuit breaking, and the
degradation ladder.

The system grew a dozen ad-hoc survival paths — scalar fallback,
fetch-failed requeue, resident flush-to-full, capability downgrade,
mirror verify-resync, pipeline flush — each correct alone, none sharing
a retry policy and none owning the question "how degraded are we right
now, and are we climbing back?". This module is the single owner:

- `BackoffPolicy`: exponential backoff with DETERMINISTIC jitter (a
  crc32 hash of (key, attempt) — no RNG, so scenario runs on the
  virtual clock replay bit-for-bit and two hosts never thundering-herd
  in phase).
- `CircuitBreaker`: closed -> open -> half-open with recovery probes.
  Shared by the advisor and bridge paths (host/scheduler.py holds one
  per dependency; bridge/client.RemoteEngine holds its own for the RPC
  surface), so an outage costs ONE probe per recovery window instead
  of a timeout per call.
- `DegradationLadder`: the explicit degradation-ladder state machine —
  one rung set per subsystem (remote->local, resident->full,
  fused->unfused, sharded->dense, mirror->rebuild, policy->scalar),
  each move exactly ONE rung with a recorded reason and entry seq
  (never skips a rung downward silently), recovery only through an
  explicit re-probe, exported as `degradation_rung{subsystem}` and
  journaled through CycleMetrics so chaos runs are replay-pinned like
  everything else. The protocol shape (one-rung demotes, probe-before-
  promote, breaker-open implies a degraded engine rung) is model-
  checked by analysis/model/protocols.py `degradation-ladder`.
"""

from __future__ import annotations

import logging
import threading
import time
import zlib
from collections import deque
from typing import Callable

log = logging.getLogger("yoda_tpu.resilience")

# ---- deterministic backoff -------------------------------------------------


class BackoffPolicy:
    """Exponential backoff with deterministic jitter.

    delay(attempt) grows `initial * multiplier**attempt` capped at
    `max_delay`, then shaved by up to `jitter_frac` of itself using a
    crc32 hash of (key, attempt) — the jitter de-phases retry storms
    across keys without any RNG, so the same (key, attempt) always
    yields the same delay (scenario determinism; PARITY round 17)."""

    def __init__(
        self,
        *,
        initial: float = 0.5,
        max_delay: float = 8.0,
        multiplier: float = 2.0,
        jitter_frac: float = 0.25,
    ):
        self.initial = float(initial)
        self.max_delay = float(max_delay)
        self.multiplier = float(multiplier)
        self.jitter_frac = float(jitter_frac)

    def delay(self, attempt: int, *, key: str = "") -> float:
        base = min(
            self.initial * self.multiplier ** max(0, int(attempt)),
            self.max_delay,
        )
        h = zlib.crc32(f"{key}:{int(attempt)}".encode()) / 2**32
        return base * (1.0 - self.jitter_frac * h)


# ---- circuit breaker -------------------------------------------------------

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half-open"


class CircuitBreaker:
    """closed -> open -> half-open with single-probe recovery.

    `allow()` answers "may this call go out?": always in CLOSED; in
    OPEN, False until `recovery_window_s` has elapsed, then the breaker
    moves to HALF_OPEN and admits exactly ONE probe; in HALF_OPEN,
    False while that probe is outstanding. `record_success()` closes
    the breaker, `record_failure()` re-opens it (and restarts the
    window) — so a dead dependency costs one probe per window, not a
    timeout per call. The clock is injectable (the scenario harness
    passes the virtual queue clock, making open/half-open transitions
    tick-deterministic)."""

    def __init__(
        self,
        name: str,
        *,
        failure_threshold: int = 3,
        recovery_window_s: float = 8.0,
        clock: Callable[[], float] | None = None,
        on_transition: Callable[[str, str], None] | None = None,
    ):
        self.name = name
        self.failure_threshold = int(failure_threshold)
        self.recovery_window_s = float(recovery_window_s)
        self._clock = clock or time.monotonic
        self._lock = threading.Lock()
        self._state = CLOSED
        self._consecutive_failures = 0
        self._opened_at = 0.0
        self._probe_outstanding = False
        self._probe_issued_at = 0.0
        # state -> times entered (CLOSED entries = recoveries)
        self.transition_counts: dict[str, int] = {}
        self._on_transition = on_transition

    def _move(self, state: str) -> str:
        """Transition under the lock; returns the new state so the
        caller can fire hooks OUTSIDE the lock."""
        self._state = state
        self.transition_counts[state] = (
            self.transition_counts.get(state, 0) + 1
        )
        return state

    def _fire(self, moved: str | None) -> None:
        if moved is not None and self._on_transition is not None:
            try:
                self._on_transition(self.name, moved)
            except Exception:
                log.exception("breaker %s transition hook failed", self.name)

    def configure(
        self,
        *,
        failure_threshold: int | None = None,
        recovery_window_s: float | None = None,
        clock: Callable[[], float] | None = None,
        on_transition: Callable[[str, str], None] | None = None,
    ) -> "CircuitBreaker":
        """Retune an existing breaker in place — the Scheduler adopts
        an engine-owned breaker (RemoteEngine constructs one per
        target) as THE engine breaker, applying its config knobs,
        clock, and transition hook so one instance governs both the
        dispatch gate and the client's RPC gate."""
        with self._lock:
            if failure_threshold is not None:
                self.failure_threshold = int(failure_threshold)
            if recovery_window_s is not None:
                self.recovery_window_s = float(recovery_window_s)
            if clock is not None:
                self._clock = clock
            if on_transition is not None:
                self._on_transition = on_transition
        return self

    def state(self) -> str:
        with self._lock:
            return self._state

    def allow(self) -> bool:
        moved = None
        with self._lock:
            now = self._clock()
            if self._state == CLOSED:
                return True
            if self._state == OPEN:
                if now - self._opened_at >= self.recovery_window_s:
                    moved = self._move(HALF_OPEN)
                    self._probe_outstanding = True
                    self._probe_issued_at = now
                    ok = True
                else:
                    ok = False
            else:  # HALF_OPEN: one probe at a time
                if self._probe_outstanding and (
                    now - self._probe_issued_at < self.recovery_window_s
                ):
                    ok = False
                else:
                    # no probe out — or the outstanding one is a full
                    # recovery window old with no outcome recorded
                    # (leaked: the caller that consumed it never
                    # reached a record_* path). A wedged half-open
                    # would be scalar-forever, so presume the probe
                    # lost and admit a fresh one.
                    self._probe_outstanding = True
                    self._probe_issued_at = now
                    ok = True
        self._fire(moved)
        return ok

    def peek(self) -> bool:
        """allow() without side effects: would a call be admitted right
        now? The scheduler's dispatch gate uses this when the breaker
        is SHARED with the bridge client — the client's allow() at send
        time is the one consuming transition/probe point, and a
        consuming pre-gate would eat the half-open probe the dispatch
        itself is entitled to."""
        with self._lock:
            now = self._clock()
            if self._state == CLOSED:
                return True
            if self._state == OPEN:
                return now - self._opened_at >= self.recovery_window_s
            return not self._probe_outstanding or (
                now - self._probe_issued_at >= self.recovery_window_s
            )

    def record_success(self) -> None:
        moved = None
        with self._lock:
            self._consecutive_failures = 0
            self._probe_outstanding = False
            if self._state != CLOSED:
                moved = self._move(CLOSED)
        self._fire(moved)

    def record_failure(self) -> None:
        moved = None
        with self._lock:
            self._probe_outstanding = False
            self._consecutive_failures += 1
            if self._state == HALF_OPEN or (
                self._state == CLOSED
                and self._consecutive_failures >= self.failure_threshold
            ):
                self._opened_at = self._clock()
                moved = self._move(OPEN)
            elif self._state == OPEN:
                # a failure recorded while already open (a raced probe
                # completing late) restarts the recovery window
                self._opened_at = self._clock()
        self._fire(moved)


# ---- the degradation ladder ------------------------------------------------

# subsystem -> rung names, TOP FIRST. Two-rung ladders today; the demote
# contract (one rung per call, reason + entry seq recorded) is written
# for any depth.
LADDER_RUNGS: dict[str, tuple[str, ...]] = {
    "engine": ("remote", "local"),
    "resident": ("resident", "full"),
    "kernel": ("fused", "unfused"),
    "sharding": ("sharded", "dense"),
    "mirror": ("mirror", "rebuild"),
    "policy": ("policy", "scalar"),
}


class DegradationLadder:
    """The single owner of "how degraded is each subsystem".

    Every subsystem sits on a rung (0 = top). `demote` moves exactly
    ONE rung down, recording the reason and the entry seq — a failure
    path can call it repeatedly but can never silently skip a rung.
    Recovery is two-phase: `probe` marks that the degraded path was
    actually re-attempted, and `promote` climbs one rung only after a
    probe — climbing without re-probing is the bug class the
    `degradation-ladder` protocol model exists to reject. The current
    rung of every subsystem is exported as `degradation_rung{subsystem}`
    (0 = top) and the bounded event log is the chaos-run audit trail;
    the per-cycle `CycleMetrics.degraded` tuple journals the same state
    into the flight recorder."""

    def __init__(self, subsystems: dict[str, tuple[str, ...]] | None = None):
        from kubernetes_scheduler_tpu_torch.host.observe import Gauge

        self._ladders = dict(subsystems or LADDER_RUNGS)
        self._lock = threading.Lock()
        self._rungs = {sub: 0 for sub in self._ladders}
        self._probed = {sub: False for sub in self._ladders}
        self.reasons: dict[str, str] = {}
        self.entry_seq: dict[str, int] = {}
        self.events: deque = deque(maxlen=4096)
        self.gauge = Gauge(
            "degradation_rung",
            "Current degradation-ladder rung per subsystem (0 = top; "
            "higher = more degraded)",
            labels=("subsystem",),
        )
        for sub in self._ladders:
            self.gauge.set(0, subsystem=sub)
        self.collectors = (self.gauge,)

    def rung(self, subsystem: str) -> str:
        with self._lock:
            return self._ladders[subsystem][self._rungs[subsystem]]

    def depth(self, subsystem: str) -> int:
        with self._lock:
            return self._rungs[subsystem]

    def degraded(self) -> tuple[str, ...]:
        """Subsystems currently below their top rung, sorted — the
        per-cycle journal field."""
        with self._lock:
            return tuple(
                sorted(sub for sub, d in self._rungs.items() if d > 0)
            )

    def fully_recovered(self) -> bool:
        with self._lock:
            return all(d == 0 for d in self._rungs.values())

    def _event(self, action, sub, rung, reason, seq):
        self.events.append(
            {
                "action": action, "subsystem": sub, "rung": rung,
                "reason": reason, "seq": int(seq),
            }
        )

    def demote(self, subsystem: str, *, reason: str = "", seq: int = -1) -> bool:
        """One rung down (never more — callers loop if a deeper drop is
        ever warranted, leaving one auditable event per rung). Returns
        False when already at the bottom."""
        with self._lock:
            names = self._ladders[subsystem]
            d = self._rungs[subsystem]
            if d >= len(names) - 1:
                return False
            self._rungs[subsystem] = d + 1
            self._probed[subsystem] = False
            self.reasons[subsystem] = reason
            self.entry_seq[subsystem] = int(seq)
            new_rung = names[d + 1]
            self._event("demote", subsystem, new_rung, reason, seq)
            self.gauge.set(d + 1, subsystem=subsystem)
        log.warning(
            "degradation: %s -> %s (%s, seq=%d)",
            subsystem, new_rung, reason or "-", seq,
        )
        return True

    def probe(self, subsystem: str, *, seq: int = -1) -> bool:
        """Record a recovery probe: the degraded subsystem's better
        path was re-attempted. No-op at the top."""
        with self._lock:
            if self._rungs[subsystem] == 0:
                return False
            self._probed[subsystem] = True
            self._event(
                "probe", subsystem,
                self._ladders[subsystem][self._rungs[subsystem]], "", seq,
            )
            return True

    def promote(self, subsystem: str, *, seq: int = -1) -> bool:
        """One rung up, only after a probe since the last demote — a
        promote with no recorded probe is a caller bug (logged, and the
        climb still requires the probe to be recorded first so the
        event log never shows an un-probed recovery)."""
        with self._lock:
            d = self._rungs[subsystem]
            if d == 0:
                return False
            if not self._probed[subsystem]:
                # recovery must re-probe: record the missing probe and
                # flag the call site rather than silently climbing
                log.warning(
                    "degradation: promote(%s) without a recorded probe "
                    "— recording one (caller should probe first)",
                    subsystem,
                )
                self._event(
                    "probe", subsystem, self._ladders[subsystem][d], "", seq
                )
            self._rungs[subsystem] = d - 1
            self._probed[subsystem] = False
            names = self._ladders[subsystem]
            self._event("promote", subsystem, names[d - 1], "", seq)
            if d - 1 == 0:
                self.reasons.pop(subsystem, None)
                self.entry_seq.pop(subsystem, None)
            self.gauge.set(d - 1, subsystem=subsystem)
        log.info("degradation: %s recovered one rung (seq=%d)", subsystem, seq)
        return True

    def snapshot(self) -> dict:
        """{subsystem: {rung, depth, reason, entry_seq}} — the summary
        surface scenario runs and /metrics debugging read."""
        with self._lock:
            return {
                sub: {
                    "rung": self._ladders[sub][d],
                    "depth": d,
                    "reason": self.reasons.get(sub, ""),
                    "entry_seq": self.entry_seq.get(sub, -1),
                }
                for sub, d in self._rungs.items()
            }
