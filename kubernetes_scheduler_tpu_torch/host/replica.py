"""Replicated scheduler fleet: first-bind-wins over a partitioned queue.

The port's copy of kubernetes_scheduler_tpu/host/replica.py, on the
port's native loader and engine pool; a fleet's engines are TorchEngines
(cuda unless the caller passes `device=` or an `engine_factory`).

These are the primitives the reference's `replica-bind` protocol model
(kubernetes_scheduler_tpu/analysis/model/protocols.py) was checked
against — no-double-bind and bound-pod-never-re-popped hold for every
interleaving of the abstract transitions, and the
`unfenced-replica-bind` mutant proves the epoch fence is load-bearing.
The mapping, transition by transition (the model's anchors name the
reference's copies of these defs):

  pop_{r}        -> ReplicaCoordinator.pop_window: filter already-bound
                    pods out of the popped window (drop_bound below) and
                    record the bind-table epoch each surviving pod was
                    seen at — the fence the CAS compares against.
  bind_win_{r}   -> BindTable.try_bind: ONE compare-and-swap under ONE
                    lock — pod unbound AND seen epoch current, else the
                    bind is rejected. Success installs the winner and
                    advances the epoch, fencing every other replica's
                    in-flight copy of the pod.
  bind_lose_{r}  -> ReplicaCoordinator.bind_lose: the losing replica
                    returns the pod through restore_window (front-of-
                    partition semantics preserved) — the pod is NOT
                    lost, it re-pops next cycle and resolves via
                    drop_bound. FencedBinder then raises with
                    status=409, which Scheduler._bind already treats as
                    "bound by a racer" (mark_scheduled, never requeue).
  drop_bound_{r} -> ReplicaCoordinator.drop_bound: a re-popped pod the
                    table shows bound is discarded via mark_scheduled
                    (retry-counter cleanup; on the native queue this
                    also releases the handle when no copy remains).

Partitioning (host/queue.pod_partition) makes conflicts the EXCEPTION:
each replica owns a crc32(namespace) partition, so two replicas only
race on a pod during partition handoff (fleet resize, membership churn,
double-submit) — the protocol makes those races safe, the partitioning
makes them rare. Gangs never straddle partitions by construction (the
gang key is namespace-prefixed), so gang atomicity stays single-replica.

Membership — which replica owns which partition — is leader.
ReplicaMembership: N slot leases, each an ordinary fenced lease; the
slot index IS the partition index.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from typing import Callable

from kubernetes_scheduler_tpu_torch.host.observe import Counter
from kubernetes_scheduler_tpu_torch.host.queue import (
    PartitionedQueue,
    pod_partition,
)
from kubernetes_scheduler_tpu_torch.host.types import Pod

log = logging.getLogger("yoda_tpu.replica")


def _pod_key(pod: Pod) -> str:
    return f"{pod.namespace}/{pod.name}"


class BindConflictError(RuntimeError):
    """Raised by FencedBinder when the bind-table CAS rejects a bind:
    another replica bound the pod first (or the epoch moved — a stale
    pop). status=409 deliberately: it is the SAME race the live API
    server answers 409 Conflict for, and Scheduler._bind's existing
    404/409 arm (drop, never requeue) is exactly the right resolution —
    the loser's requeue already happened via bind_lose before this
    raise, so the scheduler must NOT requeue it a second time."""

    status = 409


class BindTable:
    """The shared first-bind-wins table: pod key -> (epoch, holder).

    One lock, one dict — the whole cross-replica protocol reduces to
    try_bind's compare-and-swap, which is why it was model-checkable.
    Epochs start at 0 and advance only on a successful bind; a replica
    must present the epoch it popped the pod at (stale-epoch fencing),
    so a pod that was bound and re-exposed between a loser's pop and
    its bind attempt still cannot double-bind.

    The table also keeps a per-key win count as run evidence: wins > 1
    for any key is a double bind, and `double_binds` is asserted == 0
    by the bench row, the replica scenario, and `make replica-smoke`.
    """

    def __init__(self):
        self._lock = threading.Lock()
        # key -> [epoch, holder, wins]
        self._recs: dict[str, list] = {}

    def _rec(self, key: str) -> list:
        rec = self._recs.get(key)
        if rec is None:
            rec = self._recs[key] = [0, "", 0]
        return rec

    def epoch(self, key: str) -> int:
        with self._lock:
            return self._rec(key)[0]

    def holder(self, key: str) -> str:
        """The replica that bound this key, or "" while unbound."""
        with self._lock:
            rec = self._recs.get(key)
            return rec[1] if rec is not None else ""

    def try_bind(self, key: str, seen_epoch: int, replica: str) -> bool:
        """The CAS: install `replica` as the binder of `key` iff the key
        is unbound AND `seen_epoch` matches the key's current epoch (the
        fence — a stale pop presents an old epoch and is rejected even
        if the key looks unbound). Success advances the epoch."""
        with self._lock:
            rec = self._rec(key)
            if rec[1] != "":
                return False  # first bind already won
            if seen_epoch != rec[0]:
                return False  # stale-epoch fencing: late/stale pop
            rec[1] = replica
            rec[0] += 1
            rec[2] += 1
            return True

    @property
    def double_binds(self) -> int:
        """Keys bound more than once — 0 by construction; exported as
        run evidence, not as a tolerated failure mode."""
        with self._lock:
            return sum(1 for rec in self._recs.values() if rec[2] > 1)

    @property
    def bound(self) -> int:
        with self._lock:
            return sum(1 for rec in self._recs.values() if rec[1] != "")

    def holders(self) -> dict:
        """key -> winning replica snapshot (bound keys only)."""
        with self._lock:
            return {
                k: rec[1] for k, rec in self._recs.items() if rec[1] != ""
            }


class ReplicaCoordinator:
    """One replica's view of its queue partition, fenced by the shared
    BindTable. Presents the full SchedulingQueue surface, so a Scheduler
    takes it via the `queue=` injection seam and runs UNCHANGED — the
    protocol lives entirely in this wrapper plus FencedBinder.

    restore_window / requeue_unschedulable / mark_scheduled forward to
    the partition's own queue, so per-partition ordering semantics
    (front-restore on the Python queue, back-restore on the native
    heap), gang atomicity, and the pipelined prefetch slot are exactly
    the single-queue semantics.
    """

    def __init__(
        self,
        replica: str,
        inner,
        table: BindTable,
        *,
        binds_counter: Counter | None = None,
        conflicts_counter: Counter | None = None,
    ):
        self.replica = replica
        self.inner = inner
        self.table = table
        self.RESTORES_TO_FRONT = getattr(inner, "RESTORES_TO_FRONT", False)
        self._clock = inner._clock
        self._binds_counter = binds_counter
        self._conflicts_counter = conflicts_counter
        # pod key -> bind-table epoch at pop time (the fence operand)
        self._seen: dict[str, int] = {}
        # pod key -> clock at bind_lose, for requeue-to-resolution latency
        self._lost_at: dict[str, float] = {}
        self.binds = 0
        self.conflicts = 0
        self.pods_discarded = 0  # drop_bound count
        self.requeue_latencies: list[float] = []

    # -- queue surface -------------------------------------------------

    def push(self, pod: Pod) -> None:
        self.inner.push(pod)

    def pop_window(self, max_pods: int) -> list[Pod]:
        """Pop from this replica's partition, dropping pods the bind
        table already shows bound (the drop_bound transition) and
        recording the epoch each surviving pod was seen at — try_bind
        compares against exactly this value (the stale-epoch fence)."""
        out = []
        table = self.table
        for pod in self.inner.pop_window(max_pods):
            key = _pod_key(pod)
            if table.holder(key) != "":
                self.drop_bound(pod)
                continue
            self._seen[key] = table.epoch(key)
            out.append(pod)
        return out

    def restore_window(self, pods: list[Pod]) -> None:
        self.inner.restore_window(pods)

    def requeue_unschedulable(self, pod: Pod) -> None:
        self.inner.requeue_unschedulable(pod)

    def mark_scheduled(self, pod: Pod) -> None:
        self.inner.mark_scheduled(pod)

    def mark_scheduled_many(self, pods: list[Pod]) -> None:
        if hasattr(self.inner, "mark_scheduled_many"):
            self.inner.mark_scheduled_many(pods)
        else:
            for pod in pods:
                self.inner.mark_scheduled(pod)

    def __len__(self) -> int:
        return len(self.inner)

    # -- protocol transitions -----------------------------------------

    def drop_bound(self, pod: Pod) -> None:
        """A re-popped pod the table shows bound (drop_bound_{r}): it
        already ran its lifecycle on the winning replica — discard it
        here via mark_scheduled (clears this partition's retry counter;
        on the native queue, releases the handle once no copy remains).
        Closes the loser's requeue loop: bind_lose restored the pod,
        this drop retires it."""
        self.pods_discarded += 1
        key = _pod_key(pod)
        lost_at = self._lost_at.pop(key, None)
        if lost_at is not None:
            self.requeue_latencies.append(self._clock() - lost_at)
        self._seen.pop(key, None)
        self.inner.mark_scheduled(pod)

    def bind_win(self, pod: Pod) -> bool:
        """Attempt the CAS (bind_win_{r}): True installs this replica as
        the pod's binder and fences every other in-flight copy."""
        key = _pod_key(pod)
        won = self.table.try_bind(
            key, self._seen.pop(key, -1), self.replica
        )
        if won:
            self.binds += 1
            if self._binds_counter is not None:
                self._binds_counter.inc(replica=self.replica)
            lost_at = self._lost_at.pop(key, None)
            if lost_at is not None:
                self.requeue_latencies.append(self._clock() - lost_at)
        return won

    def bind_lose(self, pod: Pod) -> None:
        """The CAS lost (bind_lose_{r}): first bind won elsewhere, or
        the epoch moved under a stale pop. Requeue the pod through
        restore_window — front-of-partition on the Python queue, so it
        re-pops next cycle and resolves via drop_bound. The pod is
        never lost: either the winner's bind stands (drop_bound retires
        our copy) or — epoch races without a standing bind — the next
        pop re-records a fresh epoch and the bind retries."""
        self.conflicts += 1
        if self._conflicts_counter is not None:
            self._conflicts_counter.inc()
        key = _pod_key(pod)
        self._lost_at.setdefault(key, self._clock())
        self.inner.restore_window([pod])


class FencedBinder:
    """Binder wrapper running the CAS before every real bind.

    Deliberately does NOT define bind_many: Scheduler._apply_assignments
    only takes the bulk-bind path when the binder offers it, and the
    per-pod path is where the 404/409 conflict semantics live — the
    same reason the live KubeBinder keeps per-pod binds (scheduler.py's
    RecordingBinder.bind_many docstring).

    On CAS loss the pod is FIRST requeued via bind_lose (restore_window
    on its own partition), THEN BindConflictError(status=409) propagates
    to Scheduler._bind, which drops its copy (mark_scheduled +
    pods_dropped) exactly as it would an API-server 409 — no double
    requeue, no lost pod.
    """

    def __init__(self, inner, coordinator: ReplicaCoordinator):
        self._inner = inner
        self.coordinator = coordinator

    @property
    def bindings(self):
        """Recorded bindings of the wrapped binder (simulation /
        scenario binders record; the live KubeBinder does not)."""
        return self._inner.bindings

    def bind(self, pod: Pod, node_name: str) -> None:
        coord = self.coordinator
        if not coord.bind_win(pod):
            coord.bind_lose(pod)
            raise BindConflictError(
                f"first bind won on another replica: {_pod_key(pod)} "
                f"(held by {coord.table.holder(_pod_key(pod)) or 'epoch race'})"
            )
        self._inner.bind(pod, node_name)


class ReplicaFleet:
    """N Schedulers over one PartitionedQueue and one BindTable.

    Each replica is a FULL Scheduler — its own journal (per-replica
    trace_path subdirectory, so `trace replay` pins each replica's
    cycles independently), its own span recorder, its own degradation
    ladder and prom collectors — wired to its partition through a
    ReplicaCoordinator and to its binder through a FencedBinder. The
    fleet adds the two cross-replica metrics the protocol calls for:
    replica_binds_total{replica} (CAS wins per replica) and
    bind_conflicts_total (CAS losses, i.e. conflicts RESOLVED — each
    one is a loser requeued and retired, never a lost pod).

    In production each replica is its own process holding a membership
    slot (leader.ReplicaMembership; slot index == partition index) and
    its own /metrics exporter; this in-process fleet is the simulation/
    bench/scenario harness for the same topology.
    """

    def __init__(
        self,
        config,
        *,
        n_replicas: int,
        advisor_factory: Callable[[int], object],
        list_nodes,
        list_running_pods,
        binder_factory: Callable[[int], object] | None = None,
        engine_factory: Callable[[int], object] | None = None,
        evictor_factory: Callable[[int], object] | None = None,
        queue_clock=None,
        prefer_native: bool | None = None,
        device=None,
    ):
        from kubernetes_scheduler_tpu_torch.engine import TorchEngine
        from kubernetes_scheduler_tpu_torch.host.scheduler import (
            RecordingBinder,
            Scheduler,
        )

        if engine_factory is None:
            def engine_factory(i):
                return TorchEngine(device=device)

        if n_replicas < 1:
            raise ValueError(f"n_replicas must be >= 1, got {n_replicas}")
        self.config = config
        self.n_replicas = n_replicas
        self.table = BindTable()
        self.ctr_binds = Counter(
            "replica_binds_total",
            "Pods bound per scheduler replica (bind-table CAS wins).",
            labels=("replica",),
        )
        self.ctr_conflicts = Counter(
            "bind_conflicts_total",
            "Cross-replica bind conflicts resolved first-bind-wins "
            "(loser requeued through restore_window; never a lost pod).",
        )
        if prefer_native is None:
            if config.feature_gates.native_host:
                from kubernetes_scheduler_tpu_torch import native

                prefer_native = native.available()
            else:
                prefer_native = False
        self.queue = PartitionedQueue(
            n_replicas,
            initial_backoff=config.initial_backoff_seconds,
            max_backoff=config.max_backoff_seconds,
            prefer_native=prefer_native,
            **({"clock": queue_clock} if queue_clock is not None else {}),
        )
        # fleet-shared device engine (config.shared_engine): ONE
        # engine behind a SharedEnginePool, each replica
        # wired through a per-replica view — one resident snapshot and
        # one upload per churn event for the whole fleet, concurrent
        # windows coalesced into one device invocation. engine_factory
        # is consulted ONCE (replica 0) for the pool's inner engine;
        # decisions stay bit-identical to private engines, so the
        # BindTable protocol above is untouched.
        self.engine_pool = None
        if getattr(config, "shared_engine", False):
            from kubernetes_scheduler_tpu_torch.host.engine_pool import (
                SharedEnginePool,
            )

            self.engine_pool = SharedEnginePool(
                engine_factory(0),
                coalesce_window_ms=config.coalesce_window_ms,
            )
        self.coordinators: list[ReplicaCoordinator] = []
        self.schedulers = []
        for i in range(n_replicas):
            name = f"r{i}"
            coord = ReplicaCoordinator(
                name,
                self.queue.partition(i),
                self.table,
                binds_counter=self.ctr_binds,
                conflicts_counter=self.ctr_conflicts,
            )
            # per-replica journal/span directories: each replica's
            # cycles replay independently (`trace replay <dir>/r0`)
            cfg_r = dataclasses.replace(
                config,
                trace_path=(
                    f"{config.trace_path}/{name}" if config.trace_path else None
                ),
                span_path=(
                    f"{config.span_path}/{name}" if config.span_path else None
                ),
            )
            binder = (
                binder_factory(i) if binder_factory else RecordingBinder()
            )
            sched = Scheduler(
                cfg_r,
                advisor=advisor_factory(i),
                binder=FencedBinder(binder, coord),
                evictor=evictor_factory(i) if evictor_factory else None,
                list_nodes=list_nodes,
                list_running_pods=list_running_pods,
                engine=(
                    self.engine_pool.view(name)
                    if self.engine_pool is not None
                    else engine_factory(i)
                ),
                queue_clock=queue_clock,
                queue=coord,
            )
            self.coordinators.append(coord)
            self.schedulers.append(sched)

    # -- submission ----------------------------------------------------

    def partition_of(self, pod: Pod) -> int:
        return pod_partition(pod, self.n_replicas)

    def submit(self, pod: Pod) -> None:
        """Route the pod to its partition's replica (deterministic
        crc32(namespace) assignment — same partition across restarts)."""
        self.schedulers[self.partition_of(pod)].submit(pod)

    def submit_overlap(self, pod: Pod, replicas=None) -> None:
        """Hand the SAME pod to several replicas — the partition-handoff
        overlap (membership churn re-homing a namespace while the old
        owner still holds queued copies). This is the conflict-storm
        generator: every overlap pod races, first bind wins, the loser
        resolves through bind_lose -> drop_bound, and the run evidence
        must still show zero double binds."""
        for i in replicas if replicas is not None else range(self.n_replicas):
            self.schedulers[i].submit(pod)

    # -- drains --------------------------------------------------------

    def run_until_empty(self, *, max_cycles: int = 1000) -> dict:
        """Drain every replica CONCURRENTLY (one thread per replica) —
        the real fleet topology, and the interleavings the protocol was
        checked against. Returns per-replica summaries + fleet evidence."""
        results = [None] * self.n_replicas
        errors = [None] * self.n_replicas
        start = threading.Barrier(self.n_replicas)

        def _drain(i):
            try:
                start.wait(timeout=30)
            except threading.BrokenBarrierError:
                pass
            try:
                results[i] = self.schedulers[i].run_until_empty(
                    max_cycles=max_cycles
                )
            except Exception as e:  # surfaced below, never swallowed
                errors[i] = e
                log.exception("replica r%d drain failed", i)

        threads = [
            threading.Thread(target=_drain, args=(i,), daemon=True)
            for i in range(self.n_replicas)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for e in errors:
            if e is not None:
                raise e
        return self.evidence(results)

    def run_round_split(self) -> list:
        """One deterministic fleet round through the split-phase cycle
        seam (Scheduler.run_cycle_split): dispatch EVERY replica's
        window first, then complete them in order. With a shared engine
        all N windows sit in the pool's queue when the first force
        arrives, so the round coalesces into one device invocation —
        round-robin harnesses get the coalescing a threaded fleet gets
        from timing, deterministically. Works (as a plain pipelined
        cycle per replica) with private engines too."""
        handles = [s.run_cycle_split() for s in self.schedulers]
        return [h.complete() for h in handles]

    def run_sequential(self, *, max_cycles: int = 1000) -> dict:
        """Drain replicas one at a time, timing each drain — the
        deterministic scaling probe. N single-host processes would run
        their partitions in true parallel; under one GIL the honest
        aggregate rate is total_bound / max(per-replica busy seconds),
        which this returns alongside the per-replica wall times."""
        results = []
        busy = []
        for sched in self.schedulers:
            t0 = time.perf_counter()
            results.append(sched.run_until_empty(max_cycles=max_cycles))
            busy.append(time.perf_counter() - t0)
        ev = self.evidence(results)
        ev["replica_busy_seconds"] = busy
        ev["aggregate_drain_seconds"] = max(busy) if busy else 0.0
        return ev

    # -- evidence ------------------------------------------------------

    def evidence(self, results=None) -> dict:
        """The fleet-level numbers every replica harness asserts on:
        zero double binds, conflicts resolved, accounting intact."""
        lat = [
            s for c in self.coordinators for s in c.requeue_latencies
        ]
        ev = {
            "replicas": self.n_replicas,
            "binds_per_replica": {
                c.replica: c.binds for c in self.coordinators
            },
            "total_binds": sum(c.binds for c in self.coordinators),
            "bind_conflicts_total": self.ctr_conflicts.value(),
            "pods_discarded": sum(
                c.pods_discarded for c in self.coordinators
            ),
            "double_binds": self.table.double_binds,
            "requeue_latency_count": len(lat),
            "requeue_latency_mean_s": (sum(lat) / len(lat)) if lat else 0.0,
            "requeue_latency_max_s": max(lat) if lat else 0.0,
        }
        if self.engine_pool is not None:
            ev["shared_engine"] = self.engine_pool.stats()
        if results is not None:
            ev["replica_results"] = results
        return ev

    def prom_collectors(self, replica: int):
        """Collector tuple for replica i's exporter: the scheduler's own
        collectors (per-replica degradation_rung, cycle histograms, ...)
        plus the fleet counters (shared objects — every replica's
        /metrics shows the fleet's conflict picture)."""
        return tuple(self.schedulers[replica].prom_collectors) + (
            self.ctr_binds,
            self.ctr_conflicts,
        )

    @property
    def bindings(self):
        """Union of all replicas' recorded bindings (simulation binders)."""
        out = []
        for sched in self.schedulers:
            out.extend(sched.binder.bindings)
        return out
