"""Scheduling queue: priority ordering + retry backoff.

Reproduces the two queue behaviors the reference relies on:
- priority ordering, higher first, FIFO among equals: the API-server-
  resolved `spec.priority` (upstream PriorityClass) when present, else
  the `scv/priority` label (the QueueSort comparator the reference
  defines but never registers, pkg/yoda/sort/sort.go:8-18);
- unschedulable pods retry with exponential backoff between
  podInitialBackoffSeconds=1 and podMaxBackoffSeconds=10
  (deploy/yoda-scheduler.yaml:19-20).
"""

from __future__ import annotations

import heapq
import itertools
import threading
import time
import zlib
from dataclasses import dataclass, field

from kubernetes_scheduler_tpu_torch.host.types import Pod


def pod_priority(pod: Pod) -> int:
    """spec.priority when the API server resolved one (upstream
    PriorityClass semantics), else the reference's integer
    `scv/priority` label (sort.go:12-18), 0 when absent/garbage.
    Memoized on the pod object (immutable spec): probed per pod by the
    queue key, the batch builder, and preemption ordering every cycle."""
    v = pod.__dict__.get("_prio_cache")
    if v is None:
        if pod.priority is not None:
            v = int(pod.priority)
        else:
            try:
                v = int(pod.labels.get("scv/priority", 0))
            except (TypeError, ValueError):
                v = 0
        pod.__dict__["_prio_cache"] = v
    return v


_GANG_UNSET = object()


def pod_gang(pod: Pod) -> tuple[str, int] | None:
    """Gang identity (all-or-nothing co-scheduling, ops/gang.py) from
    the `scv/gang` + `scv/gang-size` labels, memoized on the pod object
    like pod_priority: ("<namespace>/<gang name>", declared size), or
    None for ordinary pods (absent/garbage labels, or size < 2 — a
    one-pod "gang" is just a pod). The scheduler clears the memo to None
    when a gang exhausts its defer budget under the "split" policy
    (break_gang) — its members then schedule as individuals."""
    v = pod.__dict__.get("_gang_cache", _GANG_UNSET)
    if v is _GANG_UNSET:
        v = None
        name = pod.labels.get("scv/gang")
        if name:
            try:
                size = int(pod.labels.get("scv/gang-size", 0))
            except (TypeError, ValueError):
                size = 0
            if size >= 2:
                v = (f"{pod.namespace}/{name}", size)
        pod.__dict__["_gang_cache"] = v
    return v


def break_gang(pod: Pod) -> None:
    """Drop a pod's gang identity (the "split" defer policy): it
    schedules as an individual from the next cycle on."""
    pod.__dict__["_gang_cache"] = None


@dataclass(order=True)
class _Entry:
    sort_key: tuple
    pod: Pod = field(compare=False)


class SchedulingQueue:
    """Thread-safe: the live-cluster loop (kube/source.run_kube_loop)
    feeds submissions from a watch thread while the scheduling thread
    pops windows — the same producer/consumer split as the upstream
    scheduling queue."""

    # restore_window returns pods to the FRONT of their priority class
    # (exact re-pop position). Gang deferral branches on this: a
    # front-restoring queue needs the pipelined loop's prefetched
    # window handed back BEHIND the deferred gang to match serial pop
    # order; a back-restoring queue (the native heap) must instead KEEP
    # the prefetch — see Scheduler._defer_gang.
    RESTORES_TO_FRONT = True

    def __init__(
        self,
        *,
        initial_backoff: float = 1.0,
        max_backoff: float = 10.0,
        clock=time.monotonic,
    ):
        self._active: list[_Entry] = []
        self._backoff: list[tuple[float, int, Pod]] = []  # (ready_at, seq, pod)
        self._attempts: dict[str, int] = {}
        self._seq = itertools.count()
        # restore_window keys: strictly below every normal seq, so a
        # returned window pops ahead of equal-priority pods queued since
        self._front_floor = 0
        self.initial_backoff = initial_backoff
        self.max_backoff = max_backoff
        self._clock = clock
        self._lock = threading.RLock()

    def _key(self, pod: Pod) -> tuple:
        return (-pod_priority(pod), next(self._seq))

    def push(self, pod: Pod) -> None:
        with self._lock:
            heapq.heappush(self._active, _Entry(self._key(pod), pod))

    def requeue_unschedulable(self, pod: Pod) -> None:
        """Failed cycle -> backoff queue with exponential delay."""
        with self._lock:
            uid = f"{pod.namespace}/{pod.name}"
            attempt = self._attempts.get(uid, 0) + 1
            self._attempts[uid] = attempt
            delay = min(
                self.initial_backoff * 2 ** (attempt - 1), self.max_backoff
            )
            heapq.heappush(
                self._backoff, (self._clock() + delay, next(self._seq), pod)
            )

    def mark_scheduled(self, pod: Pod) -> None:
        with self._lock:
            self._attempts.pop(f"{pod.namespace}/{pod.name}", None)

    def mark_scheduled_many(self, pods: list[Pod]) -> None:
        """Batch form: one lock round for a whole cycle's binds."""
        with self._lock:
            for pod in pods:
                self._attempts.pop(f"{pod.namespace}/{pod.name}", None)

    def _drain_backoff(self) -> None:
        now = self._clock()
        while self._backoff and self._backoff[0][0] <= now:
            _, _, pod = heapq.heappop(self._backoff)
            heapq.heappush(self._active, _Entry(self._key(pod), pod))

    def pop_window(self, max_pods: int) -> list[Pod]:
        """Highest-priority window of pending pods for one engine cycle."""
        with self._lock:
            self._drain_backoff()
            if self._active and len(self._active) <= max_pods:
                # whole-queue pop (the deep-backlog drain shape —
                # queue_pop was a named stage in the 4k-node cycle
                # budget): ONE sort instead of a heappop per pod, and
                # the SAME order — sort keys are unique (seq counter),
                # so heap drain order == sorted order
                entries = sorted(self._active)
                self._active.clear()
                return [e.pod for e in entries]
            out = []
            while self._active and len(out) < max_pods:
                out.append(heapq.heappop(self._active).pod)
            return out

    def restore_window(self, pods: list[Pod]) -> None:
        """Return a popped-but-unscheduled window to the FRONT of the
        queue: restored pods keep their relative order and precede every
        pod currently queued at equal priority — re-popping immediately
        yields the same window. Used by the pipelined scheduler
        (Scheduler.drain_pipeline) to hand back a prefetched window and
        by gang deferral (Scheduler._defer_gang) to requeue a gang
        atomically ahead of its equals. Restoring several windows
        without popping in between re-merges them newest-first — which
        is exactly what _defer_gang relies on: prefetched window first,
        deferred gang second, so the gang leads the next pop."""
        with self._lock:
            base = self._front_floor - len(pods)
            for i, pod in enumerate(pods):
                heapq.heappush(
                    self._active,
                    _Entry((-pod_priority(pod), base + i), pod),
                )
            self._front_floor = base

    def __len__(self) -> int:
        with self._lock:
            return len(self._active) + len(self._backoff)


class NativeBackedQueue:
    """SchedulingQueue surface over the C++ queue (native/queue.cc).

    Pods are handed to the native side as opaque uint64 handles; this
    wrapper owns the handle -> Pod map. Raises RuntimeError at
    construction when the native library is unavailable — callers (the
    Scheduler) then keep the pure-Python queue.
    """

    # the native heap re-pushes restored pods with fresh sequence
    # numbers: BACK of their priority class (see restore_window)
    RESTORES_TO_FRONT = False

    def __init__(
        self,
        *,
        initial_backoff: float = 1.0,
        max_backoff: float = 10.0,
        clock=time.monotonic,
    ):
        from kubernetes_scheduler_tpu_torch import native

        self._q = native.NativeQueue(
            initial_backoff=initial_backoff, max_backoff=max_backoff
        )
        self._clock = clock
        self._pods: dict[int, Pod] = {}
        self._handles = itertools.count(1)
        self._by_uid: dict[str, int] = {}
        # native-queue entries per handle; the handle->Pod mapping may only
        # be dropped once no copy is queued AND the pod is done (so a uid
        # pushed twice survives the first copy's mark_scheduled)
        self._outstanding: dict[int, int] = {}
        # same producer/consumer contract as SchedulingQueue; the lock
        # also serializes entry to the (single-threaded) C++ queue
        self._lock = threading.RLock()

    def _handle(self, pod: Pod) -> int:
        uid = f"{pod.namespace}/{pod.name}"
        h = self._by_uid.get(uid)
        if h is None:
            h = next(self._handles)
            self._by_uid[uid] = h
        self._pods[h] = pod
        # handle memo for mark_scheduled_many: handles are never reused
        # (monotonic counter), so a memoized h still present in _pods is
        # by construction this pod's live entry — the bulk mark path
        # skips the f-string + uid lookup per pod (~2us x 8k per cycle)
        pod.__dict__["_qh"] = (self, h, uid)
        return h

    def _drop_if_done(self, h: int) -> None:
        if self._outstanding.get(h, 0) <= 0:
            # graftlint: disable=lock-discipline -- callers (mark_scheduled, pop_window) hold self._lock
            self._outstanding.pop(h, None)
            pod = self._pods.pop(h, None)
            if pod is not None:
                self._by_uid.pop(f"{pod.namespace}/{pod.name}", None)

    def push(self, pod: Pod) -> None:
        with self._lock:
            h = self._handle(pod)
            self._outstanding[h] = self._outstanding.get(h, 0) + 1
            self._q.push(h, pod_priority(pod))

    def requeue_unschedulable(self, pod: Pod) -> None:
        with self._lock:
            h = self._handle(pod)
            self._outstanding[h] = self._outstanding.get(h, 0) + 1
            self._q.requeue_unschedulable(h, pod_priority(pod), self._clock())

    def mark_scheduled(self, pod: Pod) -> None:
        with self._lock:
            uid = f"{pod.namespace}/{pod.name}"
            h = self._by_uid.get(uid)
            if h is not None:
                self._q.mark_scheduled(h)
                self._drop_if_done(h)

    def mark_scheduled_many(self, pods: list[Pod]) -> None:
        """Batch form: ONE foreign call clears every bind's retry
        counter (native yoda_queue_mark_scheduled_batch), one lock round
        for the Python bookkeeping — the per-bind ctypes dispatch was a
        visible slice of big-backlog cycles. Handle resolution goes
        through the _qh memo (see _handle); pods from another queue or
        with dead handles fall back to the uid path."""
        import numpy as np

        with self._lock:
            pods_d = self._pods
            out_d = self._outstanding
            uid_d = self._by_uid
            handles = []
            append = handles.append
            for pod in pods:
                rec = pod.__dict__.get("_qh")
                if rec is not None and rec[0] is self and rec[1] in pods_d:
                    h, uid = rec[1], rec[2]
                else:
                    uid = f"{pod.namespace}/{pod.name}"
                    h = uid_d.get(uid)
                    if h is None:
                        continue
                append((h, uid))
            if handles:
                self._q.mark_scheduled_batch(
                    np.asarray([h for h, _ in handles], np.uint64)
                )
            # Python bookkeeping drops only AFTER the native marks
            # succeeded (mark-then-drop, like the serial path): a raising
            # native call must leave the maps intact so the binds can be
            # re-marked. A pod appearing twice in one batch resolves its
            # handle twice — harmless, the native mark is an idempotent
            # attempts.erase — where an early drop would instead lose the
            # second lookup mid-batch
            for h, uid in handles:
                # inline _drop_if_done with the uid already in hand
                if out_d.get(h, 0) <= 0:
                    out_d.pop(h, None)
                    if pods_d.pop(h, None) is not None:
                        uid_d.pop(uid, None)

    def restore_window(self, pods: list[Pod]) -> None:
        """Return a popped window to the queue. The native heap assigns
        its own (monotone) sequence numbers, so restored pods re-enter
        at the BACK of their priority class rather than the front —
        priority order is exact, FIFO position among equals is not.
        Callers are the drain path (Scheduler.drain_pipeline, followed
        by a fresh pop or shutdown) and gang deferral
        (Scheduler._defer_gang): a deferred gang re-enters behind
        same-priority arrivals instead of ahead of them, which delays
        its retry but never its correctness. _defer_gang reads
        RESTORES_TO_FRONT and KEEPS the pipelined loop's prefetched
        window on this queue (re-pushing it would put it behind pods
        the serial loop pops later), so serial/pipelined binding
        parity holds on either queue implementation."""
        for pod in pods:
            self.push(pod)

    def pop_window(self, max_pods: int) -> list[Pod]:
        with self._lock:
            handles = self._q.pop_window(max_pods, self._clock())
            pods_d = self._pods
            out_d = self._outstanding
            out = []
            append = out.append
            for h in (
                handles.tolist() if hasattr(handles, "tolist") else handles
            ):
                pod = pods_d.get(h)
                out_d[h] = out_d.get(h, 1) - 1
                if pod is not None:
                    append(pod)
            return out

    def __len__(self) -> int:
        with self._lock:
            return len(self._q)


def pod_partition_key(pod: Pod) -> str:
    """The partition key: the pod's namespace (tenant boundary). The
    gang identity key is `f"{namespace}/{name}"` (pod_gang above), so
    namespace-keyed partitioning guarantees BY CONSTRUCTION that a gang
    never straddles two partitions — gang atomicity (_defer_gang's
    restore_window dance) stays a single-replica affair."""
    return pod.namespace


def namespace_partition(namespace: str, n_partitions: int) -> int:
    """crc32(namespace) % n — the partition a namespace's pods belong
    to. Exposed for traffic generators / tests that need to TARGET a
    partition (pick a namespace that lands where they want)."""
    if n_partitions <= 1:
        return 0
    return zlib.crc32(namespace.encode("utf-8")) % n_partitions


def pod_partition(pod: Pod, n_partitions: int) -> int:
    """Deterministic partition index in [0, n_partitions): crc32 of the
    namespace, NOT Python's `hash()` — crc32 is stable across processes
    and restarts (hash() is salted per interpreter), so a pod resubmitted
    after a replica crash lands on the same partition and its backoff /
    gang state reconverges instead of forking. The crc is memoized on
    the pod object (immutable spec) like pod_priority; the modulus is
    not, so the same pod re-partitions correctly if the fleet is resized."""
    if n_partitions <= 1:
        return 0
    crc = pod.__dict__.get("_part_crc")
    if crc is None:
        crc = zlib.crc32(pod_partition_key(pod).encode("utf-8"))
        pod.__dict__["_part_crc"] = crc
    return crc % n_partitions


class PartitionedQueue:
    """N independent sub-queues, one per scheduler replica, with pushes
    routed by pod_partition. Each sub-queue is a full SchedulingQueue /
    NativeBackedQueue, so per-partition pop_window / restore_window /
    backoff semantics are EXACTLY the single-queue semantics — gang
    atomicity and the pipelined prefetch slot survive unchanged inside
    a partition, and there is no cross-partition ordering to preserve
    because priorities only ever competed within a tenant's submit
    stream in the first place.

    This class is a router, not a scheduler-facing queue: replicas talk
    to their own partition through a ReplicaCoordinator (host/replica.py)
    and never see the router at pop time."""

    def __init__(
        self,
        n_partitions: int,
        *,
        initial_backoff: float = 1.0,
        max_backoff: float = 10.0,
        prefer_native: bool = True,
        clock=time.monotonic,
    ):
        if n_partitions < 1:
            raise ValueError(f"n_partitions must be >= 1, got {n_partitions}")
        self.n_partitions = n_partitions
        self.partitions = [
            make_queue(
                initial_backoff=initial_backoff,
                max_backoff=max_backoff,
                prefer_native=prefer_native,
                clock=clock,
            )
            for _ in range(n_partitions)
        ]

    def partition_of(self, pod: Pod) -> int:
        return pod_partition(pod, self.n_partitions)

    def push(self, pod: Pod) -> None:
        self.partitions[self.partition_of(pod)].push(pod)

    def partition(self, i: int):
        return self.partitions[i]

    def __len__(self) -> int:
        return sum(len(q) for q in self.partitions)


def make_queue(
    *,
    initial_backoff: float = 1.0,
    max_backoff: float = 10.0,
    prefer_native: bool = True,
    clock=time.monotonic,
):
    """Native queue when the toolchain/library allows, else pure Python."""
    if prefer_native:
        try:
            return NativeBackedQueue(
                initial_backoff=initial_backoff,
                max_backoff=max_backoff,
                clock=clock,
            )
        except (RuntimeError, ImportError):
            pass
    return SchedulingQueue(
        initial_backoff=initial_backoff, max_backoff=max_backoff, clock=clock
    )
