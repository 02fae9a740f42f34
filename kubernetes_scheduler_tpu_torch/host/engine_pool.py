"""Fleet-shared device engine: N replicas, ONE resident snapshot.

A ReplicaFleet with private engines pays the cluster state N times — N
device-resident snapshot copies, N uploads per churn event, N kernel
dispatches per round even when every replica is scoring the same
cluster. SharedEnginePool multiplexes every replica's engine traffic
onto ONE engine (a TorchEngine by default) through per-replica
`_EngineView` facades
(the Scheduler's ordinary `engine=` injection seam — schedulers run
unchanged), with two fleet-level levers:

**Upload dedupe (one resident base per fleet).** The pool retains a
host-side COPY of the last snapshot content the inner engine holds
(`_prev`) plus a monotonically fenced epoch. Each dispatch diffs its
snapshot against the base (host.snapshot.snapshot_delta — row values by
content, so the reconstruction is bitwise): an unchanged snapshot ships
a zero-row delta (`upload="dedup"`, ~node_mask bytes), steady-state
churn ships changed rows once per fleet (`upload="delta"`), and
anything delta-inexpressible — layout churn, a replica that raced a
flush, a post-crash resync — transparently falls back to a fenced full
upload (`upload="full"`). The epoch fence is the resident protocol's:
the inner engine folds a delta only at exactly `epoch + 1`
(engine.ResidentState.accepts); any desync degrades to a full upload,
never to stale state.

**Cross-replica dispatch coalescing.** `schedule_batch_async` ENQUEUES
the request and returns an unforced handle; execution happens when any
participant forces a result (or a sync dispatch arrives), and the
executing thread drains EVERYTHING queued by then into coalesced
super-batches — one `schedule_batch_fleet` invocation per group, each
stacked window tagged with its origin view and scored against ITS OWN
snapshot content (the shared base plus that replica's functional
SnapshotDelta, applied inside the program without touching the base).
Results de-multiplex back to each handle, and every replica's
BindTable CAS runs exactly as with private engines — decisions are
bit-identical per replica, so first-bind-wins semantics and union
parity are unchanged. Windows that arrive while
the device is busy queue behind the executing group and are adopted
before the executor retires — the lost-wakeup-free drain loop — and a
threaded dispatch that would otherwise go out alone waits up to
`coalesce_window_ms` for companions when other fleet threads are
actively dispatching (single-threaded/round-robin drains never wait).

Deferral contract: a view's snapshot/pod arrays must stay unchanged
between its dispatch and its force. The Scheduler's cycle structure
guarantees this — builder and mirror state mutate only in the
completion/finish stages, after the force — and the split-phase fleet
drain (Scheduler.run_cycle_split) dispatches every replica before the
first force for deterministic coalescing under round-robin harnesses.

Failure fan-out: an inner-engine exception while a coalesced group is
in flight is delivered to EVERY participating handle, so each replica
runs its own established fallback chain (scalar re-schedule, breaker
feed, ladder demotion) for its own window — no pod is lost or
double-bound (the BindTable fences re-dispatches exactly like any
other race), and the pool drops its base so the next dispatch re-syncs
with a fenced full upload. Capability state lives in the ONE inner
engine, so a sidecar capability downgrade is relearned once per fleet,
not once per replica.

The port's copy of kubernetes_scheduler_tpu/host/engine_pool.py: the
default inner engine is TorchEngine (cuda unless the caller passes
`device=` or an inner engine), and the executor's wait for the device
is one CUDA event, recorded after the batch's launches on the stream
that launched them (the pool's threads share the device's current
stream); on the CPU the work is done when the call returns.
"""

from __future__ import annotations

import logging
import threading
import time

import numpy as np

from kubernetes_scheduler_tpu_torch.host.observe import Counter, Histogram

log = logging.getLogger("yoda_tpu.engine_pool")

# count-valued buckets: "how many windows rode one device dispatch"
COALESCE_BUCKETS = (1.0, 2.0, 3.0, 4.0, 6.0, 8.0, 12.0, 16.0, 32.0)


def _copy_tree(nt):
    """Pool-owned host copy of a NamedTuple-of-arrays: the base must
    survive in-place mutation of the source arrays (the mirror's
    post-bind self-applies land in the very buffers a snapshot aliased)."""
    return type(nt)(*[np.array(a, copy=True) for a in nt])


def _delta_rows(delta) -> int:
    """Real (non-sentinel) changed rows in a SnapshotDelta — 0 means the
    diff found nothing and the delta is a pure epoch advance."""
    n = int(delta.node_mask.shape[0])
    return (
        int((np.asarray(delta.req_rows) < n).sum())
        + int((np.asarray(delta.util_rows) < n).sum())
        + int((np.asarray(delta.dom_rows) < n).sum())
    )


def _wait_for_device(inner) -> None:
    """Wait until the work this thread launched on the inner engine's
    CUDA device has run: one event recorded on the current stream (the
    stream the launches went to), then waited on. Nothing to wait for on
    the CPU or for an engine without a device."""
    dev = getattr(inner, "device", None)
    if getattr(dev, "type", None) != "cuda":
        return
    import torch

    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(dev))
    event.synchronize()


class _Pending:
    """One enqueued dispatch: inputs captured at enqueue, settled by
    whichever thread ends up executing the drain."""

    __slots__ = (
        "view", "kind", "snapshot", "pods", "kw", "done", "value", "error",
    )

    def __init__(self, view, kind, snapshot, pods, kw):
        self.view = view
        self.kind = kind  # "batch" | "windows"
        self.snapshot = snapshot
        self.pods = pods
        self.kw = kw
        self.done = False
        self.value = None
        self.error = None


class _PoolHandle:
    """Async handle a view hands the scheduler: forcing it makes the
    calling thread the executor for everything queued so far."""

    __slots__ = ("_pool", "_pending")

    def __init__(self, pool, pending):
        self._pool = pool
        self._pending = pending

    def result(self):
        return self._pool._settle(self._pending)


class _EngineView:
    """One replica's engine facade. Presents the plain (non-resident)
    engine surface — `supports_resident()` is False by design, so the
    Scheduler's own resident machinery stays inert and residency is
    managed ONCE at the pool, where the fleet-wide base lives."""

    def __init__(self, pool: "SharedEnginePool", name: str):
        self._pool = pool
        self.name = name
        self.collectors = pool.collectors
        self._closed = False

    def schedule_batch(self, snapshot, pods, **kw):
        return self._pool.dispatch_sync(self, snapshot, pods, kw)

    def schedule_batch_async(self, snapshot, pods, **kw):
        return self._pool.dispatch_async(self, snapshot, pods, kw)

    def schedule_windows(self, snapshot, pods_windows, **kw):
        return self._pool.dispatch_windows(self, snapshot, pods_windows, kw)

    def preempt(self, snapshot, pods, victims, *, k_cap: int):
        return self._pool.preempt(snapshot, pods, victims, k_cap=k_cap)

    def supports_resident(self) -> bool:
        return False

    def supports_windows_resident(self) -> bool:
        return False

    def supports_gangs(self) -> bool:
        inner = self._pool.inner
        sg = getattr(inner, "supports_gangs", None)
        return bool(sg()) if sg is not None else False

    def supports_fused_min_max(self) -> bool:
        # the inner engine's probe, so a shared fleet takes the same
        # min-max route as the same fleet on private engines (the
        # reference's view has no probe: its shared fleets run min-max
        # unfused, with the same decisions)
        probe = getattr(self._pool.inner, "supports_fused_min_max", None)
        return bool(probe()) if probe is not None else False

    def invalidate_resident(self) -> None:
        self._pool.invalidate()

    def set_trace_id(self, trace_id: int, seq: int = -1) -> None:
        # last-writer-wins across the fleet: sidecar spans attribute to
        # the most recent dispatcher (coalesced groups are one device
        # call serving several trace ids — the pool's counters, not the
        # span join, are the per-replica evidence there)
        st = getattr(self._pool.inner, "set_trace_id", None)
        if st is not None:
            st(trace_id, seq)

    def healthy(self) -> bool:
        h = getattr(self._pool.inner, "healthy", None)
        return bool(h()) if h is not None else True

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            self._pool._view_closed()


class SharedEnginePool:
    """The fleet-shared engine: build one, hand each replica a
    `view()`, wire the views through the Scheduler's `engine=` seam.
    `inner` defaults to a TorchEngine on `device` (cuda unless given;
    it raises without CUDA)."""

    def __init__(
        self,
        inner=None,
        *,
        coalesce_window_ms: float = 2.0,
        resident: bool = True,
        device=None,
    ):
        if inner is None:
            from kubernetes_scheduler_tpu_torch.engine import TorchEngine

            inner = TorchEngine(device=device)
        self.inner = inner
        self.coalesce_window_ms = float(coalesce_window_ms)
        self._resident = bool(resident)
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._pending: list[_Pending] = []
        self._executing = False
        self._active = 0  # threads currently inside a dispatch/force
        self._prev = None  # pool-owned COPY of the inner resident content
        self._epoch = 0
        self._views: list[_EngineView] = []
        self._open_views = 0
        self._closed = False
        # fleet evidence (plain ints; the shipped metric surface is the
        # three collectors below)
        self.device_dispatches = 0
        self.upload_bytes = {"full": 0, "delta": 0, "dedup": 0}
        # wall time inside _execute: the shared device work a bench can
        # apportion across the participants one fused dispatch served
        self.execute_seconds = 0.0
        self.ctr_coalesced = Counter(
            "coalesced_dispatches_total",
            "Shared-engine device dispatches that carried two or more "
            "replicas' windows in one coalesced super-batch.",
        )
        self.ctr_uploads = Counter(
            "shared_engine_uploads_total",
            "Snapshot uploads through the fleet-shared engine by kind: "
            "full (base resync), delta (changed rows once per fleet), "
            "dedup (zero-row epoch advance — content already resident).",
            labels=("upload",),
        )
        self.hist_batch = Histogram(
            "coalesce_batch_window_count",
            "Windows per shared-engine device dispatch (1 = nothing to "
            "coalesce with).",
            buckets=COALESCE_BUCKETS,
        )
        self.collectors = (
            self.ctr_coalesced, self.ctr_uploads, self.hist_batch,
        )

    # ---- views --------------------------------------------------------

    def view(self, name: str) -> _EngineView:
        v = _EngineView(self, name)
        self._views.append(v)
        self._open_views += 1
        return v

    def _view_closed(self) -> None:
        self._open_views -= 1
        if self._open_views <= 0:
            self.close()

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        c = getattr(self.inner, "close", None)
        if c is not None:
            c()

    # ---- dispatch surface --------------------------------------------

    def dispatch_async(self, view, snapshot, pods, kw) -> _PoolHandle:
        p = _Pending(view, "batch", snapshot, pods, dict(kw))
        with self._cond:
            self._pending.append(p)
            self._cond.notify_all()
        return _PoolHandle(self, p)

    def dispatch_sync(self, view, snapshot, pods, kw):
        p = _Pending(view, "batch", snapshot, pods, dict(kw))
        with self._cond:
            self._active += 1
            self._pending.append(p)
            self._cond.notify_all()
        try:
            return self._settle(p, gate=True)
        finally:
            with self._cond:
                self._active -= 1

    def dispatch_windows(self, view, snapshot, pods_windows, kw):
        if not hasattr(self.inner, "schedule_windows"):
            raise NotImplementedError("inner engine lacks schedule_windows")
        p = _Pending(view, "windows", snapshot, pods_windows, dict(kw))
        with self._cond:
            self._pending.append(p)
            self._cond.notify_all()
        return self._settle(p)

    def preempt(self, snapshot, pods, victims, *, k_cap: int):
        # stateless pass-through: the preemption snapshot is an
        # ephemeral build that must never touch the resident base
        with self._cond:
            self.device_dispatches += 1
        return self.inner.preempt(snapshot, pods, victims, k_cap=k_cap)

    def invalidate(self) -> None:
        """Drop the fleet base (engine failure, external resync): the
        next dispatch re-syncs with a fenced full upload."""
        with self._cond:
            self._prev = None
        inv = getattr(self.inner, "invalidate_resident", None)
        if inv is not None:
            try:
                inv()
            except Exception:
                log.debug("inner invalidate_resident failed", exc_info=True)

    # ---- execution ----------------------------------------------------

    def _settle(self, p: _Pending, *, gate: bool = False):
        """Force one pending result. The first forcing thread becomes
        the executor and drains EVERYTHING queued (adopting late
        arrivals before retiring — no lost wakeup); others wait for
        their result to be delivered."""
        with self._cond:
            if (
                gate
                and not p.done
                and not self._executing
                and self.coalesce_window_ms > 0
                and self._active > 1
                and len(self._pending) == 1
            ):
                # threaded lone dispatch with companions en route: give
                # them one short window to land in this super-batch
                self._cond.wait(self.coalesce_window_ms / 1000.0)
            while not p.done:
                if self._executing:
                    self._cond.wait(0.05)
                    continue
                self._executing = True
                try:
                    while self._pending:
                        batch = self._pending
                        self._pending = []
                        self._cond.release()
                        try:
                            self._execute(batch)
                        finally:
                            self._cond.acquire()
                        self._cond.notify_all()
                finally:
                    self._executing = False
                    self._cond.notify_all()
        if p.error is not None:
            raise p.error
        return p.value

    @staticmethod
    def _kw_key(kw: dict):
        try:
            return tuple(sorted(kw.items()))
        except TypeError:
            return None  # unhashable option: schedules alone

    def _resident_ok(self) -> bool:
        if not self._resident:
            return False
        sr = getattr(self.inner, "supports_resident", None)
        try:
            return bool(sr()) if sr is not None else False
        except Exception:
            return False

    def _execute(self, batch: list[_Pending]) -> None:
        """Run one drained batch: windows requests go out individually
        (the backlog scan carries state across its own windows); batch
        requests group by identical engine options and coalesce."""
        t0 = time.perf_counter()
        try:
            self._execute_batch(batch)
            # deliver FORCED results: the executor absorbs the device
            # wall (so execute_seconds measures it) instead of every
            # follower waiting on work the leader launched
            if any(p.done and p.error is None for p in batch):
                _wait_for_device(self.inner)
        finally:
            self.execute_seconds += time.perf_counter() - t0

    def _execute_batch(self, batch: list[_Pending]) -> None:
        groups: list[tuple[object, list[_Pending]]] = []
        by_key: dict = {}
        for p in batch:
            key = self._kw_key(p.kw)
            if p.kind == "windows" or key is None:
                groups.append((None, [p]))
                continue
            g = by_key.get(key)
            if g is None:
                g = []
                by_key[key] = g
                groups.append((key, g))
            g.append(p)
        for _, reqs in groups:
            if reqs[0].kind == "windows":
                self._execute_windows(reqs[0])
            else:
                self._execute_group(reqs)

    def _fail(self, reqs: list[_Pending], e: BaseException) -> None:
        """Deliver one inner-engine failure to every participant and
        drop the base: each replica runs its own fallback/re-dispatch
        for its own window (the BindTable fences the retries), and the
        next dispatch re-syncs with a fenced full upload."""
        with self._cond:
            self._prev = None
        for p in reqs:
            p.error = e
            p.done = True

    def _account(self, kind: str, nbytes: int) -> None:
        self.ctr_uploads.inc(upload=kind)
        self.upload_bytes[kind] += int(nbytes)

    def _classify(self, prev, snapshot):
        """(delta | None, kind, nbytes) of moving the resident content
        from `prev` to `snapshot`: delta=None means full upload."""
        from kubernetes_scheduler_tpu_torch.engine import snapshot_nbytes
        from kubernetes_scheduler_tpu_torch.host.snapshot import snapshot_delta

        if prev is None:
            return None, "full", snapshot_nbytes(snapshot)
        delta = snapshot_delta(prev, snapshot)
        if delta is None:
            return None, "full", snapshot_nbytes(snapshot)
        if _delta_rows(delta) == 0:
            return delta, "dedup", 0
        return delta, "delta", snapshot_nbytes(delta)

    def _execute_group(self, reqs: list[_Pending]) -> None:
        from kubernetes_scheduler_tpu_torch.host.snapshot import snapshot_delta

        inner = self.inner
        n = len(reqs)
        with self._cond:
            self.device_dispatches += 1
        self.hist_batch.observe(float(n))
        if n >= 2:
            self.ctr_coalesced.inc()
        if not self._resident_ok():
            # no resident surface: plain forwarding, full upload each
            # (the inner's own caches may still dedupe bytes)
            for p in reqs:
                if p is not reqs[0]:
                    with self._cond:
                        self.device_dispatches += 1
                try:
                    p.value = inner.schedule_batch(p.snapshot, p.pods, **p.kw)
                    p.done = True
                    self._account("full", 0)
                except Exception as e:  # fan out to the rest
                    self._fail([q for q in reqs if not q.done], e)
                    return
            return
        # resident path: advance the base to the first request's
        # snapshot, then ride every other request as a functional delta
        # against it inside ONE schedule_batch_fleet invocation
        base_req = reqs[0]
        base = base_req.snapshot
        base_delta, base_kind, base_bytes = self._classify(self._prev, base)
        elements = [(None, base_req)]
        tail: list[_Pending] = []
        accounts = [(base_kind, base_bytes)]
        for p in reqs[1:]:
            d = snapshot_delta(base, p.snapshot)
            if d is None:
                # delta-inexpressible divergence (layout/shape churn):
                # this request re-syncs as its own base afterwards
                tail.append(p)
                continue
            if _delta_rows(d) == 0:
                elements.append((None, p))
                accounts.append(("dedup", 0))
            else:
                from kubernetes_scheduler_tpu_torch.engine import snapshot_nbytes

                elements.append((d, p))
                accounts.append(("delta", snapshot_nbytes(d)))
        epoch = self._epoch + 1
        try:
            if len(elements) == 1:
                results = [
                    inner.schedule_resident(
                        base, base_req.pods,
                        delta=base_delta, epoch=epoch, **base_req.kw
                    )
                ]
            elif hasattr(inner, "schedule_batch_fleet"):
                results = list(
                    inner.schedule_batch_fleet(
                        base,
                        [(d, p.pods) for d, p in elements],
                        delta=base_delta, epoch=epoch, **base_req.kw
                    )
                )
            else:
                # resident-capable inner without the fleet surface
                # (remote sidecar): chain sequential resident calls —
                # N RPCs, but the uploads stay deduped
                results = []
                content = None
                eph = epoch
                for i, (_, p) in enumerate(elements):
                    if i == 0:
                        d, content = base_delta, base
                    else:
                        d = snapshot_delta(content, p.snapshot)
                        content = p.snapshot
                        with self._cond:
                            self.device_dispatches += 1
                    results.append(
                        inner.schedule_resident(
                            p.snapshot if i else base, p.pods,
                            delta=d, epoch=eph, **p.kw
                        )
                    )
                    eph += 1
                epoch = eph - 1
                base = content
        except Exception as e:
            self._fail([q for q in reqs if not q.done], e)
            return
        self._epoch = epoch
        # the base content the inner now retains — copied, because the
        # source arrays belong to a replica's builder/mirror and mutate
        # in place after its force
        if base_kind != "dedup" or self._prev is None:
            with self._cond:
                self._prev = _copy_tree(base)
        for (kind, nbytes), (_, p), res in zip(accounts, elements, results):
            self._account(kind, nbytes)
            p.value = res
            p.done = True
        if tail:
            self._execute_group(tail)

    def _execute_windows(self, p: _Pending) -> None:
        inner = self.inner
        with self._cond:
            self.device_dispatches += 1
        self.hist_batch.observe(1.0)
        try:
            swr = getattr(inner, "supports_windows_resident", None)
            if (
                self._resident_ok()
                and swr is not None
                and swr()
                and hasattr(inner, "schedule_windows_resident")
            ):
                delta, kind, nbytes = self._classify(self._prev, p.snapshot)
                epoch = self._epoch + 1
                p.value = inner.schedule_windows_resident(
                    p.snapshot, p.pods, delta=delta, epoch=epoch, **p.kw
                )
                self._epoch = epoch
                if kind != "dedup" or self._prev is None:
                    with self._cond:
                        self._prev = _copy_tree(p.snapshot)
                self._account(kind, nbytes)
            else:
                p.value = inner.schedule_windows(p.snapshot, p.pods, **p.kw)
                self._account("full", 0)
            p.done = True
        except Exception as e:
            self._fail([p], e)

    # ---- evidence -----------------------------------------------------

    def stats(self) -> dict:
        """The fleet-shared engine numbers the bench/scenario harnesses
        assert on."""
        return {
            "device_dispatches": self.device_dispatches,
            "coalesced_dispatches": int(self.ctr_coalesced.total()),
            "uploads": {
                kind: int(self.ctr_uploads.value(upload=kind))
                for kind in ("full", "delta", "dedup")
            },
            "upload_bytes": dict(self.upload_bytes),
            "execute_seconds": round(self.execute_seconds, 4),
            "epoch": self._epoch,
        }
