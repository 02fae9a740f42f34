"""Streaming state ingestion: an event-sourced mirror of SnapshotArrays.

The pre-mirror host loop re-derives cluster state from the full pod/node
lists every cycle (host/snapshot.build_snapshot) and row-diffs whole
matrices to get a SnapshotDelta (snapshot_delta) — both O(nodes) stages
(`snapshot_build` + `delta_derive` in the span attribution), and at 100k
nodes the host-side rebuild, not the device step, is the ceiling.

SnapshotMirror inverts the dataflow: informer pod/node/utilization
events are applied DIRECTLY to a persistent host-side numpy mirror of
the snapshot leaves, accumulating touched-row sets, so each cycle emits
a ready-made SnapshotDelta (same by-value rows, same flush-to-full rules
on static/layout churn as snapshot_delta) in O(events since last cycle).
An idle cluster emits a zero-row delta at ~0 cost; `build_snapshot`
leaves the hot path and is kept only as the flush-to-full path and the
periodic verification cross-check (`verify_interval`), which pins
mirror <-> rebuild BITWISE equality — the PARITY delta/full bindings
guarantee reduces to that check never failing, and a failure resyncs
loudly (full rebuild + mirror_verify_failures_total) instead of serving
drifted state.

Bitwise-equality discipline (why the row math below mirrors the builder
line for line):

- a pod event only books the pod (store, running list, the node's pod
  list) and marks its node; the rows of every marked node are
  recomputed together in one pass (_flush_rows) before anything reads
  a leaf: at emit, verify, a selector extension and a fault injection.
- `requested` rows: the builder accumulates per-node contributions as a
  sequential left-fold in running-list order (np.add.at is unbuffered).
  The pass recomputes each marked node's row from its per-node pod list
  in the SAME order (matrix adds, then the pods-column increments, then
  hostPort increments — the builder's phase order), one float32
  np.add.accumulate per group of nodes holding the same pod count.
- domain tables: the raw per-(node, selector) tables are recounted for
  the marked nodes from their pods (integer counts and weights, added
  in running order); the domain aggregation re-sums each touched domain
  once with float64 accumulation like the builder's Python fold (f32
  inputs in realistic ranges sum exactly in f64 regardless of
  association, and the verify cross-check backstops the claim).
- utilization: by-value float32 writes, the same scalar cast the
  builder's batch fill applies.

Flush-to-full triggers (mirror -> build_snapshot, emitted delta = None):
any node event (the static block is cached per node SET), selector
drift past the allocated power-of-two bucket, hostPort SLOT GROWTH, and
any verification mismatch. The two heaviest recurring drift classes are
absorbed IN PLACE instead of flushing
(mirror_incremental_extensions_total{kind}): a selector minted into an
existing padding column is filled from the running set
(_extend_selectors — O(running x new selectors), not O(everything)),
and a same-width hostPort remap recomputes only the rows of nodes
hosting port pods (_remap_ports). Mirror-off (snapshot_delta) still
degrades to full uploads on those cycles; the mirror's extension paths
are strictly-better host work with the same emitted arrays, and the
periodic verify cross-check pins that equality.
"""

from __future__ import annotations

import logging
import threading
import time

import numpy as np

from kubernetes_scheduler_tpu_torch.engine import (
    SnapshotArrays,
    SnapshotDelta,
    snapshot_nbytes,
)
from kubernetes_scheduler_tpu_torch.host.observe import Counter
from kubernetes_scheduler_tpu_torch.host.snapshot import (
    FLAG_PLAIN,
    _rows_padded,
    pod_flags,
    pod_request_bytes,
    selector_key,
)

log = logging.getLogger("yoda_tpu.mirror")

# the snapshot leaves the mirror maintains in place (everything else is
# static per node set and flushes to a full rebuild on change — the same
# split snapshot_delta's leaf classification pins at import)
_MUTABLE_LEAVES = (
    "requested",
    "disk_io", "cpu_pct", "mem_pct", "net_up", "net_down",
    "domain_counts", "avoid_counts", "pref_attract", "pref_avoid",
)
_UTIL_LEAVES = ("disk_io", "cpu_pct", "mem_pct", "net_up", "net_down")
_DOMAIN_LEAVES = ("domain_counts", "avoid_counts", "pref_attract", "pref_avoid")


def _pod_key(pod) -> str:
    """Scheduling identity (kube.source.pod_key semantics, duplicated to
    keep the host layer free of kube imports)."""
    return pod.uid or f"{pod.namespace}/{pod.name}"


def _term_keys(pod) -> list:
    """(term, selector key) of each preferred or anti-affinity term of a
    running pod — the term kinds the builder's running-set intake
    interns — memoized on the pod (specs are immutable): the bind's
    intake check and the row pass both probe them."""
    keys = pod.__dict__.get("_term_keys_cache")
    if keys is None:
        keys = [
            (term, selector_key(term))
            for term in pod.pod_affinity
            if term.preferred or term.anti
        ]
        pod.__dict__["_term_keys_cache"] = keys
    return keys


class CycleTrigger:
    """The condition the event-driven host loop sleeps on
    (config.cycle_trigger="event"): queue pushes and mirror events
    notify(); the loop wait()s with the watchdog timeout. The
    set-then-clear-after-wait protocol cannot lose a wakeup: a notify
    landing between the caller's work check and its wait() leaves the
    event set, so the wait returns immediately."""

    def __init__(self):
        self._evt = threading.Event()
        self.notifies = 0

    def notify(self) -> None:
        self.notifies += 1
        self._evt.set()

    def wait(self, timeout: float | None = None) -> bool:
        """Block until notified or `timeout` (the tick watchdog — the
        loop still runs its bookkeeping on silence). Returns True when
        woken by a notify."""
        fired = self._evt.wait(timeout)
        self._evt.clear()
        return fired


class SnapshotMirror:
    """Persistent host-side mirror of SnapshotArrays, fed by events.

    Ownership: after seed(), the mirror's (nodes, running, utils) ARE
    the scheduler's cluster state — `state()` serves them by reference
    and the per-cycle list/fetch callables are consulted only at seed
    time. Event producers (informer hooks, the scheduler's own binds,
    ScenarioWorld, advisor coalescing) keep them current.

    Emitted arrays are frozen: the first write to a leaf after an emit
    (the row pass, a utilization event) copies it (copy-on-write), so
    journaled/retained snapshots
    never mutate underfoot — the flight recorder's delta chain rule
    compares delta bases by identity and depends on this.
    """

    def __init__(
        self,
        builder,
        *,
        verify_interval: int = 0,
        on_dirty=None,
    ):
        self.builder = builder
        # 0 = never cross-check; N = every Nth emit re-runs
        # build_snapshot (ephemeral) and compares every leaf bitwise
        self.verify_interval = int(verify_interval)
        self._on_dirty = on_dirty
        # re-entrant: the public event/emit surfaces hold it and the
        # private helpers re-take it around their own state mutations
        # (self-documenting, and safe if ever called bare)
        self._lock = threading.RLock()
        self.seeded = False
        self.nodes: list = []
        self.utils: dict = {}
        # the running set: pods in insertion order under a per-insertion
        # sequence number (removal is O(1)), each scheduling key's
        # number, and the list `running` hands out — None once a pod has
        # left, until the next read rebuilds it from the store
        self._store: dict[int, object] = {}
        self._seq_of: dict[str, int] = {}
        self._next_seq = 0
        self._running_list: list | None = []
        # a seeded list that repeats a key: a removal then also drops
        # every other copy of the pod, as a filter by identity would
        self._seed_dups = False
        # each node's pods in running order
        self._by_node: dict[str, list] = {}
        # the names of the nodes whose rows the next pass (_flush_rows)
        # recomputes, and the pod events applied since the last pass
        self._rows_dirty: set = set()
        self._rows_events = 0
        self._flush = True
        self._flush_reason = "seed"
        self._leaves: dict[str, np.ndarray] = {}
        self._owned: set[str] = set()
        self._static: SnapshotArrays | None = None
        self._raw: tuple | None = None          # mirror-owned raw domain tables
        self._topo_groups: dict = {}
        self._node_index: dict = {}
        self._names_t: tuple = ()
        self._pods_col = 0
        self._port0 = 0
        # selector-table size at adopt: any growth since (a window or
        # the preemption pass minting ids through build_pod_batch)
        # means the raw tables were never matched/sized against the new
        # selector — layout drift, flush
        self._adopt_n_sel = 0
        self._adopt_slots = 0
        self._adopt_ports: dict = {}
        self._req_dirty: set[int] = set()
        self._util_dirty: set[int] = set()
        self._dom_dirty: set[int] = set()
        self._last_emitted: SnapshotArrays | None = None
        # set when an in-place extension patched a STATIC leaf the delta
        # format cannot carry (domain_id columns): the next emit must
        # ship a full upload even though the mirror never rebuilt
        self._force_full_upload = False
        self._emits = 0
        # pod events coalesced into `pod_events` burst spans, and the
        # row pass's `mirror_rows` spans (observe.PodEventBursts), set by
        # a Scheduler with spans on; None keeps the mirror untimed
        self.bursts = None
        # exported beside the scheduler's collectors (SHIPPED_METRICS)
        self.ctr_events = Counter(
            "events_applied_total",
            "Informer/advisor events applied to the snapshot mirror",
            labels=("kind",),
        )
        self.ctr_rebuilds = Counter(
            "mirror_full_rebuilds_total",
            "Mirror flush-to-full rebuilds, labeled by the flush cause "
            "(seed, node-churn, selector-drift, layout-drift, "
            "port-churn, verify-mismatch)",
            labels=("reason",),
        )
        self.ctr_verify_failures = Counter(
            "mirror_verify_failures_total",
            "Periodic mirror-vs-rebuild cross-checks that found a "
            "bitwise mismatch (resynced by a full rebuild)",
        )
        self.ctr_extensions = Counter(
            "mirror_incremental_extensions_total",
            "Layout drifts absorbed in place instead of flushing to a "
            "full rebuild (selector = new selector columns filled from "
            "the running set; port-remap = hostPort columns recomputed "
            "under a remapped same-width port table)",
            labels=("kind",),
        )
        self.ctr_running_rebuilds = Counter(
            "mirror_running_rebuilds_total",
            "Rebuilds of the running list from the mirror's store: one "
            "at the first read after pods left the running set",
        )
        self.ctr_row_nodes = Counter(
            "mirror_row_nodes_total",
            "Node rows the mirror's batched row pass recomputed (the "
            "requested row and, with selectors, the domain tables); "
            "events_applied_total{kind=\"pod\"} over it is the events "
            "each recomputed row absorbed",
        )
        self.collectors = (
            self.ctr_events, self.ctr_rebuilds, self.ctr_verify_failures,
            self.ctr_extensions, self.ctr_running_rebuilds,
            self.ctr_row_nodes,
        )

    # -- seeding / state -------------------------------------------------

    def seed(self, nodes: list, running: list, utils: dict) -> None:
        """Adopt the initial cluster state (one full fetch). The first
        emit() flush-builds the arrays; events apply from now on."""
        with self._lock:
            self.nodes = list(nodes)
            running = list(running)
            self._running_list = running
            self._store = dict(enumerate(running))
            self._next_seq = len(running)
            self._seq_of = {_pod_key(p): i for i, p in enumerate(running)}
            self._seed_dups = len(self._seq_of) != len(running)
            self.utils = dict(utils)
            self._rebuild_by_node()
            self._mark_flush("seed")
            self.seeded = True

    @property
    def running(self) -> list:
        """The running pods in insertion order. The same list object,
        appended in place, until a pod leaves the running set; the first
        read after that builds a new one from the store, under the lock
        (mirror_running_rebuilds_total)."""
        with self._lock:
            lst = self._running_list
            if lst is None:
                lst = self._running_list = list(self._store.values())
                self.ctr_running_rebuilds.inc()
            return lst

    def state(self) -> tuple[list, list, dict]:
        """(nodes, running, utils) by REFERENCE — the running list stays
        the same (append-only between removals) object so the builder's
        prefix-identity caches hold across flush rebuilds."""
        return self.nodes, self.running, self.utils  # graftlint: disable=thread-race -- intended bulk-sync read: the running list is built under self._lock; the cycle adopts the node list and utils by reference at a flush boundary while event writes serialize under self._lock; tearing only stales one cycle and the flush path rebuilds from scratch

    def _drop_running(self, key: str):
        """Take the pod under `key` out of the running set and out of its
        node's pods; returns it, or None when the key is unknown."""
        with self._lock:
            seq = self._seq_of.pop(key, None)
            if seq is None:
                return None
            old = self._store.pop(seq)
            if self._seed_dups:
                for s in [s for s, p in self._store.items() if p is old]:
                    del self._store[s]
            self._running_list = None
            lst = self._by_node.get(old.node_name)
            if lst is not None:
                for j in reversed([j for j, p in enumerate(lst) if p is old]):
                    del lst[j]
            return old

    def _rebuild_by_node(self) -> None:
        with self._lock:
            by_node: dict[str, list] = {}
            for p in self._store.values():
                if p.node_name is not None:
                    by_node.setdefault(p.node_name, []).append(p)
            self._by_node = by_node

    def _mark_flush(self, reason: str) -> None:
        with self._lock:
            if not self._flush:
                self._flush = True
                self._flush_reason = reason

    def _selectors_stable(self) -> bool:
        return len(self.builder.selectors) == self._adopt_n_sel

    def _extend_selectors(self) -> bool:
        """Absorb selector drift IN PLACE: fill the already-allocated
        padding columns for selector ids minted since adopt, instead of
        flushing to a full rebuild.

        The domain tables (and domain_id) are sized to the power-of-two
        selector bucket, so a freshly minted id usually lands in columns
        that already exist as zero padding — the only state a new
        selector actually changes. The fill is the builder's own math
        for exactly those columns: count running pods matching each new
        key (pref/anti term WEIGHTS cannot target a new id — every
        running pod's pref/anti keys were interned when the pod entered
        the running set, so the new columns' weight tables stay zero),
        then aggregate the new columns over their topology domains.
        Returns False — caller flushes — when the drift crosses the
        bucket boundary (array shapes grow; a rebuild must re-size).

        A non-hostname topology also patches domain_id, a STATIC leaf
        the delta format cannot carry ("domain_id is layout and never
        rides a delta" — engine.py): the next emit ships a full upload,
        but the mirror still never rebuilt."""
        with self._lock:
            b = self.builder
            if len(b.selectors) == self._adopt_n_sel:
                return True
            # the marked rows first, over the table they were booked
            # against: the fill below adds to every running pod's node
            self._flush_rows()
            if self._flush:
                return False
            cur_s = int(self._leaves["domain_counts"].shape[1])
            if b._selector_slots() != cur_s:
                return False  # bucket growth: shapes change, rebuild
            new_items = list(b.selectors.items())[self._adopt_n_sel:]
            n_real = len(self.nodes)
            if self._raw is None:
                # adopt saw zero selectors: allocate the raw tables the
                # first minted id needs (bucket width is already 1+)
                self._raw = tuple(
                    np.zeros((n_real, cur_s), np.float32) for _ in range(4)
                )
            raw = self._raw[0]
            node_index = self._node_index
            for pod in self.running:
                i = node_index.get(pod.node_name)
                if i is None:
                    continue
                for key, sid in new_items:
                    if b._key_matches(pod, key):
                        raw[i, sid] += 1
            new_by_topo: dict[str, list[int]] = {}
            for key, sid in new_items:
                new_by_topo.setdefault(key[2], []).append(sid)
            outs = tuple(
                self._writable(name) for name in _DOMAIN_LEAVES
            )
            dom_id = None
            for topo, sids in new_by_topo.items():
                grp = self._topo_groups.get(topo)
                if grp is None:
                    grp = self._topo_groups[topo] = self._topo_group(topo)
                grp["sids"].extend(sids)
                for rows in grp["members"].values():
                    ix = np.ix_(rows, sids)
                    touched = False
                    for table, out in zip(self._raw, outs):
                        vals = table[ix].sum(axis=0, dtype=np.float64)
                        out[ix] = vals
                        if vals.any():
                            touched = True
                    if touched:
                        self._dom_dirty.update(rows)
                if topo != "kubernetes.io/hostname":
                    # hostname columns equal the padding default (every
                    # node its own domain, first index == own index) —
                    # only a label topology moves domain_id
                    if dom_id is None:
                        dom_id = np.array(self._static.domain_id)
                    for rows in grp["members"].values():
                        dom_id[np.ix_(rows, sids)] = rows[0]
            if dom_id is not None:
                self._static = self._static._replace(domain_id=dom_id)
                self._force_full_upload = True
            self._adopt_n_sel = len(b.selectors)
            self.ctr_extensions.inc(kind="selector")
            return True

    def _remap_ports(self, new_index: dict) -> None:
        """Absorb a hostPort REMAP within the existing slot budget: only
        the port-column block of `requested` means something different
        under the new port->column table, so mark the nodes hosting port
        pods for the row pass (row-exact, the builder's phase order)
        instead of flushing. The static block survives untouched — every port
        column's capacity is the same 1.0/node and the column NAMES are
        slot-generic (hostport/<i>), so neither alloc nor the resource-
        name tuple moves. Slot GROWTH still flushes (every width in the
        snapshot changes)."""
        with self._lock:
            self._adopt_ports = dict(new_index)
            for name, pods_on in self._by_node.items():
                if any(p.host_ports for p in pods_on):
                    self._rows_dirty.add(name)
            self.ctr_extensions.inc(kind="port-remap")

    def _notify(self) -> None:
        if self._on_dirty is not None:
            self._on_dirty()

    # -- event ingestion -------------------------------------------------

    def apply_node_event(self, etype: str, node) -> None:
        """ADDED/MODIFIED/DELETED on a Node: every node-side leaf is
        static per node SET (build_snapshot's _node_static cache), so
        any node event flushes to a full rebuild — the same rule that
        makes snapshot_delta return None on static churn."""
        with self._lock:
            if not self.seeded:
                return
            self.ctr_events.inc(kind="node")
            if etype == "DELETED":
                self.nodes = [nd for nd in self.nodes if nd.name != node.name]
            else:
                for i, nd in enumerate(self.nodes):
                    if nd.name == node.name:
                        self.nodes[i] = node  # MODIFIED keeps position
                        break
                else:
                    self.nodes.append(node)
            self._mark_flush("node-churn")
        self._notify()

    def apply_pod_event(self, etype: str, pod) -> None:
        """A running-set change: BOUND/ADDED/MODIFIED adds or replaces
        the pod, DELETED removes it. Dedup is by scheduling key AND
        object identity, so the scheduler's own post-bind self-apply and
        the informer's later echo of the same Pod object coalesce. The
        event books the pod and marks its node; the node's rows are
        recomputed by the next row pass. With `bursts` set, each event
        is timed from the call, the wait for the mirror's lock included,
        to the update's end."""
        self.apply_pod_events(etype, (pod,))

    def apply_pod_events(self, etype: str, pods) -> None:
        """apply_pod_event for each of `pods`, in order, under one hold
        of the lock: one events_applied_total increment, one
        `pod_events` burst (its `events` the pods) and one notify for
        the batch (the cycle's self-apply of its binds)."""
        if not pods:
            return
        bursts = self.bursts
        t0 = time.perf_counter() if bursts is not None else 0.0
        with self._lock:
            t_in = time.perf_counter() if bursts is not None else 0.0
            n = 0
            for pod in pods:
                n += self._apply_pod_event(etype, pod)
            if n:
                self.ctr_events.inc(n, kind="pod")
                self._rows_events += n
        if bursts is not None:
            deleted = len(pods) if etype == "DELETED" else 0
            bursts.event(t0, time.perf_counter(), t_in - t0, deleted, len(pods))
        if n:
            self._notify()

    def _apply_pod_event(self, etype: str, pod) -> bool:
        """One pod event's bookkeeping: the store, the key map, the
        running list, the node's pods, the selector interning and
        extension, the flush decisions, and the mark on each node whose
        rows change. False when the event changed nothing (mirror not
        seeded, an unknown deletion, a self-apply echo)."""
        with self._lock:
            if not self.seeded:
                return False
            key = _pod_key(pod)
            if etype == "DELETED":
                old = self._drop_running(key)
                if old is None:
                    return False
                if not self._flush:
                    if self._extend_selectors():
                        self._rows_dirty.add(old.node_name)
                    else:
                        self._mark_flush("selector-drift")
            else:
                seq = self._seq_of.get(key)
                existing = None if seq is None else self._store[seq]
                if existing is pod:
                    return False  # self-apply echo (same object): no-op
                if existing is not None:
                    # replace = remove + add (keeps row math exact)
                    self._drop_running(key)
                    if not self._flush:
                        if self._extend_selectors():
                            self._rows_dirty.add(existing.node_name)
                        else:
                            self._mark_flush("selector-drift")
                if pod.node_name is None:
                    return True
                # absorb selector drift BEFORE the pod joins the running
                # set: the extension's new-column fill scans running, and
                # the row pass recounts this pod's node against the (now
                # grown) adopted prefix. The incoming pod's own
                # pref/anti keys are minted first — the exact term kinds
                # the builder's running-set intake interns — so a pod
                # introducing a fresh soft-affinity selector extends
                # instead of flushing
                if not self._flush:
                    fl = pod.__dict__.get("_flags_cache")
                    if fl is None:
                        fl = pod_flags(pod)
                    if not fl & FLAG_PLAIN:
                        for term, sel in _term_keys(pod):
                            if sel not in self.builder.selectors:
                                self.builder._selector_id(term)
                        # topology-spread selectors: BOTH
                        # whenUnsatisfiable variants (DoNotSchedule
                        # hard, ScheduleAnyway soft) intern through the
                        # same canonical selector_key, so a bound pod
                        # arriving with either variant of a fresh
                        # spread selector extends the column in place
                        # (the fill scans running before this pod joins;
                        # the row pass then counts it once) — an
                        # out-of-band bind with spread constraints used
                        # to leave the selector unminted until a window
                        # used it
                        for sc in pod.topology_spread:
                            if selector_key(sc) not in self.builder.selectors:
                                self.builder._selector_id(sc)
                    if not self._extend_selectors():
                        self._mark_flush("layout-drift")
                seq = self._next_seq
                self._next_seq = seq + 1
                self._store[seq] = pod
                self._seq_of[key] = seq
                if self._running_list is not None:
                    self._running_list.append(pod)
                self._by_node.setdefault(pod.node_name, []).append(pod)
                if not self._flush:
                    if not self._pod_compatible(pod):
                        self._mark_flush("layout-drift")
                    else:
                        self._rows_dirty.add(pod.node_name)
        return True

    def apply_util_events(self, changed: dict) -> None:
        """{node name: NodeUtil} for CHANGED nodes only (the advisor
        coalescing protocol, host/advisor.fetch_changed). By-value f32
        writes; no-op values are filtered so idle fetches stay free."""
        if not changed:
            return
        with self._lock:
            if not self.seeded:
                return
            self.ctr_events.inc(len(changed), kind="util")
            self.utils.update(changed)
            if self._flush:
                return
            for name, u in changed.items():
                i = self._node_index.get(name)
                if i is None:
                    continue
                vals = (u.disk_io, u.cpu_pct, u.mem_pct, u.net_up, u.net_down)
                touched = False
                for leaf, v in zip(_UTIL_LEAVES, vals):
                    v32 = np.float32(v)
                    if self._leaves[leaf][i] != v32:
                        self._writable(leaf)[i] = v32
                        touched = True
                if touched:
                    self._util_dirty.add(i)
        self._notify()

    # -- the row pass (mirrors the builder line for line) -----------------

    def _pod_compatible(self, pod) -> bool:
        """Can this running pod's contribution be applied as rows, or
        does it drift the layout (unknown hostPort column, a preferred/
        anti affinity term minting a selector the tables never matched
        prefix pods against)?"""
        fl = pod.__dict__.get("_flags_cache")
        if fl is None:
            fl = pod_flags(pod)
        if fl & FLAG_PLAIN:
            return True
        if pod.host_ports and any(
            # the ADOPT-TIME mapping, never the live builder index: an
            # ephemeral/preemption build_snapshot between emits remaps
            # builder._port_index under us (the emit-time probe flushes
            # when the remap matters; row math must not race it)
            pt not in self._adopt_ports for pt in pod.host_ports
        ):
            return False
        selectors = self.builder.selectors
        return all(key in selectors for _, key in _term_keys(pod))

    def _flush_rows(self) -> None:
        """The one row computation: the rows of every node an event
        marked since the last pass, recomputed together — `requested`,
        then (with selectors) the raw domain tables and each touched
        domain's aggregates — and added to the delta's dirty rows. Runs
        before anything reads a leaf; a pending flush drops the marks,
        since its rebuild recomputes every row. With `bursts` set the
        pass is one `mirror_rows` span (args nodes, events)."""
        with self._lock:
            marked = self._rows_dirty
            if not marked:
                return
            self._rows_dirty = set()
            events, self._rows_events = self._rows_events, 0
            if self._flush:
                return
            bursts = self.bursts
            t0 = time.perf_counter() if bursts is not None else 0.0
            node_index = self._node_index
            by_node = self._by_node
            # unknown nodes contribute nothing (the builder drops rows < 0)
            known = sorted(
                (node_index[name], name) for name in marked if name in node_index
            )
            nodes = [(i, by_node.get(name, ())) for i, name in known]
            if nodes:
                self._recount_requested(nodes)
                if self._raw is not None:
                    self._recount_domains(nodes)
                self.ctr_row_nodes.inc(len(nodes))
            if bursts is not None:
                bursts.span(
                    "mirror_rows", t0, time.perf_counter(),
                    nodes=len(nodes), events=events,
                )

    def _recount_requested(self, nodes: list) -> None:
        """The builder's full-rescan contribution to the `requested` row
        of each (index, pods) node, in its phase order: matrix adds for
        every pod on the node (running-list order), then the pods-column
        increments, then hostPorts. The first two phases are one float32
        np.add.accumulate down a zero row, the node's request rows and a
        1 in the pods column per pod: a left fold, as the builder's
        np.add.at is, so the row is bitwise the builder's at any pods per
        node. Nodes holding the same pod count fold as one array."""
        with self._lock:
            req = self._writable("requested")
            r = req.shape[1]
            names_t = self._names_t
            by_count: dict[int, list] = {}
            for node in nodes:
                by_count.setdefault(len(node[1]), []).append(node)
            for k, grp in by_count.items():
                fold = np.zeros((len(grp), 2 * k + 1, r), np.float32)
                if k:
                    fold[:, 1 : k + 1] = np.frombuffer(
                        b"".join([
                            pod_request_bytes(p, names_t)
                            for _, pods in grp for p in pods
                        ]),
                        np.float32,
                    ).reshape(len(grp), k, r)
                    fold[:, k + 1 :, self._pods_col] = 1.0
                req[[i for i, _ in grp]] = np.add.accumulate(fold, axis=1)[:, -1]
            pidx = self._adopt_ports  # adopt-time mapping (see _pod_compatible)
            if pidx:  # no port columns: no pod here holds a port
                for i, pods in nodes:
                    for pod in pods:
                        for pt in pod.host_ports:
                            req[i, self._port0 + pidx[pt]] += 1
            self._req_dirty.update(i for i, _ in nodes)

    def _recount_domains(self, nodes: list) -> None:
        """The raw per-(node, selector) tables of each (index, pods) node
        recounted from its pods with the builder's own per-pod adds, in
        running order, then the domain aggregates re-summed once per
        touched domain with float64 accumulation (the builder's Python
        fold is f64 too; f32 inputs in realistic ranges sum exactly in
        f64 under any association, and the periodic verify pass
        backstops the equality). Where every domain is one node (the
        hostname key) the aggregate is the row itself."""
        with self._lock:
            b = self.builder
            n_sel = self._adopt_n_sel
            # snapshot the first adopt-count entries: the scheduler
            # thread can mint ids concurrently (preemption-pass
            # build_pod_batch); insertion order makes the prefix exactly
            # the adopted table, and any later-minted id flushes via the
            # stability guards
            table = list(b.selectors.items())[:n_sel]
            raw, raw_avoid, raw_attract, raw_avoid_w = self._raw
            rows = [i for i, _ in nodes]
            for t in self._raw:
                t[rows] = 0.0
            for i, pods in nodes:
                for pod in pods:
                    for key, sid in table:
                        if b._key_matches(pod, key):
                            raw[i, sid] += 1
                    fl = pod.__dict__.get("_flags_cache")
                    if fl is not None and fl & FLAG_PLAIN:
                        continue
                    for term, key in _term_keys(pod):
                        sid = b.selectors.get(key)
                        if sid is None or sid >= n_sel:
                            # minted after adopt (raced past the intake
                            # check): the tables never saw it — flush,
                            # never index past
                            self._mark_flush("selector-drift")
                            return
                        if term.preferred:
                            (raw_avoid_w if term.anti else raw_attract)[i, sid] += (
                                term.weight
                            )
                        else:
                            raw_avoid[i, sid] += 1
            outs = tuple(self._writable(name) for name in _DOMAIN_LEAVES)
            for grp in self._topo_groups.values():
                sids = grp["sids"]
                if grp["single"]:
                    ix = np.ix_(rows, sids)
                    for t, out in zip(self._raw, outs):
                        out[ix] = t[ix]
                    self._dom_dirty.update(rows)
                    continue
                labels, members = grp["labels"], grp["members"]
                for d in {labels[i] for i in rows}:
                    dom = members[d]
                    ix = np.ix_(dom, sids)
                    for t, out in zip(self._raw, outs):
                        out[ix] = t[ix].sum(axis=0, dtype=np.float64)
                    self._dom_dirty.update(dom)

    # -- cycle surface ---------------------------------------------------

    def emit(
        self,
        window: list,
        *,
        pending_all_plain: bool = False,
        prev: SnapshotArrays | None = None,
        max_byte_frac: float = 0.5,
    ) -> tuple[SnapshotArrays, SnapshotDelta | None, bool]:
        """One cycle's (snapshot, delta, rebuilt) in O(events since the
        last emit): the row pass over the nodes the events marked, then
        the leaves and their delta. `prev` is the snapshot the engine currently retains
        (Scheduler._resident_prev); the delta is non-None only when it
        is BY IDENTITY the mirror's previous emit — any invalidation,
        flush, or skipped cycle degrades to a full upload, exactly like
        snapshot_delta returning None. `rebuilt` reports a flush-to-full
        (build_snapshot ran)."""
        with self._lock:
            if not self.seeded:
                raise RuntimeError("SnapshotMirror.emit before seed()")
            if not self._flush:
                self._check_window(window, pending_all_plain)
                self._flush_rows()
            if (
                not self._flush
                and self.verify_interval > 0
                and self._emits > 0
                and self._emits % self.verify_interval == 0
            ):
                self._verify_locked(window, pending_all_plain)
            if self._flush:
                snap = self._rebuild(window, pending_all_plain)
                self._emits += 1
                return snap, None, True
            snap = self._static._replace(**self._leaves)
            delta = None
            if (
                prev is not None
                and prev is self._last_emitted
                and not self._force_full_upload
            ):
                delta = self._make_delta(snap, max_byte_frac)
            self._force_full_upload = False
            self._req_dirty.clear()
            self._util_dirty.clear()
            self._dom_dirty.clear()
            self._owned.clear()  # freeze: next touch copies
            self._last_emitted = snap
            self._emits += 1
            return snap, delta, False

    def _check_window(self, window: list, pending_all_plain: bool) -> None:
        """Window-driven layout drift: a pending pod minting a selector
        (its affinity/spread terms were never matched against the
        running prefix) or moving the hostPort table forces the flush
        build_snapshot would have absorbed."""
        b = self.builder
        if not self._selectors_stable():
            # an out-of-band build_pod_batch (preemption pass, direct
            # callers) minted selector ids since adopt — absorb the new
            # columns in place when they fit the allocated bucket
            if not self._extend_selectors():
                self._mark_flush("selector-drift")
                return
        has_ports = False
        minted = False
        if not pending_all_plain:
            for pod in window:
                fl = pod.__dict__.get("_flags_cache")
                if fl is None:
                    fl = pod_flags(pod)
                if fl & FLAG_PLAIN:
                    continue
                if pod.host_ports:
                    has_ports = True
                # mint window selectors NOW, in build_pod_batch's own
                # scan order (per pod: affinity terms, then spread
                # constraints — ids are append-only so the suffix is
                # exactly what _extend_selectors fills)
                for term in pod.pod_affinity:
                    if selector_key(term) not in b.selectors:
                        b._selector_id(term)
                        minted = True
                for sc in pod.topology_spread:
                    if selector_key(sc) not in b.selectors:
                        b._selector_id(sc)
                        minted = True
        if minted and not self._extend_selectors():
            self._mark_flush("selector-drift")
            return
        if has_ports or self._adopt_ports:
            # refresh the port->column mapping the way build_snapshot
            # would; running pods' port contributions would otherwise
            # sit in stale columns
            b._assign_port_slots(
                self.running,
                [] if pending_all_plain else window,
                ephemeral=True,
                pending_all_plain=pending_all_plain,
            )
            if b._port_slots != self._adopt_slots:
                # slot growth: `requested`/alloc widths change — rebuild
                self._mark_flush("port-churn")
            elif b._port_index != self._adopt_ports:
                self._remap_ports(b._port_index)

    def _rebuild(self, window: list, pending_all_plain: bool) -> SnapshotArrays:
        self.ctr_rebuilds.inc(reason=self._flush_reason or "seed")
        # survives the adopt's reason reset: the degradation ladder
        # records WHY the mirror dropped to its rebuild rung
        self.last_rebuild_reason = self._flush_reason
        log.debug("mirror: full rebuild (%s)", self._flush_reason)
        snap = self.builder.build_snapshot(
            self.nodes, self.utils, self.running,
            pending_pods=window, ephemeral=False,
            pending_all_plain=pending_all_plain,
        )
        self._adopt(snap)
        return snap

    def _adopt(self, snap: SnapshotArrays) -> None:
        with self._lock:
            b = self.builder
            self._static = snap
            self._leaves = {
                name: np.asarray(getattr(snap, name)) for name in _MUTABLE_LEAVES
            }
            self._owned = set()
            self._node_index = b._node_index
            self._names_t = b.resource_names_tuple()
            names = b.resource_names
            self._pods_col = names.index("pods")
            self._port0 = len(names) - b._port_slots
            self._adopt_slots = b._port_slots
            self._adopt_ports = dict(b._port_index)
            self._rebuild_by_node()
            # mirror-owned copies of the raw per-(node, selector) tables —
            # the builder's own _dc_raw cache stays untouched so its prefix
            # bookkeeping remains valid for the next flush rebuild
            self._adopt_n_sel = len(b.selectors)
            if b.selectors:
                rc = b.__dict__.get("_dc_raw")
                self._raw = tuple(t.copy() for t in rc["tables"])
                self._build_topo_groups()
            else:
                self._raw = None
                self._topo_groups = {}
            self._req_dirty.clear()
            self._util_dirty.clear()
            self._dom_dirty.clear()
            self._rows_dirty = set()
            self._rows_events = 0
            self._flush = False
            self._flush_reason = ""
            self._force_full_upload = False
            self._last_emitted = snap

    def _build_topo_groups(self) -> None:
        with self._lock:
            groups: dict = {}
            for key, sid in self.builder.selectors.items():
                topo = key[2]
                grp = groups.get(topo)
                if grp is None:
                    grp = groups[topo] = self._topo_group(topo)
                grp["sids"].append(sid)
            self._topo_groups = groups

    def _topo_group(self, topo: str) -> dict:
        """One topology key's partition of the nodes: each node's domain
        label, each domain's node indices, and whether every domain is a
        single node (the hostname key), where a domain's aggregate is
        its one row."""
        labels = [
            nd.name if topo == "kubernetes.io/hostname" else nd.labels.get(topo, "")
            for nd in self.nodes
        ]
        members: dict[str, list[int]] = {}
        for i, lab in enumerate(labels):
            members.setdefault(lab, []).append(i)
        return {
            "labels": labels, "members": members, "sids": [],
            "single": len(members) == len(labels),
        }

    def _writable(self, name: str) -> np.ndarray:
        """Copy-on-write: the first mutation of a leaf after an emit
        copies it, so emitted (journaled / engine-retained / recorded)
        snapshots are immutable."""
        with self._lock:
            if name not in self._owned:
                self._leaves[name] = self._leaves[name].copy()
                self._owned.add(name)
            return self._leaves[name]

    def _make_delta(
        self, snap: SnapshotArrays, max_byte_frac: float
    ) -> SnapshotDelta | None:
        n = int(np.asarray(snap.node_mask).shape[0])
        req = self._leaves["requested"]
        req_changed = np.array(sorted(self._req_dirty), np.int64)
        req_rows = _rows_padded(req_changed, n)
        req_vals = np.zeros((len(req_rows), req.shape[1]), np.float32)
        req_vals[: len(req_changed)] = req[req_changed]
        util_changed = np.array(sorted(self._util_dirty), np.int64)
        util_rows = _rows_padded(util_changed, n)
        util_vals = np.zeros((len(util_rows), 5), np.float32)
        for col, name in enumerate(_UTIL_LEAVES):
            util_vals[: len(util_changed), col] = self._leaves[name][
                util_changed
            ]
        dom_changed = np.array(sorted(self._dom_dirty), np.int64)
        dom_rows = _rows_padded(dom_changed, n)
        s = int(self._leaves["domain_counts"].shape[1])
        dom_vals = np.zeros((len(dom_rows), s, 4), np.float32)
        for col, name in enumerate(_DOMAIN_LEAVES):
            dom_vals[: len(dom_changed), :, col] = self._leaves[name][
                dom_changed
            ]
        delta = SnapshotDelta(
            req_rows=req_rows, req_vals=req_vals,
            util_rows=util_rows, util_vals=util_vals,
            dom_rows=dom_rows, dom_vals=dom_vals,
            node_mask=np.asarray(snap.node_mask, bool),
        )
        if snapshot_nbytes(delta) > max_byte_frac * snapshot_nbytes(snap):
            return None  # same bytes rule as snapshot_delta
        return delta

    # -- verification ----------------------------------------------------

    def _verify_locked(self, window: list, pending_all_plain: bool) -> bool:
        """Cross-check every mirror leaf bitwise against a fresh
        build_snapshot over the SAME state. A mismatch logs, counts, and
        flushes — this very emit then serves the rebuild, so a drifted
        mirror can never produce a decision the rebuild would not."""
        self._flush_rows()
        if self._flush:
            return True  # the rebuild serves this state
        rebuilt = self.builder.build_snapshot(
            self.nodes, self.utils, self.running,
            pending_pods=window, ephemeral=True,
            pending_all_plain=pending_all_plain,
        )
        cur = self._static._replace(**self._leaves)
        bad = []
        for name in SnapshotArrays._fields:
            a = np.asarray(getattr(cur, name))
            b = np.asarray(getattr(rebuilt, name))
            if a.shape != b.shape or a.dtype != b.dtype or not np.array_equal(a, b):
                bad.append(name)
        if bad:
            self.ctr_verify_failures.inc()
            log.error(
                "mirror: verification mismatch on %s; resyncing with a "
                "full rebuild", bad,
            )
            self._mark_flush("verify-mismatch")
            return False
        return True

    def verify(self, window: list | None = None) -> bool:
        """On-demand cross-check (tests; debugging)."""
        with self._lock:
            if not self.seeded or self._flush:
                return True
            return self._verify_locked(window or [], window is None)

    def inject_corruption(
        self, *, leaf: str = "net_up", row: int = 0, delta: float = 1.0
    ) -> bool:
        """Fault-injection surface (sim/faults.py chaos scenarios):
        perturb ONE cell of a mutable mirror leaf WITHOUT marking its
        row dirty — exactly the silent-drift class the periodic bitwise
        verify cross-check exists to catch (the corrupt value would
        ride emitted snapshots but never the delta). Goes through the
        copy-on-write path, so already-emitted (journaled / engine-
        retained) snapshots are never mutated — replay parity holds;
        the NEXT verify pass must detect, count, and resync. Returns
        False when there is nothing to corrupt (unseeded, or a flush is
        already pending and the corruption would be rebuilt away)."""
        with self._lock:
            self._flush_rows()
            if not self.seeded or self._flush or leaf not in self._leaves:
                return False
            arr = self._writable(leaf)
            if arr.size == 0:
                return False
            arr[row % arr.shape[0]] += np.float32(delta)
            return True
