"""Metrics advisor: the node-utilization sensory input.

Keeps the reference's design (pkg/yoda/advisor/advisor.go) — five PromQL
instant queries joined by hostname into one record per node — but fixes
its pathologies:

- the Prometheus host is configuration, not a hard-coded constant
  (advisor.go:15);
- one fetch per scheduling cycle for the whole batch, not 5 HTTP calls per
  (pod, node) score invocation (scheduler.go:126 calls res.Init() per
  node);
- the result is a dense array block ready for device upload, not a
  map walked per node;
- transport is injectable, so tests run hermetically (the reference's
  tests hit the production endpoints, advisor_test.go:8-18).

Join semantics preserved: series keyed by `kubernetes_io_hostname` with
`instance` as fallback (advisor.go:199-202); nodes missing from a series
keep zeros rather than failing the cycle (advisor.go:190,213 skip
silently); network-IO fetch errors degrade to zeros instead of failing
scheduling (advisor.go:219,242 swallow errors).
"""

from __future__ import annotations

import json
import threading
import time
import urllib.parse
import urllib.request
from dataclasses import dataclass, field
from typing import Callable

# The five instant queries, functionally equivalent to advisor.go:16-20:
# per-node CPU%, memory%, disk-IO MB/s, network transmit/receive MB/s.
PROM_QUERIES = {
    "cpu_pct": (
        'sum by (kubernetes_io_hostname, instance)'
        '(rate(container_cpu_usage_seconds_total{image!="",pod!=""}[1m]) * 100)'
    ),
    "mem_pct": (
        "(node_memory_MemTotal_bytes-node_memory_MemFree_bytes"
        "-node_memory_Buffers_bytes-node_memory_Cached_bytes)"
        '/node_memory_MemTotal_bytes{kubernetes_io_hostname!=""} * 100'
    ),
    "disk_io": (
        '(rate(node_disk_read_bytes_total{device="vda"}[1m]) '
        '+ rate(node_disk_written_bytes_total{device="vda"}[1m])) /1024/1024'
    ),
    "net_up": (
        "sum by (kubernetes_io_hostname,instance) "
        '(rate (node_network_transmit_bytes_total{kubernetes_io_hostname!=""}[1m]))'
        "/1024/1024"
    ),
    "net_down": (
        "sum by (kubernetes_io_hostname,instance)"
        '(rate (node_network_receive_bytes_total{kubernetes_io_hostname!=""}[1m]))'
        "/1024/1024"
    ),
}

# net_up/net_down failures degrade to zeros (advisor.go:219,242); the other
# three fail the cycle like the reference's PreScore error path
# (scheduler.go:106-109).
SOFT_FAIL_SERIES = {"net_up", "net_down"}


@dataclass
class NodeUtil:
    cpu_pct: float = 0.0
    mem_pct: float = 0.0
    disk_io: float = 0.0
    net_up: float = 0.0
    net_down: float = 0.0


Transport = Callable[[str, dict], dict]


def _util_tuple(u: NodeUtil) -> tuple:
    """Value identity of one node's utilization record — the coalescing
    comparisons must see in-place NodeUtil mutation, so they compare
    values, never object identity."""
    return (u.disk_io, u.cpu_pct, u.mem_pct, u.net_up, u.net_down)


def util_delta(last: dict, snap: dict[str, NodeUtil]) -> dict[str, NodeUtil]:
    """Changed-node diff of a utilization snapshot against `last` (a
    {name: value-tuple} map, UPDATED in place): nodes whose series moved
    since the previous call, plus nodes that vanished (reported as a
    zeros record — the builder's missing-node semantics). The shared
    body of every fetch_changed implementation."""
    changed: dict[str, NodeUtil] = {}
    for name, u in snap.items():
        t = _util_tuple(u)
        if last.get(name) != t:
            changed[name] = u
            last[name] = t
    if len(last) > len(snap):
        for name in [k for k in last if k not in snap]:
            del last[name]
            changed[name] = NodeUtil()
    return changed


class CoalescingAdvisor:
    """Changed-only fetch over any advisor: `fetch_changed()` returns
    {node: NodeUtil} for nodes whose series moved since the previous
    call (first call returns everything), feeding the snapshot mirror's
    utilization events (host/mirror.py) so an idle cluster's state
    fetch applies ZERO rows. The diff itself is O(nodes) of tuple
    compares per call — advisors that can do better (BackgroundAdvisor
    diffs in its refresh thread; bench churn advisors know exactly what
    they perturbed) expose their own fetch_changed and are not wrapped
    (Scheduler wraps only advisors lacking the surface). Unknown
    attributes (stale_served, close) delegate to the inner advisor so
    exporters keep reading through the wrapper."""

    def __init__(self, inner):
        self.inner = inner
        self._last: dict[str, tuple] = {}

    def fetch(self) -> dict[str, NodeUtil]:
        return self.inner.fetch()

    def fetch_changed(self) -> dict[str, NodeUtil]:
        return util_delta(self._last, self.inner.fetch())

    def __getattr__(self, name):
        return getattr(self.inner, name)


def _urllib_transport(url: str, form: dict) -> dict:
    data = urllib.parse.urlencode(form).encode()
    with urllib.request.urlopen(url, data=data, timeout=10) as resp:
        return json.load(resp)


class PrometheusAdvisor:
    """Scrapes the five series and joins them into {node: NodeUtil}."""

    def __init__(self, host: str, *, transport: Transport | None = None):
        self.host = host
        self.transport = transport or _urllib_transport

    def _fetch_series(self, query: str) -> dict[str, float]:
        payload = self.transport(
            f"http://{self.host}/api/v1/query", {"query": query}
        )
        out: dict[str, float] = {}
        for item in payload.get("data", {}).get("result", []):
            metric = item.get("metric", {})
            # join key: kubernetes_io_hostname, falling back to instance
            key = metric.get("kubernetes_io_hostname") or metric.get("instance")
            if not key:
                continue
            value = item.get("value", [None, None])[1]
            try:
                out[key] = float(value)
            except (TypeError, ValueError):
                continue
        return out

    def fetch(self) -> dict[str, NodeUtil]:
        series: dict[str, dict[str, float]] = {}
        for name, query in PROM_QUERIES.items():
            try:
                series[name] = self._fetch_series(query)
            except Exception:
                if name in SOFT_FAIL_SERIES:
                    series[name] = {}
                else:
                    raise
        nodes: dict[str, NodeUtil] = {}
        for name, values in series.items():
            for host, v in values.items():
                nodes.setdefault(host, NodeUtil())
                setattr(nodes[host], name, v)
        return nodes


@dataclass
class StaticAdvisor:
    """Hermetic advisor for tests and simulation."""

    utils: dict[str, NodeUtil] = field(default_factory=dict)

    def fetch(self) -> dict[str, NodeUtil]:
        return self.utils


class BackgroundAdvisor:
    """Cycle-path decoupled advisor: a daemon thread refreshes the inner
    advisor every `interval` seconds and fetch() returns the latest
    snapshot WITHOUT blocking the scheduling cycle on the five
    Prometheus HTTP round-trips. The reference pays those round-trips
    inside the scheduling cycle itself (advisor.Result.Init() from
    PreScore, scheduler.go:104,126 + advisor.go:149-265), and so did
    this host's direct wiring — at a 100ms Prometheus RTT that is most
    of a cycle's latency budget.

    Degradation contract: a snapshot older than `max_staleness` is not
    served. fetch() then falls through to ONE synchronous inner fetch
    (covering startup and advisor recovery); if that raises, the
    exception propagates so Scheduler.run_cycle's fetch-failure path
    requeues the window — exactly the direct wiring's outage behavior,
    just `max_staleness` later. `stale_served` counts fetches served a
    snapshot older than TWICE the refresh interval (one interval of
    slack covers the healthy gap between a scrape completing and the
    next starting) — exported as advisor_stale_served_total.

    The refresh thread starts LAZILY on the first fetch(): an HA standby
    replica constructs the advisor and then blocks waiting for
    leadership without running cycles — it must not scrape Prometheus
    for its whole standby life (the direct wiring only scraped inside
    cycles).
    """

    def __init__(
        self,
        inner,
        *,
        interval: float = 5.0,
        max_staleness: float = 60.0,
        clock: Callable[[], float] | None = None,
        start_thread: bool = True,
    ):
        if float(interval) > float(max_staleness):
            # a budget below the refresh period would put every fetch on
            # the synchronous fallback path WHILE the thread scrapes
            # redundantly — strictly worse than direct wiring
            raise ValueError(
                f"refresh interval ({interval}s) must not exceed "
                f"max_staleness ({max_staleness}s)"
            )
        self.inner = inner
        self.interval = float(interval)
        self.max_staleness = float(max_staleness)
        self._clock = clock or time.monotonic
        self._lock = threading.Lock()
        self._snap: dict[str, NodeUtil] | None = None
        self._ts: float = float("-inf")
        # changed-node coalescing (fetch_changed): the refresh thread
        # diffs each scrape against the last-seen value map and
        # accumulates the changed records, so the CYCLE path drains them
        # in O(changed) — an idle cluster's state fetch applies nothing
        self._last_tuples: dict[str, tuple] = {}
        self._pending_changed: dict[str, NodeUtil] = {}
        self.stale_served = 0
        self._stop = threading.Event()
        # serializes scrapes: the cycle-path staleness fallback must
        # never run a second set of the five PromQL queries concurrently
        # with the refresh thread's — doubling load on a Prometheus that
        # is already struggling is exactly the wrong failure response
        self._refresh_lock = threading.Lock()
        self._thread = None
        self._want_thread = bool(start_thread)

    def _ensure_thread(self) -> None:
        if not self._want_thread or self._thread is not None:
            return
        with self._lock:
            if self._thread is None and not self._stop.is_set():
                self._thread = threading.Thread(
                    target=self._run, name="advisor-refresh", daemon=True
                )
                self._thread.start()

    def _store(self, snap: dict[str, NodeUtil]) -> None:
        """Adopt one fresh scrape: diff against the last-seen values
        (off the cycle path when called from the refresh thread) and
        accumulate the changed records for fetch_changed."""
        with self._lock:
            self._pending_changed.update(util_delta(self._last_tuples, snap))
            self._snap = snap
            self._ts = self._clock()

    def _refresh_once(self) -> None:
        with self._refresh_lock:
            self._store(self.inner.fetch())

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self._refresh_once()
            except Exception:
                # keep serving the last snapshot inside the staleness
                # budget; fetch() surfaces the outage when it expires
                pass
            self._stop.wait(self.interval)

    def fetch(self) -> dict[str, NodeUtil]:
        self._ensure_thread()
        now = self._clock()
        with self._lock:
            snap, ts = self._snap, self._ts
        if snap is not None and now - ts <= self.max_staleness:
            if now - ts > 2 * self.interval:
                self.stale_served += 1
            return snap
        # no usable snapshot (startup, or the refresher has been failing
        # past the budget): one synchronous attempt, errors propagating.
        # Serialized with the refresh thread — and re-checked after
        # taking the scrape lock, because the scrape we were about to
        # duplicate may have just landed
        with self._refresh_lock:
            now = self._clock()
            with self._lock:
                snap, ts = self._snap, self._ts
            if snap is not None and now - ts <= self.max_staleness:
                return snap
            inner_snap = self.inner.fetch()
            self._store(inner_snap)
            return inner_snap

    def fetch_changed(self) -> dict[str, NodeUtil]:
        """Changed-node records since the previous fetch_changed call —
        the snapshot mirror's utilization event feed. Same staleness/
        outage contract as fetch() (it runs first); the drain itself is
        O(changed): idle cycles return {} on one dict swap."""
        self.fetch()
        with self._lock:
            out = self._pending_changed
            self._pending_changed = {}
        return out

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
