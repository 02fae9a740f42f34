"""Live-cluster source + binder: the scheduler's API-server I/O.

KubeClusterSource supplies host.Scheduler's injectable callables
(list_nodes / list_running_pods) from the real API server and feeds the
queue from a pending-pod watch — the role the embedded upstream
framework's informers play for the reference (SURVEY.md §1 L6).
KubeBinder closes the cycle with the Binding POST the upstream binding
cycle performs after PreBind (SURVEY.md §3.2: POST
/api/v1/.../pods/<p>/binding).

The port's copy of kubernetes_scheduler_tpu/kube/source.py: the loop
drives the port's Scheduler.
"""

from __future__ import annotations

import http.client
import logging
import threading
import time

from kubernetes_scheduler_tpu_torch.host.types import Node, Pod
from kubernetes_scheduler_tpu_torch.kube.client import KubeApiError, KubeClient
from kubernetes_scheduler_tpu_torch.kube.convert import node_from_api, pod_from_api

log = logging.getLogger("yoda_tpu.kube")

FINISHED_PHASES = ("Succeeded", "Failed")


class InformerCache:
    """Watch-backed local cache of nodes and assigned pods.

    The upstream framework feeds its snapshot from informer caches, not
    per-cycle full LISTs; re-listing every assigned pod cluster-wide each
    cycle is O(cluster) API-server load and multi-second overhead at 5k+
    nodes. Each resource runs list -> replace -> bounded watch -> apply
    in a daemon thread, with relist as the error/expiry recovery (the
    informer resync pattern). Readers get point-in-time copies."""

    def __init__(
        self,
        client: KubeClient,
        *,
        watch_timeout: float = 60.0,
        resync_interval: float = 300.0,
        volumes: bool = True,
        on_event=None,
    ):
        self.client = client
        self.watch_timeout = watch_timeout
        # streaming-ingestion hook (host/mirror.SnapshotMirror):
        # on_event(resource, etype, obj) fires AFTER the store update,
        # outside the cache lock, with the CONVERTED object the store
        # now holds (Node/Pod; None on RESYNC — a full relist replaced
        # the store and the consumer must reseed). Only the node and
        # assigned-pod streams emit: they are the snapshot's inputs.
        self.on_event = on_event
        # volumes=False skips the PVC/PV loops (no list+watch streams, no
        # resident stores) for deployments that disable volume topology
        self.volumes = volumes
        # periodic full relist (client-go resyncPeriod): the correctness
        # backstop for missed deletes on servers that don't honor
        # resourceVersion-d watches; rv-tracked streams carry the load
        # in between
        self.resync_interval = resync_interval
        self._nodes: dict[str, Node] = {}
        self._pods: dict[str, Pod] = {}
        self._pdbs: dict[str, object] = {}
        self._pvcs: dict[str, object] = {}
        self._pvs: dict[str, object] = {}
        # namespace name -> labels, for exact namespaceSelector
        # resolution (convert.resolve_namespace_selectors); None until
        # synced or when the list is denied (RBAC) — readers then fall
        # back to the ALL-namespaces approximation
        self._namespaces: dict[str, dict] | None = None
        # (kind, namespace, name) -> spec.replicas of workload
        # controllers, for the PDB percentage math's expected-count
        # lookup (upstream disruption-controller semantics)
        self._controllers: dict[tuple, int] = {}
        # StorageClass name -> volumeBindingMode, for the WFFC
        # selected-node handoff (VolumeBinding's active half)
        self._storage_classes: dict[str, str] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._synced = {
            "nodes": threading.Event(),
            "pods": threading.Event(),
            "pdbs": threading.Event(),
            "pvcs": threading.Event(),
            "pvs": threading.Event(),
            "namespaces": threading.Event(),
            "replicasets": threading.Event(),
            "statefulsets": threading.Event(),
            "storageclasses": threading.Event(),
        }
        self._threads: list[threading.Thread] = []

    # -- lifecycle -------------------------------------------------------

    def start(self) -> "InformerCache":
        loops = [
            self._node_loop, self._pod_loop, self._pdb_loop, self._ns_loop,
            self._rs_loop, self._sts_loop,
        ]
        if self.volumes:
            loops += [self._sc_loop, self._pvc_loop, self._pv_loop]
        else:
            for name in ("storageclasses", "pvcs", "pvs"):
                self._synced[name].set()
        for target in loops:
            t = threading.Thread(target=target, daemon=True)
            t.start()
            self._threads.append(t)
        return self

    def stop(self) -> None:
        self._stop.set()

    def wrap_events(self, wrapper) -> None:
        """Compose a wrapper around the on_event hook — the informer-
        stream fault-injection surface (sim/faults.py chaos runs gate
        delivery here: partition buffers, error drops) and a seam for
        any other event-tap. `wrapper(inner)` receives the current
        callback (possibly None) and returns the replacement."""
        self.on_event = wrapper(self.on_event)

    def wait_synced(self, timeout: float = 30.0) -> bool:
        return all(ev.wait(timeout) for ev in self._synced.values())

    # -- readers ---------------------------------------------------------

    def nodes(self) -> list[Node]:
        with self._lock:
            return list(self._nodes.values())

    def running_pods(self) -> list[Pod]:
        with self._lock:
            return list(self._pods.values())

    def pdbs(self) -> list:
        with self._lock:
            return list(self._pdbs.values())

    def pvc_map(self) -> dict:
        """'ns/name' -> PersistentVolumeClaim, watch-fed (full copy —
        prefer get_pvc on per-pod paths)."""
        with self._lock:
            return dict(self._pvcs)

    def pv_map(self) -> dict:
        """PV name -> PersistentVolume, watch-fed (full copy — prefer
        get_pv on per-pod paths)."""
        with self._lock:
            return dict(self._pvs)

    def get_pvc(self, key: str):
        """Point lookup, 'ns/name' — no map copy."""
        with self._lock:
            return self._pvcs.get(key)

    def get_pv(self, name: str):
        """Point lookup by PV name — no map copy."""
        with self._lock:
            return self._pvs.get(name)

    def controller_replicas(self, kind: str, namespace: str, name: str):
        """spec.replicas of a workload controller (ReplicaSet/
        StatefulSet), watch-fed; None = unknown (callers fall back to
        current-count PDB math)."""
        with self._lock:
            return self._controllers.get((kind, namespace, name))

    def storage_class_mode(self, name: str) -> str | None:
        """volumeBindingMode of a StorageClass (None = unknown class or
        no data — callers then skip the WFFC handoff)."""
        with self._lock:
            return self._storage_classes.get(name)

    def namespace_labels(self) -> dict[str, dict] | None:
        """name -> labels of every namespace, watch-fed; None when the
        namespace list is unavailable (callers then approximate
        namespaceSelectors as ALL namespaces)."""
        with self._lock:
            return dict(self._namespaces) if self._namespaces is not None else None

    def assume(self, pod: Pod) -> None:
        """Record a just-bound pod before the watch echoes it back —
        upstream's assume-cache: without this, back-to-back cycles read
        a running set that misses the previous cycle's bindings and
        over-commit node capacity. A later relist reconciles either way
        (confirms the binding, or removes a pod that raced away)."""
        with self._lock:
            self._pods[f"{pod.namespace}/{pod.name}"] = pod

    # -- node loop -------------------------------------------------------

    def _node_loop(self) -> None:
        self._resource_loop(
            "nodes",
            "/api/v1/nodes",
            params=None,
            replace=self._replace_nodes,
            apply=self._apply_node_event,
        )

    def _emit(self, resource: str, etype: str, obj) -> None:
        if self.on_event is None:
            return
        try:
            self.on_event(resource, etype, obj)
        except Exception:
            # a consumer bug must never kill an informer loop. A missed
            # pod/node event is bounded by the periodic RESYNC relist
            # (resync_interval), which reseeds the consumer from the
            # fresh stores — the mirror's verify pass cannot catch it
            # (it cross-checks against the mirror's OWN lists)
            log.exception("informer on_event hook failed (%s)", resource)

    def _replace_nodes(self, items: list[dict]) -> None:
        fresh = {o["metadata"]["name"]: node_from_api(o) for o in items}
        with self._lock:
            first = not self._synced["nodes"].is_set()
            self._nodes = fresh
        if not first:
            self._emit("nodes", "RESYNC", None)

    def _apply_node_event(self, ev: dict) -> None:
        obj = ev.get("object") or {}
        name = (obj.get("metadata") or {}).get("name")
        if not name:
            return
        etype = ev.get("type")
        node = None
        with self._lock:
            if etype == "DELETED":
                node = self._nodes.pop(name, None)
            elif etype in ("ADDED", "MODIFIED"):
                node = self._nodes[name] = node_from_api(obj)
        if node is not None:
            self._emit("nodes", etype, node)

    # -- assigned-pod loop ----------------------------------------------

    def _pod_loop(self) -> None:
        self._resource_loop(
            "pods",
            "/api/v1/pods",
            params={"fieldSelector": "spec.nodeName!="},
            replace=self._replace_pods,
            apply=self._apply_pod_event,
        )

    def _replace_pods(self, items: list[dict]) -> None:
        fresh: dict[str, Pod] = {}
        for o in items:
            if (o.get("status") or {}).get("phase") in FINISHED_PHASES:
                continue
            meta = o.get("metadata") or {}
            fresh[f"{meta.get('namespace', 'default')}/{meta.get('name')}"] = (
                pod_from_api(o)
            )
        with self._lock:
            first = not self._synced["pods"].is_set()
            self._pods = fresh
        if not first:
            self._emit("pods", "RESYNC", None)

    def _apply_pod_event(self, ev: dict) -> None:
        obj = ev.get("object") or {}
        meta = obj.get("metadata") or {}
        key = f"{meta.get('namespace', 'default')}/{meta.get('name')}"
        finished = (obj.get("status") or {}).get("phase") in FINISHED_PHASES
        etype = ev.get("type")
        pod = None
        deleted = False
        with self._lock:
            if etype == "DELETED" or finished:
                pod = self._pods.pop(key, None)
                deleted = True
            elif etype in ("ADDED", "MODIFIED"):
                pod = self._pods[key] = pod_from_api(obj)
        if pod is not None:
            self._emit("pods", "DELETED" if deleted else etype, pod)

    # -- PDB loop --------------------------------------------------------

    def _pdb_loop(self) -> None:
        """PodDisruptionBudgets ride the informer pattern like nodes/pods
        (per-preemption-pass LISTs were the exact
        per-cycle O(cluster) pattern the cache exists to kill); a watch
        also closes the TTL staleness window — a just-created or
        tightened budget reaches the next preemption pass as soon as its
        event lands, not after a TTL expiry."""
        self._resource_loop(
            "pdbs",
            "/apis/policy/v1/poddisruptionbudgets",
            params=None,
            replace=self._replace_pdbs,
            apply=self._apply_pdb_event,
            optional=True,
        )

    def _replace_pdbs(self, items: list[dict]) -> None:
        from kubernetes_scheduler_tpu_torch.kube.convert import pdb_from_api

        fresh = {}
        for o in items:
            meta = o.get("metadata") or {}
            fresh[f"{meta.get('namespace', 'default')}/{meta.get('name')}"] = (
                pdb_from_api(o)
            )
        with self._lock:
            self._pdbs = fresh

    def _apply_pdb_event(self, ev: dict) -> None:
        from kubernetes_scheduler_tpu_torch.kube.convert import pdb_from_api

        obj = ev.get("object") or {}
        meta = obj.get("metadata") or {}
        key = f"{meta.get('namespace', 'default')}/{meta.get('name')}"
        with self._lock:
            if ev.get("type") == "DELETED":
                self._pdbs.pop(key, None)
            elif ev.get("type") in ("ADDED", "MODIFIED"):
                self._pdbs[key] = pdb_from_api(obj)

    # -- namespace loop --------------------------------------------------

    def _ns_loop(self) -> None:
        """Namespace names + labels, for exact namespaceSelector
        resolution on inter-pod (anti)affinity terms (k8s >= 1.21
        semantics). Optional: a control plane denying the list (RBAC)
        flips the store to None and selector-carrying terms degrade to
        the logged ALL-namespaces approximation instead of silently
        matching nothing."""
        self._resource_loop(
            "namespaces",
            "/api/v1/namespaces",
            params=None,
            replace=self._replace_namespaces,
            apply=self._apply_ns_event,
            optional=True,
            unavailable=self._namespaces_unavailable,
        )

    def _replace_namespaces(self, items: list[dict]) -> None:
        fresh = {
            (o.get("metadata") or {}).get("name", ""): dict(
                (o.get("metadata") or {}).get("labels") or {}
            )
            for o in items
        }
        fresh.pop("", None)
        with self._lock:
            self._namespaces = fresh

    def _namespaces_unavailable(self) -> None:
        with self._lock:
            self._namespaces = None

    def _apply_ns_event(self, ev: dict) -> None:
        obj = ev.get("object") or {}
        name = (obj.get("metadata") or {}).get("name")
        if not name:
            return
        with self._lock:
            if self._namespaces is None:
                self._namespaces = {}
            if ev.get("type") == "DELETED":
                self._namespaces.pop(name, None)
            elif ev.get("type") in ("ADDED", "MODIFIED"):
                self._namespaces[name] = dict(
                    (obj.get("metadata") or {}).get("labels") or {}
                )

    # -- workload-controller loops (PDB expected counts) -----------------

    def _rs_loop(self) -> None:
        self._controller_loop(
            "replicasets", "ReplicaSet", "/apis/apps/v1/replicasets"
        )

    def _sts_loop(self) -> None:
        self._controller_loop(
            "statefulsets", "StatefulSet", "/apis/apps/v1/statefulsets"
        )

    def _controller_loop(self, sync_name: str, kind: str, path: str) -> None:
        """spec.replicas per workload controller, for the PDB
        percentage math (upstream resolves expected counts through the
        owning controllers' scale). Optional: RBAC denial degrades to
        current-count math, the documented conservative fallback."""

        def replace(items: list[dict]) -> None:
            fresh = {}
            for o in items:
                meta = o.get("metadata") or {}
                fresh[(kind, meta.get("namespace", "default"),
                       meta.get("name", ""))] = int(
                    (o.get("spec") or {}).get("replicas") or 0
                )
            with self._lock:
                self._controllers = {
                    k: v for k, v in self._controllers.items() if k[0] != kind
                } | fresh

        def apply(ev: dict) -> None:
            obj = ev.get("object") or {}
            meta = obj.get("metadata") or {}
            key = (kind, meta.get("namespace", "default"),
                   meta.get("name", ""))
            with self._lock:
                if ev.get("type") == "DELETED":
                    self._controllers.pop(key, None)
                elif ev.get("type") in ("ADDED", "MODIFIED"):
                    self._controllers[key] = int(
                        (obj.get("spec") or {}).get("replicas") or 0
                    )

        self._resource_loop(
            sync_name, path, params=None, replace=replace, apply=apply,
            optional=True,
        )

    # -- volume loops ----------------------------------------------------

    def _sc_loop(self) -> None:
        """StorageClass volumeBindingMode, for VolumeBinding's active
        half: a pod binding with an unbound WaitForFirstConsumer claim
        gets the claim annotated with the chosen node (KubeBinder)."""

        def replace(items: list[dict]) -> None:
            fresh = {
                (o.get("metadata") or {}).get("name", ""):
                    o.get("volumeBindingMode") or "Immediate"
                for o in items
            }
            fresh.pop("", None)
            with self._lock:
                self._storage_classes = fresh

        def apply(ev: dict) -> None:
            obj = ev.get("object") or {}
            name = (obj.get("metadata") or {}).get("name")
            if not name:
                return
            with self._lock:
                if ev.get("type") == "DELETED":
                    self._storage_classes.pop(name, None)
                elif ev.get("type") in ("ADDED", "MODIFIED"):
                    self._storage_classes[name] = (
                        obj.get("volumeBindingMode") or "Immediate"
                    )

        self._resource_loop(
            "storageclasses", "/apis/storage.k8s.io/v1/storageclasses",
            params=None, replace=replace, apply=apply, optional=True,
        )

    def _pvc_loop(self) -> None:
        self._resource_loop(
            "pvcs",
            "/api/v1/persistentvolumeclaims",
            params=None,
            replace=self._replace_pvcs,
            apply=self._apply_pvc_event,
            optional=True,
        )

    def _pv_loop(self) -> None:
        self._resource_loop(
            "pvs",
            "/api/v1/persistentvolumes",
            params=None,
            replace=self._replace_pvs,
            apply=self._apply_pv_event,
            optional=True,
        )

    def _replace_pvcs(self, items: list[dict]) -> None:
        from kubernetes_scheduler_tpu_torch.kube.convert import pvc_from_api

        fresh = {}
        for o in items:
            c = pvc_from_api(o)
            fresh[f"{c.namespace}/{c.name}"] = c
        with self._lock:
            self._pvcs = fresh

    def _apply_pvc_event(self, ev: dict) -> None:
        from kubernetes_scheduler_tpu_torch.kube.convert import pvc_from_api

        obj = ev.get("object") or {}
        c = pvc_from_api(obj)
        key = f"{c.namespace}/{c.name}"
        with self._lock:
            if ev.get("type") == "DELETED":
                self._pvcs.pop(key, None)
            elif ev.get("type") in ("ADDED", "MODIFIED"):
                self._pvcs[key] = c

    def _replace_pvs(self, items: list[dict]) -> None:
        from kubernetes_scheduler_tpu_torch.kube.convert import pv_from_api

        fresh = {(v := pv_from_api(o)).name: v for o in items}
        with self._lock:
            self._pvs = fresh

    def _apply_pv_event(self, ev: dict) -> None:
        from kubernetes_scheduler_tpu_torch.kube.convert import pv_from_api

        v = pv_from_api(ev.get("object") or {})
        with self._lock:
            if ev.get("type") == "DELETED":
                self._pvs.pop(v.name, None)
            elif ev.get("type") in ("ADDED", "MODIFIED"):
                self._pvs[v.name] = v

    # -- shared loop -----------------------------------------------------

    def _resource_loop(
        self, name, path, *, params, replace, apply, optional: bool = False,
        unavailable=None,
    ) -> None:
        """list -> watch-from-resourceVersion -> apply, relisting only on
        410 Gone (rv expired), errors, or the periodic resync — NOT on
        every routine stream close, which would be a full O(cluster) LIST
        plus event replay per watch_timeout.

        optional=True: a 404 (API group absent — e.g. policy/v1 on a
        minimal control plane) or 403 (ServiceAccount lacks the grant —
        e.g. an upgrade that didn't reapply the ClusterRole) on the LIST
        degrades to an empty, SYNCED set re-probed at the resync
        interval: an optional resource must never hang wait_synced or
        error-backoff-spam — the scheduler runs on, with the dependent
        feature (preemption budgets) inert."""
        backoff = 0.5
        rv: str | None = None
        listed_at = 0.0
        while not self._stop.is_set():
            try:
                if rv is None or (
                    time.monotonic() - listed_at > self.resync_interval
                ):
                    items, rv = self.client.list_with_rv(path, params)
                    replace(items)
                    listed_at = time.monotonic()
                    self._synced[name].set()
                wparams = dict(params or {})
                if rv:
                    wparams["resourceVersion"] = rv
                    wparams["allowWatchBookmarks"] = "true"
                for ev in self.client.watch(
                    path, wparams, timeout_seconds=self.watch_timeout
                ):
                    etype = ev.get("type")
                    obj = ev.get("object") or {}
                    if etype == "ERROR":
                        # 410 Gone: our rv fell off the server's window
                        rv = None
                        break
                    new_rv = (obj.get("metadata") or {}).get("resourceVersion")
                    if new_rv:
                        rv = new_rv
                    if etype in ("ADDED", "MODIFIED", "DELETED"):
                        apply(ev)
                    if self._stop.is_set():
                        return
                backoff = 0.5
            except KubeApiError as e:
                if optional and e.status in (403, 404):
                    log.warning(
                        "%s unavailable (HTTP %s); continuing without",
                        name, e.status,
                    )
                    # default: empty-but-synced; resources distinguishing
                    # "none exist" from "cannot know" (namespaces) supply
                    # their own unavailable state
                    (unavailable or (lambda: replace([])))()
                    self._synced[name].set()
                    rv = None
                    self._stop.wait(self.resync_interval)
                    continue
                rv = None if e.status == 410 else rv
                log.warning("%s informer error (%s); backing off", name, e)
                self._stop.wait(backoff)
                backoff = min(backoff * 2, 30.0)
            except Exception as e:
                log.warning("%s informer error (%s); relisting", name, e)
                rv = None
                self._stop.wait(backoff)
                backoff = min(backoff * 2, 30.0)
            # bounded streams close routinely; brief pause avoids a hot
            # rewatch loop against servers with instant-closing watches
            self._stop.wait(0.2)


class KubeClusterSource:
    """List/watch nodes and pods for the scheduling loop.

    scheduler_name filters the pending stream the way upstream's
    profile-based queue admission does: only pods whose spec.schedulerName
    names this scheduler are ours to place
    (deploy/yoda-scheduler.yaml:48, example/test-pod.yaml:10).
    """

    def __init__(
        self,
        client: KubeClient,
        *,
        scheduler_name: str = "yoda-tpu",
        namespace: str | None = None,   # None = all namespaces
        cache: InformerCache | None = None,
        pdb_ttl: float = 15.0,
        volume_topology: bool = True,
    ):
        from kubernetes_scheduler_tpu_torch.kube.volumes import VolumeTopology

        self.client = client
        self.scheduler_name = scheduler_name
        self.namespace = namespace
        self.cache = cache
        self.pdb_ttl = pdb_ttl
        self._pdb_cache: list | None = None
        self._pdb_expiry = 0.0
        # cache-less namespace snapshot for namespaceSelector resolution
        # (TTL like the PDB list); the informer path reads its watch-fed
        # namespace store instead
        self._ns_cache: dict | None = None
        self._ns_expiry = 0.0
        # monotonic time before which a denied (403/404) namespace LIST
        # is not retried — a TTL, not a permanent latch: transient RBAC
        # propagation must not degrade selectors for the process lifetime
        self._ns_denied_until = 0.0
        # bound PVs constrain placement (VolumeZone/VolumeBinding parity):
        # the pending stream hands the scheduler pods whose node-affinity
        # already carries their volumes' topology (kube/volumes.py). With
        # an informer cache the resolver reads its watch-fed PVC/PV
        # stores; otherwise a TTL LIST pair
        self.volumes = (
            VolumeTopology(client, cache=cache) if volume_topology else None
        )

    def _fold_volumes(self, pod: Pod) -> Pod:
        if self.volumes is None or not pod.volume_claims:
            return pod
        return self.volumes.fold(pod)

    def _namespace_labels(self) -> dict[str, dict] | None:
        """Namespace name -> labels for namespaceSelector resolution.
        Informer-cached when available; else a TTL LIST; None (= degrade
        to the ALL-namespaces approximation) when the list is denied."""
        if self.cache is not None:
            return self.cache.namespace_labels()
        now = time.monotonic()
        if now < self._ns_denied_until:
            return None
        if self._ns_cache is not None and now < self._ns_expiry:
            return self._ns_cache
        try:
            items = self.client.list_all("/api/v1/namespaces")
        except KubeApiError as e:
            if e.status in (403, 404):
                log.warning(
                    "namespace list unavailable (HTTP %s); "
                    "namespaceSelectors approximate ALL namespaces "
                    "(retrying in 60s)",
                    e.status,
                )
                self._ns_denied_until = now + 60.0
                return None
            raise
        self._ns_cache = {
            (o.get("metadata") or {}).get("name", ""): dict(
                (o.get("metadata") or {}).get("labels") or {}
            )
            for o in items
        }
        self._ns_cache.pop("", None)
        self._ns_expiry = now + self.pdb_ttl
        return self._ns_cache

    def _resolve_ns(self, pods: list[Pod]) -> list[Pod]:
        """Exact namespaceSelector resolution (lazy: the namespace set is
        only consulted when some pod actually carries a selector)."""
        from kubernetes_scheduler_tpu_torch.kube.convert import (
            resolve_namespace_selectors,
        )

        if not any(
            t.namespace_selector for p in pods for t in p.pod_affinity
        ):
            return pods
        nss = self._namespace_labels()
        return [resolve_namespace_selectors(p, nss) for p in pods]

    def _pods_path(self) -> str:
        if self.namespace:
            return f"/api/v1/namespaces/{self.namespace}/pods"
        return "/api/v1/pods"

    def list_nodes(self) -> list[Node]:
        if self.cache is not None:
            return self.cache.nodes()
        return [node_from_api(o) for o in self.client.list_all("/api/v1/nodes")]

    def list_pdbs(self) -> list:
        """policy/v1 PodDisruptionBudgets, cluster-wide — consulted by
        the preemption pass so evictions never overdraw a budget. With an
        informer cache attached, budgets come from its watch-fed PDB
        store (no per-pass LIST, and a new/tightened budget is visible as
        soon as its event lands). Without one, the list is TTL-cached
        (refreshed at most every pdb_ttl seconds) — documented trade-off:
        a budget created or tightened inside the TTL window is invisible
        to up to pdb_ttl seconds of preemption passes; deployments that
        care run the informer (the CLI's --source=kube mode always does).
        Overdraw across cycles is independently prevented by the
        scheduler's pending-eviction accounting
        (host/scheduler._run_preemption)."""
        from kubernetes_scheduler_tpu_torch.kube.convert import pdb_from_api

        if self.cache is not None:
            return self.cache.pdbs()
        now = time.monotonic()
        if self._pdb_cache is not None and now < self._pdb_expiry:
            return self._pdb_cache
        self._pdb_cache = [
            pdb_from_api(o)
            for o in self.client.list_all(
                "/apis/policy/v1/poddisruptionbudgets"
            )
        ]
        self._pdb_expiry = now + self.pdb_ttl
        return self._pdb_cache

    def controller_replicas(self, kind: str, namespace: str, name: str):
        """Workload-controller replicas for the PDB percentage math;
        informer-backed only (None without a cache — callers then use
        the conservative current-count fallback)."""
        if self.cache is not None:
            return self.cache.controller_replicas(kind, namespace, name)
        return None

    def list_running_pods(self) -> list[Pod]:
        """Assigned, unfinished pods — the capacity + affinity base state
        (what the upstream snapshot's NodeInfo.Pods aggregates).

        Always CLUSTER-WIDE, even under a namespace filter: node capacity
        is consumed by every namespace's pods, so scoping this list would
        schedule onto effectively-full nodes. Only the pending stream is
        namespace-scoped."""
        if self.cache is not None:
            return self._resolve_attach(
                self._resolve_ns(self.cache.running_pods())
            )
        items = self.client.list_all(
            "/api/v1/pods", {"fieldSelector": "spec.nodeName!="}
        )
        return self._resolve_attach(self._resolve_ns([
            pod_from_api(o)
            for o in items
            if (o.get("status") or {}).get("phase") not in FINISHED_PHASES
        ]))

    def _resolve_attach(self, pods: list[Pod]) -> list[Pod]:
        """NodeVolumeLimits usage accounting: running pods' bound CSI
        volumes consume attach units on their nodes — resolved here (the
        pending stream gets demands from fold()) and only for the rare
        claim-carrying pods."""
        if self.volumes is None:
            return pods
        import dataclasses

        out = []
        for p in pods:
            if p.volume_claims and not p.attach_demands:
                d = self.volumes.attach_demands(p)
                if d:
                    p = dataclasses.replace(p, attach_demands=d)
            out.append(p)
        return out

    def list_pending_pods(self) -> list[Pod]:
        """Unassigned pods addressed to this scheduler, bound volumes'
        topology folded into their node affinity."""
        items = self.client.list_all(
            self._pods_path(),
            {"fieldSelector": f"spec.nodeName=,spec.schedulerName={self.scheduler_name}"},
        )
        return self._resolve_ns(
            [self._fold_volumes(pod_from_api(o)) for o in items]
        )

    def watch_pending_events(self, *, timeout_seconds: float = 60.0):
        """Yield (event_type, Pod) for this scheduler's pending stream —
        DELETED included, so consumers can retire queue/dedup state when a
        pod is deleted while still pending. One bounded stream; callers
        loop to re-watch (the informer relist pattern)."""
        events = self.client.watch(
            self._pods_path(),
            {"fieldSelector": f"spec.nodeName=,spec.schedulerName={self.scheduler_name}"},
            timeout_seconds=timeout_seconds,
        )
        for ev in events:
            etype = ev.get("type")
            if etype in ("ADDED", "MODIFIED", "DELETED"):
                pod = pod_from_api(ev.get("object") or {})
                if etype != "DELETED":
                    pod = self._resolve_ns([self._fold_volumes(pod)])[0]
                yield etype, pod

    def watch_pending(self, *, timeout_seconds: float = 60.0):
        """Yield Pods as they become pending (ADDED/MODIFIED only)."""
        for etype, pod in self.watch_pending_events(
            timeout_seconds=timeout_seconds
        ):
            if etype != "DELETED" and pod.node_name is None:
                yield pod


def pod_key(pod: Pod) -> str:
    """Scheduling identity: UID when the API provided one (survives
    delete-and-recreate under the same name — upstream keys its queue by
    UID for exactly that reason), ns/name for simulated pods."""
    return pod.uid or f"{pod.namespace}/{pod.name}"


class KubeBinder:
    """POST pods/<name>/binding — the upstream bind step. With a
    VolumeTopology attached, unbound WaitForFirstConsumer claims are
    annotated with the chosen node FIRST (upstream VolumeBinding's
    PreBind handoff: the external provisioner reads
    volume.kubernetes.io/selected-node and provisions in that node's
    topology)."""

    def __init__(
        self,
        client: KubeClient,
        *,
        cache: InformerCache | None = None,
        volumes=None,
    ):
        self.client = client
        self.cache = cache
        self.volumes = volumes
        self.bound: list[tuple[str, str]] = []

    def _annotate_wffc(self, pod: Pod, node_name: str) -> None:
        for pvc in self.volumes.wffc_unbound(pod):
            if pvc.selected_node == node_name:
                continue  # idempotent retry
            try:
                self.client.patch(
                    f"/api/v1/namespaces/{pvc.namespace}"
                    f"/persistentvolumeclaims/{pvc.name}",
                    {"metadata": {"annotations": {
                        "volume.kubernetes.io/selected-node": node_name
                    }}},
                )
            except KubeApiError as e:
                if e.status == 404:
                    # claim deleted underfoot; the Binding POST settles
                    # the pod's own fate
                    continue
                # abort the bind: a pod placed without its volume
                # handoff would wait on provisioning that never targets
                # its node — the scheduler requeues with backoff instead
                raise

    def bind(self, pod: Pod, node_name: str) -> None:
        if self.volumes is not None and pod.volume_claims:
            self._annotate_wffc(pod, node_name)
        meta = {"name": pod.name, "namespace": pod.namespace}
        if pod.uid:
            # UID precondition: the API server rejects the bind (409) if
            # the name now belongs to a recreated pod — a stale queued
            # Pod must never place its successor
            meta["uid"] = pod.uid
        body = {
            "apiVersion": "v1",
            "kind": "Binding",
            "metadata": meta,
            "target": {"apiVersion": "v1", "kind": "Node", "name": node_name},
        }
        self.client.post(
            f"/api/v1/namespaces/{pod.namespace}/pods/{pod.name}/binding", body
        )
        pod.node_name = node_name
        if self.cache is not None:
            self.cache.assume(pod)
        self.bound.append((pod_key(pod), node_name))


class KubeEvictor:
    """DELETE the victim pod — the eviction step of the preemption pass
    (upstream PostFilter; host/scheduler._run_preemption). A UID
    precondition makes the delete a no-op (409) when the name has been
    recreated since the snapshot, so a stale proposal can never kill an
    unrelated pod; 404/409 are swallowed (the victim is already gone or
    already replaced — either way capacity resolves by the next cycle).
    """

    def __init__(self, client: KubeClient):
        self.client = client
        self.evicted: list[str] = []

    def evict(self, victim: Pod, *, preemptor: Pod) -> None:
        body: dict = {"apiVersion": "v1", "kind": "DeleteOptions"}
        if victim.uid:
            body["preconditions"] = {"uid": victim.uid}
        try:
            self.client.delete(
                f"/api/v1/namespaces/{victim.namespace}/pods/{victim.name}",
                body,
            )
        except KubeApiError as e:
            if e.status not in (404, 409):
                raise
            return
        self.evicted.append(pod_key(victim))


class _Feeder(threading.Thread):
    """Background pending-pod watcher feeding the scheduling queue.

    Decouples event ingestion from cycle execution so pods are scheduled
    on ARRIVAL (upstream behavior) instead of after a full bounded watch
    stream closes (~watch_timeout of added bind latency). The queue is
    thread-safe (host/queue.py); `seen` mutations here are guarded by
    `lock` and tolerate the benign race where a just-bound pod is
    re-submitted from a stale relist — the second bind 409s and is
    dropped by Scheduler._bind."""

    def __init__(self, sched, source, *, watch_timeout, idle_sleep, elector=None):
        super().__init__(daemon=True)
        self.sched = sched
        self.source = source
        self.watch_timeout = watch_timeout
        self.idle_sleep = idle_sleep
        self.elector = elector
        self.lock = threading.Lock()
        self.seen: set[str] = set()
        self.wake = threading.Event()      # signals the cycle loop
        self.stop_evt = threading.Event()
        self.idle_rounds = 0               # consecutive zero-submit rounds

    def _submit_new(self, pod) -> bool:
        # a STANDBY must not accumulate the cluster's pod churn in its
        # queue (unbounded growth + a flood of stale binds on failover):
        # skip without marking seen, so promotion's next watch/relist
        # round submits whatever is genuinely still pending
        if self.elector is not None and not self.elector.is_leader():
            return False
        key = pod_key(pod)
        with self.lock:
            if key in self.seen:
                return False
            self.seen.add(key)
        self.sched.submit(pod)
        self.wake.set()
        return True

    def discard(self, key: str) -> None:
        with self.lock:
            self.seen.discard(key)

    def run(self) -> None:
        # connection-level failures (reset/timeout mid-stream) arrive as
        # OSError/URLError/IncompleteRead, not KubeApiError — all retry;
        # nothing may kill a serve-forever feeder
        retryable = (KubeApiError, OSError, http.client.HTTPException)
        while not self.stop_evt.is_set():
            submitted = 0
            try:
                for etype, pod in self.source.watch_pending_events(
                    timeout_seconds=self.watch_timeout
                ):
                    if etype == "DELETED":
                        # deleted while pending: forget it, so a
                        # recreation under the same name (new UID) is
                        # submitted; the stale queued copy can't hurt —
                        # its UID-preconditioned bind 409s and drops
                        self.discard(pod_key(pod))
                    elif pod.node_name is None:
                        submitted += self._submit_new(pod)
                    if self.stop_evt.is_set():
                        return
                # relist safety net: watches can miss events across
                # restarts; a periodic list reconciles (informer resync).
                # Every pod still in our queue is still pending
                # server-side, so pruning `seen` to the server pending set
                # drops bound/deleted entries without touching queued ones
                # — keeps `seen` bounded over a long run.
                pending_keys = set()
                for pod in self.source.list_pending_pods():
                    pending_keys.add(pod_key(pod))
                    submitted += self._submit_new(pod)
                with self.lock:
                    self.seen &= pending_keys
            except retryable as e:
                log.warning("pending watch failed (%s); retrying", e)
                self.stop_evt.wait(self.idle_sleep)
                # an ERROR round proves nothing about the server's pending
                # set — it must not count as idle, or one-shot mode would
                # exit 0 during an API outage with pods still unscheduled
                continue
            self.idle_rounds = 0 if submitted else self.idle_rounds + 1
            self.stop_evt.wait(0.02)   # yield between bounded streams


def _idle_wait(sched, feeder: "_Feeder", idle_sleep: float) -> None:
    """One idle wait of the serving loop: with config.cycle_trigger=
    "event" the scheduler's CycleTrigger is the wake source (queue
    pushes notify it from Scheduler.submit — including the feeder's —
    and mirror events do too, so a utilization shift alone can start a
    cycle); otherwise the feeder's wake event, the tick-polling
    default. Either way idle_sleep is the watchdog timeout — the loop
    re-checks on silence."""
    trigger = getattr(sched, "trigger", None)
    if trigger is not None:
        trigger.wait(idle_sleep)
    else:
        feeder.wake.wait(timeout=idle_sleep)
        feeder.wake.clear()


def attach_mirror(cache: InformerCache, sched) -> None:
    """Wire an InformerCache's node/pod streams into a mirror-enabled
    Scheduler (config.snapshot_mirror): watch events become mirror row
    updates, and a RESYNC (periodic full relist — the missed-event
    backstop) reseeds the mirror from the cache's fresh stores (the
    next emit flushes to a full rebuild). Utilization events ride the
    advisor's fetch_changed drain on the cycle path, not this hook.

    Eventual-consistency bound: an event landing between the seed's
    cache-store reads and the mirror becoming seeded is dropped (and
    the mirror's verify pass cannot see it — it cross-checks against
    the mirror's own lists); the next RESYNC reconciles, so staleness
    is bounded by the cache's resync_interval — the same bound the
    informer pattern itself gives the pre-mirror list reads."""
    mirror = getattr(sched, "mirror", None)
    if mirror is None:
        raise ValueError(
            "scheduler has no snapshot mirror (set config.snapshot_mirror)"
        )

    def on_event(resource: str, etype: str, obj) -> None:
        if not mirror.seeded:
            return  # the scheduler's first cycle seeds from the cache
        if etype == "RESYNC":
            mirror.seed(
                cache.nodes(), cache.running_pods(), dict(mirror.utils)
            )
        elif resource == "nodes":
            mirror.apply_node_event(etype, obj)
        elif resource == "pods":
            mirror.apply_pod_event(etype, obj)

    cache.on_event = on_event


def run_kube_loop(
    sched,
    source: KubeClusterSource,
    *,
    max_cycles: int | None = None,
    idle_sleep: float = 0.5,
    watch_timeout: float = 30.0,
    elector=None,
    stop=None,
    exit_when_idle: bool = False,
) -> int:
    """The live scheduling loop: watch pending pods -> queue -> cycles.

    A feeder thread streams pending pods into the (thread-safe) queue;
    this loop runs a cycle whenever work is queued — bind-on-arrival like
    upstream, with whole-window batching for free because the queue
    accumulates while a cycle runs. A standby replica (elector held by
    another identity) keeps watching but never schedules — the
    active/passive failover contract of lease leader election
    (deploy/yoda-scheduler.yaml:10-17).

    Returns the number of cycles run. `stop` is an optional callable
    polled between iterations (tests; signal handlers).
    exit_when_idle=True returns once a full watch+relist round delivered
    nothing and the queue is drained — the one-shot "schedule what's
    pending" mode (CLI without --serve-forever).
    """
    cycles = 0
    feeder = _Feeder(
        sched, source, watch_timeout=watch_timeout, idle_sleep=idle_sleep,
        elector=elector,
    )
    feeder.start()
    was_leader = True
    try:
        while not (stop and stop()):
            if elector is not None and not elector.is_leader():
                if was_leader:
                    log.warning("not leader; pausing scheduling")
                    was_leader = False
                # drain anything queued before leadership was lost and
                # forget it (the feeder is gated while standby; promotion
                # re-submits from the server's pending set). A pipelined
                # scheduler may hold a prefetched window OUTSIDE the
                # queue — restore it first so the same drain covers it
                # (a stale window surviving standby would be scheduled
                # on re-promotion, double-binding pods the new leader
                # already placed)
                if hasattr(sched, "drain_pipeline"):
                    sched.drain_pipeline()
                for pod in sched.queue.pop_window(1 << 20):
                    feeder.discard(pod_key(pod))
                time.sleep(idle_sleep)
                continue
            if not was_leader:
                log.info("leadership (re)gained; resuming scheduling")
                was_leader = True
            # a pipelined scheduler's prefetched window counts as queued
            # work: parking on the feeder with it in hand would strand
            # real popped pods until an unrelated arrival
            if (
                len(sched.queue) == 0
                and getattr(sched, "_prefetched", None) is None
            ):
                if exit_when_idle and feeder.idle_rounds >= 1:
                    return cycles
                _idle_wait(sched, feeder, idle_sleep)
                continue
            try:
                m = sched.run_cycle()
            except Exception:
                # run_cycle requeues its window on source/advisor outages;
                # anything still escaping must not kill the loop
                log.exception("scheduling cycle failed; continuing")
                time.sleep(idle_sleep)
                continue
            cycles += 1
            bound = getattr(sched.binder, "bound", [])
            for b in bound:
                feeder.discard(b[0])
            del bound[:]   # drained: keeps per-cycle work O(this cycle)
            if max_cycles is not None and cycles >= max_cycles:
                return cycles
            if m.pods_in == 0:
                # only backoff pods remain: wait a full idle period (new
                # arrivals cut it short via the feeder's wake event)
                # rather than spinning empty cycles at 20Hz
                _idle_wait(sched, feeder, idle_sleep)
    finally:
        feeder.stop_evt.set()
        # any exit (stop(), max_cycles) with a prefetched window in hand
        # returns it to the queue, so len(queue) reflects reality and a
        # restarted loop (or a promoted replica sharing the scheduler)
        # reschedules the pods instead of stranding them
        if hasattr(sched, "drain_pipeline"):
            sched.drain_pipeline()
    return cycles
