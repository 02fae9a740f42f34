"""Volume-topology feasibility: bound PVs constrain pod placement.

The reference inherits VolumeZone / VolumeBinding from the embedded
upstream scheduler (the reference's go.mod:13); this framework folds the
same facts into the node-affinity tensors the engine already evaluates:
a pod whose PVC is Bound to a PV carrying node-affinity terms or
zone/region labels may only land on nodes satisfying them. The fold is a
pure OR-of-ANDs conjunction —

    (pod term_1 OR ...) AND (pv term_1 OR ...) = OR over the cross
    product of (pod term_i AND pv term_j)

— expressed with the per-expression OR-group ids PodBatch.na_term
carries, so the engine needs NO new kernel: VolumeZone rides the
node-affinity contraction.

WaitForFirstConsumer / unbound claims contribute no constraint
(constrain-at-bind: the volume follows the pod, upstream VolumeBinding's
WFFC stance). Claims are resolved when the pod is handed to the
scheduling queue (KubeClusterSource folds on the pending stream); a PVC
that binds while the pod is already queued is picked up on the next
relist round's resubmission.

The port's copy of kubernetes_scheduler_tpu/kube/volumes.py.
"""

from __future__ import annotations

import dataclasses
import logging
import time

from kubernetes_scheduler_tpu_torch.host.types import MatchExpression, Pod
from kubernetes_scheduler_tpu_torch.kube.client import KubeApiError, KubeClient
from kubernetes_scheduler_tpu_torch.kube.convert import pv_from_api, pvc_from_api

log = logging.getLogger("yoda_tpu.kube")


def fold_volume_terms(
    pod: Pod, pv_term_sets: list[list[list[MatchExpression]]]
) -> Pod:
    """Return a pod whose node_affinity is the conjunction of its own
    OR-of-ANDs requirement with every PV's OR-of-ANDs term set, via the
    cross-product expansion. Expressions are copied with fresh term ids;
    the input pod is not mutated."""
    if not pv_term_sets:
        return pod
    by_term: dict[int, list[MatchExpression]] = {}
    for e in pod.node_affinity:
        by_term.setdefault(e.term, []).append(e)
    base: list[list[MatchExpression]] = list(by_term.values()) or [[]]
    for terms in pv_term_sets:
        if not terms:
            continue
        base = [bt + et for bt in base for et in terms]
    merged: list[MatchExpression] = []
    for t_i, exprs in enumerate(base):
        for e in exprs:
            merged.append(
                MatchExpression(
                    key=e.key, operator=e.operator, values=list(e.values),
                    term=t_i,
                )
            )
    return dataclasses.replace(pod, node_affinity=merged)


class VolumeTopology:
    """PVC->PV resolution.

    With an InformerCache attached (the CLI kube path), claims/volumes
    come from its watch-fed stores — always current within watch lag
    (the same currency upstream's VolumeBinding plugin gets from ITS
    informers), and no LIST ever lands on the pending-pod path. Without
    one, a TTL-cached pair of cluster-wide LISTs serves the same facts
    (errors keep stale data and retry after a short backoff, never a
    full TTL of flying blind). A cluster without the PV API (or RBAC
    for it) degrades to no volume constraints."""

    ERROR_RETRY_SECONDS = 5.0

    def __init__(self, client: KubeClient, *, ttl: float = 30.0, cache=None):
        self.client = client
        self.ttl = ttl
        self.cache = cache
        self._pvcs: dict[str, object] = {}
        self._pvs: dict[str, object] = {}
        self._expiry = 0.0
        # StorageClass name -> volumeBindingMode (TTL path; the informer
        # path reads the cache's watch-fed store)
        self._classes: dict[str, str] = {}
        self._classes_expiry = 0.0

    def _refresh(self) -> None:
        now = time.monotonic()
        if now < self._expiry:
            return
        try:
            pvcs = self.client.list_all("/api/v1/persistentvolumeclaims")
            pvs = self.client.list_all("/api/v1/persistentvolumes")
        except KubeApiError as e:
            # keep whatever view we have; re-probe soon (a full TTL of
            # no-constraints after a transient blip risks out-of-zone
            # binds the kubelet then rejects)
            self._expiry = now + self.ERROR_RETRY_SECONDS
            log.warning(
                "volume topology LIST failed (%s); keeping the previous "
                "view and retrying in %.0fs", e, self.ERROR_RETRY_SECONDS,
            )
            return
        self._expiry = now + self.ttl
        fresh_pvcs = {}
        for o in pvcs:
            c = pvc_from_api(o)
            fresh_pvcs[f"{c.namespace}/{c.name}"] = c
        self._pvcs = fresh_pvcs
        self._pvs = {
            (v := pv_from_api(o)).name: v for o in pvs
        }

    def _maps(self) -> tuple[dict, dict]:
        if self.cache is not None:
            return self.cache.pvc_map(), self.cache.pv_map()
        self._refresh()
        return self._pvcs, self._pvs

    def _lookup(self, pvc_key: str, pv_name: str | None):
        """(pvc, pv) by key — point lookups against the informer stores
        (no full-map copies on the per-pod path), TTL maps otherwise."""
        if self.cache is not None:
            pvc = self.cache.get_pvc(pvc_key)
            pv = self.cache.get_pv(pv_name) if pv_name else None
            return pvc, pv
        self._refresh()
        pvc = self._pvcs.get(pvc_key)
        pv = self._pvs.get(pv_name) if pv_name else None
        return pvc, pv

    def storage_class_mode(self, name: str | None) -> str | None:
        """volumeBindingMode of a StorageClass; None = unknown (the WFFC
        handoff is then skipped — conservative)."""
        if not name:
            return None
        if self.cache is not None:
            return self.cache.storage_class_mode(name)
        now = time.monotonic()
        if now >= self._classes_expiry:
            try:
                items = self.client.list_all(
                    "/apis/storage.k8s.io/v1/storageclasses"
                )
                self._classes = {
                    (o.get("metadata") or {}).get("name", ""):
                        o.get("volumeBindingMode") or "Immediate"
                    for o in items
                }
                self._classes_expiry = now + self.ttl
            except KubeApiError as e:
                self._classes_expiry = now + self.ERROR_RETRY_SECONDS
                log.warning("storageclass LIST failed (%s)", e)
        return self._classes.get(name)

    def wffc_unbound(self, pod: Pod) -> list:
        """The pod's UNBOUND WaitForFirstConsumer claims — the set the
        binder must annotate with the chosen node before the Binding
        POST (upstream VolumeBinding's PreBind handoff)."""
        out = []
        for claim in pod.volume_claims:
            pvc, _ = self._lookup(f"{pod.namespace}/{claim}", None)
            if pvc is None or pvc.volume_name:
                continue
            if self.storage_class_mode(pvc.storage_class) == "WaitForFirstConsumer":
                out.append(pvc)
        return out

    def attach_demands(self, pod: Pod) -> dict[str, float]:
        """NodeVolumeLimits input: attachable-volumes-csi-<driver> units
        this pod's BOUND CSI volumes consume (one per volume), matching
        the capacity keys kubelet publishes in status.allocatable."""
        demands: dict[str, float] = {}
        for claim in pod.volume_claims:
            key = f"{pod.namespace}/{claim}"
            pvc, _ = self._lookup(key, None)
            if pvc is None or not pvc.volume_name:
                continue
            _, pv = self._lookup(key, pvc.volume_name)
            if pv is not None and pv.csi_driver:
                res = f"attachable-volumes-csi-{pv.csi_driver}"
                demands[res] = demands.get(res, 0.0) + 1.0
        return demands

    def fold(self, pod: Pod) -> Pod:
        """Pod with every bound claim's PV topology ANDed into its
        node-affinity requirement; claims that are unbound (WFFC) or
        reference unknown volumes contribute nothing. ReadWriteOncePod
        claims are recorded on Pod.exclusive_claims — the SCHEDULER
        enforces their exclusivity per cycle (host/scheduler.run_cycle),
        because a fold-time check races: two pods pending together would
        both fold before either holds the claim."""
        if not pod.volume_claims:
            return pod
        term_sets = []
        exclusive: list[str] = []
        for claim in pod.volume_claims:
            key = f"{pod.namespace}/{claim}"
            pvc, _ = self._lookup(key, None)
            if pvc is None:
                continue
            if "ReadWriteOncePod" in pvc.access_modes:
                exclusive.append(key)
            if not pvc.volume_name:
                continue  # unbound: constrain-at-bind
            _, pv = self._lookup(key, pvc.volume_name)
            if pv is not None and pv.terms:
                term_sets.append(pv.terms)
        # NodeVolumeLimits: the ONE accounting implementation
        demands = self.attach_demands(pod)
        out = fold_volume_terms(pod, term_sets)
        if (exclusive or demands) and out is pod:
            out = dataclasses.replace(pod)
        if exclusive:
            out.exclusive_claims = exclusive
        if demands:
            out.attach_demands = demands
        return out
