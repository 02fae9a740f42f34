"""coordination.k8s.io/v1 Lease backend for leader election.

The reference's HA comes from upstream kube-scheduler leader election on
cluster leases (deploy/yoda-scheduler.yaml:10-17, RBAC
deploy/yoda-scheduler.yaml:…/leases). This implements host.leader.Lease
against the real Lease API: compare-and-swap via resourceVersion-d PUTs
(the API server rejects stale writes with 409 Conflict), create via POST.

Time mapping: LeaseRecord carries epoch floats; the Lease spec carries
RFC3339 MicroTime (acquireTime/renewTime) + leaseDurationSeconds.

The port's copy of kubernetes_scheduler_tpu/kube/lease.py.
"""

from __future__ import annotations

import datetime
import logging
import math

from kubernetes_scheduler_tpu_torch.host.leader import LeaseRecord
from kubernetes_scheduler_tpu_torch.kube.client import KubeApiError, KubeClient

log = logging.getLogger("yoda_tpu.kube")

_MICRO = "%Y-%m-%dT%H:%M:%S.%fZ"


def _to_micro(ts: float) -> str:
    return datetime.datetime.fromtimestamp(
        ts, tz=datetime.timezone.utc
    ).strftime(_MICRO)


def _from_micro(s: str | None) -> float:
    if not s:
        return 0.0
    # tolerate both MicroTime and second-resolution RFC3339
    base = s.rstrip("Z")
    fmt = "%Y-%m-%dT%H:%M:%S.%f" if "." in base else "%Y-%m-%dT%H:%M:%S"
    return (
        datetime.datetime.strptime(base, fmt)
        .replace(tzinfo=datetime.timezone.utc)
        .timestamp()
    )


class KubeLease:
    """host.leader.Lease over a cluster Lease object."""

    def __init__(
        self,
        client: KubeClient,
        *,
        name: str = "yoda-tpu-scheduler",
        namespace: str = "kube-system",
    ):
        self.client = client
        self.name = name
        self.namespace = namespace
        self._resource_version: str | None = None

    def _path(self) -> str:
        return (
            f"/apis/coordination.k8s.io/v1/namespaces/{self.namespace}"
            f"/leases/{self.name}"
        )

    def read(self) -> LeaseRecord | None:
        try:
            obj = self.client.get(self._path())
        except KubeApiError as e:
            if e.status == 404:
                self._resource_version = None
                return None
            raise
        self._resource_version = (obj.get("metadata") or {}).get("resourceVersion")
        spec = obj.get("spec") or {}
        holder = spec.get("holderIdentity")
        if not holder:
            return None
        return LeaseRecord(
            holder=holder,
            acquired_at=_from_micro(spec.get("acquireTime")),
            renewed_at=_from_micro(spec.get("renewTime")),
            duration=float(spec.get("leaseDurationSeconds") or 0),
        )

    def _body(self, record: LeaseRecord, resource_version: str | None) -> dict:
        meta: dict = {"name": self.name, "namespace": self.namespace}
        if resource_version:
            meta["resourceVersion"] = resource_version
        return {
            "apiVersion": "coordination.k8s.io/v1",
            "kind": "Lease",
            "metadata": meta,
            "spec": {
                "holderIdentity": record.holder,
                "acquireTime": _to_micro(record.acquired_at),
                "renewTime": _to_micro(record.renewed_at),
                # the API field is integer seconds; round UP so a
                # sub-second duration cannot truncate to an
                # instantly-expired lease
                "leaseDurationSeconds": max(1, math.ceil(record.duration)),
            },
        }

    def try_claim(
        self, record: LeaseRecord, previous: LeaseRecord | None
    ) -> bool:
        # re-read for the freshest resourceVersion AND to CAS against
        # `previous` the way FileLease does; the 409 path then catches
        # writers racing between this read and the PUT
        current = self.read()
        cur_key = (current.holder, current.renewed_at) if current else None
        prev_key = (previous.holder, previous.renewed_at) if previous else None
        if cur_key != prev_key:
            return False
        try:
            if self._resource_version is None:
                self.client.post(
                    f"/apis/coordination.k8s.io/v1/namespaces/{self.namespace}/leases",
                    self._body(record, None),
                )
            else:
                self.client.put(
                    self._path(), self._body(record, self._resource_version)
                )
            return True
        except KubeApiError as e:
            if e.status in (409, 422):   # conflict: lost the race
                return False
            raise

    def clear(self, holder: str) -> None:
        """Release by PUTting an empty holderIdentity (client-go's release
        semantics) — the shipped RBAC grants update but not delete, and an
        empty holder reads back as an unheld lease either way."""
        current = self.read()
        if current and current.holder == holder:
            body = {
                "apiVersion": "coordination.k8s.io/v1",
                "kind": "Lease",
                "metadata": {
                    "name": self.name,
                    "namespace": self.namespace,
                    "resourceVersion": self._resource_version,
                },
                "spec": {"holderIdentity": ""},
            }
            try:
                self.client.put(self._path(), body)
            except KubeApiError as e:
                if e.status not in (404, 409):
                    raise
