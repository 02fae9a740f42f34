"""Kubernetes API boundary: the live-cluster half of the host.

The reference is a drop-in scheduler for a real cluster: it embeds the
upstream kube-scheduler binary (cmd/scheduler/main.go:12-21), talks to the
API server via client-go with QPS/Burst 1000 (pkg/yoda/scheduler.go:58-60),
and ships RBAC for nodes/pods/bindings/leases
(deploy/yoda-scheduler.yaml:91-251). This package is that boundary rebuilt
on the stdlib (no client-go, no vendored client): a rate-limited REST
client, list/watch cluster sources feeding host.Scheduler's injectable
callables, a Binding POST binder, and a coordination.k8s.io/v1 Lease
backend for host.leader.LeaderElector.

The port's copy of kubernetes_scheduler_tpu/kube over the port's host
modules; it drives the port's Scheduler, whose engine the caller builds
(the CLI's `scheduler --source kube` builds TorchEngine(device=...) or a
RemoteEngine).
"""

from kubernetes_scheduler_tpu_torch.kube.client import KubeApiError, KubeClient, KubeConfig
from kubernetes_scheduler_tpu_torch.kube.convert import node_from_api, pdb_from_api, pod_from_api
from kubernetes_scheduler_tpu_torch.kube.source import KubeBinder, KubeClusterSource, KubeEvictor
from kubernetes_scheduler_tpu_torch.kube.lease import KubeLease

__all__ = [
    "KubeApiError",
    "KubeBinder",
    "KubeEvictor",
    "KubeClient",
    "KubeClusterSource",
    "KubeConfig",
    "KubeLease",
    "node_from_api",
    "pdb_from_api",
    "pod_from_api",
]
