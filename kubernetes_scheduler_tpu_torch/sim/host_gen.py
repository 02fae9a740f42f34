"""Object-level (host API) cluster generators.

sim/cluster_gen.py produces dense device arrays directly; these produce
the host layer's Node/Pod objects + a StaticAdvisor, so the FULL pipeline
— queue, snapshot builder, engine, binder — can run against a kwok-style
simulated cluster (the hermetic stand-in for the reference's de-facto
integration test of applying example/test-pod*.yaml to a live cluster,
SURVEY.md §4).
"""

from __future__ import annotations

import numpy as np

from kubernetes_scheduler_tpu_torch.host.advisor import NodeUtil, StaticAdvisor
from kubernetes_scheduler_tpu_torch.host.types import (
    Card,
    Container,
    MatchExpression,
    Pod,
    PodAffinityTerm,
    Taint,
    Toleration,
)
from kubernetes_scheduler_tpu_torch.host.types import Node

ZONES = ("zone-a", "zone-b", "zone-c", "zone-d")


def gen_host_cluster(
    n_nodes: int,
    *,
    seed: int = 0,
    gpu: bool = False,
    cards_per_node: int = 4,
    constraints: bool = False,
) -> tuple[list[Node], StaticAdvisor]:
    """Nodes + a StaticAdvisor with matching utilization series."""
    rng = np.random.default_rng(seed)
    nodes, utils = [], {}
    for i in range(n_nodes):
        name = f"node-{i}"
        kw: dict = {}
        if gpu:
            kw["cards"] = [
                Card(
                    bandwidth=float(rng.integers(16, 64)),
                    clock=float(rng.choice([1000, 1500, 2000])),
                    core=float(rng.integers(1024, 8192)),
                    power=float(rng.integers(100, 400)),
                    free_memory=float(rng.integers(0, 32_000)),
                    total_memory=32_000.0,
                    health="Healthy" if rng.random() < 0.95 else "Unhealthy",
                )
                for _ in range(cards_per_node)
            ]
        if constraints:
            kw["labels"] = {"topology.kubernetes.io/zone": ZONES[i % len(ZONES)]}
            if rng.random() < 0.1:
                kw["taints"] = [
                    Taint(key="dedicated", value="infra", effect="NoSchedule")
                ]
        nodes.append(
            Node(
                name=name,
                allocatable={
                    "cpu": float(rng.choice([4000, 8000, 16000, 32000])),
                    "memory": float(rng.choice([8, 16, 32, 64])) * 2**30,
                    "pods": 110.0,
                },
                **kw,
            )
        )
        utils[name] = NodeUtil(
            cpu_pct=float(rng.uniform(0, 100)),
            mem_pct=float(rng.uniform(0, 100)),
            disk_io=float(min(rng.gamma(2.0, 8.0), 50.0)),
            net_up=float(rng.gamma(2.0, 2.0)),
            net_down=float(rng.gamma(2.0, 2.0)),
        )
    return nodes, StaticAdvisor(utils)


def gen_host_pods(
    n_pods: int,
    *,
    seed: int = 1,
    gpu: bool = False,
    constraints: bool = False,
) -> list[Pod]:
    """Pending pods shaped like example/test-pod.yaml at scale: diskIO
    annotation, scv/priority label, optional GPU demands / tolerations /
    zone anti-affinity."""
    rng = np.random.default_rng(seed)
    pods = []
    for i in range(n_pods):
        labels = {"scv/priority": str(int(rng.integers(0, 10)))}
        kw: dict = {}
        if gpu and rng.random() < 0.5:
            labels["scv/number"] = str(int(rng.choice([1, 1, 2, 4])))
            if rng.random() < 0.5:
                labels["scv/memory"] = str(int(rng.choice([8000, 16000])))
        if constraints:
            if rng.random() < 0.3:
                kw["tolerations"] = [
                    Toleration(key="dedicated", value="infra", operator="Equal")
                ]
            if rng.random() < 0.2:
                kw["node_affinity"] = [
                    MatchExpression(
                        key="topology.kubernetes.io/zone",
                        operator="In",
                        values=[ZONES[int(rng.integers(0, len(ZONES)))]],
                    )
                ]
            if rng.random() < 0.1:
                kw["pod_affinity"] = [
                    PodAffinityTerm(
                        match_labels={"app": f"svc-{i % 16}"},
                        topology_key="topology.kubernetes.io/zone",
                        anti=True,
                    )
                ]
        pods.append(
            Pod(
                name=f"pod-{i}",
                labels={**labels, "app": f"svc-{i % 16}"},
                annotations={"diskIO": f"{min(max(rng.gamma(2.0, 5.0), 0.1), 45.0):.1f}"},
                containers=[
                    Container(
                        requests={
                            "cpu": float(rng.choice([100, 250, 500, 1000, 2000])),
                            "memory": float(rng.choice([1, 2, 4])) * 2**28,
                        }
                    )
                ],
                **kw,
            )
        )
    return pods
