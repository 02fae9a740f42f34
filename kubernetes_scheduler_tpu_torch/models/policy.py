"""Heuristic policy registry.

The reference hard-wires one live policy and keeps three alternates dead in
comments or unreachable branches (pkg/yoda/score/algorithm.go:90-96). Here
every policy is a first-class registry entry selectable per cycle; each
maps to a kernel dispatched inside engine.compute_scores.

The port's copy of kubernetes_scheduler_tpu/models/policy.py.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class PolicyInfo:
    name: str
    description: str
    reference: str  # file:line in the reference Go repository
    live_in_reference: bool
    # True: engine.compute_scores evaluates it by name (engine.POLICIES).
    # False: needs a dedicated engine carrying state (models/learned.py
    # LearnedEngine holds the scorer parameters) — host.Scheduler builds
    # it from config; sending the name to a stock engine raises.
    engine_schedulable: bool = True


HEURISTIC_POLICIES = {
    "balanced_cpu_diskio": PolicyInfo(
        name="balanced_cpu_diskio",
        description="CPU/disk-IO load balancing: S = 10 - 10|alpha.V - beta.U|",
        reference="pkg/yoda/score/algorithm.go:99-119",
        live_in_reference=True,
    ),
    "balanced_diskio": PolicyInfo(
        name="balanced_diskio",
        description="disk-IO variance minimization, min-max rescaled",
        reference="pkg/yoda/score/algorithm.go:121-176",
        live_in_reference=False,
    ),
    "free_capacity": PolicyInfo(
        name="free_capacity",
        description="weighted free capacity: 100(100-io) + 2(100-cpu) + 3(100-mem)",
        reference="pkg/yoda/score/algorithm.go:178-198",
        live_in_reference=False,
    ),
    "card": PolicyInfo(
        name="card",
        description="GPU-card weighted normalized metrics, summed per node",
        reference="pkg/yoda/score/algorithm.go:264-291",
        live_in_reference=False,
    ),
    "least_allocated": PolicyInfo(
        name="least_allocated",
        description="NodeResourcesLeastAllocated (k8s 1.22 default): mean "
        "free share of cpu/memory after placement",
        reference="k8s 1.22 default score plugin via go.mod:13 "
        "(deploy/yoda-scheduler.yaml:21-47 disables nothing)",
        live_in_reference=True,
    ),
    "balanced_allocation": PolicyInfo(
        name="balanced_allocation",
        description="NodeResourcesBalancedAllocation (k8s 1.22 default): "
        "(1 - |cpuFrac - memFrac|) * 100 after placement",
        reference="k8s 1.22 default score plugin via go.mod:13",
        live_in_reference=True,
    ),
    "image_locality": PolicyInfo(
        name="image_locality",
        description="ImageLocality (k8s 1.22 default): spread-scaled image "
        "footprint already present on the node, 23MB..1GB/container ramp",
        reference="k8s 1.22 default score plugin via go.mod:13",
        live_in_reference=True,
    ),
    "learned": PolicyInfo(
        name="learned",
        description="two-tower learned scorer (models/learned.py), distilled"
        " from any heuristic policy over the full advisor feature set",
        reference="beyond reference (SURVEY.md has no learned path)",
        live_in_reference=False,
        engine_schedulable=False,
    ),
}

# back-compat / clearer name: the registry holds every selectable policy,
# heuristic or learned
POLICY_REGISTRY = HEURISTIC_POLICIES


def get_policy(name: str) -> PolicyInfo:
    try:
        return HEURISTIC_POLICIES[name]
    except KeyError:
        raise ValueError(
            f"unknown policy {name!r}; available: {sorted(HEURISTIC_POLICIES)}"
        ) from None
