"""The port's Kubernetes API boundary (kubernetes_scheduler_tpu_torch.kube):
every test of tests/test_kube.py against the port's modules, its
Scheduler on TorchEngine(device="cpu") and the port's CLI with --device
cpu: conversion, list/watch/bind through the live path, Lease CAS.

Hermetic: every test runs against tests/fake_kube.FakeKube, an
httptest-style stdlib server with resourceVersion CAS on leases and
fieldSelector filtering on pods — no cluster required (the reference's
own tests hit live services; SURVEY.md §4 calls for fixing that here).
"""

import time

import pytest

from kubernetes_scheduler_tpu_torch.engine import TorchEngine
from kubernetes_scheduler_tpu_torch.host.advisor import NodeUtil, StaticAdvisor
from kubernetes_scheduler_tpu_torch.host.scheduler import Scheduler as _Scheduler
from kubernetes_scheduler_tpu_torch.host.leader import LeaderElector, LeaseRecord
from kubernetes_scheduler_tpu_torch.kube import (
    KubeApiError,
    KubeBinder,
    KubeClient,
    KubeClusterSource,
    KubeConfig,
    KubeEvictor,
    KubeLease,
    node_from_api,
    pod_from_api,
)
from kubernetes_scheduler_tpu_torch.kube.source import run_kube_loop
from kubernetes_scheduler_tpu_torch.utils.config import SchedulerConfig
from tests.fake_kube import FakeKube, make_node_obj, make_pod_obj


@pytest.fixture()
def fake():
    srv = FakeKube().start()
    yield srv
    srv.stop()


def Scheduler(config, **kw):
    """The port's Scheduler on the CPU engine (its default is the card)."""
    kw.setdefault("engine", TorchEngine(device="cpu"))
    return _Scheduler(config, **kw)


def client_for(fake, **kw):
    return KubeClient(KubeConfig(base_url=fake.url, **kw))


# ---- conversion ---------------------------------------------------------


def test_torch_pod_from_api_full_spec():
    obj = {
        "metadata": {
            "name": "web-0",
            "namespace": "prod",
            "labels": {"app": "web", "scv/priority": "3"},
            "annotations": {"diskIO": "10"},
        },
        "spec": {
            "schedulerName": "yoda-tpu",
            "nodeSelector": {"disk": "ssd"},
            "containers": [
                {
                    "resources": {
                        "requests": {"cpu": "500m", "memory": "2Gi"}
                    },
                    "ports": [{"containerPort": 80, "hostPort": 8080}],
                },
                {"resources": {"requests": {"cpu": "1"}}},
            ],
            "initContainers": [
                {"resources": {"requests": {"memory": "4Gi"}}}
            ],
            "overhead": {"cpu": "100m"},
            "tolerations": [
                {"key": "gpu", "operator": "Exists", "effect": "NoSchedule"}
            ],
            "affinity": {
                "nodeAffinity": {
                    "requiredDuringSchedulingIgnoredDuringExecution": {
                        "nodeSelectorTerms": [
                            {
                                "matchExpressions": [
                                    {
                                        "key": "zone",
                                        "operator": "In",
                                        "values": ["a", "b"],
                                    }
                                ]
                            }
                        ]
                    },
                    "preferredDuringSchedulingIgnoredDuringExecution": [
                        {
                            "weight": 7,
                            "preference": {
                                "matchExpressions": [
                                    {"key": "fast", "operator": "Exists"}
                                ]
                            },
                        }
                    ],
                },
                "podAntiAffinity": {
                    "requiredDuringSchedulingIgnoredDuringExecution": [
                        {
                            "labelSelector": {"matchLabels": {"app": "web"}},
                            "topologyKey": "zone",
                        }
                    ]
                },
                "podAffinity": {
                    "preferredDuringSchedulingIgnoredDuringExecution": [
                        {
                            "weight": 5,
                            "podAffinityTerm": {
                                "labelSelector": {
                                    "matchLabels": {"app": "cache"}
                                },
                                "topologyKey": "kubernetes.io/hostname",
                            },
                        }
                    ]
                },
            },
            "topologySpreadConstraints": [
                {
                    "maxSkew": 2,
                    "topologyKey": "zone",
                    "whenUnsatisfiable": "DoNotSchedule",
                    "labelSelector": {"matchLabels": {"app": "web"}},
                },
                {
                    "maxSkew": 1,
                    "topologyKey": "zone",
                    "whenUnsatisfiable": "ScheduleAnyway",
                    "labelSelector": {"matchLabels": {"app": "web"}},
                },
            ],
        },
        "status": {"phase": "Pending"},
    }
    pod = pod_from_api(obj)
    assert pod.name == "web-0" and pod.namespace == "prod"
    assert pod.labels["scv/priority"] == "3"
    assert pod.annotations["diskIO"] == "10"
    # cpu -> millicores, memory -> bytes
    assert pod.containers[0].requests == {"cpu": 500.0, "memory": 2 * 2**30}
    assert pod.containers[1].requests == {"cpu": 1000.0}
    assert pod.init_containers[0].requests == {"memory": 4 * 2**30}
    assert pod.overhead == {"cpu": 100.0}
    assert pod.tolerations[0].operator == "Exists"
    # nodeSelector AND first nodeSelectorTerm
    ops = {(e.key, e.operator) for e in pod.node_affinity}
    assert ops == {("disk", "In"), ("zone", "In")}
    assert pod.preferred_node_affinity[0].weight == 7
    terms = {(t.topology_key, t.anti, t.preferred) for t in pod.pod_affinity}
    assert ("zone", True, False) in terms
    assert ("kubernetes.io/hostname", False, True) in terms
    # both whenUnsatisfiable modes convert: DoNotSchedule hard,
    # ScheduleAnyway soft
    assert len(pod.topology_spread) == 2
    hard = [sc for sc in pod.topology_spread if not sc.soft]
    soft = [sc for sc in pod.topology_spread if sc.soft]
    assert len(hard) == 1 and hard[0].max_skew == 2
    assert len(soft) == 1 and soft[0].max_skew == 1
    assert pod.host_ports == [8080]
    assert pod.node_name is None and pod.target_node is None


def test_torch_pod_from_api_or_of_ands_node_affinity():
    """ALL nodeSelectorTerms are kept as OR groups (upstream semantics),
    nodeSelector is ANDed into every group, and an empty term becomes the
    matches-nothing encoding."""
    obj = {
        "metadata": {"name": "multi-term"},
        "spec": {
            "nodeSelector": {"disk": "ssd"},
            "containers": [{}],
            "affinity": {
                "nodeAffinity": {
                    "requiredDuringSchedulingIgnoredDuringExecution": {
                        "nodeSelectorTerms": [
                            {
                                "matchExpressions": [
                                    {"key": "zone", "operator": "In",
                                     "values": ["a"]},
                                    {"key": "arch", "operator": "Exists"},
                                ]
                            },
                            {
                                "matchExpressions": [
                                    {"key": "zone", "operator": "In",
                                     "values": ["b"]},
                                ]
                            },
                            {},  # empty term: matches nothing
                        ]
                    }
                }
            },
        },
    }
    pod = pod_from_api(obj)
    by_term: dict[int, list] = {}
    for e in pod.node_affinity:
        by_term.setdefault(e.term, []).append(e)
    assert sorted(by_term) == [0, 1, 2]
    # every group carries the nodeSelector conjunct
    for t, exprs in by_term.items():
        assert any(
            e.key == "disk" and e.operator == "In" and e.values == ["ssd"]
            for e in exprs
        ), t
    assert {(e.key, e.operator) for e in by_term[0]} == {
        ("zone", "In"), ("arch", "Exists"), ("disk", "In")
    }
    assert any(e.key == "zone" and e.values == ["b"] for e in by_term[1])
    # the empty term's placeholder: In with no values, satisfiable nowhere
    assert any(
        e.operator == "In" and e.values == [] for e in by_term[2]
    )


def test_torch_pod_from_api_affinity_namespace_scope():
    """PodAffinityTerm namespace scope converts per upstream: default =
    the pod's own namespace; explicit `namespaces` honored; the `{}`
    namespaceSelector selects ALL namespaces (exactly, per upstream)."""
    obj = {
        "metadata": {"name": "scoped", "namespace": "prod"},
        "spec": {
            "containers": [{}],
            "affinity": {"podAntiAffinity": {
                "requiredDuringSchedulingIgnoredDuringExecution": [
                    {"labelSelector": {"matchLabels": {"app": "a"}},
                     "topologyKey": "zone"},
                    {"labelSelector": {"matchLabels": {"app": "b"}},
                     "namespaces": ["x", "y"], "topologyKey": "zone"},
                    {"labelSelector": {"matchLabels": {"app": "c"}},
                     "namespaceSelector": {}, "topologyKey": "zone"},
                ],
            }},
        },
    }
    pod = pod_from_api(obj)
    by_app = {t.match_labels["app"]: t.namespaces for t in pod.pod_affinity}
    assert by_app["a"] == ["prod"]
    assert by_app["b"] == ["x", "y"]
    assert by_app["c"] is None  # all namespaces

    # spread selectors scope to the pod's own namespace
    obj2 = {
        "metadata": {"name": "sp", "namespace": "prod"},
        "spec": {
            "containers": [{}],
            "topologySpreadConstraints": [{
                "maxSkew": 1, "topologyKey": "zone",
                "whenUnsatisfiable": "DoNotSchedule",
                "labelSelector": {"matchLabels": {"app": "w"}},
            }],
        },
    }
    assert pod_from_api(obj2).topology_spread[0].namespaces == ["prod"]


def test_torch_namespace_selector_resolution():
    """A NON-empty namespaceSelector captures the label selector at
    conversion and resolves exactly against a namespace set: matched
    namespaces UNION any explicit `namespaces` entries (upstream
    k8s >= 1.21 semantics); with no namespace data it degrades to the
    ALL-namespaces approximation."""
    from kubernetes_scheduler_tpu_torch.kube.convert import (
        resolve_namespace_selectors,
    )

    obj = {
        "metadata": {"name": "sel", "namespace": "prod"},
        "spec": {
            "containers": [{}],
            "affinity": {"podAffinity": {
                "requiredDuringSchedulingIgnoredDuringExecution": [
                    {"labelSelector": {"matchLabels": {"app": "db"}},
                     "namespaceSelector": {"matchLabels": {"team": "be"}},
                     "namespaces": ["extra"], "topologyKey": "zone"},
                ],
            }},
        },
    }
    pod = pod_from_api(obj)
    term = pod.pod_affinity[0]
    assert term.namespace_selector == ({"team": "be"}, [])
    assert term.namespaces == ["extra"]  # unresolved: explicit only

    nss = {"a": {"team": "be"}, "b": {"team": "web"}, "c": {"team": "be"}}
    resolved = resolve_namespace_selectors(pod, nss)
    assert resolved.pod_affinity[0].namespaces == ["a", "c", "extra"]
    # selector matches nothing and no explicit list -> empty scope
    obj["spec"]["affinity"]["podAffinity"][
        "requiredDuringSchedulingIgnoredDuringExecution"
    ][0].pop("namespaces")
    none = resolve_namespace_selectors(pod_from_api(obj), {"b": {"team": "web"}})
    assert none.pod_affinity[0].namespaces == []
    # no namespace data: ALL-namespaces approximation (logged)
    degraded = resolve_namespace_selectors(pod, None)
    assert degraded.pod_affinity[0].namespaces is None


def test_torch_pod_from_api_preferred_term_groups():
    """Multi-expression preferred terms convert with shared group ids:
    the weight is granted once per fully-matching entry."""
    obj = {
        "metadata": {"name": "pref"},
        "spec": {
            "containers": [{}],
            "affinity": {"nodeAffinity": {
                "preferredDuringSchedulingIgnoredDuringExecution": [
                    {"weight": 7, "preference": {"matchExpressions": [
                        {"key": "a", "operator": "Exists"},
                        {"key": "b", "operator": "Exists"},
                    ]}},
                    {"weight": 3, "preference": {"matchExpressions": [
                        {"key": "c", "operator": "Exists"},
                    ]}},
                ]
            }},
        },
    }
    pod = pod_from_api(obj)
    by_term = {}
    for w in pod.preferred_node_affinity:
        by_term.setdefault(w.term, []).append((w.expr.key, w.weight))
    assert by_term == {0: [("a", 7), ("b", 7)], 1: [("c", 3)]}


def test_torch_pod_from_api_spec_priority_wins():
    """spec.priority (PriorityClass admission) outranks the reference's
    scv/priority label; absent spec falls back to the label."""
    from kubernetes_scheduler_tpu_torch.host.queue import pod_priority

    both = pod_from_api({
        "metadata": {"name": "b", "labels": {"scv/priority": "3"}},
        "spec": {"priority": 1000000, "containers": [{}]},
    })
    assert both.priority == 1000000 and pod_priority(both) == 1000000
    label_only = pod_from_api({
        "metadata": {"name": "l", "labels": {"scv/priority": "3"}},
        "spec": {"containers": [{}]},
    })
    assert label_only.priority is None and pod_priority(label_only) == 3
    neither = pod_from_api({"metadata": {"name": "n"},
                            "spec": {"containers": [{}]}})
    assert pod_priority(neither) == 0


def test_torch_node_from_api_cordoned():
    """spec.unschedulable (kubectl cordon) converts to the well-known
    unschedulable taint, so cordoned nodes filter like upstream's
    NodeUnschedulable plugin — and a toleration for it still admits."""
    from kubernetes_scheduler_tpu_torch.kube.convert import node_from_api

    node = node_from_api({
        "metadata": {"name": "cordoned"},
        "spec": {"unschedulable": True},
        "status": {"allocatable": {"cpu": "4"}},
    })
    assert any(
        t.key == "node.kubernetes.io/unschedulable"
        and t.effect == "NoSchedule"
        for t in node.taints
    )
    # already-tainted node (the taint-nodes controller beat us): no dupe
    node2 = node_from_api({
        "metadata": {"name": "c2"},
        "spec": {
            "unschedulable": True,
            "taints": [{"key": "node.kubernetes.io/unschedulable",
                        "effect": "NoSchedule"}],
        },
        "status": {},
    })
    assert (
        sum(t.key == "node.kubernetes.io/unschedulable" for t in node2.taints)
        == 1
    )
    plain = node_from_api({"metadata": {"name": "open"}, "spec": {},
                           "status": {}})
    assert not plain.taints


def test_torch_pod_from_api_match_fields():
    """matchFields convert as ordinary expressions keyed metadata.name,
    joining the term's matchExpressions conjunct."""
    obj = {
        "metadata": {"name": "fields"},
        "spec": {
            "containers": [{}],
            "affinity": {"nodeAffinity": {
                "requiredDuringSchedulingIgnoredDuringExecution": {
                    "nodeSelectorTerms": [{
                        "matchExpressions": [
                            {"key": "zone", "operator": "In", "values": ["a"]}
                        ],
                        "matchFields": [
                            {"key": "metadata.name", "operator": "NotIn",
                             "values": ["cordoned-node"]}
                        ],
                    }]
                }
            }},
        },
    }
    pod = pod_from_api(obj)
    got = {(e.key, e.operator, tuple(e.values)) for e in pod.node_affinity}
    assert got == {
        ("zone", "In", ("a",)),
        ("metadata.name", "NotIn", ("cordoned-node",)),
    }
    assert {e.term for e in pod.node_affinity} == {0}


def test_torch_pod_from_api_pinned_and_running():
    pending = pod_from_api(
        {
            "metadata": {"name": "p"},
            "spec": {"nodeName": "n3", "containers": []},
            "status": {"phase": "Pending"},
        }
    )
    assert pending.target_node == "n3"  # upstream NodeName filter input
    running = pod_from_api(
        {
            "metadata": {"name": "r"},
            "spec": {"nodeName": "n3", "containers": []},
            "status": {"phase": "Running"},
        }
    )
    assert running.target_node is None and running.node_name == "n3"


def test_torch_node_from_api():
    node = node_from_api(
        {
            "metadata": {
                "name": "n0",
                "labels": {"zone": "a"},
                "annotations": {
                    "scv/cards": '[{"clock": 1500, "free_memory": 8000, '
                    '"total_memory": 16000, "health": "Healthy"}]'
                },
            },
            "spec": {
                "taints": [{"key": "gpu", "value": "yes", "effect": "NoSchedule"}]
            },
            "status": {
                "allocatable": {
                    "cpu": "7500m",
                    "memory": "30Gi",
                    "pods": "110",
                    "nvidia.com/gpu": "2",
                }
            },
        }
    )
    assert node.allocatable["cpu"] == 7500.0
    assert node.allocatable["memory"] == 30 * 2**30
    assert node.allocatable["nvidia.com/gpu"] == 2.0
    assert node.taints[0].key == "gpu"
    assert node.cards[0].clock == 1500 and node.cards[0].health == "Healthy"


# ---- client + source against the fake API server ------------------------


def test_torch_list_nodes_running_pending(fake):
    fake.add_node(make_node_obj("n0"))
    fake.add_node(make_node_obj("n1", taints=[{"key": "x", "effect": "NoSchedule"}]))
    fake.add_pod(make_pod_obj("running-1", node_name="n0"))
    fake.add_pod(make_pod_obj("pending-1"))
    fake.add_pod(make_pod_obj("other-sched", scheduler_name="default-scheduler"))
    src = KubeClusterSource(client_for(fake), scheduler_name="yoda-tpu")
    assert [n.name for n in src.list_nodes()] == ["n0", "n1"]
    assert [p.name for p in src.list_running_pods()] == ["running-1"]
    assert [p.name for p in src.list_pending_pods()] == ["pending-1"]
    # watch yields the same pending set (bounded ADDED stream)
    assert [p.name for p in src.watch_pending(timeout_seconds=5)] == ["pending-1"]


def test_torch_bearer_token_enforced():
    srv = FakeKube(token="sekret").start()
    try:
        with pytest.raises(KubeApiError) as ei:
            KubeClient(KubeConfig(base_url=srv.url)).get("/api/v1/nodes")
        assert ei.value.status == 401
        ok = KubeClient(KubeConfig(base_url=srv.url, token="sekret"))
        assert ok.get("/api/v1/nodes") == {"items": []}
    finally:
        srv.stop()


def test_torch_binder_posts_binding_and_conflicts(fake):
    fake.add_pod(make_pod_obj("p0"))
    client = client_for(fake)
    binder = KubeBinder(client)
    pod = pod_from_api(fake.pods["default/p0"])
    binder.bind(pod, "n5")
    assert fake.bindings == [("default/p0", "n5")]
    assert fake.pods["default/p0"]["spec"]["nodeName"] == "n5"
    # double bind -> 409 surfaces as KubeApiError
    with pytest.raises(KubeApiError) as ei:
        binder.bind(pod, "n6")
    assert ei.value.status == 409


def test_torch_pdb_conversion_and_listing(fake):
    from kubernetes_scheduler_tpu_torch.kube import KubeClusterSource, pdb_from_api

    obj = {
        "metadata": {"name": "db-pdb", "namespace": "prod"},
        "spec": {
            "minAvailable": "50%",
            "selector": {"matchLabels": {"app": "db"}},
        },
        "status": {"disruptionsAllowed": 1},
    }
    pdb = pdb_from_api(obj)
    assert pdb.name == "db-pdb" and pdb.namespace == "prod"
    assert pdb.match_labels == {"app": "db"}
    assert pdb.allowed(4) == 1  # status wins over the 50% spec math

    fake.pdbs.append(obj)
    client = client_for(fake)
    source = KubeClusterSource(client, scheduler_name="yoda-tpu")
    pdbs = source.list_pdbs()
    assert len(pdbs) == 1 and pdbs[0].name == "db-pdb"


def test_torch_evictor_deletes_with_uid_precondition(fake):
    from kubernetes_scheduler_tpu_torch.kube import KubeEvictor

    fake.add_pod(make_pod_obj("victim", uid="uid-1"))
    client = client_for(fake)
    ev = KubeEvictor(client)
    victim = pod_from_api(fake.pods["default/victim"])
    preemptor = pod_from_api(make_pod_obj("urgent"))

    # stale UID: the name was recreated since the snapshot -> no delete
    stale = pod_from_api(make_pod_obj("victim", uid="uid-OLD"))
    ev.evict(stale, preemptor=preemptor)
    assert "default/victim" in fake.pods and not fake.deleted

    ev.evict(victim, preemptor=preemptor)
    assert fake.deleted == ["default/victim"]
    assert "default/victim" not in fake.pods
    assert ev.evicted == ["uid-1"]

    # already gone: 404 swallowed
    ev.evict(victim, preemptor=preemptor)
    assert fake.deleted == ["default/victim"]


def _ns_selector_spec(team: str, anti: bool = False) -> dict:
    kind = "podAntiAffinity" if anti else "podAffinity"
    return {"affinity": {kind: {
        "requiredDuringSchedulingIgnoredDuringExecution": [{
            "labelSelector": {"matchLabels": {"app": "db"}},
            "namespaceSelector": {"matchLabels": {"team": team}},
            "topologyKey": "kubernetes.io/hostname",
        }],
    }}}


def test_torch_namespace_selector_exact_live(fake):
    """Exact namespaceSelector end-to-end: terms resolve against the
    live namespace set, so affinity admits only selector-matched
    namespaces and anti-affinity is not over-constrained by pods in
    unmatched ones (round-4 verdict: the ALL-namespaces approximation
    over-admitted the first and wrongly blocked the second)."""
    fake.add_namespace("default")
    fake.add_namespace("ns-a", {"team": "backend"})
    fake.add_namespace("ns-b", {"team": "web"})
    fake.add_node(make_node_obj("n0"))
    # anchor: a running db pod in ns-a (team=backend) on the only node
    fake.add_pod(make_pod_obj(
        "anchor", namespace="ns-a", node_name="n0", labels={"app": "db"}
    ))
    fake.add_pod(make_pod_obj(
        "wants-backend", extra_spec=_ns_selector_spec("backend")
    ))
    fake.add_pod(make_pod_obj(
        "wants-web", extra_spec=_ns_selector_spec("web")
    ))
    fake.add_pod(make_pod_obj(
        "avoids-web", extra_spec=_ns_selector_spec("web", anti=True)
    ))
    fake.add_pod(make_pod_obj(
        "avoids-backend", extra_spec=_ns_selector_spec("backend", anti=True)
    ))
    client = client_for(fake)
    src = KubeClusterSource(client, scheduler_name="yoda-tpu")
    sched = Scheduler(
        SchedulerConfig(batch_window=64, min_device_work=0),
        advisor=StaticAdvisor({"n0": NodeUtil(cpu_pct=10, disk_io=3)}),
        binder=KubeBinder(client),
        list_nodes=src.list_nodes,
        list_running_pods=src.list_running_pods,
    )
    for p in src.list_pending_pods():
        sched.submit(p)
    sched.run_cycle()
    bound = {k.split("/")[1] for k, _ in fake.bindings}
    # affinity: the anchor's namespace matches team=backend -> binds;
    # team=web selects only the db-less ns-b -> unschedulable
    assert "wants-backend" in bound
    assert "wants-web" not in bound
    # anti-affinity: the anchor is OUTSIDE team=web's scope -> n0 open;
    # inside team=backend's scope -> blocked
    assert "avoids-web" in bound
    assert "avoids-backend" not in bound


def test_torch_namespace_selector_degrades_without_namespace_data(fake):
    """With the namespace list unavailable (404/RBAC), selectors fall
    back to the logged ALL-namespaces approximation — over-admitting
    affinity rather than silently matching nothing."""
    assert fake.namespaces is None  # route disabled
    fake.add_node(make_node_obj("n0"))
    fake.add_pod(make_pod_obj(
        "anchor", namespace="ns-a", node_name="n0", labels={"app": "db"}
    ))
    fake.add_pod(make_pod_obj(
        "wants-web", extra_spec=_ns_selector_spec("web")
    ))
    client = client_for(fake)
    src = KubeClusterSource(client, scheduler_name="yoda-tpu")
    sched = Scheduler(
        SchedulerConfig(batch_window=64, min_device_work=0),
        advisor=StaticAdvisor({"n0": NodeUtil(cpu_pct=10, disk_io=3)}),
        binder=KubeBinder(client),
        list_nodes=src.list_nodes,
        list_running_pods=src.list_running_pods,
    )
    for p in src.list_pending_pods():
        sched.submit(p)
    sched.run_cycle()
    assert {k.split("/")[1] for k, _ in fake.bindings} == {"wants-web"}


def test_torch_kube_watch_cycle_bind_loop(fake):
    """The VERDICT-prescribed e2e: fake API server driving
    watch -> cycle -> bind. Nodes and pending pods live only on the
    server; the scheduler sees them through KubeClusterSource and the
    placements land back on the server through KubeBinder."""
    for i in range(4):
        fake.add_node(make_node_obj(f"n{i}"))
    fake.add_pod(make_pod_obj("running-0", node_name="n0", cpu="2"))
    for i in range(6):
        fake.add_pod(
            make_pod_obj(
                f"job-{i}", cpu="250m", labels={"scv/priority": str(i % 3)},
                annotations={"diskIO": "5"},
            )
        )
    client = client_for(fake)
    src = KubeClusterSource(client, scheduler_name="yoda-tpu")
    binder = KubeBinder(client)
    utils = {f"n{i}": NodeUtil(cpu_pct=10 * i, disk_io=3 * i) for i in range(4)}
    sched = Scheduler(
        SchedulerConfig(batch_window=64, min_device_work=0),
        advisor=StaticAdvisor(utils),
        binder=binder,
        list_nodes=src.list_nodes,
        list_running_pods=src.list_running_pods,
    )
    cycles = run_kube_loop(
        sched, src,
        max_cycles=4, idle_sleep=0.01, watch_timeout=5,
        stop=lambda: len(fake.bindings) >= 6,
    )
    assert cycles >= 1
    assert sorted(k for k, _ in fake.bindings) == [
        f"default/job-{i}" for i in range(6)
    ]
    for _, node in fake.bindings:
        assert node in {f"n{i}" for i in range(4)}
    # server state reflects every placement; nothing is pending anymore
    assert [p.name for p in src.list_pending_pods()] == []


def test_torch_sigterm_releases_lease(fake, tmp_path, capsys, monkeypatch):
    """Kubernetes stops pods with SIGTERM: the serve loop must release
    the leader Lease on the way out (an unreleased lease stalls standby
    failover for the whole lease duration). Simulated by raising the
    CLI's SIGTERM translation (SystemExit) from inside the loop."""
    import json as _json

    import kubernetes_scheduler_tpu_torch.cli as cli
    import kubernetes_scheduler_tpu_torch.kube.source as kube_source

    fake.add_node(make_node_obj("n0"))
    fake.prom["n0"] = {"cpu_pct": 10.0, "disk_io": 3.0}
    host = fake.url.removeprefix("http://")
    cfg_file = tmp_path / "cfg.json"
    cfg_file.write_text(
        _json.dumps({"batch_window": 8, "min_device_work": 0,
                     "advisor": {"prometheus_host": host}})
    )

    def boom(*a, **kw):
        raise SystemExit(0)  # what cli._terminate raises on SIGTERM

    monkeypatch.setattr(kube_source, "run_kube_loop", boom)
    rc = cli.main([
        "scheduler", "--source", "kube", "--kube-server", fake.url,
        "--config", str(cfg_file), "--watch-timeout", "5",
        "--lease-kube", "--device", "cpu",
    ])
    assert rc == 0  # clean exit: totals printed, no traceback
    # the finally block released the lease: the fake server's Lease
    # object exists and carries an EMPTY holderIdentity
    lease = next(iter(fake.leases.values()), None)
    assert lease is not None
    holder = ((lease.get("spec") or {}).get("holderIdentity")) or ""
    assert holder == ""


def test_torch_kube_postfilter_evicts_live(fake):
    """Live-path preemption: a high-priority pod that fits nowhere
    evicts a lower-priority victim THROUGH the API server (KubeEvictor
    DELETE), the eviction becomes visible via the cluster source, and
    the preemptor binds on a later cycle — while a PDB-protected victim
    is never touched.

    snapshot_mirror is off here: without an informer feeding it events,
    the mirror (on by default) never sees the DELETE, so the preemptor
    would stay unschedulable — the reference's copy of this test fails
    that way since the mirror became the default."""
    fake.add_node(make_node_obj("n0", cpu="1"))
    fake.add_node(make_node_obj("n1", cpu="1"))
    victim = make_pod_obj(
        "victim", node_name="n0", cpu="900m", uid="v-1",
        labels={"scv/priority": "1"},
    )
    guarded = make_pod_obj(
        "guarded", node_name="n1", cpu="900m", uid="g-1",
        labels={"scv/priority": "0", "app": "db"},
    )
    fake.add_pod(victim)
    fake.add_pod(guarded)
    fake.pdbs.append({
        "metadata": {"name": "db-pdb"},
        "spec": {"maxUnavailable": 0,
                 "selector": {"matchLabels": {"app": "db"}}},
    })
    fake.add_pod(make_pod_obj(
        "urgent", cpu="800m", labels={"scv/priority": "9"},
        annotations={"diskIO": "3"},
    ))
    client = client_for(fake)
    src = KubeClusterSource(client, scheduler_name="yoda-tpu")
    utils = {"n0": NodeUtil(cpu_pct=10, disk_io=3),
             "n1": NodeUtil(cpu_pct=20, disk_io=5)}
    sched = Scheduler(
        SchedulerConfig(batch_window=8, min_device_work=0,
                        adaptive_dispatch=False, snapshot_mirror=False),
        advisor=StaticAdvisor(utils),
        binder=KubeBinder(client),
        evictor=KubeEvictor(client),
        list_nodes=src.list_nodes,
        list_running_pods=src.list_running_pods,
        list_pdbs=src.list_pdbs,
    )
    for p in src.list_pending_pods():
        sched.submit(p)
    m1 = sched.run_cycle()
    # urgent fits nowhere; the unprotected prio-1 victim is DELETEd on
    # the server, the PDB-guarded prio-0 pod is not
    assert m1.pods_unschedulable == 1 and m1.pods_preempted == 1
    assert fake.deleted == ["default/victim"]
    assert "default/guarded" in fake.pods

    # the DELETE is immediately visible through the source (no grace
    # period on the fake server): the requeued preemptor binds on n0
    sched.queue._clock = lambda: 1e9
    m2 = sched.run_cycle()
    assert m2.pods_bound == 1
    assert ("default/urgent", "n0") in fake.bindings


# ---- Lease backend ------------------------------------------------------


def test_torch_kube_lease_cas_and_elector(fake):
    client = client_for(fake)
    a = KubeLease(client, name="sched", namespace="kube-system")
    b = KubeLease(client, name="sched", namespace="kube-system")
    now = time.time()
    rec_a = LeaseRecord(holder="A", acquired_at=now, renewed_at=now, duration=5)
    assert a.read() is None
    assert a.try_claim(rec_a, None)
    got = b.read()
    assert got.holder == "A" and abs(got.renewed_at - now) < 0.01
    # stale CAS: B claims with previous=None while A holds -> refused
    rec_b = LeaseRecord(holder="B", acquired_at=now, renewed_at=now, duration=5)
    assert not b.try_claim(rec_b, None)
    # A renews against its own previous
    rec_a2 = LeaseRecord(
        holder="A", acquired_at=now, renewed_at=now + 1, duration=5
    )
    assert a.try_claim(rec_a2, got)
    # B steals with the correct previous (as after expiry)
    cur = b.read()
    assert b.try_claim(
        LeaseRecord(holder="B", acquired_at=now + 2, renewed_at=now + 2, duration=5),
        cur,
    )
    assert a.read().holder == "B"
    b.clear("B")
    assert a.read() is None


def test_torch_kube_lease_leader_election_failover(fake):
    """Two replicas on the cluster Lease: standby acquires only after the
    active holder's lease expires — client-go failover semantics on the
    coordination.k8s.io backend."""
    client = client_for(fake)
    active = LeaderElector(
        KubeLease(client, name="ha"), identity="active",
        lease_duration=0.5, retry_period=0.05,
    )
    standby = LeaderElector(
        KubeLease(client, name="ha"), identity="standby",
        lease_duration=0.5, retry_period=0.05,
    )
    assert active.acquire_blocking(timeout=2)
    assert not standby.acquire_blocking(timeout=0.2)
    # active dies without releasing: stop renewals, keep the lease record
    active._stop.set()
    assert standby.acquire_blocking(timeout=5)
    assert standby.is_leader()
    standby.release()


def test_torch_command_source_kube_one_shot(fake, capsys, tmp_path):
    """`scheduler --source kube` end-to-end: flags -> KubeClient ->
    watch -> cycle -> Binding POSTs -> one-shot idle exit. The fake
    server doubles as the Prometheus endpoint, so the live
    PrometheusAdvisor path is exercised too."""
    import json as _json

    from kubernetes_scheduler_tpu_torch.cli import main

    for i in range(3):
        fake.add_node(make_node_obj(f"n{i}"))
        fake.prom[f"n{i}"] = {"cpu_pct": 10.0 * i, "disk_io": 4.0 * i}
    for i in range(4):
        fake.add_pod(make_pod_obj(f"w-{i}", cpu="200m", annotations={"diskIO": "5"}))
    host = fake.url.removeprefix("http://")
    cfg_file = tmp_path / "cfg.json"
    cfg_file.write_text(
        _json.dumps({"batch_window": 64, "min_device_work": 0,
                     "advisor": {"prometheus_host": host}})
    )
    rc = main(
        [
            "scheduler",
            "--source", "kube",
            "--kube-server", fake.url,
            "--config", str(cfg_file),
            "--watch-timeout", "5",
            "--device", "cpu",
        ]
    )
    assert rc == 0
    out = _json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["pods_bound"] == 4 and out["pods_unschedulable"] == 0
    assert sorted(k for k, _ in fake.bindings) == [
        f"default/w-{i}" for i in range(4)
    ]


def test_torch_bind_race_does_not_kill_cycle(fake):
    """Routine lifecycle races on bind (pod deleted -> 404, bound by a
    racer -> 409) must drop the pod and keep the cycle alive; transient
    errors requeue with backoff. A binder exception previously escaped
    run_cycle and killed the serve-forever loop."""
    for i in range(3):
        fake.add_node(make_node_obj(f"n{i}"))
    for name in ("ok-0", "gone-1", "ok-2"):
        fake.add_pod(make_pod_obj(name, cpu="200m", annotations={"diskIO": "2"}))
    client = client_for(fake)
    src = KubeClusterSource(client)
    sched = Scheduler(
        SchedulerConfig(batch_window=64, min_device_work=0),
        advisor=StaticAdvisor(
            {f"n{i}": NodeUtil(cpu_pct=10 * i, disk_io=i) for i in range(3)}
        ),
        binder=KubeBinder(client),
        list_nodes=src.list_nodes,
        list_running_pods=src.list_running_pods,
    )
    for pod in src.list_pending_pods():
        sched.submit(pod)
    # user deletes one pod between queue admission and the bind POST
    del fake.pods["default/gone-1"]
    m = sched.run_cycle()
    assert m.pods_bound == 2 and m.pods_dropped == 1
    assert m.pods_unschedulable == 0  # a race is churn, not a failure
    assert sorted(k for k, _ in fake.bindings) == [
        "default/ok-0", "default/ok-2"
    ]
    assert len(sched.queue) == 0  # 404 drops; no eternal rebind loop


def test_torch_informer_cache_sync_and_assume(fake):
    """InformerCache serves nodes/assigned pods from local state, applies
    relist reconciliation, and `assume` makes a just-bound pod visible to
    the very next cycle (capacity cannot be double-sold while the watch
    echo is in flight)."""
    from kubernetes_scheduler_tpu_torch.kube.source import InformerCache

    fake.add_node(make_node_obj("n0"))
    fake.add_pod(make_pod_obj("sys", node_name="n0", cpu="1"))
    cache = InformerCache(client_for(fake), watch_timeout=2).start()
    try:
        assert cache.wait_synced(timeout=10)
        assert [n.name for n in cache.nodes()] == ["n0"]
        assert [p.name for p in cache.running_pods()] == ["sys"]
        # bind through a cache-aware binder: immediately visible
        fake.add_pod(make_pod_obj("w0", cpu="200m"))
        binder = KubeBinder(client_for(fake), cache=cache)
        pod = pod_from_api(fake.pods["default/w0"])
        binder.bind(pod, "n0")
        names = {p.name for p in cache.running_pods()}
        assert "w0" in names  # assumed before any watch echo
        # relist reconciliation: server-side delete eventually drops it
        del fake.pods["default/w0"]
        deadline = time.time() + 10
        while "w0" in {p.name for p in cache.running_pods()}:
            assert time.time() < deadline, "relist never dropped deleted pod"
            time.sleep(0.05)
    finally:
        cache.stop()


def test_torch_volume_topology_zonal_pv_constrains_pod(fake):
    """A pod whose PVC is Bound to a zonal PV may only land in the PV's
    zone (upstream VolumeZone via the embedded scheduler,
    the reference's go.mod:13): the source folds the PV's topology into
    the pod's node affinity, and the engine binds only in-zone."""
    from kubernetes_scheduler_tpu_torch.host.advisor import StaticAdvisor
    from kubernetes_scheduler_tpu_torch.host.advisor import NodeUtil
    from kubernetes_scheduler_tpu_torch.utils.config import SchedulerConfig

    fake.pvs.append({
        "metadata": {
            "name": "pv-za",
            "labels": {"topology.kubernetes.io/zone": "za"},
        },
        "spec": {},
    })
    fake.pvcs.append({
        "metadata": {"name": "data", "namespace": "default"},
        "spec": {"volumeName": "pv-za"},
    })
    fake.add_pod({
        "metadata": {"name": "zonal"},
        "spec": {
            "schedulerName": "yoda-tpu",
            "containers": [{"resources": {"requests": {"cpu": "100m"}}}],
            "volumes": [{"persistentVolumeClaim": {"claimName": "data"}}],
        },
        "status": {"phase": "Pending"},
    })
    src = KubeClusterSource(client_for(fake), scheduler_name="yoda-tpu")
    pods = src.list_pending_pods()
    assert len(pods) == 1
    pod = pods[0]
    assert pod.volume_claims == ["data"]
    assert any(
        e.key == "topology.kubernetes.io/zone" and e.values == ["za"]
        for e in pod.node_affinity
    ), pod.node_affinity

    from kubernetes_scheduler_tpu_torch.host.types import Node

    nodes = [
        Node(name="in-zone", labels={"topology.kubernetes.io/zone": "za"},
             allocatable={"cpu": 8000.0, "memory": 2**33, "pods": 100}),
        Node(name="out-zone", labels={"topology.kubernetes.io/zone": "zb"},
             allocatable={"cpu": 8000.0, "memory": 2**33, "pods": 100}),
    ]
    utils = {n.name: NodeUtil(cpu_pct=10, disk_io=5) for n in nodes}
    sched = Scheduler(
        SchedulerConfig(batch_window=8, min_device_work=0,
                        adaptive_dispatch=False),
        advisor=StaticAdvisor(utils),
        list_nodes=lambda: nodes,
        list_running_pods=lambda: [],
    )
    sched.submit(pod)
    m = sched.run_cycle()
    assert m.pods_bound == 1
    assert sched.binder.bindings[0].node_name == "in-zone"


def test_torch_volume_topology_unbound_wffc_and_cross_product(fake):
    """An unbound claim (WaitForFirstConsumer) contributes no constraint;
    a local PV's OR terms conjoin with the pod's own OR terms via the
    cross product."""
    from kubernetes_scheduler_tpu_torch.host.types import MatchExpression, Pod
    from kubernetes_scheduler_tpu_torch.kube.convert import pv_from_api
    from kubernetes_scheduler_tpu_torch.kube.volumes import fold_volume_terms

    # unbound claim through the live source: no constraint added
    fake.pvcs.append({
        "metadata": {"name": "wffc", "namespace": "default"},
        "spec": {},
    })
    fake.add_pod({
        "metadata": {"name": "waiter"},
        "spec": {
            "schedulerName": "yoda-tpu",
            "containers": [{}],
            "volumes": [{"persistentVolumeClaim": {"claimName": "wffc"}}],
        },
        "status": {"phase": "Pending"},
    })
    src = KubeClusterSource(client_for(fake), scheduler_name="yoda-tpu")
    (pod,) = src.list_pending_pods()
    assert pod.node_affinity == []

    # cross product: pod (zone a OR zone b) AND pv (host h1 OR host h2)
    pv = pv_from_api({
        "metadata": {"name": "local-pv"},
        "spec": {"nodeAffinity": {"required": {"nodeSelectorTerms": [
            {"matchExpressions": [
                {"key": "kubernetes.io/hostname", "operator": "In",
                 "values": ["h1"]}]},
            {"matchExpressions": [
                {"key": "kubernetes.io/hostname", "operator": "In",
                 "values": ["h2"]}]},
        ]}}},
    })
    base = Pod(name="p", node_affinity=[
        MatchExpression(key="zone", operator="In", values=["a"], term=0),
        MatchExpression(key="zone", operator="In", values=["b"], term=1),
    ])
    folded = fold_volume_terms(base, [pv.terms])
    groups: dict[int, set] = {}
    for e in folded.node_affinity:
        groups.setdefault(e.term, set()).add((e.key, tuple(e.values)))
    assert len(groups) == 4  # 2 pod terms x 2 pv terms
    assert {("zone", ("a",)), ("kubernetes.io/hostname", ("h1",))} in [
        set(g) for g in groups.values()
    ]
    assert {("zone", ("b",)), ("kubernetes.io/hostname", ("h2",))} in [
        set(g) for g in groups.values()
    ]


def test_torch_informer_cache_serves_pdbs(fake):
    """PDBs ride the informer like nodes/pods: list_pdbs with a cache
    attached reads the watch-fed store — no per-preemption-pass LIST —
    and new budgets appear without a TTL wait."""
    from kubernetes_scheduler_tpu_torch.kube.source import InformerCache

    def pdb_obj(name):
        return {
            "metadata": {"name": name, "namespace": "default"},
            "spec": {"selector": {"matchLabels": {"app": name}},
                     "minAvailable": 1},
            "status": {"disruptionsAllowed": 1},
        }

    fake.pdbs.append(pdb_obj("db"))
    cache = InformerCache(client_for(fake), watch_timeout=2).start()
    try:
        assert cache.wait_synced(timeout=10)
        assert [b.name for b in cache.pdbs()] == ["db"]
        source = KubeClusterSource(client_for(fake), cache=cache)
        got = source.list_pdbs()
        assert [b.name for b in got] == ["db"]
        assert got[0].disruptions_allowed == 1
        # a budget created later reaches the cache via relist/watch
        fake.pdbs.append(pdb_obj("web"))
        deadline = time.time() + 10
        while len(cache.pdbs()) < 2:
            assert time.time() < deadline, "new PDB never reached the cache"
            time.sleep(0.05)
        assert {b.name for b in source.list_pdbs()} == {"db", "web"}
    finally:
        cache.stop()


def test_torch_informer_serves_volumes_and_fold_uses_them(fake):
    """PVCs/PVs ride the informer: the volume fold reads the watch-fed
    stores (no LIST on the pending-pod path), and a PVC that binds later
    reaches the fold without a TTL wait."""
    from kubernetes_scheduler_tpu_torch.kube.source import InformerCache

    fake.pvs.append({
        "metadata": {"name": "pv-za",
                     "labels": {"topology.kubernetes.io/zone": "za"}},
        "spec": {},
    })
    fake.pvcs.append({
        "metadata": {"name": "data", "namespace": "default"},
        "spec": {"volumeName": "pv-za"},
    })
    fake.add_pod({
        "metadata": {"name": "zonal"},
        "spec": {"schedulerName": "yoda-tpu", "containers": [{}],
                 "volumes": [{"persistentVolumeClaim": {"claimName": "data"}}]},
        "status": {"phase": "Pending"},
    })
    cache = InformerCache(client_for(fake), watch_timeout=2).start()
    try:
        assert cache.wait_synced(timeout=10)
        assert "default/data" in cache.pvc_map()
        assert "pv-za" in cache.pv_map()
        src = KubeClusterSource(
            client_for(fake), scheduler_name="yoda-tpu", cache=cache
        )
        assert src.volumes.cache is cache
        (pod,) = src.list_pending_pods()
        assert any(
            e.key == "topology.kubernetes.io/zone" and e.values == ["za"]
            for e in pod.node_affinity
        ), pod.node_affinity
    finally:
        cache.stop()


def test_torch_volume_restrictions_rwop_exclusive(fake):
    """VolumeRestrictions (ReadWriteOncePod): exclusivity enforced per
    CYCLE in the scheduler — two pods pending together cannot both take
    the claim (the race an admission-time check loses), a running holder
    blocks it, and a released claim admits the waiter."""
    from kubernetes_scheduler_tpu_torch.host.advisor import StaticAdvisor
    from kubernetes_scheduler_tpu_torch.host.advisor import NodeUtil
    from kubernetes_scheduler_tpu_torch.host.types import Node
    from kubernetes_scheduler_tpu_torch.kube.source import InformerCache
    from kubernetes_scheduler_tpu_torch.utils.config import SchedulerConfig

    fake.pvcs.append({
        "metadata": {"name": "exclusive", "namespace": "default"},
        "spec": {"volumeName": "pv-x", "accessModes": ["ReadWriteOncePod"]},
    })
    fake.pvs.append({"metadata": {"name": "pv-x"}, "spec": {}})
    for name in ("rival-a", "rival-b"):
        fake.add_pod({
            "metadata": {"name": name},
            "spec": {"schedulerName": "yoda-tpu",
                     "containers": [{"resources": {"requests": {"cpu": "100m"}}}],
                     "volumes": [{"persistentVolumeClaim": {"claimName": "exclusive"}}]},
            "status": {"phase": "Pending"},
        })
    cache = InformerCache(client_for(fake), watch_timeout=2).start()
    try:
        assert cache.wait_synced(timeout=10)
        src = KubeClusterSource(
            client_for(fake), scheduler_name="yoda-tpu", cache=cache
        )
        pods = src.list_pending_pods()
        assert all(p.exclusive_claims == ["default/exclusive"] for p in pods)

        nodes = [Node(name=f"n{i}", allocatable={"cpu": 8000.0, "memory": 2**33,
                                                 "pods": 100}) for i in range(2)]
        utils = {n.name: NodeUtil(cpu_pct=10, disk_io=5) for n in nodes}
        running: list = []
        sched = Scheduler(
            SchedulerConfig(batch_window=8, min_device_work=0,
                            adaptive_dispatch=False),
            advisor=StaticAdvisor(utils),
            list_nodes=lambda: nodes,
            list_running_pods=lambda: running,
        )
        for p in pods:
            sched.submit(p)
        m = sched.run_cycle()
        # exactly ONE rival binds; the other waits
        assert m.pods_bound == 1 and m.pods_unschedulable == 1

        # the winner is now running and HOLDS the claim: the loser stays
        # pending even with free nodes
        winner = sched.binder.bindings[0].pod
        running.append(winner)
        sched.queue._clock = lambda: 1e9  # clear backoff
        m2 = sched.run_cycle()
        assert m2.pods_bound == 0 and m2.pods_unschedulable == 1

        # holder released: the waiter binds (the mirror owns running
        # state once seeded, so the release is an informer event too)
        running.clear()
        sched.mirror.apply_pod_event("DELETED", winner)
        sched.queue._clock = lambda: 2e9
        m3 = sched.run_cycle()
        assert m3.pods_bound == 1
    finally:
        cache.stop()


def test_torch_informer_pdb_403_does_not_block_sync(fake, monkeypatch):
    """An RBAC gap on the OPTIONAL PDB resource (403) must not hang
    wait_synced or spam error backoff — the scheduler starts with an
    empty budget set (review finding r4)."""
    from kubernetes_scheduler_tpu_torch.kube.client import KubeApiError
    from kubernetes_scheduler_tpu_torch.kube.source import InformerCache

    fake.add_node(make_node_obj("n0"))
    client = client_for(fake)
    real = client.list_with_rv

    def forbidden(path, params=None):
        if "poddisruptionbudgets" in path:
            raise KubeApiError(403, "GET", path, "forbidden")
        return real(path, params)

    monkeypatch.setattr(client, "list_with_rv", forbidden)
    cache = InformerCache(client, watch_timeout=2).start()
    try:
        assert cache.wait_synced(timeout=10)
        assert cache.pdbs() == []
        assert [n.name for n in cache.nodes()] == ["n0"]
    finally:
        cache.stop()


def test_torch_command_kube_uses_informer_cache(fake, capsys, tmp_path):
    """The CLI kube path schedules from the informer cache (running pod
    on the server consumes capacity seen by the cycle)."""
    import json as _json

    from kubernetes_scheduler_tpu_torch.cli import main

    fake.add_node(make_node_obj("only", cpu="1"))
    fake.prom["only"] = {"cpu_pct": 10.0, "disk_io": 1.0}
    fake.add_pod(make_pod_obj("hog", node_name="only", cpu="900m"))
    fake.add_pod(make_pod_obj("wants", cpu="500m", annotations={"diskIO": "1"}))
    host = fake.url.removeprefix("http://")
    cfg_file = tmp_path / "cfg.json"
    cfg_file.write_text(
        _json.dumps({"batch_window": 8, "min_device_work": 0,
                     "max_backoff_seconds": 0.2, "initial_backoff_seconds": 0.1,
                     "advisor": {"prometheus_host": host}})
    )
    # --max-cycles 3: the pod is unschedulable by design, so without a
    # cycle cap the loop would retry it for the full default 1000 cycles
    # (~0.25s of backoff each — the 258s this test used to take)
    rc = main(
        ["scheduler", "--source", "kube", "--kube-server", fake.url,
         "--config", str(cfg_file), "--watch-timeout", "2",
         "--max-cycles", "3", "--device", "cpu"]
    )
    assert rc == 0
    out = _json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    # the hog (seen only via the informer) fills the node: wants cannot fit
    assert out["pods_bound"] == 0 and fake.bindings == []


def test_torch_token_file_rotation(tmp_path):
    """File-backed bearer tokens are re-read after rotation (projected
    service-account tokens rotate ~hourly; a stale one 401s forever)."""
    srv = FakeKube(token="tok-v2").start()
    try:
        tf = tmp_path / "token"
        tf.write_text("tok-v1")
        client = KubeClient(KubeConfig(base_url=srv.url, token_path=str(tf)))
        with pytest.raises(KubeApiError):
            client.get("/api/v1/nodes")
        tf.write_text("tok-v2")
        client._token_cache = None  # expire the 60s cache (test shortcut)
        assert client.get("/api/v1/nodes") == {"items": []}
    finally:
        srv.stop()


def test_torch_stale_pod_cannot_bind_recreated_name(fake):
    """Delete-and-recreate under the same name: the stale queued Pod's
    UID-preconditioned bind must 409 (never placing the successor, which
    may have a wildly different spec), and the recreation — a new UID —
    must be schedulable as itself."""
    fake.add_node(make_node_obj("n0"))
    fake.add_pod(make_pod_obj("web", cpu="100m", uid="uid-old"))
    client = client_for(fake)
    src = KubeClusterSource(client)
    binder = KubeBinder(client)
    stale = pod_from_api(fake.pods["default/web"])
    # user deletes and recreates the name with a different spec/UID
    del fake.pods["default/web"]
    fake.add_pod(make_pod_obj("web", cpu="30", uid="uid-new"))
    with pytest.raises(KubeApiError) as ei:
        binder.bind(stale, "n0")
    assert ei.value.status == 409
    assert fake.bindings == []           # successor untouched
    fresh = pod_from_api(fake.pods["default/web"])
    binder.bind(fresh, "n0")             # the recreation binds as itself
    assert fake.bindings == [("default/web", "n0")]
    # scheduling identities differ, so the feeder would resubmit it
    from kubernetes_scheduler_tpu_torch.kube.source import pod_key
    assert pod_key(stale) != pod_key(fresh)


def test_torch_owner_reference_and_controller_replicas(fake):
    """pod_from_api captures the controller ownerReference; the informer
    watches apps/v1 workloads so the PDB percentage math can resolve
    expected replica counts."""
    from kubernetes_scheduler_tpu_torch.kube.source import InformerCache

    obj = make_pod_obj("web-abc", node_name="n0")
    obj["metadata"]["ownerReferences"] = [
        {"kind": "ReplicaSet", "name": "web-rs", "controller": True},
        {"kind": "Thing", "name": "x"},  # non-controller ignored
    ]
    pod = pod_from_api(obj)
    assert pod.owner == ("ReplicaSet", "web-rs")
    assert pod_from_api(make_pod_obj("solo")).owner is None

    fake.add_replicaset("web-rs", 10)
    cache = InformerCache(client_for(fake), watch_timeout=1.0).start()
    try:
        assert cache.wait_synced(timeout=30)
        assert cache.controller_replicas("ReplicaSet", "default", "web-rs") == 10
        assert cache.controller_replicas("ReplicaSet", "default", "nope") is None
        # statefulsets route disabled (404): optional resource degrades
        assert cache.controller_replicas("StatefulSet", "default", "x") is None
    finally:
        cache.stop()


def test_torch_wffc_selected_node_handoff_live(fake):
    """VolumeBinding's ACTIVE half: binding a pod with an unbound
    WaitForFirstConsumer claim PATCHes volume.kubernetes.io/selected-node
    onto the PVC BEFORE the Binding POST, so the external provisioner
    creates the volume in the chosen node's topology (upstream
    VolumeBinding PreBind via the reference's go.mod:13). Bound and
    Immediate-class claims are left alone."""
    from kubernetes_scheduler_tpu_torch.host.advisor import StaticAdvisor
    from kubernetes_scheduler_tpu_torch.host.advisor import NodeUtil
    from kubernetes_scheduler_tpu_torch.host.types import Node
    from kubernetes_scheduler_tpu_torch.kube.volumes import VolumeTopology

    fake.add_storageclass("fast-wffc", "WaitForFirstConsumer")
    fake.add_storageclass("std", "Immediate")
    fake.add_node(make_node_obj("n0"))
    fake.pvcs.append({
        "metadata": {"name": "scratch", "namespace": "default"},
        "spec": {"storageClassName": "fast-wffc"},   # unbound WFFC
    })
    fake.pvcs.append({
        "metadata": {"name": "plain", "namespace": "default"},
        "spec": {"storageClassName": "std"},         # unbound Immediate
    })
    fake.add_pod({
        "metadata": {"name": "wants-scratch"},
        "spec": {
            "schedulerName": "yoda-tpu",
            "containers": [{"resources": {"requests": {"cpu": "100m"}}}],
            "volumes": [
                {"persistentVolumeClaim": {"claimName": "scratch"}},
                {"persistentVolumeClaim": {"claimName": "plain"}},
            ],
        },
        "status": {"phase": "Pending"},
    })
    client = client_for(fake)
    src = KubeClusterSource(client, scheduler_name="yoda-tpu")
    binder = KubeBinder(client, volumes=src.volumes)
    nodes = [Node(name="n0",
                  allocatable={"cpu": 8000.0, "memory": 2**33, "pods": 100})]
    sched = Scheduler(
        SchedulerConfig(batch_window=8, min_device_work=0,
                        adaptive_dispatch=False),
        advisor=StaticAdvisor({"n0": NodeUtil(cpu_pct=10, disk_io=5)}),
        binder=binder,
        list_nodes=lambda: nodes,
        list_running_pods=lambda: [],
    )
    for p in src.list_pending_pods():
        sched.submit(p)
    m = sched.run_cycle()
    assert m.pods_bound == 1 and fake.bindings == [
        ("default/wants-scratch", "n0")
    ]
    # only the WFFC claim was annotated, with the chosen node
    assert [k for k, _ in fake.pvc_patches] == ["default/scratch"]
    ann = (fake.pvcs[-2]["metadata"].get("annotations") or {})
    assert ann.get("volume.kubernetes.io/selected-node") == "n0"
    assert "annotations" not in fake.pvcs[-1].get("metadata", {})


def test_torch_csi_attach_limits_cap_placement(fake):
    """NodeVolumeLimits: a node at its attachable-volumes-csi-* limit
    filters out — the running pod's bound CSI volume consumes the one
    attach unit, so the pending pod's CSI claim forces it elsewhere."""
    from kubernetes_scheduler_tpu_torch.host.advisor import StaticAdvisor
    from kubernetes_scheduler_tpu_torch.host.advisor import NodeUtil

    for name in ("full", "open"):
        obj = make_node_obj(name)
        obj["status"]["allocatable"]["attachable-volumes-csi-ebs.x"] = "1"
        fake.add_node(obj)
    for pv, claim in (("pv-a", "vol-a"), ("pv-b", "vol-b")):
        fake.pvs.append({
            "metadata": {"name": pv},
            "spec": {"csi": {"driver": "ebs.x"}},
        })
        fake.pvcs.append({
            "metadata": {"name": claim, "namespace": "default"},
            "spec": {"volumeName": pv},
        })
    fake.add_pod({
        "metadata": {"name": "holder"},
        "spec": {
            "schedulerName": "yoda-tpu", "nodeName": "full",
            "containers": [{"resources": {"requests": {"cpu": "100m"}}}],
            "volumes": [{"persistentVolumeClaim": {"claimName": "vol-a"}}],
        },
        "status": {"phase": "Running"},
    })
    fake.add_pod({
        "metadata": {"name": "wants-vol"},
        "spec": {
            "schedulerName": "yoda-tpu",
            "containers": [{"resources": {"requests": {"cpu": "100m"}}}],
            "volumes": [{"persistentVolumeClaim": {"claimName": "vol-b"}}],
        },
        "status": {"phase": "Pending"},
    })
    client = client_for(fake)
    src = KubeClusterSource(client, scheduler_name="yoda-tpu")
    # make "full" the score-preferred node so the test fails loud if the
    # attach column is ignored
    utils = {"full": NodeUtil(cpu_pct=5, disk_io=1),
             "open": NodeUtil(cpu_pct=80, disk_io=40)}
    sched = Scheduler(
        SchedulerConfig(batch_window=8, min_device_work=0,
                        adaptive_dispatch=False),
        advisor=StaticAdvisor(utils),
        binder=KubeBinder(client, volumes=src.volumes),
        list_nodes=src.list_nodes,
        list_running_pods=src.list_running_pods,
    )
    pending = src.list_pending_pods()
    assert pending[0].attach_demands == {"attachable-volumes-csi-ebs.x": 1.0}
    running = src.list_running_pods()
    holder = next(p for p in running if p.name == "holder")
    assert holder.attach_demands == {"attachable-volumes-csi-ebs.x": 1.0}
    for p in pending:
        sched.submit(p)
    m = sched.run_cycle()
    assert m.pods_bound == 1
    assert fake.bindings == [("default/wants-vol", "open")]


def test_torch_deep_backlog_live(fake):
    """Deep-queue cycle against the live API path: one run_cycle pops
    max_windows_per_cycle windows and schedules them in ONE engine
    dispatch (capacity + window-internal anti-affinity carried on
    device), with every bind landing on the server through KubeBinder's
    per-pod POSTs. Pins the deep-backlog configuration
    (examples/scheduler-config-deep-backlog.json) to the kube surface,
    not just the simulated host loop."""
    for i in range(3):
        fake.add_node(make_node_obj(f"n{i}", cpu="64"))
    anti = {"affinity": {"podAntiAffinity": {
        "requiredDuringSchedulingIgnoredDuringExecution": [{
            "labelSelector": {"matchLabels": {"app": "db"}},
            "topologyKey": "kubernetes.io/hostname",
        }],
    }}}
    # 3 mutually anti-affine db pods FIRST (FIFO pop order puts all
    # three inside cycle 1's single deep dispatch), then 30 plain pods
    for i in range(3):
        fake.add_pod(make_pod_obj(
            f"db-{i}", cpu="100m", labels={"app": "db"}, extra_spec=anti
        ))
    for i in range(30):
        fake.add_pod(make_pod_obj(f"plain-{i}", cpu="100m"))
    client = client_for(fake)
    src = KubeClusterSource(client, scheduler_name="yoda-tpu")
    utils = {f"n{i}": NodeUtil(cpu_pct=10 + i, disk_io=3) for i in range(3)}
    sched = Scheduler(
        SchedulerConfig(
            batch_window=8, max_windows_per_cycle=4, min_device_work=0
        ),
        advisor=StaticAdvisor(utils),
        binder=KubeBinder(client),
        list_nodes=src.list_nodes,
        list_running_pods=src.list_running_pods,
    )
    for p in src.list_pending_pods():
        sched.submit(p)
    m1 = sched.run_cycle()
    assert m1.pods_in == 32  # 4 windows x 8 popped in ONE cycle
    m2 = sched.run_cycle()
    assert m1.pods_bound + m2.pods_bound == 33
    bound = {k.split("/")[1]: v for k, v in fake.bindings}
    assert len(bound) == 33
    # the three db pods are mutually anti-affine: three distinct nodes,
    # enforced WITHIN the single deep dispatch
    db_nodes = {bound[f"db-{i}"] for i in range(3)}
    assert len(db_nodes) == 3, db_nodes
