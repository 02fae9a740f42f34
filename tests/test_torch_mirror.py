"""The port's snapshot mirror's running set (host/mirror.py), on the CPU.

- Random sequences of BOUND, ADDED, replacing MODIFIED, echoed,
  unbinding (node_name None) and DELETED events (known and unknown
  pods) leave the mirror's running list holding the pods of a plain-list
  oracle in the oracle's order, object for object. The oracle applies
  the running set's semantics as a list filter does: a pod leaves by
  identity, and a replacement joins at the end. After every emit the
  mirror's arrays are bitwise those of a fresh build_snapshot (verify).
- The list is the same object across appends and emits, and a new one
  after a pod leaves; the rebuilds that takes are counted, once a read.
- Events applied from another thread, one at a time and in batches
  (apply_pod_events), while this one reads, emits and verifies, leave
  the oracle's running set and arrays that verify.
- Row math is deferred to the emit: random interleavings of single and
  batched BOUND, replacing MODIFIED, echoed, unbinding and DELETED
  events over hostname anti-affinity, zone spread, preferred terms,
  hostPorts and explicit `pods` requests leave, at every emit, leaves
  bitwise those of a fresh build_snapshot, and a delta that folds the
  previous emit into this one bitwise.
- Engagement: k events on m distinct nodes between two emits copy no
  leaf, and the emit makes one `mirror_rows` pass over m rows
  (mirror_row_nodes_total); a batch of n counts n events, one burst and
  one notify.

Test names avoid the substrings tests/conftest.py marks slow."""

import dataclasses
import random
import sys
import threading
import time

import numpy as np
import pytest

from kubernetes_scheduler_tpu_torch.engine import SnapshotArrays, apply_snapshot_delta_np
from kubernetes_scheduler_tpu_torch.host import observe
from kubernetes_scheduler_tpu_torch.host.mirror import SnapshotMirror
from kubernetes_scheduler_tpu_torch.host.snapshot import SnapshotBuilder
from kubernetes_scheduler_tpu_torch.host.types import (
    Container,
    PodAffinityTerm,
    Pod,
    SpreadConstraint,
)
from kubernetes_scheduler_tpu_torch.sim.host_gen import gen_host_cluster

PORTS = (80, 443, 8080)


def key_of(pod) -> str:
    return pod.uid or f"{pod.namespace}/{pod.name}"


class Oracle:
    """The running set as a plain list: removal by identity, then append."""

    def __init__(self, running):
        self.running = list(running)
        self.keys = {key_of(p): p for p in self.running}

    def apply(self, etype, pod):
        key = key_of(pod)
        if etype == "DELETED":
            old = self.keys.pop(key, None)
            if old is not None:
                self.running = [p for p in self.running if p is not old]
            return
        existing = self.keys.get(key)
        if existing is pod:
            return
        if existing is not None:
            self.running = [p for p in self.running if p is not existing]
        if pod.node_name is None:
            self.keys.pop(key, None)
            return
        self.keys[key] = pod
        self.running.append(pod)


def make_pod(kind, rng, name, node):
    """One bound pod of `kind`: plain, anti-affine on the hostname (a
    color picked from two), or holding a hostPort. Its requests round in
    float32, so a row summed in another order reads other bits."""
    cpu = rng.choice((100.0, 250.0, 333.3))
    memory = float(rng.randrange(1, 1 << 33))
    pod = Pod(name=name, containers=[Container(requests={"cpu": cpu, "memory": memory})],
              node_name=node)
    if kind == "anti":
        color = rng.choice(("green", "blue"))
        pod.labels = {"color": color}
        pod.pod_affinity = [PodAffinityTerm(match_labels={"color": color}, anti=True)]
    elif kind == "ports" and rng.random() < 0.5:
        pod.host_ports = [rng.choice(PORTS)]
    return pod


def seeded(kind, rng, *, n_nodes=12, n_running=40):
    nodes, advisor = gen_host_cluster(n_nodes, seed=rng.randrange(1 << 30))
    running = [make_pod(kind, rng, f"r{i}", rng.choice(nodes).name) for i in range(n_running)]
    mirror = SnapshotMirror(SnapshotBuilder())
    mirror.seed(nodes, running, advisor.fetch())
    # a pending pod of the kind mints its selector, as a window would
    window = [make_pod(kind, rng, "pending", None)]
    mirror.emit(window, pending_all_plain=kind == "plain")
    return mirror, nodes, running


def random_event(kind, rng, oracle, nodes, fresh, make=make_pod):
    """(etype, pod) drawn over every way a pod enters or leaves; new pods
    are make(kind, rng, name, node)."""
    names = [nd.name for nd in nodes]
    r = rng.random()
    if r < 0.35 or not oracle.running:
        return "BOUND" if r < 0.2 else "ADDED", make(kind, rng, next(fresh), rng.choice(names))
    victim = rng.choice(oracle.running)
    if r < 0.5:      # a replacing MODIFIED: a new object under the same key
        return "MODIFIED", dataclasses.replace(victim, node_name=rng.choice(names))
    if r < 0.55:     # the echo of a pod the mirror holds
        return "MODIFIED", victim
    if r < 0.6:      # unbound: leaves the running set
        return "MODIFIED", dataclasses.replace(victim, node_name=None)
    if r < 0.65:     # a pod the mirror never saw
        return "DELETED", make(kind, rng, next(fresh), rng.choice(names))
    if r < 0.8:      # the informer's object, not the mirror's
        return "DELETED", dataclasses.replace(victim)
    return "DELETED", victim


def names():
    i = 0
    while True:
        yield f"p{i}"
        i += 1


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("kind", ["plain", "anti", "ports"])
def test_torch_mirror_running_set_matches_list_oracle(kind, seed):
    rng = random.Random(1000 * seed + len(kind))
    mirror, nodes, running = seeded(kind, rng)
    if kind == "anti":
        assert mirror.builder.selectors
    oracle = Oracle(running)
    fresh = names()
    for _ in range(12):
        for _ in range(rng.randrange(1, 30)):
            etype, pod = random_event(kind, rng, oracle, nodes, fresh)
            mirror.apply_pod_event(etype, pod)
            oracle.apply(etype, pod)
        got = mirror.state()[1]
        assert len(got) == len(oracle.running)
        assert all(a is b for a, b in zip(got, oracle.running))
        mirror.emit([], pending_all_plain=True)
        assert mirror.verify()
    assert mirror.ctr_verify_failures.value() == 0


def test_torch_mirror_seeded_duplicates_leave_as_a_filter_would():
    """A seeded list that repeats a pod, and holds two objects under one
    key: removals take every copy of the object, as a list filter does."""
    rng = random.Random(5)
    nodes, advisor = gen_host_cluster(6, seed=2)
    pods = [make_pod("plain", rng, f"r{i}", nodes[i % 6].name) for i in range(8)]
    twin = dataclasses.replace(pods[3])
    running = pods + [pods[2], twin]
    mirror = SnapshotMirror(SnapshotBuilder())
    mirror.seed(nodes, running, advisor.fetch())
    mirror.emit([], pending_all_plain=True)
    oracle = Oracle(running)
    events = [("DELETED", pods[2]), ("MODIFIED", pods[3]), ("DELETED", twin),
              ("DELETED", pods[3]), ("BOUND", dataclasses.replace(pods[2]))]
    for etype, pod in events:
        mirror.apply_pod_event(etype, pod)
        oracle.apply(etype, pod)
        got = mirror.state()[1]
        assert len(got) == len(oracle.running)
        assert all(a is b for a, b in zip(got, oracle.running))
        mirror.emit([], pending_all_plain=True)
        assert mirror.verify()


def test_torch_mirror_running_list_identity_and_rebuild_count():
    rng = random.Random(7)
    nodes, advisor = gen_host_cluster(50, seed=3)
    running = [make_pod("plain", rng, f"r{i}", rng.choice(nodes).name) for i in range(1200)]
    mirror = SnapshotMirror(SnapshotBuilder())
    mirror.seed(nodes, running, advisor.fetch())
    mirror.emit([], pending_all_plain=True)
    rebuilds = mirror.ctr_running_rebuilds
    first = mirror.state()[1]
    for i in range(20):       # appends and emits keep the list object
        mirror.apply_pod_event("BOUND", make_pod("plain", rng, f"a{i}", nodes[i].name))
        mirror.emit([], pending_all_plain=True)
        assert mirror.state()[1] is first
    assert len(first) == 1220 and rebuilds.value() == 0

    mirror.apply_pod_event("DELETED", running[0])
    second = mirror.state()[1]
    assert second is not first and rebuilds.value() == 1
    assert len(second) == 1219 and all(p is not running[0] for p in second)
    # the list handed out before the deletion is never touched again
    mirror.apply_pod_event("BOUND", make_pod("plain", rng, "b0", nodes[0].name))
    assert len(first) == 1220 and first[0] is running[0]
    assert mirror.state()[1] is second and second[-1].name == "b0"

    for pod in running[1:1001]:
        mirror.apply_pod_event("DELETED", pod)
    assert rebuilds.value() == 1
    third = mirror.state()[1]
    assert rebuilds.value() == 2 and len(third) == 220
    assert mirror.state()[1] is third and rebuilds.value() == 2
    mirror.emit([], pending_all_plain=True)
    assert mirror.verify()
    assert "mirror_running_rebuilds_total" in [c.name for c in mirror.collectors]


def test_torch_mirror_events_from_another_thread():
    rng = random.Random(11)
    mirror, nodes, running = seeded("plain", rng, n_nodes=40, n_running=200)
    oracle = Oracle(running)
    events = []
    fresh = names()
    for _ in range(3000):
        etype, pod = random_event("plain", rng, oracle, nodes, fresh)
        oracle.apply(etype, pod)
        events.append((etype, pod))
    errors, verified = [], []

    def writer():
        try:
            i = 0
            while i < len(events):
                # a run of events of one type goes in as one batch
                j = i + 1
                if rng.random() < 0.5:
                    while j < min(i + 8, len(events)) and events[j][0] == events[i][0]:
                        j += 1
                if j - i > 1:
                    mirror.apply_pod_events(events[i][0], [pod for _, pod in events[i:j]])
                else:
                    mirror.apply_pod_event(*events[i])
                i = j
        except Exception as e:  # noqa: BLE001 -- handed to the main thread
            errors.append(e)

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        t = threading.Thread(target=writer, daemon=True)
        t.start()
        deadline = time.monotonic() + 60.0
        reads = 0
        while t.is_alive() and time.monotonic() < deadline:
            mirror.state()
            mirror.emit([], pending_all_plain=True)
            reads += 1
            if reads % 8 == 0:
                verified.append(mirror.verify())
        t.join(timeout=max(deadline - time.monotonic(), 0.0))
    finally:
        sys.setswitchinterval(switch)
    assert not t.is_alive() and not errors and reads > 0
    assert all(verified)
    got = mirror.state()[1]
    assert len(got) == len(oracle.running)
    assert all(a is b for a, b in zip(got, oracle.running))
    mirror.emit([], pending_all_plain=True)
    assert mirror.verify()


ZONE = "topology.kubernetes.io/zone"
APPS = ("web", "db", "cache")
# cluster -> the kinds of pod on it; zones: nodes labelled with a zone
RICH = {
    "hostname": ("plain", "anti", "preferred", "ports", "pods"),
    "zones": ("plain", "anti", "spread", "preferred", "ports", "pods"),
}


def make_rich_pod(kinds, rng, name, node):
    """One pod of a kind drawn from `kinds`: make_pod's plain, hostname
    anti-affine or hostPort pods, or a pod under a zone spread
    constraint, one with a preferred (anti-)affinity term of any weight
    on the zone or the hostname, or one that requests `pods` itself."""
    kind = rng.choice(kinds)
    if kind in ("plain", "anti"):
        return make_pod(kind, rng, name, node)
    pod = make_pod("plain", rng, name, node)
    if kind == "ports":
        pod.host_ports = [rng.choice(PORTS)]
    elif kind == "pods":
        pod.containers[0].requests["pods"] = float(rng.choice((1, 2, 3)))
    else:
        app = rng.choice(APPS)
        pod.labels = {"app": app}
        if kind == "spread":
            pod.topology_spread = [SpreadConstraint(match_labels={"app": app}, topology_key=ZONE,
                                                    soft=rng.random() < 0.5)]
        else:
            pod.pod_affinity = [PodAffinityTerm(
                match_labels={"app": rng.choice(APPS)},
                topology_key=rng.choice((ZONE, "kubernetes.io/hostname")),
                preferred=True, anti=rng.random() < 0.5, weight=rng.randrange(1, 101))]
    return pod


def assert_bitwise(a: SnapshotArrays, b: SnapshotArrays):
    for name in SnapshotArrays._fields:
        x, y = np.asarray(getattr(a, name)), np.asarray(getattr(b, name))
        assert x.dtype == y.dtype and x.shape == y.shape, name
        assert x.tobytes() == y.tobytes(), name


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("cluster", list(RICH))
def test_torch_mirror_deferred_rows_bitwise_at_every_emit(cluster, seed):
    rng = random.Random(7000 + 100 * seed + len(cluster))
    kinds = RICH[cluster]
    nodes, advisor = gen_host_cluster(10, seed=rng.randrange(1 << 30),
                                      constraints=cluster == "zones")
    running = [make_rich_pod(kinds, rng, f"r{i}", rng.choice(nodes).name) for i in range(30)]
    # a selector bucket wide enough that minted selectors extend in place
    mirror = SnapshotMirror(SnapshotBuilder(initial_selectors=16))
    mirror.seed(nodes, running, advisor.fetch())
    oracle = Oracle(running)
    fresh = names()
    prev, _, rebuilt = mirror.emit([make_rich_pod(kinds, rng, "pending", None)])
    assert rebuilt
    deltas = 0
    for step in range(16):
        for _ in range(rng.randrange(1, 24)):
            if rng.random() < 0.2:
                # a cycle's binds in one batch, at times with an echo in it
                batch = [make_rich_pod(kinds, rng, next(fresh), rng.choice(nodes).name)
                         for _ in range(rng.randrange(1, 6))]
                if oracle.running and rng.random() < 0.5:
                    batch.insert(rng.randrange(len(batch)), rng.choice(oracle.running))
                mirror.apply_pod_events("BOUND", batch)
                for pod in batch:
                    oracle.apply("BOUND", pod)
            else:
                etype, pod = random_event(kinds, rng, oracle, nodes, fresh, make=make_rich_pod)
                mirror.apply_pod_event(etype, pod)
                oracle.apply(etype, pod)
        # a window now and then, whose pod may mint a selector
        window = [make_rich_pod(kinds, rng, f"w{step}", None)] if rng.random() < 0.3 else []
        snap, delta, _ = mirror.emit(window, prev=prev, max_byte_frac=float("inf"))
        assert all(a is b for a, b in zip(mirror.state()[1], oracle.running))
        # the emitted leaves themselves, then the mirror's own cross-check
        assert_bitwise(snap, mirror.builder.build_snapshot(
            nodes, mirror.utils, oracle.running, pending_pods=window, ephemeral=True))
        assert mirror.verify(window)
        if delta is not None:
            assert_bitwise(apply_snapshot_delta_np(prev, delta), snap)
            deltas += 1
        prev = snap
    assert deltas >= 8
    assert mirror.ctr_verify_failures.value() == 0
    if cluster == "zones":
        assert any(key[2] == ZONE for key in mirror.builder.selectors)


def test_torch_mirror_rows_pass_engages_once_per_emit():
    rng = random.Random(21)
    mirror, nodes, running = seeded("anti", rng, n_nodes=16, n_running=24)
    assert mirror._raw is not None
    notes = []
    mirror._on_dirty = lambda: notes.append(1)
    mirror.bursts = observe.PodEventBursts()
    mirror.emit([], pending_all_plain=True)
    mirror.bursts.cut()
    mirror.bursts.drain()
    rows0, events0 = mirror.ctr_row_nodes.value(), mirror.ctr_events.value(kind="pod")
    leaves, owned = dict(mirror._leaves), set(mirror._owned)

    # the cycle's binds: 8 pods on 5 nodes, one batch
    targets = [nd.name for nd in nodes[:5]]
    batch = [make_pod("anti", rng, f"b{i}", targets[i % 5]) for i in range(8)]
    mirror.apply_pod_events("BOUND", batch)
    assert mirror.ctr_events.value(kind="pod") == events0 + 8 and len(notes) == 1
    mirror.bursts.cut()
    (burst,), dropped = mirror.bursts.drain()
    assert dropped == 0
    assert burst[0] == "pod_events" and burst[3]["events"] == 8 and burst[3]["deleted"] == 0
    # an echo of the batch changes nothing and notifies no one
    mirror.apply_pod_events("BOUND", batch[:3])
    assert mirror.ctr_events.value(kind="pod") == events0 + 8 and len(notes) == 1
    # then 3 deletions and 1 bind, one at a time, on the same nodes
    for pod in batch[:3]:
        mirror.apply_pod_event("DELETED", pod)
    mirror.apply_pod_event("BOUND", make_pod("anti", rng, "c0", targets[0]))
    assert mirror.ctr_events.value(kind="pod") == events0 + 12 and len(notes) == 5
    # no event copied a leaf or recomputed a row
    assert mirror._owned == owned
    assert all(mirror._leaves[name] is leaf for name, leaf in leaves.items())
    assert mirror.ctr_row_nodes.value() == rows0
    mirror.bursts.cut()
    mirror.bursts.drain()

    snap, _, _ = mirror.emit([], pending_all_plain=True)
    mirror.bursts.cut()
    got, _ = mirror.bursts.drain()
    passes = [g for g in got if g[0] == "mirror_rows"]
    assert len(passes) == 1 and passes[0][3] == {"nodes": 5, "events": 12}
    assert mirror.ctr_row_nodes.value() == rows0 + 5
    # the pass copied the leaves it wrote; the emitted ones stay frozen
    for name in ("requested", "domain_counts", "avoid_counts"):
        assert getattr(snap, name) is not leaves[name]
    assert snap.disk_io is leaves["disk_io"]
    assert mirror.verify()
    # nothing marked: the next emit makes no pass
    mirror.emit([], pending_all_plain=True)
    mirror.bursts.cut()
    assert mirror.bursts.drain() == ([], 0)
    assert mirror.ctr_row_nodes.value() == rows0 + 5

    # spans off: the pass still runs, untimed
    mirror.bursts = None
    mirror.apply_pod_events("BOUND", [make_pod("anti", rng, "d0", targets[1]),
                                      make_pod("anti", rng, "d1", targets[2])])
    mirror.emit([], pending_all_plain=True)
    assert mirror.ctr_row_nodes.value() == rows0 + 7
    assert mirror.verify()
