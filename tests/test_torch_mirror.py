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
- Events applied from another thread while this one reads and emits
  leave the oracle's running set and arrays that verify.

Test names avoid the substrings tests/conftest.py marks slow."""

import dataclasses
import random
import sys
import threading
import time

import pytest

from kubernetes_scheduler_tpu_torch.host.mirror import SnapshotMirror
from kubernetes_scheduler_tpu_torch.host.snapshot import SnapshotBuilder
from kubernetes_scheduler_tpu_torch.host.types import Container, PodAffinityTerm, Pod
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


def random_event(kind, rng, oracle, nodes, fresh):
    """(etype, pod) drawn over every way a pod enters or leaves."""
    names = [nd.name for nd in nodes]
    r = rng.random()
    if r < 0.35 or not oracle.running:
        return "BOUND" if r < 0.2 else "ADDED", make_pod(kind, rng, next(fresh), rng.choice(names))
    victim = rng.choice(oracle.running)
    if r < 0.5:      # a replacing MODIFIED: a new object under the same key
        return "MODIFIED", dataclasses.replace(victim, node_name=rng.choice(names))
    if r < 0.55:     # the echo of a pod the mirror holds
        return "MODIFIED", victim
    if r < 0.6:      # unbound: leaves the running set
        return "MODIFIED", dataclasses.replace(victim, node_name=None)
    if r < 0.65:     # a pod the mirror never saw
        return "DELETED", make_pod(kind, rng, next(fresh), rng.choice(names))
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
    errors = []

    def writer():
        try:
            for etype, pod in events:
                mirror.apply_pod_event(etype, pod)
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
        t.join(timeout=max(deadline - time.monotonic(), 0.0))
    finally:
        sys.setswitchinterval(switch)
    assert not t.is_alive() and not errors and reads > 0
    got = mirror.state()[1]
    assert len(got) == len(oracle.running)
    assert all(a is b for a, b in zip(got, oracle.running))
    mirror.emit([], pending_all_plain=True)
    assert mirror.verify()
