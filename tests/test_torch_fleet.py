"""The port's replica fleet, fleet-shared engine, leases and shadow
serving (kubernetes_scheduler_tpu_torch/host/replica.py, engine_pool.py,
leader.py, shadow.py) against the JAX reference's, on the CPU.

- BindTable, ReplicaCoordinator, FencedBinder, FileLease, LeaderElector
  and ReplicaMembership run the reference's cases (tests/test_replica.py,
  tests/test_leader.py) on the port's classes.
- A fleet on ONE shared TorchEngine(device="cpu") binds the same pods to
  the same nodes as the same fleet on private TorchEngines and as the
  reference's fleet, with the pool's evidence: windows coalesced, fewer
  device dispatches than windows, one full upload, deltas or dedups.
- ShadowScheduler over a soak journal the port recorded: an identical
  candidate diverges nowhere, a divergent one moves bindings the same
  way every run (and the way the reference's shadow does over the same
  journal), a wedged one opens the breaker while tailing continues,
  and resume_seq is honoured.

Test names and parametrize ids avoid the substrings tests/conftest.py
marks slow."""

import time

import pytest

from kubernetes_scheduler_tpu.host import replica as ref_replica
from kubernetes_scheduler_tpu.host import shadow as ref_shadow
from kubernetes_scheduler_tpu.host import types as ref_types
from kubernetes_scheduler_tpu.sim import host_gen as ref_gen
from kubernetes_scheduler_tpu.utils import config as ref_config
from kubernetes_scheduler_tpu_torch import TorchEngine
from kubernetes_scheduler_tpu_torch.host.engine_pool import SharedEnginePool
from kubernetes_scheduler_tpu_torch.host.leader import (
    FileLease,
    LeaderElector,
    LeaseRecord,
    ReplicaMembership,
)
from kubernetes_scheduler_tpu_torch.host.queue import PartitionedQueue, namespace_partition
from kubernetes_scheduler_tpu_torch.host.replica import (
    BindConflictError,
    BindTable,
    FencedBinder,
    ReplicaCoordinator,
    ReplicaFleet,
)
from kubernetes_scheduler_tpu_torch.host.shadow import MODES, ShadowScheduler, candidate_kw
from kubernetes_scheduler_tpu_torch.host.types import Container, Pod
from kubernetes_scheduler_tpu_torch.sim import scenarios
from kubernetes_scheduler_tpu_torch.sim.host_gen import gen_host_cluster
from kubernetes_scheduler_tpu_torch.sim.scenarios import SCENARIOS, scenario_config
from kubernetes_scheduler_tpu_torch.trace.recorder import last_journal_seq
from kubernetes_scheduler_tpu_torch.trace.spans import read_span_file, span_files
from kubernetes_scheduler_tpu_torch.utils.config import SchedulerConfig


def cpu_engine(i=0):
    return TorchEngine(device="cpu")


def mk_pod(name, ns="default", cpu=100.0, side="port"):
    pod, ctr = (ref_types.Pod, ref_types.Container) if side == "ref" else (Pod, Container)
    return pod(name=name, namespace=ns,
               containers=[ctr(requests={"cpu": cpu, "memory": 2**28})])


# ---- bind table, coordinator, fenced binder (tests/test_replica.py) ---------


def test_torch_fleet_bind_table_first_bind_wins_and_fences():
    for cls in (BindTable, ref_replica.BindTable):
        t = cls()
        assert t.holder("ns/p") == "" and t.epoch("ns/p") == 0
        assert t.try_bind("ns/p", -1, "r0") is False     # never saw a pop
        assert t.try_bind("ns/p", 1, "r0") is False      # future epoch
        assert t.try_bind("ns/p", 0, "r0") is True
        assert t.holder("ns/p") == "r0" and t.epoch("ns/p") == 1
        assert t.try_bind("ns/p", 0, "r1") is False
        assert t.try_bind("ns/p", 1, "r1") is False
        assert t.bound == 1 and t.double_binds == 0
        assert t.holders() == {"ns/p": "r0"}


class _StubBinder:
    def __init__(self):
        self.bindings = []

    def bind(self, pod, node_name):
        self.bindings.append((pod.name, node_name))


def _coordinator_pair():
    table = BindTable()
    queues = PartitionedQueue(2, prefer_native=False, clock=lambda: 0.0)
    return (table, ReplicaCoordinator("r0", queues.partition(0), table),
            ReplicaCoordinator("r1", queues.partition(1), table))


def test_torch_fleet_pop_window_filters_bound_pods():
    table, c0, _ = _coordinator_pair()
    c0.push(mk_pod("mine", ns="a"))
    c0.push(mk_pod("stale", ns="a"))
    assert table.try_bind("a/stale", 0, "r1")
    assert [p.name for p in c0.pop_window(8)] == ["mine"]
    assert c0.pods_discarded == 1 and len(c0) == 0
    assert c0._seen == {"a/mine": 0}
    assert c0.bind_win(mk_pod("ghost", ns="x")) is False


def test_torch_fleet_fenced_binder_conflict_keeps_the_pod():
    table, c0, c1 = _coordinator_pair()
    b0, b1 = FencedBinder(_StubBinder(), c0), FencedBinder(_StubBinder(), c1)
    for c in (c0, c1):
        c.push(mk_pod("racer", ns="x"))
    w0, w1 = c0.pop_window(4), c1.pop_window(4)
    b0.bind(w0[0], "node-1")
    assert b0.bindings == [("racer", "node-1")]
    with pytest.raises(BindConflictError) as err:
        b1.bind(w1[0], "node-2")
    assert err.value.status == 409 and b1.bindings == []
    assert c1.conflicts == 1 and len(c1) == 1
    assert c1.pop_window(4) == [] and c1.pods_discarded == 1 and len(c1) == 0
    assert len(c1.requeue_latencies) == 1
    assert table.double_binds == 0 and table.bound == 1


# ---- leases (tests/test_leader.py) -------------------------------------------


def test_torch_fleet_file_lease_claim_and_cas(tmp_path):
    lease = FileLease(str(tmp_path / "lease"))
    assert lease.read() is None
    rec = LeaseRecord(holder="a", acquired_at=1.0, renewed_at=1.0, duration=15.0)
    assert lease.try_claim(rec, None)
    got = lease.read()
    assert got.holder == "a"
    rec_b = LeaseRecord(holder="b", acquired_at=2.0, renewed_at=2.0, duration=15.0)
    assert not lease.try_claim(rec_b, None)
    assert lease.try_claim(rec_b, got) and lease.read().holder == "b"
    lease.clear("a")
    assert lease.read() is not None
    lease.clear("b")
    assert lease.read() is None


def test_torch_fleet_elector_single_holder_and_steal(tmp_path):
    path = str(tmp_path / "lease")
    a = LeaderElector(FileLease(path), identity="a", lease_duration=5.0, retry_period=0.05)
    b = LeaderElector(FileLease(path), identity="b", lease_duration=5.0, retry_period=0.05)
    assert a.acquire_blocking(timeout=2.0) and a.is_leader()
    assert not b.acquire_blocking(timeout=0.3) and not b.is_leader()
    a.release()
    assert b.acquire_blocking(timeout=2.0) and b.is_leader()
    b.release()
    lease = FileLease(str(tmp_path / "stale"))
    stale = LeaseRecord(holder="dead", acquired_at=time.time() - 60,
                        renewed_at=time.time() - 60, duration=1.0)
    assert lease.try_claim(stale, None)
    c = LeaderElector(lease, identity="c", lease_duration=5.0, retry_period=0.05)
    assert c.acquire_blocking(timeout=2.0) and lease.read().holder == "c"
    c.release()


def test_torch_fleet_elector_survives_backend_errors(tmp_path):
    class FlakyLease(FileLease):
        fail = False

        def try_claim(self, record, previous):
            if self.fail:
                raise ConnectionError("api server down")
            return super().try_claim(record, previous)

        def read(self):
            if self.fail:
                raise ConnectionError("api server down")
            return super().read()

    lease = FlakyLease(str(tmp_path / "lease"))
    el = LeaderElector(lease, identity="a", lease_duration=0.6, retry_period=0.05)
    assert el.acquire_blocking(timeout=2)
    lease.fail = True
    time.sleep(0.2)
    assert el.is_leader()
    time.sleep(0.8)
    assert not el.is_leader()
    lease.fail = False
    deadline = time.time() + 3
    while not el.is_leader() and time.time() < deadline:
        time.sleep(0.05)
    assert el.is_leader()
    el.release()


def test_torch_fleet_replica_membership_slots(tmp_path):
    path = str(tmp_path / "fleet-lease")
    kw = dict(retry_period=0.05)
    m0 = ReplicaMembership.on_files(path, 2, **kw)
    m1 = ReplicaMembership.on_files(path, 2, **kw)
    assert m0.join(timeout=5) == 0 and m1.join(timeout=5) == 1
    assert m0.is_member() and m1.is_member()
    assert ReplicaMembership.on_files(path, 2, **kw).join(timeout=0.3) is None
    m0.leave()
    assert not m0.is_member()
    successor = ReplicaMembership.on_files(path, 2, **kw)
    assert successor.join(timeout=5) == 0
    m1.leave()
    successor.leave()


# ---- fleets: shared engine == private engines == the reference ---------------


def _tenants(n):
    return [next(ns for i in range(256)
                 if namespace_partition(ns := f"tenant-{i}", n) == r) for r in range(n)]


def _workload(side, n_replicas, pods_per, tag="w"):
    return [mk_pod(f"{tag}{t}-{j}", ns, side=side)
            for t, ns in enumerate(_tenants(n_replicas)) for j in range(pods_per)]


SHARED_RECIPE = dict(batch_window=8, normalizer="none", adaptive_dispatch=False,
                     min_device_work=0, pipeline_depth=1, max_windows_per_cycle=1)


def _fleet(side, n_replicas, *, shared, n_nodes=24, engine_factory=None):
    """A fleet on the shared-engine recipe (single-window pipelined
    cycles: a multi-window backlog dispatches alone and never
    coalesces); the port's engines on the CPU."""
    if side == "ref":
        fleet_cls, gen, config_cls, kw = (
            ref_replica.ReplicaFleet, ref_gen.gen_host_cluster, ref_config.SchedulerConfig, {})
    else:
        fleet_cls, gen, config_cls = ReplicaFleet, gen_host_cluster, SchedulerConfig
        kw = {"engine_factory": engine_factory or cpu_engine}
    nodes, advisor = gen(n_nodes, seed=0)
    running: list = []
    return fleet_cls(config_cls(shared_engine=shared, **SHARED_RECIPE),
                     n_replicas=n_replicas, advisor_factory=lambda i: advisor,
                     list_nodes=lambda: nodes, list_running_pods=lambda: running, **kw)


def _drain_rounds(fleet, max_rounds=64):
    rounds = 0
    while any(len(s.queue) or s._prefetched is not None for s in fleet.schedulers):
        assert rounds < max_rounds
        fleet.run_round_split()
        rounds += 1
    for s in fleet.schedulers:
        s.drain_pipeline()
    return rounds


def _bound(fleet):
    return {(b.pod.namespace, b.pod.name): b.node_name
            for s in fleet.schedulers for b in s.binder.bindings}


@pytest.mark.parametrize("n_replicas", [2, 4])
def test_torch_fleet_shared_union_map_bitwise(n_replicas):
    maps, evs = {}, {}
    for key, side, shared in (("shared", "port", True), ("private", "port", False),
                              ("ref", "ref", True)):
        fleet = _fleet(side, n_replicas, shared=shared)
        for pod in _workload(side, n_replicas, 16):
            fleet.submit(pod)
        _drain_rounds(fleet)
        maps[key], evs[key] = _bound(fleet), fleet.evidence()
    assert len(maps["shared"]) == 16 * n_replicas
    assert maps["shared"] == maps["private"] == maps["ref"]
    for ev in evs.values():
        assert ev["double_binds"] == 0 and ev["pods_discarded"] == 0
    st = evs["shared"]["shared_engine"]
    assert st["coalesced_dispatches"] > 0
    assert st["device_dispatches"] < n_replicas * 2
    assert st["uploads"]["full"] == 1
    assert st["uploads"]["delta"] + st["uploads"]["dedup"] > 0
    assert st["epoch"] == st["device_dispatches"]
    ref_st = evs["ref"]["shared_engine"]
    for k in ("device_dispatches", "coalesced_dispatches", "uploads", "epoch"):
        assert st[k] == ref_st[k], k
    assert "shared_engine" not in evs["private"]


def test_torch_fleet_threaded_drain_matches_private():
    """The threaded drain (the real topology): coalescing happens on the
    threads' timing and must not show in the decisions; the pool's
    collectors reach every replica's exporter."""
    out = {}
    for shared in (True, False):
        fleet = _fleet("port", 2, shared=shared, n_nodes=16)
        for pod in _workload("port", 2, 12):
            fleet.submit(pod)
        ev = fleet.run_until_empty(max_cycles=100)
        assert ev["double_binds"] == 0 and ev["total_binds"] == 24
        out[shared] = (_bound(fleet), ev, fleet)
    assert out[True][0] == out[False][0]
    st = out[True][1]["shared_engine"]
    assert st["uploads"]["full"] == 1 and st["upload_bytes"]["dedup"] == 0
    fleet = out[True][2]
    for replica in (0, 1):
        body = "\n".join(line for c in fleet.prom_collectors(replica) for line in c.render())
        assert "yoda_tpu_coalesced_dispatches_total" in body
        assert "yoda_tpu_coalesce_batch_window_count_bucket" in body
        assert 'yoda_tpu_shared_engine_uploads_total{upload="full"}' in body


class _CrashOnSecondFleetCall:
    """TorchEngine wrapper whose second coalesced fleet dispatch dies."""

    def __init__(self):
        self._inner = cpu_engine()
        self.fleet_calls = 0

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def schedule_batch_fleet(self, *args, **kw):
        self.fleet_calls += 1
        if self.fleet_calls == 2:
            raise RuntimeError("engine died mid-coalesced-batch")
        return self._inner.schedule_batch_fleet(*args, **kw)


def test_torch_fleet_crash_mid_coalesced_batch_loses_nothing():
    inner = _CrashOnSecondFleetCall()
    fleet = _fleet("port", 2, shared=True, n_nodes=16, engine_factory=lambda i: inner)
    for pod in _workload("port", 2, 24):
        fleet.submit(pod)
    _drain_rounds(fleet)
    ev = fleet.evidence()
    assert inner.fleet_calls >= 3
    assert ev["total_binds"] == 48 and ev["double_binds"] == 0
    assert ev["pods_discarded"] == 0
    assert sum(s.totals["fallback_cycles"] for s in fleet.schedulers) >= 2
    assert ev["shared_engine"]["uploads"]["full"] >= 2


def test_torch_fleet_view_surface_and_overlap_storm():
    pool = SharedEnginePool(cpu_engine(), coalesce_window_ms=0.0)
    v0, v1 = pool.view("r0"), pool.view("r1")
    assert v0.supports_resident() is False and v0.supports_windows_resident() is False
    assert v0.healthy() and v0.supports_gangs()
    pool._prev = {"sentinel": object()}
    v1.invalidate_resident()
    assert pool._prev is None
    v0.close()
    assert not pool._closed
    v1.close()
    assert pool._closed
    # the same pod handed to every replica binds exactly once
    fleet = _fleet("port", 2, shared=False, n_nodes=16)
    for pod in _workload("port", 2, 4):
        fleet.submit(pod)
    for j in range(5):
        fleet.submit_overlap(mk_pod(f"overlap-{j}", ns="contested"))
    ev = fleet.run_sequential(max_cycles=100)
    assert ev["double_binds"] == 0 and ev["total_binds"] == 13
    assert ev["pods_discarded"] + ev["bind_conflicts_total"] == 5


# ---- shadow serving over a soak journal ---------------------------------------


def _soak_config(**overrides) -> SchedulerConfig:
    kw = dict(SCENARIOS["soak"].config_overrides)
    kw.update(overrides)
    return scenario_config(kw)


@pytest.fixture(scope="module")
def soak_journal(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("shadow") / "journal")
    summary = scenarios.run("soak", n_nodes=16, seed=0, trace_path=path, device="cpu")
    assert summary["pods_bound"] > 0 and summary["fallback_cycles"] == 0
    return path, summary


def test_torch_fleet_shadow_identical_config_zero_divergence(soak_journal, tmp_path):
    journal, primary = soak_journal
    shadow = ShadowScheduler(journal, _soak_config(), span_path=str(tmp_path / "spans"),
                             device="cpu")
    try:
        summary = shadow.run()
    finally:
        shadow.close()
    assert summary["records_applied"] == primary["cycles"]
    assert summary["cycles"] == {"scored": summary["records_applied"]}
    assert summary["pods_compared"] > 0
    assert summary["bindings_changed"] == 0 and summary["divergence_ratio"] == 0.0
    assert summary["gangs_diverged"] == 0 and summary["score_delta_mean"] == 0.0
    assert summary["candidate_errors"] == 0 and summary["breaker_state"] == "closed"
    assert summary["unanchored_skips"] == 0
    assert summary["candidate_engine_seconds"] > 0 and summary["latency_ratio"] > 0
    assert summary["tail"]["rotations_followed"] >= 1
    names = {ev["name"] for fp in span_files(str(tmp_path / "spans"))
             for ev in read_span_file(fp) if ev.get("ph") == "X"}
    assert {"cycle", "reconstruct", "candidate_step", "decision_diff"} <= names
    for mode in MODES:
        s = ShadowScheduler(journal, _soak_config(), mode=mode, device="cpu").run()
        assert s["bindings_changed"] == 0 and s["records_applied"] == primary["cycles"]


def test_torch_fleet_shadow_divergent_candidate_is_deterministic(soak_journal):
    journal, _ = soak_journal
    keys = ("records_applied", "pods_compared", "bindings_changed",
            "divergence_ratio", "gangs_diverged")

    def once():
        s = ShadowScheduler(journal, _soak_config(policy="least_allocated"),
                            device="cpu").run()
        return {k: s[k] for k in (*keys, "score_delta_mean")}

    s1, s2 = once(), once()
    assert s1["bindings_changed"] > 0 and s1["divergence_ratio"] > 0
    assert s1["score_delta_mean"] > 0
    assert s1 == s2
    # the reference's shadow over the same journal diffs the same way
    from kubernetes_scheduler_tpu.sim.scenarios import scenario_config as ref_scenario_config

    kw = dict(SCENARIOS["soak"].config_overrides, policy="least_allocated")
    ref = ref_shadow.ShadowScheduler(journal, ref_scenario_config(kw)).run()
    assert {k: ref[k] for k in keys} == {k: s1[k] for k in keys}
    assert ref["score_delta_mean"] == pytest.approx(s1["score_delta_mean"], rel=1e-5)


def test_torch_fleet_shadow_breaker_guards_wedged_candidate(soak_journal):
    class WedgedEngine:
        def schedule_windows(self, *a, **kw):
            raise RuntimeError("candidate wedged")

        def schedule_batch(self, *a, **kw):
            raise RuntimeError("candidate wedged")

    journal, primary = soak_journal
    cfg = _soak_config()
    summary = ShadowScheduler(journal, cfg, engine=WedgedEngine()).run()
    assert summary["records_applied"] == primary["cycles"]
    assert summary["candidate_errors"] >= cfg.breaker_failure_threshold
    assert summary["breaker_skips"] > 0 and summary["breaker_state"] == "open"
    assert summary["cycles"].get("scored", 0) == 0
    assert (summary["cycles"]["error"] + summary["cycles"]["breaker_open"]
            == summary["records_applied"])
    assert summary["unanchored_skips"] == 0 and summary["bindings_changed"] == 0


def test_torch_fleet_shadow_resume_seq_and_candidate_kw(soak_journal, tmp_path):
    journal, _ = soak_journal
    last = last_journal_seq(journal)
    assert last is not None
    summary = ShadowScheduler(journal, _soak_config(), resume_seq=last, device="cpu").run()
    assert summary["records_applied"] == 0 and summary["cycles"] == {}
    assert summary["tail"]["records_filtered"] > 0
    with pytest.raises(ValueError, match="unknown shadow mode"):
        ShadowScheduler(str(tmp_path / "j"), _soak_config(), mode="turbo", device="cpu")
    recorded = {"policy": "card", "assigner": "auction", "normalizer": "min_max",
                "fused": True, "auction_rounds": 7, "auction_price_frac": 0.5}
    for cfg_kw in ({"policy": "balanced_cpu_diskio", "normalizer": "none"},
                   {"policy": "least_allocated"}):
        got = candidate_kw(recorded, SchedulerConfig(**cfg_kw))
        want = ref_shadow.candidate_kw(recorded, ref_config.SchedulerConfig(**cfg_kw))
        assert got == want
    assert recorded["policy"] == "card" and recorded["fused"] is True
    shadow = ShadowScheduler(journal, _soak_config(), device="cpu")
    shadow.run(limit=3)
    body = shadow._render()
    for name in ("shadow_records_applied_total", "shadow_divergence_ratio",
                 "shadow_candidate_step_duration_seconds"):
        assert name in body, name
