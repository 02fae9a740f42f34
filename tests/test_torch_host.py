"""The port's host layer (kubernetes_scheduler_tpu_torch/host/, sim/host_gen.py,
utils/config.py) against the JAX reference's, on the CPU.

The snapshot builder and snapshot_delta give leaves bitwise equal to the
reference's from the same generated cluster, and the port's Scheduler on
TorchEngine(device="cpu") binds the same pods to the same nodes, in the
same order, as the reference's Scheduler on LocalEngine over a few
cycles: both assigners, resident state, the snapshot mirror, the
pipelined loop, gangs, preemption (the evictions are equal too) and the
default adaptive route. With deletions between cycles, the port's
Scheduler binds the same pods to the same nodes with the snapshot mirror
on (each cycle's binds self-applied as one batch, the row math deferred
to the emit) and off. Both sides run one virtual queue clock, and the
reference engine answers supports_fused_min_max() as TorchEngine does,
so both take the fused min-max route (the reference's LocalEngine has no
such probe and would run min-max unfused on the CPU).

Test names and parametrize ids avoid the substrings tests/conftest.py
marks slow."""

import dataclasses

import numpy as np
import pytest

from kubernetes_scheduler_tpu import engine as ref_engine
from kubernetes_scheduler_tpu.host import scheduler as ref_sched
from kubernetes_scheduler_tpu.host import snapshot as ref_snap
from kubernetes_scheduler_tpu.host import types as ref_types
from kubernetes_scheduler_tpu.sim import host_gen as ref_gen
from kubernetes_scheduler_tpu.utils import config as ref_config
from kubernetes_scheduler_tpu_torch import TorchEngine
from kubernetes_scheduler_tpu_torch.host import scheduler as port_sched
from kubernetes_scheduler_tpu_torch.host import snapshot as port_snap
from kubernetes_scheduler_tpu_torch.host import types as port_types
from kubernetes_scheduler_tpu_torch.sim import host_gen as port_gen
from kubernetes_scheduler_tpu_torch.utils import config as port_config


class FusedMinMaxLocalEngine(ref_engine.LocalEngine):
    """The reference engine on the route TorchEngine takes: min-max fused."""

    def supports_fused_min_max(self) -> bool:
        return True


SIDES = {
    "ref": (ref_sched, ref_gen, ref_config, ref_types, FusedMinMaxLocalEngine),
    "port": (port_sched, port_gen, port_config, port_types,
             lambda: TorchEngine(device="cpu")),
}


def bits(a):
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def assert_leaves_equal(got, want):
    assert got._fields == want._fields
    for name in want._fields:
        g, w = np.asarray(getattr(got, name)), np.asarray(getattr(want, name))
        assert g.shape == w.shape and g.dtype == w.dtype, name
        np.testing.assert_array_equal(bits(g), bits(w), err_msg=name)


def test_torch_host_generators_give_equal_objects():
    for kw in ({}, {"constraints": True, "gpu": True}):
        rn, ra = ref_gen.gen_host_cluster(20, seed=3, **kw)
        pn, pa = port_gen.gen_host_cluster(20, seed=3, **kw)
        assert [dataclasses.asdict(x) for x in rn] == [dataclasses.asdict(x) for x in pn]
        assert {k: dataclasses.asdict(v) for k, v in ra.fetch().items()} == {
            k: dataclasses.asdict(v) for k, v in pa.fetch().items()}
        rp = ref_gen.gen_host_pods(30, seed=4, **kw)
        pp = port_gen.gen_host_pods(30, seed=4, **kw)
        assert [dataclasses.asdict(x) for x in rp] == [dataclasses.asdict(x) for x in pp]


def built(side, constraints, *, bound=10):
    """(snapshot, next snapshot after more binds, pod batch) of one side's
    SnapshotBuilder over its own generated objects."""
    _, gen, _, _, _ = SIDES[side]
    snap_mod = ref_snap if side == "ref" else port_snap
    kw = {"constraints": True, "gpu": True} if constraints else {}
    nodes, advisor = gen.gen_host_cluster(40, seed=5, **kw)
    pods = gen.gen_host_pods(48, seed=6, **kw)
    running = []
    for i, pod in enumerate(pods[:bound]):
        pod.node_name = nodes[(7 * i) % len(nodes)].name
        running.append(pod)
    b = snap_mod.SnapshotBuilder()
    utils = advisor.fetch()
    pending = pods[bound:]
    s0 = b.build_snapshot(nodes, utils, running, pending_pods=pending)
    batch = b.build_pod_batch(pending)
    for i, pod in enumerate(pending[:6]):
        pod.node_name = nodes[(3 * i + 1) % len(nodes)].name
    s1 = b.build_snapshot(nodes, utils, running + pending[:6], pending_pods=pending[6:])
    return s0, s1, batch, snap_mod


@pytest.mark.parametrize("kind", ["plain", "constraints"])
def test_torch_host_snapshot_leaves_bitwise(kind):
    r0, r1, rb, _ = built("ref", kind == "constraints")
    p0, p1, pb, _ = built("port", kind == "constraints")
    assert_leaves_equal(p0, r0)
    assert_leaves_equal(p1, r1)
    assert_leaves_equal(pb, rb)


@pytest.mark.parametrize("kind", ["plain", "constraints"])
def test_torch_host_snapshot_delta_bitwise(kind):
    r0, r1, _, rmod = built("ref", kind == "constraints")
    p0, p1, _, pmod = built("port", kind == "constraints")
    want = rmod.snapshot_delta(r0, r1, max_byte_frac=1.0)
    got = pmod.snapshot_delta(p0, p1, max_byte_frac=1.0)
    assert want is not None and got is not None
    assert_leaves_equal(got, want)


def gang_up(pods):
    """Label every 4th group of 3 pods as a gang of 3 (one gang declares 4
    members it never gets, so it never completes)."""
    for g in range(0, len(pods) - 3, 12):
        size = "4" if g == 12 else "3"
        for pod in pods[g:g + 3]:
            pod.labels = {**pod.labels, "scv/gang": f"g{g}", "scv/gang-size": size}


def drain(side, cfg, *, n_nodes=64, n_pods=96, backlogs=2, constraints=False,
          gangs=False, evictions=False):
    """One side's Scheduler over `backlogs` backlogs on one virtual queue
    clock, binds fed back as running pods. Returns (bindings as (pod,
    node) names in order, evictions as (victim, preemptor) names, the
    scheduler)."""
    sched_mod, gen, config_mod, types, make_engine = SIDES[side]
    kw = {"constraints": True} if constraints else {}
    nodes, advisor = gen.gen_host_cluster(n_nodes, seed=0, **kw)
    running = []
    evictor = None
    if evictions:
        # every node full of low-priority pods: the high-priority backlog
        # fits nowhere until victims leave
        for i, nd in enumerate(nodes):
            for j in range(2):
                cpu = nd.allocatable["cpu"] / 2
                victim = types.Pod(
                    name=f"low-{i}-{j}",
                    labels={"scv/priority": str(j)},
                    containers=[types.Container(requests={"cpu": cpu, "memory": 2.0**28})],
                    node_name=nd.name, start_time=float(100 * i + j),
                )
                running.append(victim)
        evictor = sched_mod.RecordingEvictor()
    clock = [0.0]
    engine = make_engine()
    sched = sched_mod.Scheduler(
        config_mod.SchedulerConfig(**cfg), advisor=advisor, evictor=evictor,
        list_nodes=lambda: nodes, list_running_pods=lambda: running,
        engine=engine, queue_clock=lambda: clock[0],
    )
    seen = 0
    for b in range(backlogs):
        pods = gen.gen_host_pods(n_pods, seed=1 + b, **kw)
        for pod in pods:        # distinct running pods: the mirror dedups by key
            pod.name = f"b{b}-{pod.name}"
        if gangs:
            gang_up(pods)
        if evictions:
            pods = pods[:24]
            for pod in pods:
                pod.labels = {**pod.labels, "scv/priority": "9"}
        for pod in pods:
            sched.submit(pod)
        for _ in range(8):
            if len(sched.queue) == 0 and sched._prefetched is None:
                break
            sched.run_cycle()
            clock[0] += 30.0
            for bd in sched.binder.bindings[seen:]:
                running.append(bd.pod)
            seen = len(sched.binder.bindings)
            if evictions:
                # victims terminate; the informer's delete events reach
                # the snapshot mirror
                gone = {e.victim.name for e in evictor.evictions}
                for victim in [p for p in running if p.name in gone]:
                    running.remove(victim)
                    if sched.mirror is not None:
                        sched.mirror.apply_pod_event("DELETED", victim)
    binds = [(bd.pod.name, bd.node_name) for bd in sched.binder.bindings]
    evs = [(e.victim.name, e.preemptor.name) for e in evictor.evictions] if evictor else []
    return binds, evs, sched


DEVICE = dict(batch_window=32, max_windows_per_cycle=4, adaptive_dispatch=False,
              min_device_work=1)
HOST_CASES = {
    "k3": {},
    "k4": {"assigner": "greedy"},
    "k3-resident": {"resident_state": True},
    "k4-resident": {"assigner": "greedy", "resident_state": True},
    "k3-nomirror": {"snapshot_mirror": False},
    "k4-nomirror-resident": {"assigner": "greedy", "snapshot_mirror": False,
                             "resident_state": True},
    "k3-depth1": {"pipeline_depth": 1, "max_windows_per_cycle": 1},
    "k4-depth1-resident": {"assigner": "greedy", "pipeline_depth": 1,
                           "max_windows_per_cycle": 1, "resident_state": True},
}


@pytest.mark.parametrize("case", list(HOST_CASES))
def test_torch_host_binds_match_reference(case):
    cfg = {**DEVICE, **HOST_CASES[case]}
    want, _, ref = drain("ref", cfg)
    got, _, port = drain("port", cfg)
    assert len(want) > 96
    assert got == want
    for key in ("fallback_cycles", "degraded_cycles", "delta_uploads", "full_uploads"):
        assert port.totals[key] == ref.totals[key], key
    assert port.totals["fallback_cycles"] == 0
    assert all(m.engine_seconds > 0 for m in port.metrics if m.pods_in)


@pytest.mark.parametrize("assigner", ["k3", "k4"])
def test_torch_host_binds_gangs_match_reference(assigner):
    cfg = {**DEVICE, "gang_scheduling": True,
           "assigner": "greedy" if assigner == "k4" else "auction"}
    want, _, ref = drain("ref", cfg, gangs=True, constraints=True)
    got, _, port = drain("port", cfg, gangs=True, constraints=True)
    assert got == want
    assert port.totals["gangs_admitted"] == ref.totals["gangs_admitted"] > 0
    assert port.totals["gangs_deferred"] == ref.totals["gangs_deferred"] > 0


def test_torch_host_evictions_match_reference():
    cfg = {**DEVICE, "batch_window": 8, "max_windows_per_cycle": 1}
    want, want_ev, ref = drain("ref", cfg, n_nodes=16, backlogs=1, evictions=True)
    got, got_ev, port = drain("port", cfg, n_nodes=16, backlogs=1, evictions=True)
    assert want_ev and got_ev == want_ev
    assert got == want and len(got) > 0
    assert port.totals["victims_evicted"] == ref.totals["victims_evicted"]
    assert port.engine.preempt_calls > 0 and port.totals["pods_preempted"] > 0


def test_torch_host_binds_default_route_match_reference():
    """Default adaptive dispatch: a small cluster stays under
    min_device_work and runs the scalar route on both sides."""
    cfg = {"batch_window": 32, "max_windows_per_cycle": 4}
    want, _, _ = drain("ref", cfg, n_nodes=24, n_pods=48)
    got, _, port = drain("port", cfg, n_nodes=24, n_pods=48)
    assert got == want and len(got) > 48
    assert all(m.engine_seconds == 0 for m in port.metrics)


def drain_with_deletions(cfg, *, constraints, seed, cycles=6):
    """The port's Scheduler over `cycles` cycles of a refilled backlog on
    one virtual queue clock; after each cycle its binds join the running
    pods and every third running pod is deleted (through the mirror as
    the informer's DELETED events, when it is on). Returns the bindings
    as (pod, node) names in order, and the scheduler."""
    nodes, advisor = port_gen.gen_host_cluster(48, seed=seed, constraints=constraints)
    running = []
    clock = [0.0]
    sched = port_sched.Scheduler(
        port_config.SchedulerConfig(**cfg), advisor=advisor,
        list_nodes=lambda: nodes, list_running_pods=lambda: running,
        engine=TorchEngine(device="cpu"), queue_clock=lambda: clock[0],
    )
    seen = 0
    for c in range(cycles):
        pods = port_gen.gen_host_pods(40, seed=seed + c, constraints=constraints)
        for pod in pods:
            pod.name = f"c{c}-{pod.name}"
            sched.submit(pod)
        sched.run_cycle()
        clock[0] += 30.0
        running.extend(bd.pod for bd in sched.binder.bindings[seen:])
        seen = len(sched.binder.bindings)
        for pod in running[::3]:
            running.remove(pod)
            if sched.mirror is not None:
                sched.mirror.apply_pod_event("DELETED", pod)
    return [(bd.pod.name, bd.node_name) for bd in sched.binder.bindings], sched


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("kind", ["plain", "constraints"])
def test_torch_host_mirror_binds_match_mirror_off(kind, seed):
    # a selector bucket wide enough that the windows' selectors extend it
    cfg = {**DEVICE, "mirror_initial_selectors": 32}
    want, off = drain_with_deletions({**cfg, "snapshot_mirror": False},
                                     constraints=kind == "constraints", seed=seed)
    got, on = drain_with_deletions(cfg, constraints=kind == "constraints", seed=seed)
    assert off.mirror is None and on.mirror is not None
    assert got == want and len(got) > 120
    # the mirror served every cycle after the seed
    assert on.mirror.ctr_rebuilds.breakdown() == {("seed",): 1}
    assert on.mirror.ctr_row_nodes.value() > 0
    assert on.mirror.verify() and on.mirror.ctr_verify_failures.value() == 0
