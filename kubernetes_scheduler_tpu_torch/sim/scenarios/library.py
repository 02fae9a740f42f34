"""The shipped scenario programs (sim/scenarios/base.py is the harness).

Each scenario is a seeded adversarial traffic shape the static
generators (sim/cluster_gen, sim/host_gen) cannot express: load that
CHANGES over time, nodes that vanish mid-run, gangs whose members
straggle in. Every one is registered by name in SCENARIOS and runnable
via sim.scenarios.run(<name>); all randomness flows from the single
rng the runner seeds, so a (name, seed, scale) triple pins the journal.
"""

from __future__ import annotations

import math

import numpy as np

from kubernetes_scheduler_tpu_torch.host.types import Container, Pod, PodAffinityTerm
from kubernetes_scheduler_tpu_torch.sim.scenarios.base import Scenario, ScenarioWorld

ZONES = ("zone-a", "zone-b", "zone-c", "zone-d")
_ZONE_KEY = "topology.kubernetes.io/zone"


def _mk_pod(
    rng,
    name: str,
    *,
    labels: dict | None = None,
    cpu: float | None = None,
    anti_group: str | None = None,
) -> Pod:
    """One simulated pod, everything drawn from the scenario rng."""
    lab = {"scv/priority": str(int(rng.integers(0, 10)))}
    if labels:
        lab.update(labels)
    kw: dict = {}
    if anti_group is not None:
        lab["app"] = anti_group
        kw["pod_affinity"] = [
            PodAffinityTerm(
                match_labels={"app": anti_group},
                topology_key=_ZONE_KEY,
                anti=True,
            )
        ]
    return Pod(
        name=name,
        labels=lab,
        annotations={
            "diskIO": f"{min(max(rng.gamma(2.0, 5.0), 0.1), 45.0):.1f}"
        },
        containers=[
            Container(
                requests={
                    "cpu": float(
                        cpu
                        if cpu is not None
                        else rng.choice([100, 250, 500, 1000])
                    ),
                    "memory": float(rng.choice([1, 2, 4])) * 2**28,
                }
            )
        ],
        **kw,
    )


class DiurnalScenario(Scenario):
    """A day compressed into `ticks`: arrivals follow a sinusoidal load
    curve (trough ~20% of peak), the steady-state shape a production
    scheduler actually sees. The baseline every adversarial scenario is
    judged against."""

    name = "diurnal"
    description = "sinusoidal arrival curve: compressed day/night load"
    ticks = 12
    smoke = True

    def tick(self, t: int, world: ScenarioWorld, rng) -> None:
        base = max(2, int(self.n_nodes * self.intensity))
        phase = 2.0 * math.pi * t / self.ticks
        n = max(1, int(base * (0.6 - 0.4 * math.cos(phase))))
        for i in range(n):
            world.submit(_mk_pod(rng, f"diurnal-t{t}-{i}"))


class BurstScenario(Scenario):
    """A quiet trickle, then one tick delivers a backlog ~8x the
    steady state (a controller rollout, a namespace un-pause): the
    deep-window pop, bucket-padding recompiles, and queue ordering all
    get exercised at once."""

    name = "burst"
    description = "arrival burst: ~8x backlog lands in one tick"
    ticks = 10
    smoke = True

    def tick(self, t: int, world: ScenarioWorld, rng) -> None:
        base = max(2, int(self.n_nodes * self.intensity / 4))
        n = base * 8 if t == self.ticks // 2 else base
        for i in range(n):
            world.submit(_mk_pod(rng, f"burst-t{t}-{i}"))


class NodeFlapScenario(Scenario):
    """Nodes vanish and return mid-run: each flap kills the node's
    running pods (resubmitted by their controllers) and churns the
    snapshot layout — with resident state on, every flap forces the
    delta chain to flush to a full upload; the pipelined loop's
    speculative batches discard on the fingerprint change."""

    name = "node-flap"
    description = "nodes vanish/return mid-run; resident state flushes"
    ticks = 14

    def tick(self, t: int, world: ScenarioWorld, rng) -> None:
        n = max(2, int(self.n_nodes * self.intensity / 2))
        for i in range(n):
            world.submit(_mk_pod(rng, f"flap-t{t}-{i}"))
        if t >= 2 and t % 3 == 2 and world.nodes:
            k = max(1, len(world.nodes) // 16)
            names = [
                world.nodes[int(j)].name
                for j in rng.choice(
                    len(world.nodes), size=min(k, len(world.nodes)),
                    replace=False,
                )
            ]
            for name in names:
                world.fail_node(name)
        if t % 3 == 1:
            for name in list(world.downed):
                world.restore_node(name)


class ZoneFailureScenario(Scenario):
    """A whole zone dies at once: every node in it is gone in one tick
    and every pod that ran there floods back into the queue — the mass-
    rescheduling spike. The zone returns (empty) near the end."""

    name = "zone-failure"
    description = "whole-zone outage -> mass rescheduling flood"
    ticks = 12

    def tick(self, t: int, world: ScenarioWorld, rng) -> None:
        n = max(2, int(self.n_nodes * self.intensity))
        for i in range(n):
            world.submit(_mk_pod(rng, f"zone-t{t}-{i}"))
        if t == self.ticks // 2:
            zone = ZONES[int(rng.integers(0, len(ZONES)))]
            for name in [
                nd.name
                for nd in world.nodes
                if nd.labels.get(_ZONE_KEY) == zone
            ]:
                world.fail_node(name)
        if t == self.ticks - 2:
            for name in list(world.downed):
                world.restore_node(name)


class AntiAffinityPackScenario(Scenario):
    """Adversarial packing: waves of pods whose REQUIRED zone-level
    anti-affinity admits at most one per zone per group — more members
    than zones, so every wave leaves a deterministic unschedulable
    remainder churning through retry backoff while plain filler traffic
    must keep flowing around it."""

    name = "anti-affinity-pack"
    description = "zone anti-affinity groups larger than the zone count"
    ticks = 10

    def tick(self, t: int, world: ScenarioWorld, rng) -> None:
        groups = max(1, int(self.n_nodes * self.intensity / 16))
        for g in range(groups):
            size = len(ZONES) + 2  # two can never place per wave
            for i in range(size):
                world.submit(
                    _mk_pod(
                        rng,
                        f"anti-t{t}-g{g}-{i}",
                        anti_group=f"spread-{t}-{g}",
                    )
                )
        for i in range(max(2, int(self.n_nodes * self.intensity / 4))):
            world.submit(_mk_pod(rng, f"anti-fill-t{t}-{i}"))


class GangMixScenario(Scenario):
    """Gang-heavy traffic (ops/gang.py): complete gangs of mixed sizes,
    straggler gangs whose last member arrives a tick late (deferral +
    reunite via restore_window), one oversize gang that must resolve by
    policy, and plain filler — the all-or-nothing machinery end to end."""

    name = "gang-mix"
    description = "gangs of mixed sizes, stragglers, one oversize gang"
    ticks = 10
    smoke = True

    def _gang_pod(self, rng, gang: str, size: int, i: int) -> Pod:
        return _mk_pod(
            rng,
            f"{gang}-m{i}",
            labels={"scv/gang": gang, "scv/gang-size": str(size)},
            cpu=float(rng.choice([100, 250, 500])),
        )

    def tick(self, t: int, world: ScenarioWorld, rng) -> None:
        scale = max(1, int(self.n_nodes * self.intensity / 32))
        for g in range(scale):
            size = int(rng.choice([2, 3, 4, 8]))
            gang = f"gang-t{t}-{g}"
            for i in range(size):
                world.submit(self._gang_pod(rng, gang, size, i))
        # straggler: all but one member now, the last one next tick
        if t % 2 == 0:
            size = int(rng.choice([3, 4]))
            gang = f"straggler-t{t}"
            for i in range(size - 1):
                world.submit(self._gang_pod(rng, gang, size, i))
            self._pending = (gang, size)
        elif getattr(self, "_pending", None) is not None:
            gang, size = self._pending
            self._pending = None
            world.submit(self._gang_pod(rng, gang, size, size - 1))
        # one gang no window can hold: exercises the oversize policy
        if t == 1:
            size = 2048 + 2
            # only a handful of members actually submitted — the
            # declared size alone makes it unschedulable as a gang
            for i in range(4):
                world.submit(self._gang_pod(rng, f"oversize-t{t}", size, i))
        for i in range(max(2, int(self.n_nodes * self.intensity / 8))):
            world.submit(_mk_pod(rng, f"gangfill-t{t}-{i}"))


# ---- chaos programs (sim/faults.py) ---------------------------------------
#
# Each chaos scenario is steady traffic PLUS a deterministic FaultPlan
# on the virtual clock: the run must keep scheduling through the fault
# windows (bounded degraded cycles, never a stall) and END fully
# recovered — every degradation-ladder rung back at top, both breakers
# closed — with the journal replay-pinned like every clean scenario.
# The breaker knobs are tightened so open -> half-open -> closed fits
# inside a handful of virtual ticks.

_CHAOS_BREAKER = {
    "breaker_failure_threshold": 2,
    "breaker_recovery_window_s": 3.0,
}


class ChaosScenario(Scenario):
    """Shared chaos shape: a steady half-intensity trickle every tick
    (including the calm recovery tail — recovery probes need traffic
    to ride), with the fault program declared in `windows()`."""

    chaos = True
    ticks = 18

    def windows(self) -> tuple:
        raise NotImplementedError

    def fault_plan(self):
        from kubernetes_scheduler_tpu_torch.sim.faults import FaultPlan

        return FaultPlan(self.windows())

    def tick(self, t: int, world: ScenarioWorld, rng) -> None:
        n = max(2, int(self.n_nodes * self.intensity / 2))
        for i in range(n):
            world.submit(_mk_pod(rng, f"{self.name}-t{t}-{i}"))


def _w(boundary, kind, start, end, **kw):
    from kubernetes_scheduler_tpu_torch.sim.faults import FaultWindow

    return FaultWindow(
        boundary=boundary, kind=kind, start=float(start), end=float(end),
        **kw,
    )


class AdvisorOutageScenario(ChaosScenario):
    """Prometheus dies for 8 virtual seconds: the stale-TTL grace mode
    serves last-good utilization (marked) until the TTL expires, then
    the window-requeue outage path takes over with backoff-paced
    retries; the advisor breaker opens and recovers by probe."""

    name = "advisor-outage"
    description = "advisor down past the stale TTL; grace then requeue"
    ticks = 18
    smoke = True
    config_overrides = {"advisor_stale_ttl_s": 4.0, **_CHAOS_BREAKER}

    def windows(self):
        return (_w("advisor", "error", 3, 11),)


class SidecarCrashRestartScenario(ChaosScenario):
    """The engine process crashes and restarts: in-window dispatches
    fail to the scalar path, the restarted engine lost its retained
    resident state (full-resend recovery), and the ladder walks
    engine->local->remote and resident->full->resident."""

    name = "sidecar-crash-restart"
    description = "engine crash-restart; resident state re-learned"
    ticks = 16
    config_overrides = {
        "resident_state": True, "pipeline_depth": 1, **_CHAOS_BREAKER,
    }

    def windows(self):
        return (_w("engine", "error", 4, 6, detail="crash"),)


class RpcFlapScenario(ChaosScenario):
    """The engine path flaps (fails every other virtual second): the
    pipelined loop alternates device cycles with scalar fallbacks,
    the breaker opens on failing phases and recovers by half-open
    probe on good ones — the retry-storm shape the unified backoff
    exists to de-phase."""

    name = "rpc-flap"
    description = "engine RPCs flap; breaker + fallback churn"
    ticks = 18
    smoke = True
    config_overrides = {"pipeline_depth": 1, **_CHAOS_BREAKER}

    def windows(self):
        return (_w("engine", "flap", 3, 11, period=2),)


class DiskFullJournalScenario(ChaosScenario):
    """The flight-recorder disk fills for 6 virtual seconds: journal
    appends fail, the recorder counts drops and keeps the loop
    unharmed (never raises into a cycle), the delta chain re-anchors
    with a full snapshot after the gap, and the journal still
    replay-pins."""

    name = "disk-full-journal"
    description = "journal writes ENOSPC; recorder drops, loop unharmed"
    ticks = 14
    config_overrides = dict(_CHAOS_BREAKER)

    def windows(self):
        return (_w("journal", "error", 3, 9),)


class MirrorCorruptionScenario(ChaosScenario):
    """Silent mirror drift, injected: one cell of a mirror leaf is
    perturbed without dirtying its row — the bitwise verify cross-check
    (pinned to every emit here) must detect it, count
    mirror_verify_failures_total, resync with a full rebuild, and climb
    the mirror rung back."""

    name = "mirror-corruption"
    description = "mirror cell corrupted; verify detects and resyncs"
    ticks = 14
    corrupt_ticks = (4, 8)
    config_overrides = {
        "snapshot_mirror": True, "mirror_verify_interval": 1,
        **_CHAOS_BREAKER,
    }

    def windows(self):
        # the corruption itself goes through SnapshotMirror.
        # inject_corruption (tick below); the plan carries a marker
        # window so the run is audited as chaos
        return (_w("mirror", "corrupt", min(self.corrupt_ticks),
                   max(self.corrupt_ticks) + 1),)

    def tick(self, t: int, world: ScenarioWorld, rng) -> None:
        super().tick(t, world, rng)
        if t in self.corrupt_ticks:
            mirror = world.scheduler.mirror
            if mirror is not None:
                mirror.inject_corruption(leaf="net_up", row=t)


class CompoundStormScenario(ChaosScenario):
    """Everything at once: advisor flapping past the stale TTL, an
    engine crash-restart, an informer partition over a node failure,
    a full journal disk, added engine latency, and a mirror corruption
    — the composed-degradation case none of the single-fault paths
    exercise together. The gate: bounded degraded cycles, zero binding
    diffs on replay, and FULL recovery (every rung top, breakers
    closed) by scenario end."""

    name = "compound-storm"
    description = "advisor+engine+informer+journal+mirror faults at once"
    ticks = 22
    config_overrides = {
        "resident_state": True, "pipeline_depth": 1,
        "snapshot_mirror": True, "mirror_verify_interval": 1,
        "advisor_stale_ttl_s": 4.0, **_CHAOS_BREAKER,
    }

    def windows(self):
        return (
            _w("advisor", "flap", 3, 9, period=2),
            _w("engine", "error", 5, 7, detail="crash"),
            _w("informer", "partition", 6, 9),
            _w("journal", "error", 5, 8),
            _w("engine", "latency", 9, 11, latency_s=0.005),
            _w("mirror", "corrupt", 10, 11),
        )

    def tick(self, t: int, world: ScenarioWorld, rng) -> None:
        super().tick(t, world, rng)
        if t == 6 and world.nodes:
            # node failure INSIDE the informer partition: the mirror
            # learns about it only when the buffered events flush
            world.fail_node(world.nodes[0].name)
        if t == 12:
            for name in list(world.downed):
                world.restore_node(name)
        if t == 10:
            mirror = world.scheduler.mirror
            if mirror is not None:
                mirror.inject_corruption(leaf="net_up", row=3)


class ReplicaConflictStormScenario(Scenario):
    """2-replica fleet over the partitioned queue: partition-skew plus
    conflict storms (host/replica.py, the shipped replica-bind protocol).

    Two tenant namespaces are picked to land on partitions 0 and 1
    (queue.namespace_partition), with skewed traffic — 75% of arrivals
    on replica 0's partition, 25% on replica 1's — so the fleet drains
    an UNBALANCED workload. Every third tick is a conflict storm: a
    filler window of high-priority pods occupies replica 0's current
    cycle while mid-priority OVERLAP pods are submitted to BOTH
    replicas (FleetScenarioWorld.submit_overlap — the partition-handoff
    race). With pipeline_depth=1, replica 0 prefetches the overlap
    window while binding filler, replica 1 binds its overlap copies in
    the same round-robin round, and replica 0's prefetched binds then
    LOSE the bind-table CAS — bind_lose requeues, the 409 lands in the
    binder's drop arm, and the requeued copies retire via drop_bound on
    the next pop. Deterministic, so the per-replica journals replay-pin;
    the evidence gate is bind_conflicts > 0 with double_binds == 0 and
    every pod bound exactly once."""

    name = "replica-conflict-storm"
    description = (
        "2-replica partitioned fleet: skewed tenants + overlap-pod "
        "conflict storms resolved first-bind-wins"
    )
    ticks = 10
    smoke = True
    replicas = 2
    # small windows so a storm's filler fills exactly one cycle, ONE
    # window per cycle (deep-queue batching would swallow filler AND
    # overlap in one backlog pop), and the pipelined prefetch slot to
    # hold the overlap window across the round-robin round
    config_overrides = {
        "batch_window": 32,
        "pipeline_depth": 1,
        "max_windows_per_cycle": 1,
    }

    def __init__(self, **kw):
        super().__init__(**kw)
        from kubernetes_scheduler_tpu_torch.host.queue import namespace_partition

        # first tenant names landing on each partition, deterministically
        self.ns_by_partition = {}
        i = 0
        while len(self.ns_by_partition) < 2:
            ns = f"tenant-{i}"
            part = namespace_partition(ns, self.replicas)
            self.ns_by_partition.setdefault(part, ns)
            i += 1

    def _pod(self, rng, name, ns, prio):
        pod = _mk_pod(rng, name, labels={"scv/priority": str(prio)}, cpu=100)
        pod.namespace = ns
        return pod

    def tick(self, t: int, world: ScenarioWorld, rng) -> None:
        ns0 = self.ns_by_partition[0]
        ns1 = self.ns_by_partition[1]
        # partition skew: 75% of steady traffic on replica 0's tenant
        for i in range(12):
            world.submit(self._pod(rng, f"skew0-{t}-{i}", ns0, 0))
        for i in range(4):
            world.submit(self._pod(rng, f"skew1-{t}-{i}", ns1, 0))
        if t % 3 == 1:
            # conflict storm: filler occupies r0's current window so the
            # overlap pods land in its PREFETCHED window...
            for i in range(32):
                world.submit(self._pod(rng, f"filler-{t}-{i}", ns0, 10))
            # ...while the same overlap pods also enter r1's queue (the
            # handoff race) and bind there first — r0's prefetched copy
            # then loses the CAS
            for i in range(8):
                world.submit_overlap(
                    self._pod(rng, f"overlap-{t}-{i}", ns0, 5)
                )


class SoakScenario(Scenario):
    """A multi-hour soak compressed onto the virtual clock: TWO diurnal
    day cycles composed with periodic arrival bursts and node flaps —
    the traffic shape a long-lived deployment actually survives, run in
    minutes. This is what the trend gate (trace/trend.py) and the
    shadow scorer chew on: long enough for leak/drift slopes to mean
    something, rotated enough (config_overrides pins a small journal
    file size) that a live tailer crosses real file boundaries, and
    SLO-armed so the watchdog staying quiet is an assertable outcome
    (`make soak-smoke` checks slo_breaches == 0).
    """

    name = "soak"
    description = "compressed soak: diurnal x2 + bursts + node flaps"
    ticks = 48
    smoke = True
    config_overrides = {
        # force journal rotation during even a smoke-scale soak so the
        # shadow tailer's boundary-following is exercised end-to-end
        "trace_file_bytes": 1 << 16,
        # the watchdog is ARMED (not off) and expected to stay clean on
        # the virtual clock; a breach in a soak run is a finding. The
        # bound must clear the first-cycle kernel build even on a loaded
        # smoke machine (a colocated shadow doubles wall time) while
        # still catching a genuinely wedged cycle
        "cycle_slo_ms": 15000.0,
    }

    def tick(self, t: int, world: ScenarioWorld, rng) -> None:
        base = max(2, int(self.n_nodes * self.intensity / 2))
        # two compressed day cycles across the run
        phase = 2.0 * math.pi * t / max(1, self.ticks // 2)
        n = max(1, int(base * (0.6 - 0.4 * math.cos(phase))))
        # the final eighth is a COOL-DOWN: diurnal tail only, no bursts
        # or flaps, so the trend gate's queue-depth series measures
        # drain health (a backlog surviving the cool-down is a real
        # runaway) instead of aliasing the injection schedule
        cooldown = t >= self.ticks - max(2, self.ticks // 8)
        if t % 12 == 6 and not cooldown:
            n *= 6  # rollout-style burst on top of the curve
        for i in range(n):
            world.submit(_mk_pod(rng, f"soak-t{t}-{i}"))
        if cooldown:
            for name in list(world.downed):
                world.restore_node(name)
            return
        if t >= 4 and t % 8 == 4 and world.nodes:
            k = max(1, len(world.nodes) // 16)
            names = [
                world.nodes[int(j)].name
                for j in rng.choice(
                    len(world.nodes), size=min(k, len(world.nodes)),
                    replace=False,
                )
            ]
            for name in names:
                world.fail_node(name)
        if t % 8 == 6:
            for name in list(world.downed):
                world.restore_node(name)


SCENARIOS = {
    s.name: s
    for s in (
        DiurnalScenario,
        BurstScenario,
        NodeFlapScenario,
        SoakScenario,
        ZoneFailureScenario,
        AntiAffinityPackScenario,
        GangMixScenario,
        AdvisorOutageScenario,
        SidecarCrashRestartScenario,
        RpcFlapScenario,
        DiskFullJournalScenario,
        MirrorCorruptionScenario,
        CompoundStormScenario,
        ReplicaConflictStormScenario,
    )
}
