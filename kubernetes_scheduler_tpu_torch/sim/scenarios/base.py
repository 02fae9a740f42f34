"""Scenario harness: seeded, event-driven traffic programs over the host
loop.

A Scenario is a small deterministic program: the runner builds a
simulated cluster, then advances virtual time tick by tick — each tick
the scenario injects events (pod arrivals, node failures/returns,
utilization shifts) into the ScenarioWorld and the runner drains the
scheduler until it stops making progress. Everything downstream of the
seed is deterministic: the RNG is a single `np.random.default_rng(seed)`
stream, the queue runs on a virtual clock the runner advances one second
per tick (retry backoffs resolve in ticks, not wall time), and the
scheduler itself is single-threaded — so the same (scenario, seed,
scale) always produces the same journal, which is what lets every
scenario be REPLAY-PINNED: run it with `trace_path` set and
`trace replay` over the emitted journal must report zero binding diffs
(the scenario-smoke gate, and the diverse-traffic generator the
learned-policy ROADMAP item trains from).

Scenarios register by name in sim.scenarios.SCENARIOS (library.py) and
run via run_scenario() / run_scenario_replicated().

The port's copy of kubernetes_scheduler_tpu/sim/scenarios/base.py: both
runners take `device=` and build TorchEngine(device=device) (cuda unless
given) where the reference builds its LocalEngine; the same (scenario,
seed, scale) gives the reference's journal on the same decisions.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

from kubernetes_scheduler_tpu_torch.host.advisor import NodeUtil, StaticAdvisor
from kubernetes_scheduler_tpu_torch.host.scheduler import RecordingBinder, Scheduler
from kubernetes_scheduler_tpu_torch.host.types import Node, Pod
from kubernetes_scheduler_tpu_torch.utils.config import SchedulerConfig


class SimClock:
    """Deterministic stand-in for time.monotonic on the scheduling
    queue: the runner advances it one second per tick, so retry backoffs
    (initial 1s) resolve on the NEXT tick regardless of how fast the
    host machine drained the previous one."""

    def __init__(self):
        self.now = 0.0

    def __call__(self) -> float:
        return self.now

    def advance(self, dt: float = 1.0) -> None:
        self.now += dt


@dataclass
class ScenarioWorld:
    """The mutable cluster a scenario program acts on. All state changes
    go through these methods so the summary counters stay truthful."""

    nodes: list
    utils: dict
    scheduler: Scheduler
    running: list = field(default_factory=list)
    downed: dict = field(default_factory=dict)   # name -> Node
    submitted: int = 0
    resubmitted: int = 0
    node_failures: int = 0
    node_restores: int = 0
    # chaos runs (sim/faults.InformerGate): mirror-bound event delivery
    # routed through the informer-stream fault boundary — partitions
    # buffer, errors drop, everything else passes through
    informer_gate: object = None
    _seen_bindings: int = 0

    def submit(self, pod: Pod) -> None:
        self.submitted += 1
        self.scheduler.submit(pod)

    def _deliver(self, apply, *args) -> None:
        """One informer-style event delivery, through the fault gate
        when a chaos plan installed one."""
        if self.informer_gate is not None:
            self.informer_gate.deliver(apply, *args)
        else:
            apply(*args)

    def _mirror(self):
        """The scheduler's snapshot mirror when streaming ingestion is
        on (config.snapshot_mirror) — ScenarioWorld plays the informer's
        role then, delivering node/pod events instead of relying on the
        per-cycle list reads the mirror replaced. Bind events need no
        delivery: the scheduler self-applies its own binds."""
        return getattr(self.scheduler, "mirror", None)

    def fail_node(self, name: str) -> int:
        """Remove a node mid-run; its running pods are killed and
        resubmitted (the informer would deliver exactly this as a node
        delete + pod deletes + controller re-creates). Returns how many
        pods went back to the queue."""
        nd = next((n for n in self.nodes if n.name == name), None)
        if nd is None:
            return 0
        self.nodes.remove(nd)
        self.downed[name] = nd
        self.node_failures += 1
        mirror = self._mirror()
        if mirror is not None:
            self._deliver(mirror.apply_node_event, "DELETED", nd)
        displaced = [p for p in self.running if p.node_name == name]
        for pod in displaced:
            self.running.remove(pod)
            if mirror is not None:
                # the pod DELETE the informer would stream; the
                # controller's re-create is the submit below
                self._deliver(mirror.apply_pod_event, "DELETED", pod)
            pod.node_name = None
            self.resubmitted += 1
            self.scheduler.submit(pod)
        return len(displaced)

    def restore_node(self, name: str) -> bool:
        nd = self.downed.pop(name, None)
        if nd is None:
            return False
        self.nodes.append(nd)
        self.node_restores += 1
        mirror = self._mirror()
        if mirror is not None:
            self._deliver(mirror.apply_node_event, "ADDED", nd)
        return True

    def absorb_bindings(self) -> None:
        """Fold this drain's binds into the running set (what the
        informer's pod cache would reflect next cycle)."""
        binder = self.scheduler.binder
        for b in binder.bindings[self._seen_bindings:]:
            self.running.append(b.pod)
        self._seen_bindings = len(binder.bindings)


class Scenario:
    """One registered traffic program. Subclasses set `name`,
    `description`, optionally `smoke` (cheap enough for the
    scenario-smoke gate) and override build_cluster()/tick(). Chaos
    programs additionally set `chaos = True`, declare their
    SchedulerConfig knobs in `config_overrides`, and return a
    sim/faults.FaultPlan from fault_plan() — the runner then wraps the
    advisor/engine/journal boundaries and gates informer delivery, and
    the summary grows the recovery audit (degraded cycle counts,
    breaker states, ladder rungs, injected-fault counts, `recovered`).
    Replicated programs set `replicas` > 1 — scenarios.run then routes
    to run_scenario_replicated (a ReplicaFleet over the partitioned
    queue) and ticks receive a FleetScenarioWorld."""

    name = "?"
    description = ""
    ticks = 12
    smoke = False
    # chaos programs: deterministic fault injection rides this run
    chaos = False
    # replicated programs: N schedulers over a partitioned queue
    replicas = 1
    # SchedulerConfig overrides merged into scenario_config() when the
    # caller passes no explicit config (chaos programs pin the modes
    # their fault plan targets: mirror on, resident on, stale TTL, ...)
    config_overrides: dict = {}

    def fault_plan(self):
        """The sim/faults.FaultPlan for this program (None = no
        injection — every pre-chaos scenario)."""
        return None

    def __init__(self, *, n_nodes: int = 64, intensity: float = 1.0):
        self.n_nodes = int(n_nodes)
        self.intensity = float(intensity)

    # -- cluster -------------------------------------------------------

    def build_cluster(self, rng) -> tuple[list, dict]:
        """(nodes, utils) — zone-labeled by default so zone/affinity
        scenarios work against any cluster this base builds."""
        from kubernetes_scheduler_tpu_torch.sim.scenarios.library import ZONES

        nodes, utils = [], {}
        for i in range(self.n_nodes):
            name = f"node-{i}"
            nodes.append(
                Node(
                    name=name,
                    labels={
                        "topology.kubernetes.io/zone": ZONES[i % len(ZONES)]
                    },
                    allocatable={
                        "cpu": float(rng.choice([4000, 8000, 16000])),
                        "memory": float(rng.choice([8, 16, 32])) * 2**30,
                        "pods": 110.0,
                    },
                )
            )
            utils[name] = NodeUtil(
                cpu_pct=float(rng.uniform(5, 70)),
                mem_pct=float(rng.uniform(5, 70)),
                disk_io=float(min(rng.gamma(2.0, 8.0), 50.0)),
                net_up=float(rng.gamma(2.0, 2.0)),
                net_down=float(rng.gamma(2.0, 2.0)),
            )
        return nodes, utils

    # -- per-tick program ----------------------------------------------

    def tick(self, t: int, world: ScenarioWorld, rng) -> None:
        raise NotImplementedError


def scenario_config(overrides: dict | None = None) -> SchedulerConfig:
    """The harness's SchedulerConfig: the device path pinned (tiny
    simulated cycles must not route to the scalar fallback — scalar
    cycles record decisions but are not replayable, and the whole point
    of a scenario is a replayable journal)."""
    base = dict(
        batch_window=256,
        normalizer="none",
        min_device_work=1,
        adaptive_dispatch=False,
    )
    base.update(overrides or {})
    return SchedulerConfig(**base)


def run_scenario(
    scenario: Scenario,
    *,
    seed: int = 0,
    trace_path: str | None = None,
    span_path: str | None = None,
    config: SchedulerConfig | None = None,
    max_cycles_per_tick: int = 64,
    faults: bool = True,
    device=None,
) -> dict:
    """Drive `scenario` through the host loop on TorchEngine(device); returns the summary dict
    (one JSON-able line). With `trace_path`, every cycle lands in a
    flight-recorder journal replay-pinnable via `trace replay`; with
    `span_path`, every cycle emits its span timeline too, so an
    adversarial program produces attribution data (`spans report`) the
    same way a production run does."""
    rng = np.random.default_rng(seed)
    nodes, utils = scenario.build_cluster(rng)
    cfg = (
        config
        if config is not None
        else scenario_config(dict(scenario.config_overrides))
    )
    if (trace_path is not None and cfg.trace_path is None) or (
        span_path is not None and cfg.span_path is None
    ):
        import dataclasses

        cfg = dataclasses.replace(
            cfg,
            trace_path=cfg.trace_path or trace_path,
            span_path=cfg.span_path or span_path,
        )
    clock = SimClock()
    # chaos plan (sim/faults.py): wrap the boundaries the Scheduler/CLI
    # already own — advisor fetch, engine dispatch, journal writes —
    # and gate the world's informer-style event delivery. Everything
    # keys off the virtual clock, so the same (scenario, seed) injects
    # the same faults at the same ticks and the journal replay-pins.
    plan = scenario.fault_plan() if faults else None
    injector = None
    gate = None
    advisor = StaticAdvisor(utils)
    from kubernetes_scheduler_tpu_torch.engine import TorchEngine

    engine = TorchEngine(device=device)
    if plan is not None and plan.windows:
        from kubernetes_scheduler_tpu_torch.sim.faults import (
            FaultInjector,
            FaultyAdvisor,
            FaultyEngine,
            InformerGate,
        )

        injector = FaultInjector(plan, clock)
        advisor = FaultyAdvisor(advisor, injector)
        engine = FaultyEngine(engine, injector)
        gate = InformerGate(injector)
    world = ScenarioWorld(nodes=nodes, utils=utils, scheduler=None)
    sched = Scheduler(
        cfg,
        advisor=advisor,
        binder=RecordingBinder(),
        engine=engine,
        list_nodes=lambda: world.nodes,
        list_running_pods=lambda: world.running,
        queue_clock=clock,
    )
    world.scheduler = sched
    world.informer_gate = gate
    if injector is not None:
        injector.wrap_journal(sched.recorder)

    t0 = time.perf_counter()
    cycles = 0
    try:
        for t in range(scenario.ticks):
            if gate is not None:
                # a closed partition window flushes its buffered events
                # at the tick boundary (the re-established watch)
                gate.flush()
            scenario.tick(t, world, rng)
            clock.advance(1.0)
            for _ in range(max_cycles_per_tick):
                if len(sched.queue) == 0 and sched._prefetched is None:
                    break
                m = sched.run_cycle()
                cycles += 1
                world.absorb_bindings()
                if m.pods_bound == 0:
                    # no progress: everything left is backoff-parked or
                    # a deferred gang waiting for members — both need
                    # the clock to advance, i.e. the next tick
                    break
        if gate is not None:
            gate.flush()
        sched.drain_pipeline()
    finally:
        if sched.recorder is not None:
            sched.recorder.close()
        if sched.spans is not None:
            sched.spans.close()
    dt = time.perf_counter() - t0
    totals = sched.totals
    out = {
        "scenario": scenario.name,
        "seed": seed,
        "n_nodes": scenario.n_nodes,
        "ticks": scenario.ticks,
        "cycles": cycles,
        "pods_submitted": world.submitted,
        "pods_resubmitted": world.resubmitted,
        "pods_bound": totals["pods_bound"],
        "pods_unschedulable": totals["pods_unschedulable"],
        "node_failures": world.node_failures,
        "node_restores": world.node_restores,
        "fallback_cycles": totals["fallback_cycles"],
        "gangs_admitted": totals["gangs_admitted"],
        "gangs_deferred": totals["gangs_deferred"],
        "gang_pods_masked": totals["gang_pods_masked"],
        "delta_uploads": totals["delta_uploads"],
        "full_uploads": totals["full_uploads"],
        "seconds": round(dt, 3),
        "pods_per_sec": round(totals["pods_bound"] / max(dt, 1e-9), 1),
        # resilience audit (host/resilience.py): how degraded the run
        # got, whether it climbed all the way back, and what the
        # breakers did — the chaos-scenario recovery gate reads these
        "fetch_failures": totals["fetch_failures"],
        "advisor_stale_cycles": totals["advisor_stale_cycles"],
        "degraded_cycles": totals["degraded_cycles"],
        "breaker_state": sched.engine_breaker.state(),
        "breaker_transitions": dict(sched.engine_breaker.transition_counts),
        "advisor_breaker_state": sched.advisor_breaker.state(),
        "degradation_rungs": {
            sub: info["rung"]
            for sub, info in sched.ladder.snapshot().items()
            if info["depth"] > 0
        },
        "recovered": (
            sched.ladder.fully_recovered()
            and sched.engine_breaker.state() == "closed"
            and sched.advisor_breaker.state() == "closed"
        ),
        # SLO watchdog verdict (config.cycle_slo_ms): a soak run asserts
        # the armed watchdog stayed QUIET — "watchdog clean" is an
        # outcome, not the absence of instrumentation
        "slo_breaches": int(getattr(sched, "slo_breaches", 0)),
    }
    if sched.recorder is not None:
        out["trace_records_dropped"] = sched.recorder.records_dropped
    if sched.mirror is not None:
        out["mirror_full_rebuilds"] = int(sched.mirror.ctr_rebuilds.total())
        out["mirror_rebuild_reasons"] = {
            key[0]: int(n)
            for key, n in sorted(sched.mirror.ctr_rebuilds.breakdown().items())
        }
        out["mirror_verify_failures"] = int(
            sched.mirror.ctr_verify_failures.value()
        )
    if injector is not None:
        out["faults_injected"] = injector.summary()
        if gate is not None:
            out["informer_events_dropped"] = gate.dropped
    if trace_path is not None:
        out["journal"] = trace_path
    if span_path is not None:
        out["spans"] = span_path
    return out


class FleetScenarioWorld(ScenarioWorld):
    """ScenarioWorld over a ReplicaFleet: submissions route to their
    partition's replica (or to SEVERAL replicas via submit_overlap —
    the partition-handoff race the replica-bind protocol resolves), and
    absorb_bindings folds every replica's recorded binds. Node-failure
    chaos is not wired for fleets yet (`scheduler` stays None so a
    fleet scenario reaching for it fails loudly, not silently)."""

    def __init__(self, *, nodes, utils, fleet=None):
        super().__init__(nodes=nodes, utils=utils, scheduler=None)
        self.fleet = fleet
        self._seen_per: list[int] = []

    def attach(self, fleet) -> None:
        self.fleet = fleet
        self._seen_per = [0] * fleet.n_replicas

    def submit(self, pod: Pod) -> None:
        self.submitted += 1
        self.fleet.submit(pod)

    def submit_overlap(self, pod: Pod, replicas=None) -> None:
        """The conflict generator: the SAME pod lands in several
        replicas' queues (membership churn re-homing a namespace while
        the old owner still holds queued copies). Counted once — it is
        one pod, however many queues transiently hold it."""
        self.submitted += 1
        self.fleet.submit_overlap(pod, replicas)

    def absorb_bindings(self) -> None:
        for i, sched in enumerate(self.fleet.schedulers):
            bindings = sched.binder.bindings
            for b in bindings[self._seen_per[i]:]:
                self.running.append(b.pod)
            self._seen_per[i] = len(bindings)


def run_scenario_replicated(
    scenario: Scenario,
    *,
    seed: int = 0,
    trace_path: str | None = None,
    span_path: str | None = None,
    config: SchedulerConfig | None = None,
    max_cycles_per_tick: int = 64,
    faults: bool = True,
    device=None,
) -> dict:
    """run_scenario for `scenario.replicas` > 1, on TorchEngines on
    `device`: N full Schedulers over
    one PartitionedQueue + BindTable (host/replica.ReplicaFleet), drained
    in deterministic ROUND-ROBIN — one cycle per live replica per round,
    single-threaded on the shared virtual clock, so the same (scenario,
    seed, scale) produces the same per-replica journals every run and
    each journal replay-pins independently (`trace replay <dir>/r0`).

    Round-robin at cycle granularity plus the pipelined prefetch slot is
    what makes conflicts REAL here: with pipeline_depth=1 a replica pops
    its next window while its current one binds, so an overlap pod can
    sit popped-but-unbound on replica A across the round in which
    replica B binds its copy — A's bind then loses the CAS (bind_lose:
    requeue + 409-drop), and A's next pop retires the requeued copy via
    drop_bound. The exact interleaving the model checks, produced
    deterministically."""
    del faults  # fleet scenarios carry no fault plan yet
    rng = np.random.default_rng(seed)
    nodes, utils = scenario.build_cluster(rng)
    cfg = (
        config
        if config is not None
        else scenario_config(dict(scenario.config_overrides))
    )
    if (trace_path is not None and cfg.trace_path is None) or (
        span_path is not None and cfg.span_path is None
    ):
        import dataclasses

        cfg = dataclasses.replace(
            cfg,
            trace_path=cfg.trace_path or trace_path,
            span_path=cfg.span_path or span_path,
        )
    from kubernetes_scheduler_tpu_torch.host.replica import ReplicaFleet

    clock = SimClock()
    advisor = StaticAdvisor(utils)
    world = FleetScenarioWorld(nodes=nodes, utils=utils)
    fleet = ReplicaFleet(
        cfg,
        n_replicas=scenario.replicas,
        advisor_factory=lambda i: advisor,
        list_nodes=lambda: world.nodes,
        list_running_pods=lambda: world.running,
        queue_clock=clock,
        device=device,
    )
    world.attach(fleet)

    t0 = time.perf_counter()
    cycles = 0
    try:
        for t in range(scenario.ticks):
            scenario.tick(t, world, rng)
            clock.advance(1.0)
            for _ in range(max_cycles_per_tick):
                progressed = False
                active = False
                if fleet.engine_pool is not None:
                    # shared engine: split-phase round — dispatch EVERY
                    # live replica before the first force, so the whole
                    # round's windows coalesce into one device
                    # invocation (the deterministic round-robin
                    # equivalent of the timing a threaded fleet gets)
                    live = [
                        s for s in fleet.schedulers
                        if len(s.queue) > 0 or s._prefetched is not None
                    ]
                    if live:
                        active = True
                        handles = [s.run_cycle_split() for s in live]
                        for h in handles:
                            m = h.complete()
                            cycles += 1
                            world.absorb_bindings()
                            if m.pods_bound > 0 or m.pods_dropped > 0:
                                progressed = True
                else:
                    for sched in fleet.schedulers:
                        if len(sched.queue) == 0 and sched._prefetched is None:
                            continue
                        active = True
                        m = sched.run_cycle()
                        cycles += 1
                        world.absorb_bindings()
                        # a conflict cycle binds 0 but DROPS its fenced
                        # copies — that is progress (the queue shrank)
                        if m.pods_bound > 0 or m.pods_dropped > 0:
                            progressed = True
                if not active or not progressed:
                    break
        for sched in fleet.schedulers:
            sched.drain_pipeline()
            world.absorb_bindings()
    finally:
        for sched in fleet.schedulers:
            if sched.recorder is not None:
                sched.recorder.close()
            if sched.spans is not None:
                sched.spans.close()
    dt = time.perf_counter() - t0

    def _total(key):
        return sum(s.totals[key] for s in fleet.schedulers)

    evidence = fleet.evidence()
    out = {
        "scenario": scenario.name,
        "seed": seed,
        "n_nodes": scenario.n_nodes,
        "ticks": scenario.ticks,
        "replicas": scenario.replicas,
        "cycles": cycles,
        "pods_submitted": world.submitted,
        "pods_resubmitted": world.resubmitted,
        "pods_bound": _total("pods_bound"),
        "pods_unschedulable": _total("pods_unschedulable"),
        "pods_dropped": _total("pods_dropped"),
        "fallback_cycles": _total("fallback_cycles"),
        "gangs_admitted": _total("gangs_admitted"),
        "gangs_deferred": _total("gangs_deferred"),
        "seconds": round(dt, 3),
        "pods_per_sec": round(_total("pods_bound") / max(dt, 1e-9), 1),
        # the replica-bind evidence: conflicts RESOLVED, zero double
        # binds, every overlap pod bound exactly once somewhere
        "binds_per_replica": evidence["binds_per_replica"],
        "bind_conflicts": evidence["bind_conflicts_total"],
        "pods_discarded": evidence["pods_discarded"],
        "double_binds": evidence["double_binds"],
        "requeue_latency_mean_s": round(
            evidence["requeue_latency_mean_s"], 3
        ),
        "recovered": all(
            s.ladder.fully_recovered() for s in fleet.schedulers
        ),
    }
    if "shared_engine" in evidence:
        # fleet-shared engine evidence: dispatch coalescing + upload
        # dedupe (the replica-smoke --shared-engine leg asserts on these)
        out["shared_engine"] = evidence["shared_engine"]
    if trace_path is not None:
        out["journal"] = trace_path
        out["journals"] = [
            f"{trace_path}/r{i}" for i in range(scenario.replicas)
        ]
    if span_path is not None:
        out["spans"] = span_path
    return out
