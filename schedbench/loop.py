"""One run of one cell: the program's deployed host loop driven by a traffic mix.

The measured path is kubernetes_scheduler_tpu_torch.host.scheduler.
Scheduler.run_cycle() over its default engine (TorchEngine on the card):
queue pop, the snapshot mirror, the engine (schedule_windows, K1, K3 or
the affinity auction) and the binds. The harness plays the cluster around
it: it creates pods (the informer's submit), and after each cycle deletes
the oldest running pods so the cluster stays at the configuration's
running count (the informer's pod DELETED event into the mirror, and the
list `list_running_pods` returns).

Everything the reference needs is recorded here as plain arrays: the
cluster draws, each pod's diskIO and class, and per cycle the pods bound
(with their nodes), the pods left unschedulable and the pods deleted. Of
the program's arrays only one output is kept, for the reference to judge:
the engine's masked, min-max scaled score matrix of the window's last
engine window, with the pods of its rows in the order the host loop
handed them to the engine: the scores and feasibility the engine hands
its assigner (engine.finish_cycle), NEG where infeasible. Under the live
policy that is K1's output (ops.fused.masked_score).

The pods a run creates are built before the window (the closed backlog's
pool), so the window times the program's submit of each, not their
construction.

Under a configuration whose `scheduler` block sets "preemption": true
(traffic of kind preemption_backlog), the harness also plays the API
server's side of the program's preemption pass: the Scheduler gets an
evictor that only records each eviction (cycle, victim, preemptor,
node), the binder stamps each pod's start time (the kubelet's
status.startTime), and once the cycle has returned the harness kills
the victims with grace period 0: they leave list_running_pods and their
DELETED events go into the mirror (stage schedbench.evict), and they are
recorded beside the cycle's deletions for the reference.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import gc
import time
from dataclasses import dataclass, field

import numpy as np

from schedbench.gen import traffic as traffic_gen
from schedbench.gen.cluster import (
    CARD_METRICS,
    HOSTNAME,
    STREAM_COMPLETIONS,
    PodSource,
    class_priorities,
    draw_cluster,
    init_template,
    pod_classes,
    pod_priority,
    rng,
)

# cycles allowed to place the running pods the cell starts with
SETUP_CYCLES = 32
# warm-up cycles of the cell's own traffic before the window
WARMUP_CYCLES = 2
# how long set-up sleeps after a cycle that popped nothing (backoff)
SETUP_SLEEP_S = 0.002
# preemption_backlog: how long set-up waits past max_backoff_seconds for
# the next running pod to be placed before it fails
SETUP_STALL_S = 5.0


@dataclass
class CycleRecord:
    phase: str               # "setup", "warmup" or "window"
    t0: float                # perf_counter at the cycle's start
    t1: float                # perf_counter at the cycle's end
    metrics: object          # the program's CycleMetrics
    bound_pids: np.ndarray   # [b] int64 pods bound by the cycle
    bound_nodes: np.ndarray  # [b] int64 their node indices (-1: unknown name)
    deleted_pids: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    # [u] int64 pods the cycle requeued as unschedulable
    unsched_pids: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    # [e, 3] int64 the program's evictions, in the order it made them:
    # victim, preemptor, the victim's node index; the victims killed are
    # also in deleted_pids
    evicted: np.ndarray = field(default_factory=lambda: np.zeros((0, 3), np.int64))
    evicted_at: np.ndarray = field(default_factory=lambda: np.zeros(0))  # [e] time.monotonic()
    m0: float = 0.0          # time.monotonic() at the cycle's start


@dataclass
class Records:
    """What a run leaves for the metrics and the reference."""

    config: dict
    traffic: dict
    seed: int
    cluster: object
    cycles: list = field(default_factory=list)
    submitted: int = 0                     # pod ids handed out to submitted pods
    pod_io: np.ndarray | None = None       # [submitted] diskIO by pod id
    pod_init: np.ndarray | None = None     # [submitted] bool: the running pods set-up placed
    pod_class: np.ndarray | None = None    # [submitted] int64 index into pod.classes
    pod_priority: np.ndarray | None = None  # [submitted] int64 the queue's priority of each pod
    pod_from_init: np.ndarray | None = None  # [submitted] bool: made from init_pod (None without it)
    pod_start: np.ndarray | None = None    # [submitted] float64 start time stamped at bind, NaN none
    pod_made: np.ndarray | None = None     # [submitted] bool: submitted (None: every id)
    queued_at_end: int = 0                 # len(queue) once the window closed
    window_submitted: int = 0              # pods submitted inside the window
    pool_short: int = 0                    # pods the window built, the pool spent
    k1: dict | None = None                 # the engine's last window: cycle, window, out, pids
    window_t0: float = 0.0
    window_t1: float = 0.0
    seconds: float = 0.0                   # the window's asked length
    batch_window: int = 1024
    effective_config: dict = field(default_factory=dict)
    stages: list = field(default_factory=list)   # [(name, t0, t1)] harness stages

    def window(self) -> list:
        return [c for c in self.cycles if c.phase == "window"]


class ClusterBinder:
    """The cluster's side of a binding (the Binding POST): sets the pod's
    node and keeps (pod id, node index) pairs, not the pods, so a bound
    pod is freed once the cluster deletes it. With `stamp` it also sets
    each pod's start time (the kubelet's status.startTime, in whole
    seconds as the API carries it) and keeps it by pod id in `start`."""

    def __init__(self, node_index: dict, *, stamp: bool = False):
        self._index = node_index
        self.start: dict | None = {} if stamp else None
        self.pids: list = []
        self.nodes: list = []
        self.last: list = []     # the pods of the latest calls, until taken

    def bind(self, pod, node_name: str) -> None:
        self.bind_many([pod], [node_name])

    def bind_many(self, pods: list, node_names: list) -> None:
        idx = self._index
        for pod, nm in zip(pods, node_names):
            pod.node_name = nm
            self.pids.append(int(pod.name[1:]))
            self.nodes.append(idx.get(nm, -1))
        if self.start is not None:
            now = float(int(time.time()))
            for pod in pods:
                pod.start_time = now
                self.start[int(pod.name[1:])] = now
        self.last.extend(pods)

    def take(self) -> tuple:
        """(pods, pod ids, node indices) bound since the last call."""
        pods, self.last = self.last, []
        pids = np.asarray(self.pids, np.int64)
        nodes = np.asarray(self.nodes, np.int64)
        self.pids, self.nodes = [], []
        return pods, pids, nodes


class HarnessEvictor:
    """The cluster's side of the program's evictions (the victim's DELETE):
    `evict` only records (victim, preemptor, time.monotonic()), since the
    program calls it inside run_cycle; the harness kills the victims once
    the cycle has returned."""

    def __init__(self):
        self.log: list = []

    def evict(self, victim, *, preemptor) -> None:
        self.log.append((victim, preemptor, time.monotonic()))

    def take(self) -> list:
        """The evictions recorded since the last call."""
        out, self.log = self.log, []
        return out


def node_cards(types, cluster, i: int) -> list:
    """The program's types.Card list of node `i` ([] without cards)."""
    if cluster.cards is None:
        return []
    return [
        types.Card(**dict(zip(CARD_METRICS, map(float, cluster.cards[i, j]))),
                   health="Healthy" if cluster.card_healthy[i, j] else "Unhealthy")
        for j in range(cluster.cards.shape[1])
    ]


def _program():
    """The program's host types, imported when a run starts."""
    from kubernetes_scheduler_tpu_torch.host import advisor, scheduler, types
    from kubernetes_scheduler_tpu_torch.utils import config

    return advisor, scheduler, types, config


# ---- the cluster of each traffic kind (gen/traffic.py names their keys) ----


class ClosedBacklog:
    """closed_backlog's cluster: the pending pods are refilled to the
    backlog before each cycle, and after it the oldest running pods are
    deleted down to the configuration's running count (completions)."""

    evicts = False

    def __init__(self, run: "CellRun"):
        self.run = run
        self.running = collections.deque()   # bound pods, oldest first

    def list_running(self) -> list:
        return list(self.running)

    def placed(self) -> int:
        """Running pods of the kind set-up places."""
        return len(self.running)

    def build_pool(self, count: int) -> None:
        """Pods of the kind's own to build beside the pool: none."""

    def refill(self) -> None:
        run = self.run
        run.submit(run.pool_pods(traffic_gen.refill_count(run.traffic, len(run.sched.queue))))

    def bound(self, pods) -> None:
        self.running.extend(pods)

    def setup(self) -> None:
        """Set-up's cycles: at most SETUP_CYCLES, until the running set is
        placed."""
        run = self.run
        for _ in range(SETUP_CYCLES):
            if len(self.running) >= run.hold:
                break
            rec = run.cycle("setup")
            if not rec.metrics.pods_in:
                time.sleep(SETUP_SLEEP_S)

    def after_cycle(self, rec: CycleRecord) -> None:
        """Delete the oldest running pods down to the held count."""
        run = self.run
        extra = len(self.running) - run.hold
        if extra <= 0:
            return
        t0 = time.perf_counter()
        mirror = run.sched.mirror
        gone = np.empty(extra, np.int64)
        for k in range(extra):
            pod = self.running.popleft()
            gone[k] = int(pod.name[1:])
            if mirror is not None:
                mirror.apply_pod_event("DELETED", pod)
        rec.deleted_pids = gone
        run.rec.stages.append(("schedbench.delete", t0, time.perf_counter()))

    def finish(self, r: Records) -> None:
        """The pods that exist for the cluster: the pool's pods never
        submitted, the last ids handed out, do not."""
        r.submitted = self.run.pods.count - len(self.run.pool)


class PreemptionBacklog:
    """preemption_backlog's cluster: a running set of init_pod's priority;
    before each cycle the pod template's pending pods are refilled to the
    backlog (and, with recreate_victims, the victims killed since the last
    refill come back as pods of init_pod); after it the program's victims
    are killed, then the pod template's oldest running pods beyond
    held_pods are deleted (completions)."""

    evicts = True

    def __init__(self, run: "CellRun"):
        if run.init is None:
            raise ValueError("traffic of kind preemption_backlog needs the configuration's init_pod")
        self.run = run
        self.recreate = bool(run.traffic["recreate_victims"])
        self.live = collections.OrderedDict()   # every running pod by id, in bind order
        self.held = collections.deque()  # the pod template's, oldest first; killed ones skipped
        self.held_live = 0       # the pod template's pods running
        self.init_live = 0       # init_pod's pods running
        self.pending = 0         # the pod template's pods submitted, not bound
        self.killed = 0          # victims killed since the last refill
        self.init_pool = None    # init_pod's pods built ahead (recreate_victims)

    def list_running(self) -> list:
        return list(self.live.values())

    def placed(self) -> int:
        return self.init_live

    def build_pool(self, count: int) -> None:
        """With recreate_victims, as many pods of init_pod as the pool
        holds of pod's."""
        if self.recreate:
            self.init_pool = collections.deque(self.run.make_init() for _ in range(count))

    def refill(self) -> None:
        run = self.run
        count = traffic_gen.refill_count(run.traffic, self.pending)
        self.pending += count
        pods = run.pool_pods(count)
        if self.killed:
            pods += run.from_pool(self.init_pool, self.killed, run.make_init)
            self.killed = 0
        run.submit(pods)

    def bound(self, pods) -> None:
        init = self.run.init_ids
        for pod in pods:
            pid = int(pod.name[1:])
            self.live[pid] = pod
            if pid in init:
                self.init_live += 1
            else:
                self.held.append(pod)
                self.held_live += 1
                self.pending -= 1

    def setup(self) -> None:
        """Set-up's cycles, each settled: the running set can fill its nodes
        to the last pod, so where SETUP_CYCLES fall short set-up goes on
        through the program's backoff, until the running set is placed or
        no pod was placed for max_backoff_seconds + SETUP_STALL_S."""
        run = self.run
        stall = float(run.sched_config.max_backoff_seconds) + SETUP_STALL_S
        last, placed = time.perf_counter(), self.init_live
        while placed < run.hold:
            rec = run.cycle("setup")
            self.after_cycle(rec)
            now = time.perf_counter()
            if self.init_live > placed:
                last, placed = now, self.init_live
            elif now - last > stall:
                return
            if not rec.metrics.pods_in:
                time.sleep(SETUP_SLEEP_S)

    def gone(self, pid: int) -> object | None:
        """Take pod `pid` off the running set (None where it is not
        running) and send its DELETED event to the mirror."""
        pod = self.live.pop(pid, None)
        if pod is None:
            return None
        if pid in self.run.init_ids:
            self.init_live -= 1
        else:
            self.held_live -= 1
        if self.run.sched.mirror is not None:
            self.run.sched.mirror.apply_pod_event("DELETED", pod)
        return pod

    def after_cycle(self, rec: CycleRecord) -> None:
        """Kill the program's victims, then delete the pod template's
        oldest pods beyond held_pods."""
        run = self.run
        killed = self.kill(rec)
        t0 = time.perf_counter()
        extra = self.held_live - int(run.traffic["held_pods"])
        gone = []
        while extra > 0 and self.held:
            pid = int(self.held.popleft().name[1:])
            if self.gone(pid) is not None:
                gone.append(pid)
                extra -= 1
        if gone:
            run.rec.stages.append(("schedbench.delete", t0, time.perf_counter()))
        rec.deleted_pids = np.concatenate([killed, np.asarray(gone, np.int64)])

    def kill(self, rec: CycleRecord) -> np.ndarray:
        """The evictions the program made in the cycle, played out with
        grace period 0: each victim leaves the running set and its DELETED
        event goes into the mirror; records them on `rec` and returns the
        ids of the pods killed (a victim named twice dies once)."""
        run = self.run
        taken = run.evictor.take()
        if not taken:
            return np.zeros(0, np.int64)
        t0 = time.perf_counter()
        rows = np.empty((len(taken), 3), np.int64)
        killed = []
        for k, (victim, preemptor, _) in enumerate(taken):
            vid = int(victim.name[1:])
            rows[k] = vid, int(preemptor.name[1:]), run.node_index.get(victim.node_name, -1)
            if self.gone(vid) is not None:
                killed.append(vid)
        rec.evicted = rows
        rec.evicted_at = np.asarray([t for *_, t in taken], np.float64)
        if self.recreate:
            self.killed += len(killed)
        run.rec.stages.append(("schedbench.evict", t0, time.perf_counter()))
        return np.asarray(killed, np.int64)

    def finish(self, r: Records) -> None:
        """The pods that exist for the cluster: with two pools, the ids left
        in either are not the last ones, so pod_made marks the rest."""
        run = self.run
        if self.init_pool is None:
            r.submitted = run.pods.count - len(run.pool)
            return
        r.submitted = run.pods.count
        r.pod_made = np.ones(r.submitted, bool)
        left = [int(p.name[1:]) for p in (*run.pool, *self.init_pool)]
        r.pod_made[np.asarray(left, np.int64)] = False
        self.init_pool.clear()


TRAFFIC_KINDS = {"closed_backlog": ClosedBacklog, "preemption_backlog": PreemptionBacklog}


class CellRun:
    """Builds the cluster and the Scheduler of one cell and drives it."""

    def __init__(self, config: dict, traffic: dict, seed: int, *, device,
                 span_path: str | None = None):
        advisor_mod, sched_mod, types, config_mod = _program()
        traffic_gen.check(traffic)
        self.types = types
        self.config = config
        self.traffic = traffic
        self.seed = seed
        self.cluster = draw_cluster(config, seed)
        self.pods = PodSource(config, seed)
        self.hold = int(config["running_pods"])
        self.tmpl = config["pod"]
        self.init = init_template(config)
        self.init_ids: set = set()           # ids of the pods made from init_pod
        self.kind = TRAFFIC_KINDS[traffic["kind"]](self)
        if (config.get("scheduler", {}).get("preemption") is True) != self.kind.evicts:
            raise ValueError("scheduler.preemption: true goes with traffic of kind "
                             "preemption_backlog, and only with it")
        self._completion_rng = rng(seed, STREAM_COMPLETIONS)
        c = self.cluster
        node_t = config["node"]
        self.nodes = [
            types.Node(
                name=nm,
                labels={HOSTNAME: nm} if node_t.get("hostname_label") else {},
                allocatable={
                    "cpu": float(c.alloc[i, 0]),
                    "memory": float(c.alloc[i, 1]),
                    "pods": float(c.alloc[i, 2]),
                },
                cards=node_cards(types, c, i),
            )
            for i, nm in enumerate(c.names)
        ]
        utils = {
            nm: advisor_mod.NodeUtil(
                cpu_pct=float(c.cpu_pct[i]), mem_pct=float(c.mem_pct[i]),
                disk_io=float(c.disk_io[i]), net_up=float(c.net_up[i]),
                net_down=float(c.net_down[i]),
            )
            for i, nm in enumerate(c.names)
        }
        sched_kw = dict(config.get("scheduler", {}))
        if span_path:
            sched_kw["span_path"] = span_path
        self.sched_config = config_mod.SchedulerConfig(**sched_kw)
        self.node_index = {nm: i for i, nm in enumerate(c.names)}
        self.binder = ClusterBinder(self.node_index, stamp=self.kind.evicts)
        self.evictor = HarnessEvictor() if self.kind.evicts else None
        engine = sched_mod.default_engine(self.sched_config, device=device)
        self.sched = sched_mod.Scheduler(
            self.sched_config,
            advisor=advisor_mod.StaticAdvisor(utils),
            binder=self.binder,
            evictor=self.evictor,
            engine=engine,
            list_nodes=lambda: self.nodes,
            list_running_pods=self.kind.list_running,
        )
        self.pool = collections.deque()
        self._submitted = 0
        self._priority = self.tmpl.get("priority")
        # the latest pod batch built and the engine windows scored since;
        # "last": (window index, output, the batch's pods) of the latest
        # engine window the cycle scored
        self._k1_box = {"pods": None, "calls": 0, "last": None}
        self._k1_last = None
        self._restore = self._capture_k1()
        self._unsched: list = []
        self._restore_queue = self._capture_unschedulable()
        if self.tmpl.get("classes"):
            self._classes = [
                (labels, {"cpu": float(req[0]), "memory": float(req[1])}, prio)
                for (labels, req), prio in zip(pod_classes(self.tmpl),
                                               class_priorities(self.tmpl))
            ]
            self._make_pod = self._make_class_pod
        if self.init is not None:
            self.make_init = self._make_init_pod
        self.rec = Records(
            config=config, traffic=traffic, seed=seed, cluster=self.cluster,
            batch_window=self.sched_config.batch_window,
            effective_config=_plain(dataclasses.asdict(self.sched_config)),
        )

    # ---- the cluster around the scheduler --------------------------------

    def _make_pod(self, namespace: str):
        t = self.types
        pid = self.pods.count
        self.pods.count += 1
        aff = []
        anti = self.tmpl.get("anti_affinity")
        if anti:
            aff.append(t.PodAffinityTerm(
                match_labels=dict(anti["match_labels"]),
                topology_key=anti["topology_key"],
                anti=True,
                namespaces=list(anti["namespaces"]) if anti.get("namespaces") else None,
            ))
        return t.Pod(
            name=f"p{pid}",
            namespace=namespace,
            labels=dict(self.tmpl.get("labels", {})),
            annotations={"diskIO": f"{self.pods.disk_io(pid):.1f}"},
            containers=[t.Container(requests={
                "cpu": float(self.tmpl["cpu"]), "memory": float(self.tmpl["memory"]),
            })],
            pod_affinity=aff,
            priority=self._priority,
        )

    def _make_class_pod(self, namespace: str):
        """_make_pod under pod.classes: the pod's class's labels, request
        and priority."""
        pod = CellRun._make_pod(self, namespace)
        labels, requests, prio = self._classes[self.pods.pod_class(self.pods.count - 1)]
        pod.labels = dict(labels)
        pod.containers = [self.types.Container(requests=dict(requests))]
        pod.priority = prio
        return pod

    def make_init(self):
        """A running pod of the kind set-up places: pod's template in its
        init namespace, or init_pod where the configuration has one."""
        return self._make_pod(self._namespace(True))

    def _make_init_pod(self):
        """A pod of init_pod in pod's init namespace: its labels, request
        and priority; no anti-affinity and no class."""
        t, init = self.types, self.init
        pid = self.pods.count
        self.pods.count += 1
        self.init_ids.add(pid)
        return t.Pod(
            name=f"p{pid}",
            namespace=self._namespace(True),
            labels=dict(init["labels"]),
            annotations={"diskIO": f"{self.pods.disk_io(pid):.1f}"},
            containers=[t.Container(requests={
                "cpu": float(init["cpu"]), "memory": float(init["memory"]),
            })],
            priority=init.get("priority"),
        )

    def _namespace(self, init: bool) -> str:
        t = self.tmpl
        return t.get("init_namespace" if init else "namespace") or t["namespace"]

    def build_pool(self, count: int) -> None:
        """Build `count` pods ahead (and the traffic kind's own), with the
        cyclic collector off, then freeze what set-up made so the window's
        collections skip it."""
        ns = self._namespace(False)
        gc.disable()
        try:
            self.pool.extend(self._make_pod(ns) for _ in range(count))
            self.kind.build_pool(count)
        finally:
            gc.enable()
        gc.freeze()

    def from_pool(self, pool, count: int, make) -> list:
        """`count` pods off `pool`; a spent pool's rest is built here,
        inside the window, by make()."""
        take = min(count, len(pool))
        pods = [pool.popleft() for _ in range(take)]
        self.rec.pool_short += count - take
        return pods + [make() for _ in range(count - take)]

    def pool_pods(self, count: int) -> list:
        """The next `count` pods of the pod template's pool."""
        ns = self._namespace(False)
        return self.from_pool(self.pool, count, lambda: self._make_pod(ns))

    def submit(self, pods: list) -> None:
        """Hand `pods` to the program's Scheduler.submit."""
        self._submitted += len(pods)
        now = time.perf_counter()
        submit = self.sched.submit
        for pod in pods:
            submit(pod)
        if pods:
            self.rec.stages.append(("schedbench.submit", now, time.perf_counter()))

    def _capture_k1(self):
        """Keep the engine's scores of each cycle's last engine window and
        the pods the host loop handed the engine, by wrapping the loop's
        pod-batch builder and engine.finish_cycle, which receives the
        scores and feasibility the assigner reads (under the live policy
        both are K1's output, ops.fused.masked_score); they are kept as
        they are and masked once the window has closed. Returns the
        function that undoes the wrapping. A batch built after the last
        engine window (the preemption pass builds its preemptors') leaves
        the capture as it is."""
        from kubernetes_scheduler_tpu_torch import engine

        box = self._k1_box
        finish = engine.finish_cycle
        builder = self.sched.builder
        build = builder.build_pod_batch

        @functools.wraps(finish)
        def finish_cycle(snapshot, pods, raw, norm, feasible, *a, **k):
            box["last"] = (box["calls"], (norm, feasible), box["pods"])
            box["calls"] += 1
            return finish(snapshot, pods, raw, norm, feasible, *a, **k)

        @functools.wraps(build)
        def build_pod_batch(pods, *a, **k):
            box["pods"], box["calls"] = list(pods), 0
            return build(pods, *a, **k)

        engine.finish_cycle = finish_cycle
        builder.build_pod_batch = build_pod_batch

        def restore():
            engine.finish_cycle = finish
            builder.build_pod_batch = build

        return restore

    def _capture_unschedulable(self):
        """Keep the pods each cycle requeues as unschedulable, by wrapping
        the program's queue's requeue_unschedulable. Returns the function
        that undoes the wrapping."""
        queue = self.sched.queue
        requeue = queue.requeue_unschedulable
        kept = self._unsched

        @functools.wraps(requeue)
        def requeue_unschedulable(pod, *a, **k):
            kept.append(int(pod.name[1:]))
            return requeue(pod, *a, **k)

        queue.requeue_unschedulable = requeue_unschedulable
        return lambda: setattr(queue, "requeue_unschedulable", requeue)

    def cycle(self, phase: str) -> CycleRecord:
        box = self._k1_box
        box["pods"], box["calls"], box["last"] = None, 0, None
        m0 = time.monotonic()
        t0 = time.perf_counter()
        m = self.sched.run_cycle()
        t1 = time.perf_counter()
        new, pids, nodes = self.binder.take()
        rec = CycleRecord(phase, t0, t1, m, pids, nodes,
                          unsched_pids=np.asarray(self._unsched, np.int64), m0=m0)
        self._unsched.clear()
        if m.pods_in:
            self.rec.cycles.append(rec)
            if phase == "window" and box["last"] is not None:
                self._k1_last = (len(self.rec.cycles) - 1, *box["last"])
        box["pods"] = box["last"] = None
        if new:
            order = self._completion_rng.permutation(len(new))
            self.kind.bound(new[i] for i in order)
        return rec

    # ---- phases ----------------------------------------------------------

    def setup(self, seconds: float) -> None:
        """Place the running pods the cell starts with, build the pods of
        the warm-up and of a window of `seconds`, then warm up on the
        cell's own traffic."""
        self.submit([self.make_init() for _ in range(self.hold)])
        self.build_pool(WARMUP_CYCLES * int(self.traffic["backlog_pods"])
                        + traffic_gen.pool_size(self.traffic, seconds))
        self.kind.setup()
        if self.kind.placed() < self.hold:
            raise RuntimeError(
                f"set-up placed {self.kind.placed()} of {self.hold} running pods"
            )
        for _ in range(WARMUP_CYCLES):
            self.kind.refill()
            self.kind.after_cycle(self.cycle("warmup"))

    def window(self, seconds: float) -> None:
        """Whole cycles of the traffic until `seconds` have passed."""
        self.rec.seconds = seconds
        first = self._submitted
        t_start = time.perf_counter()
        self.rec.window_t0 = t_start
        while True:
            self.kind.refill()
            rec = self.cycle("window")
            self.rec.window_t1 = rec.t1
            self.kind.after_cycle(rec)
            if rec.t1 - t_start >= seconds:
                break
        self.rec.queued_at_end = len(self.sched.queue)
        self.rec.window_submitted = self._submitted - first
        self._finish_records()

    def _finish_records(self) -> None:
        r = self.rec
        self.kind.finish(r)
        self.pool.clear()
        r.pod_io = self.pods.draws()[: r.submitted]
        r.pod_init = np.arange(r.submitted) < self.hold
        r.pod_class = self.pods.classes()[: r.submitted]
        r.pod_priority = self._priorities(r.pod_class)
        if self.init is not None:
            r.pod_from_init = np.zeros(r.submitted, bool)
            r.pod_from_init[np.fromiter(self.init_ids, np.int64, len(self.init_ids))] = True
            r.pod_priority[r.pod_from_init] = pod_priority(self.init["labels"],
                                                           self.init.get("priority"))
        if self.binder.start is not None:
            r.pod_start = np.full(r.submitted, np.nan)
            for pid, t in self.binder.start.items():
                r.pod_start[pid] = t
        if self._k1_last is not None:
            import torch

            from schedbench.reference import NEG

            cycle, window, (norm, feasible), pods = self._k1_last
            r.k1 = {"cycle": cycle, "window": window, "out": torch.where(feasible, norm, NEG),
                    "pids": np.asarray([int(p.name[1:]) for p in pods], np.int64)}
        self._k1_last = None

    def _priorities(self, pod_class: np.ndarray) -> np.ndarray:
        """[pods] int64 the queue's priority of each pod of pod's template
        by its class."""
        prio = [pod_priority(labels, p) for (labels, _), p in
                zip(pod_classes(self.tmpl), class_priorities(self.tmpl))]
        return np.asarray(prio, np.int64)[pod_class]

    def close(self) -> None:
        self._restore()
        self._restore_queue()
        if self.sched.spans is not None:
            self.sched.spans.close()


def _plain(obj):
    """A JSON-able copy of a config dict."""
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_plain(v) for v in obj]
    if isinstance(obj, (int, float, str, bool)) or obj is None:
        return obj
    return repr(obj)
