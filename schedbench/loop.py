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
    draw_cluster,
    pod_classes,
    rng,
)

# cycles allowed to place the running pods the cell starts with
SETUP_CYCLES = 32
# warm-up cycles of the cell's own traffic before the window
WARMUP_CYCLES = 2
# how long set-up sleeps after a cycle that popped nothing (backoff)
SETUP_SLEEP_S = 0.002


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


@dataclass
class Records:
    """What a run leaves for the metrics and the reference."""

    config: dict
    traffic: dict
    seed: int
    cluster: object
    cycles: list = field(default_factory=list)
    submitted: int = 0                     # pods created and submitted
    pod_io: np.ndarray | None = None       # [submitted] diskIO by pod id
    pod_init: np.ndarray | None = None     # [submitted] bool: the running pods set-up placed
    pod_class: np.ndarray | None = None    # [submitted] int64 index into pod.classes
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
    pod is freed once the cluster deletes it."""

    def __init__(self, node_index: dict):
        self._index = node_index
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
        self.last.extend(pods)

    def take(self) -> tuple:
        """(pods, pod ids, node indices) bound since the last call."""
        pods, self.last = self.last, []
        pids = np.asarray(self.pids, np.int64)
        nodes = np.asarray(self.nodes, np.int64)
        self.pids, self.nodes = [], []
        return pods, pids, nodes


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
        self.running = collections.deque()   # bound pods, oldest first
        self.node_index = {nm: i for i, nm in enumerate(c.names)}
        self.binder = ClusterBinder(self.node_index)
        engine = sched_mod.default_engine(self.sched_config, device=device)
        self.sched = sched_mod.Scheduler(
            self.sched_config,
            advisor=advisor_mod.StaticAdvisor(utils),
            binder=self.binder,
            engine=engine,
            list_nodes=lambda: self.nodes,
            list_running_pods=lambda: list(self.running),
        )
        self._pool = collections.deque()
        self._k1_box = {"out": None, "calls": 0, "pods": None}
        self._k1_last = None
        self._restore = self._capture_k1()
        self._unsched: list = []
        self._restore_queue = self._capture_unschedulable()
        if self.tmpl.get("classes"):
            self._classes = [
                (labels, {"cpu": float(req[0]), "memory": float(req[1])})
                for labels, req in pod_classes(self.tmpl)
            ]
            self._make_pod = self._make_class_pod
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
        )

    def _make_class_pod(self, namespace: str):
        """_make_pod under pod.classes: the pod's class's labels and request."""
        pod = CellRun._make_pod(self, namespace)
        labels, requests = self._classes[self.pods.pod_class(self.pods.count - 1)]
        pod.labels = dict(labels)
        pod.containers = [self.types.Container(requests=dict(requests))]
        return pod

    def _namespace(self, init: bool) -> str:
        t = self.tmpl
        return t.get("init_namespace" if init else "namespace") or t["namespace"]

    def build_pool(self, count: int) -> None:
        """Build `count` pods ahead, with the cyclic collector off, then
        freeze what set-up made so the window's collections skip it."""
        ns = self._namespace(False)
        gc.disable()
        try:
            self._pool.extend(self._make_pod(ns) for _ in range(count))
        finally:
            gc.enable()
        gc.freeze()

    def submit(self, count: int, *, init: bool = False) -> None:
        """Hand `count` pods to the program's Scheduler.submit: the running
        pods set-up starts with (init), else the next pods of the pool."""
        pool = self._pool
        if init:
            pods = [self._make_pod(self._namespace(True)) for _ in range(count)]
        else:
            take = min(count, len(pool))
            pods = [pool.popleft() for _ in range(take)]
            # a spent pool: the rest is built here, inside the window
            self.rec.pool_short += count - take
            pods += [self._make_pod(self._namespace(False)) for _ in range(count - take)]
        now = time.perf_counter()
        submit = self.sched.submit
        for pod in pods:
            submit(pod)
        if count:
            self.rec.stages.append(("schedbench.submit", now, time.perf_counter()))

    def _capture_k1(self):
        """Keep the engine's scores of each cycle's last engine window and
        the pods the host loop handed the engine, by wrapping the loop's
        pod-batch builder and engine.finish_cycle, which receives the
        scores and feasibility the assigner reads (under the live policy
        both are K1's output, ops.fused.masked_score); they are kept as
        they are and masked once the window has closed. Returns the
        function that undoes the wrapping."""
        from kubernetes_scheduler_tpu_torch import engine

        box = self._k1_box
        finish = engine.finish_cycle
        builder = self.sched.builder
        build = builder.build_pod_batch

        @functools.wraps(finish)
        def finish_cycle(snapshot, pods, raw, norm, feasible, *a, **k):
            box["out"] = (norm, feasible)
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
        box["calls"] = 0
        t0 = time.perf_counter()
        m = self.sched.run_cycle()
        t1 = time.perf_counter()
        new, pids, nodes = self.binder.take()
        rec = CycleRecord(phase, t0, t1, m, pids, nodes,
                          unsched_pids=np.asarray(self._unsched, np.int64))
        self._unsched.clear()
        if m.pods_in:
            self.rec.cycles.append(rec)
            if phase == "window" and box["calls"]:
                self._k1_last = (len(self.rec.cycles) - 1, box["calls"] - 1,
                                 box["out"], box["pods"])
        box["out"] = box["pods"] = None
        if new:
            order = self._completion_rng.permutation(len(new))
            self.running.extend(new[i] for i in order)
        return rec

    def complete(self, rec: CycleRecord) -> None:
        """Delete the oldest running pods down to the held count."""
        extra = len(self.running) - self.hold
        if extra <= 0:
            return
        t0 = time.perf_counter()
        mirror = self.sched.mirror
        gone = np.empty(extra, np.int64)
        for k in range(extra):
            pod = self.running.popleft()
            gone[k] = int(pod.name[1:])
            if mirror is not None:
                mirror.apply_pod_event("DELETED", pod)
        rec.deleted_pids = gone
        self.rec.stages.append(("schedbench.delete", t0, time.perf_counter()))

    # ---- phases ----------------------------------------------------------

    def setup(self, seconds: float) -> None:
        """Place the running pods the cell starts with, build the pods of
        the warm-up and of a window of `seconds`, then warm up on the
        cell's own traffic."""
        self.submit(self.hold, init=True)
        self.build_pool(WARMUP_CYCLES * int(self.traffic["backlog_pods"])
                        + traffic_gen.pool_size(self.traffic, seconds))
        for _ in range(SETUP_CYCLES):
            if len(self.running) >= self.hold:
                break
            rec = self.cycle("setup")
            if not rec.metrics.pods_in:
                time.sleep(SETUP_SLEEP_S)
        if len(self.running) < self.hold:
            raise RuntimeError(
                f"set-up placed {len(self.running)} of {self.hold} running pods"
            )
        for _ in range(WARMUP_CYCLES):
            self.submit(traffic_gen.refill_count(self.traffic, len(self.sched.queue)))
            self.complete(self.cycle("warmup"))

    def window(self, seconds: float) -> None:
        """Whole cycles of the closed backlog until `seconds` have passed."""
        self.rec.seconds = seconds
        first = self.pods.count - len(self._pool)
        t_start = time.perf_counter()
        self.rec.window_t0 = t_start
        while True:
            self.submit(traffic_gen.refill_count(self.traffic, len(self.sched.queue)))
            rec = self.cycle("window")
            self.rec.window_t1 = rec.t1
            self.complete(rec)
            if rec.t1 - t_start >= seconds:
                break
        self.rec.queued_at_end = len(self.sched.queue)
        self.rec.window_submitted = self.pods.count - len(self._pool) - first
        self._finish_records()

    def _finish_records(self) -> None:
        r = self.rec
        # the pool's pods never submitted do not exist for the cluster
        r.submitted = self.pods.count - len(self._pool)
        self._pool.clear()
        r.pod_io = self.pods.draws()[: r.submitted]
        r.pod_init = np.arange(r.submitted) < self.hold
        r.pod_class = self.pods.classes()[: r.submitted]
        if self._k1_last is not None:
            import torch

            from schedbench.reference import NEG

            cycle, window, (norm, feasible), pods = self._k1_last
            r.k1 = {"cycle": cycle, "window": window, "out": torch.where(feasible, norm, NEG),
                    "pids": np.asarray([int(p.name[1:]) for p in pods], np.int64)}
        self._k1_last = None

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
