"""Extension-point plugin surface + the scalar fallback scoring path.

The reference implements six scheduling-framework extension points
(pkg/yoda/scheduler.go:26-31: PreFilter, Filter, PreScore, Score,
NormalizeScore via ScoreExtensions, PreBind). This module keeps that
surface — so behavior stays auditable hook-by-hook against the reference —
and provides `ScalarYodaPlugin`, a pure-Python implementation with the
same per-pod/per-node call pattern. It is the `TPUBatchScore=false`
fallback: no device, no batching, same answers; its per-cycle statistics
memoization uses CycleCache where the reference used Redis.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Protocol

from kubernetes_scheduler_tpu_torch.host.advisor import NodeUtil
from kubernetes_scheduler_tpu_torch.host.cache import CycleCache
from kubernetes_scheduler_tpu_torch.host.snapshot import parse_float_or_zero, pod_resource_request
from kubernetes_scheduler_tpu_torch.host.types import Node, Pod

MAX_NODE_SCORE = 100.0


@dataclass
class CycleState:
    """Per-pod scratch, the framework.CycleState analog (scheduler.go:105)."""

    data: dict = field(default_factory=dict)

    def write(self, key, value):
        self.data[key] = value

    def read(self, key):
        return self.data[key]


class SchedulerPlugin(Protocol):
    def pre_filter(self, state: CycleState, pod: Pod) -> None: ...
    def filter(self, state: CycleState, pod: Pod, node: Node) -> bool: ...
    def pre_score(self, state: CycleState, pod: Pod, nodes: list[Node]) -> None: ...
    def score(self, state: CycleState, pod: Pod, node: Node) -> float: ...
    def normalize_scores(
        self, state: CycleState, pod: Pod, scores: dict[str, float]
    ) -> dict[str, float]: ...
    def pre_bind(self, state: CycleState, pod: Pod, node_name: str) -> None: ...


# card-metric weights mirroring ops/score.py (algorithm.go:24-35), in the
# snapshot builder's metric order (bandwidth, clock, core, power,
# free_memory, total_memory)
_CARD_WEIGHTS = (1.0, 1.0, 2.0, 1.0, 3.0, 1.0)
_CARD_METRICS = ("bandwidth", "clock", "core", "power", "free_memory", "total_memory")
# free-capacity weights (algorithm.go:178-198): diskIO, cpu, memory
_FC_DISK_W, _FC_CPU_W, _FC_MEM_W = 100.0, 2.0, 3.0

# policies the scalar path scores faithfully; anything else falls back to
# the yoda formula and bumps fallback_policy_mismatch (host/scheduler) —
# with every heuristic policy mirrored, `learned` is the only policy
# with no scalar equivalent (its scores live in device parameters)
SCALAR_POLICIES = (
    "balanced_cpu_diskio",
    "balanced_diskio",
    "free_capacity",
    "card",
    "least_allocated",
    "balanced_allocation",
    "image_locality",
)
# mirrors engine.PRESCALED_PLUGINS (kept import-free here so the scalar
# fallback never pulls jax; tests pin the two tuples equal): plugins whose
# raw output is already on the [0, 100] MaxNodeScore scale — the weighted
# combination min-max normalizes everything else per pod, like the
# upstream framework runtime
PRESCALED_SCALAR = (
    "least_allocated", "balanced_allocation", "image_locality",
    "balanced_diskio",
)
# ImageLocality ramp (mirrors ops/score.py)
_IMG_MIN = 23.0 * 1024 * 1024
_IMG_MAX = 1000.0 * 1024 * 1024


def gpu_demands(pod: Pod) -> tuple[int, float, float]:
    """(want_number, want_memory, want_clock) from the scv labels, exactly
    as host/snapshot.build_pod_batch encodes them — parse_int_or_zero
    strconv semantics included (an unparsable "2.5" means 0, not 2): -1 =
    label absent; a pod with any scv demand label but no explicit number
    wants 1 card."""
    from kubernetes_scheduler_tpu_torch.host.snapshot import parse_int_or_zero

    labels = pod.labels
    has_gpu = any(k in labels for k in ("scv/number", "scv/memory", "scv/clock"))
    if not has_gpu:
        return 0, -1.0, -1.0
    want_n = (
        parse_int_or_zero(labels["scv/number"])
        if "scv/number" in labels
        else 1
    )
    want_mem = (
        float(parse_int_or_zero(labels["scv/memory"]))
        if "scv/memory" in labels
        else -1.0
    )
    want_clock = (
        float(parse_int_or_zero(labels["scv/clock"]))
        if "scv/clock" in labels
        else -1.0
    )
    return want_n, want_mem, want_clock


def card_fit_node(node: Node, want_n: int, want_mem: float, want_clock: float) -> bool:
    """Scalar mirror of feasibility.card_fit's node predicate
    (filter.go:11-58): number / memory / clock demands with the health
    gate and the ==-vs->= clock quirk."""
    if want_n == 0:
        return True
    cards = node.cards
    if want_n > len(cards):
        return False
    healthy = [c for c in cards if c.health == "Healthy"]
    if want_mem >= 0 and sum(1 for c in healthy if c.free_memory >= want_mem) < want_n:
        return False
    if want_clock >= 0 and sum(1 for c in healthy if c.clock == want_clock) < want_n:
        return False
    return True


class ScalarYodaPlugin:
    """The reference's plugin behavior, hook for hook, without the network.

    - pre_filter / filter: log-only pass-through (scheduler.go:91-99 —
      every node passes; real filtering happens in the engine path) —
      except under policy="card", where filter applies the GPU-card
      predicates so fallback decisions match the engine's card path.
    - pre_score: advisor snapshot into CycleState + cache flush
      (scheduler.go:101-113).
    - score: per-cycle statistics computed once and memoized (the
      algorithm.go:47-97 structure, with CycleCache replacing Redis) then
      the live BalancedCpuDiskIO formula (algorithm.go:99-119). The
      `policy` knob swaps in the scalar mirrors of the engine's
      free_capacity (algorithm.go:178-198), card
      (algorithm.go:264-291 + collection.go:30-55) and balanced_diskio
      (algorithm.go:121-176) kernels, so an engine failure under any
      heuristic policy degrades to the SAME policy, not silently to the
      yoda formula; `learned` is the only remaining mismatch case.
    - normalize_scores: min-max to [0, 100] with the highest==lowest guard
      (scheduler.go:158-183).
    - pre_bind: snapshot existence check (scheduler.go:189-196).
    """

    def __init__(
        self,
        utils: dict[str, NodeUtil],
        *,
        truncate: bool = True,
        policy: str = "balanced_cpu_diskio",
        score_plugins: tuple | None = None,
    ):
        if score_plugins:
            bad = [n for n, _ in score_plugins if n not in SCALAR_POLICIES]
            if bad:
                raise ValueError(
                    f"scalar path cannot score plugins {bad}; "
                    f"supported: {SCALAR_POLICIES}"
                )
        elif policy not in SCALAR_POLICIES:
            raise ValueError(
                f"scalar path cannot score policy {policy!r}; "
                f"supported: {SCALAR_POLICIES}"
            )
        self.utils = utils
        self.cache = CycleCache()
        self.truncate = truncate
        self.policy = policy
        # weighted multi-plugin mode (engine.combine_scores mirror):
        # ((name, weight), ...) — scores become the framework's weighted
        # sum; pass truncate=False for exact engine parity (the engine's
        # yoda term never truncates)
        self.score_plugins = tuple(score_plugins or ())

    def pre_filter(self, state, pod):
        return None

    def filter(self, state, pod, node):
        if self.policy == "card":
            return card_fit_node(node, *gpu_demands(pod))
        return True

    def pre_score(self, state, pod, nodes):
        self.cache.flush()
        state.write("nodeInfo", {n.name: self.utils.get(n.name, NodeUtil()) for n in nodes})

    def _ensure_stats(self, state, nodes: list[Node]):
        if "U-AVG" in self.cache:
            return
        info = state.read("nodeInfo")
        u_sum = 0.0
        for n in nodes:
            u = info[n.name].disk_io / 50.0
            v = info[n.name].cpu_pct / 100.0
            self.cache.set(f"U-{n.name}", u)
            self.cache.set(f"V-{n.name}", v)
            u_sum += u
        u_avg = u_sum / len(nodes)
        m_tmp = sum(
            (self.cache.get(f"U-{n.name}") - u_avg) ** 2 for n in nodes
        ) / len(nodes)
        self.cache.set("U-AVG", u_avg)
        self.cache.set("M-tmp", m_tmp)
        self.cache.set("nodeLen", len(nodes))

    def _free_capacity_score(self, node: Node) -> float:
        """Scalar ops/score.free_capacity (CalculateBasicScore2,
        algorithm.go:178-198): 100*(100-floor(DiskIO)) + 2*(100-Cpu) +
        3*(100-Memory)."""
        u = self.utils.get(node.name, NodeUtil())
        return (
            _FC_DISK_W * (100.0 - math.floor(u.disk_io))
            + _FC_CPU_W * (100.0 - u.cpu_pct)
            + _FC_MEM_W * (100.0 - u.mem_pct)
        )

    def _card_score(self, pod: Pod, node: Node, nodes: list[Node]) -> float:
        """Scalar ops/score.card_score + ops/collect.collect_max_card_values:
        per fitting card, sum weight_k * metric_k * 100 / max_k, maxima
        collected over fitting cards of card-fitting nodes, seeded at 1
        (collection.go:31-38). Mirrors the engine's scoring-fit quirk:
        free_memory >= demand AND clock >= demand, no health gate."""
        want_n, want_mem, want_clock = gpu_demands(pod)
        mem = max(want_mem, 0.0)
        clk = max(want_clock, 0.0)

        def fits_for_score(c):
            return c.free_memory >= mem and c.clock >= clk

        maxima = self.cache.get("CARD-MAX")
        if maxima is None:
            maxima = [1.0] * 6
            for nd in nodes:
                if not card_fit_node(nd, want_n, want_mem, want_clock):
                    continue
                for c in nd.cards:
                    if fits_for_score(c):
                        for k, metric in enumerate(_CARD_METRICS):
                            maxima[k] = max(maxima[k], float(getattr(c, metric)))
            self.cache.set("CARD-MAX", maxima)
        total = 0.0
        for c in node.cards:
            if fits_for_score(c):
                total += sum(
                    _CARD_WEIGHTS[k] * float(getattr(c, metric)) * 100.0 / maxima[k]
                    for k, metric in enumerate(_CARD_METRICS)
                )
        return total

    def _balanced_diskio_score(self, state, pod, node, nodes: list[Node]) -> float:
        """Scalar ops/score.balanced_diskio (BalancedDiskIOPriority,
        algorithm.go:121-176): variance-minimization Mj per node, min-max
        rescaled to [0, 100] with the reference's sentinel seeds
        (M_max starts at 0, M_min at 1e6, algorithm.go:122-123) and the
        engine's zero-denominator guard. Whole vector computed once per
        pod, memoized under S- keys like the live formula."""
        memo = self.cache.get(f"S-{node.name}")
        if memo is not None:
            return memo
        scores = self._balanced_diskio_vector(state, pod, nodes)
        result = 0.0
        for nd, s in zip(nodes, scores):
            self.cache.set(f"S-{nd.name}", s)
            if nd.name == node.name:
                result = s
        return result

    def _balanced_diskio_vector(self, state, pod, nodes) -> list[float]:
        self._ensure_stats(state, nodes)
        info = state.read("nodeInfo")
        r_io = parse_float_or_zero(pod.annotations.get("diskIO"))
        n = len(nodes)
        u_avg = self.cache.get("U-AVG")
        m_tmp = self.cache.get("M-tmp")
        ms = []
        for nd in nodes:
            uj = self.cache.get(f"U-{nd.name}")
            fj = (info[nd.name].disk_io + r_io) / 100.0
            f_avg = u_avg - (uj - fj) / n
            ms.append(m_tmp - ((uj - u_avg) ** 2 - (fj - f_avg) ** 2) / n)
        m_max = max(0.0, max(ms))
        m_min = min(1.0e6, min(ms))
        denom = (m_max - m_min) or 1.0
        return [100.0 - 100.0 * (mj - m_min) / denom for mj in ms]

    # ---- upstream resource-shape scorers (ops/score.py mirrors) -------

    def _used_after(self, pod: Pod, node: Node, free, res: str) -> float:
        """alloc - free + this pod's request for `res` (NonZeroRequested
        semantics — `free` was accumulated with the same defaults)."""
        alloc = node.allocatable.get(res, 0.0)
        node_free = free[node.name].get(res, alloc) if free else alloc
        return alloc - node_free + pod_resource_request(pod, res)

    def _least_allocated_score(self, pod, node, free) -> float:
        total = 0.0
        for res in ("cpu", "memory"):
            alloc = node.allocatable.get(res, 0.0)
            used = self._used_after(pod, node, free, res)
            if alloc > 0 and used <= alloc:
                total += (alloc - used) * MAX_NODE_SCORE / alloc
        return total / 2.0

    def _balanced_allocation_score(self, pod, node, free) -> float:
        fracs = []
        for res in ("cpu", "memory"):
            alloc = node.allocatable.get(res, 0.0)
            if alloc <= 0:
                return 0.0
            fracs.append(self._used_after(pod, node, free, res) / alloc)
        if any(f >= 1.0 for f in fracs):
            return 0.0
        return (1.0 - abs(fracs[0] - fracs[1])) * MAX_NODE_SCORE

    def _image_holders(self, nodes) -> dict:
        """Image -> node count, memoized on the node LIST identity (not
        the per-pod CycleCache, which flushes between pods — the map
        depends only on the nodes and must survive the window)."""
        memo = getattr(self, "_holders_memo", None)
        if memo is not None and memo[0] is nodes:
            return memo[1]
        holders: dict = {}
        for nd in nodes:
            for img in nd.images:
                holders[img] = holders.get(img, 0) + 1
        self._holders_memo = (nodes, holders)
        return holders

    def _image_locality_score(self, pod, node, nodes) -> float:
        total_nodes = max(len(nodes), 1)
        holders = self._image_holders(nodes)
        total = 0.0
        for c in pod.containers:
            if c.image and c.image in node.images:
                total += node.images[c.image] * holders[c.image] / total_nodes
        n_c = max(len(pod.containers), 1)
        lo, hi = _IMG_MIN * n_c, _IMG_MAX * n_c
        return min(max((total - lo) / (hi - lo), 0.0), 1.0) * MAX_NODE_SCORE

    # ---- weighted multi-plugin combination (engine.combine_scores) ----

    def _plugin_vector(self, name, state, pod, nodes, free) -> list[float]:
        if name == "balanced_cpu_diskio":
            self._ensure_stats(state, nodes)
            r_io = parse_float_or_zero(pod.annotations.get("diskIO"))
            r_cpu = pod_resource_request(pod, "cpu")
            beta = 1.0 / (1.0 + r_cpu / r_io) if r_io > 0 else 0.0
            alpha = 1.0 - beta
            out = []
            for n in nodes:
                u = self.cache.get(f"U-{n.name}")
                v = self.cache.get(f"V-{n.name}")
                s = 10.0 - 10.0 * abs(alpha * v - beta * u)
                if self.truncate:
                    s = float(int(s)) if s >= 0 else 0.0
                out.append(s)
            return out
        if name == "balanced_diskio":
            return self._balanced_diskio_vector(state, pod, nodes)
        if name == "free_capacity":
            return [self._free_capacity_score(n) for n in nodes]
        if name == "card":
            return [self._card_score(pod, n, nodes) for n in nodes]
        if name == "least_allocated":
            return [self._least_allocated_score(pod, n, free) for n in nodes]
        if name == "balanced_allocation":
            return [
                self._balanced_allocation_score(pod, n, free) for n in nodes
            ]
        if name == "image_locality":
            return [self._image_locality_score(pod, n, nodes) for n in nodes]
        raise ValueError(f"unknown scalar plugin {name!r}")

    @staticmethod
    def _min_max(vec: list[float]) -> list[float]:
        """The framework's rescale (scheduler.go:161-180 /
        ops/normalize.min_max_normalize): highest clamped >= 0, hi==lo
        guard. The ONE implementation behind both normalize_scores (the
        per-pod NormalizeScore hook) and the per-plugin rescale inside
        the weighted combination — they must not drift."""
        hi = max(0.0, *vec)
        lo = min(vec)
        if hi == lo:
            lo -= 1.0
        return [(s - lo) * MAX_NODE_SCORE / (hi - lo) for s in vec]

    def _combined_score(self, state, pod, node, nodes, free) -> float:
        memo = self.cache.get(f"S-{node.name}")
        if memo is not None:
            return memo
        total = [0.0] * len(nodes)
        for name, weight in self.score_plugins:
            vec = self._plugin_vector(name, state, pod, nodes, free)
            if name not in PRESCALED_SCALAR:
                vec = self._min_max(vec)
            for i, s in enumerate(vec):
                total[i] += s * float(weight)
        result = 0.0
        for n, s in zip(nodes, total):
            self.cache.set(f"S-{n.name}", s)
            if n.name == node.name:
                result = s
        return result

    def score(
        self,
        state,
        pod,
        node,
        *,
        all_nodes: list[Node] | None = None,
        free: dict | None = None,
    ):
        nodes = all_nodes or [node]
        if self.score_plugins:
            return self._combined_score(state, pod, node, nodes, free)
        if self.policy == "free_capacity":
            return self._free_capacity_score(node)
        if self.policy == "card":
            return self._card_score(pod, node, nodes)
        if self.policy == "balanced_diskio":
            return self._balanced_diskio_score(state, pod, node, nodes)
        if self.policy == "least_allocated":
            return self._least_allocated_score(pod, node, free)
        if self.policy == "balanced_allocation":
            return self._balanced_allocation_score(pod, node, free)
        if self.policy == "image_locality":
            return self._image_locality_score(pod, node, nodes)
        memo = self.cache.get(f"S-{node.name}")
        if memo is not None:
            return memo
        self._ensure_stats(state, nodes)
        r_io = parse_float_or_zero(pod.annotations.get("diskIO"))
        r_cpu = pod_resource_request(pod, "cpu")
        beta = 1.0 / (1.0 + r_cpu / r_io) if r_io > 0 else 0.0
        alpha = 1.0 - beta
        result = 0.0
        for n in nodes:
            u = self.cache.get(f"U-{n.name}")
            v = self.cache.get(f"V-{n.name}")
            load = abs(alpha * v - beta * u)
            s = 10.0 - 10.0 * load
            if self.truncate:  # uint64() truncation, algorithm.go:113
                s = float(int(s)) if s >= 0 else 0.0
            self.cache.set(f"S-{n.name}", s)
            if n.name == node.name:
                result = s
        return result

    def normalize_scores(self, state, pod, scores):
        self.cache.flush()
        if not scores:
            return {}
        names = list(scores)
        return dict(zip(names, self._min_max([scores[n] for n in names])))

    def pre_bind(self, state, pod, node_name):
        return None


def scalar_schedule_one(
    plugin: ScalarYodaPlugin,
    pod: Pod,
    nodes: list[Node],
    free: dict[str, dict[str, float]],
    score_free: dict[str, dict[str, float]] | None = None,
) -> str | None:
    """One full upstream-style scheduling cycle for one pod: the hook
    sequence of SURVEY.md §3.2, with real resource-fit filtering and
    capacity bookkeeping (which upstream's NodeResourcesFit + binding cycle
    provide around the reference plugin).

    score_free: the capacity state SCORES read (the shape scorers'
    A-Q input). The engine computes a window's score matrices against
    PRE-window state (feasibility stays dynamic), so a fallback
    mirroring it must score against a frozen copy while `free` keeps
    live bookkeeping; None = score against live `free` (single-pod
    cycles, where the two coincide)."""
    state = CycleState()
    plugin.pre_filter(state, pod)
    plugin.pre_score(state, pod, nodes)
    feasible = []
    for node in nodes:
        if not plugin.filter(state, pod, node):
            continue
        ok = True
        for res, avail in free[node.name].items():
            req = pod_resource_request(pod, res)
            if req > 0 and req > avail:
                ok = False
                break
        if ok:
            feasible.append(node)
    if not feasible:
        return None
    scores = {
        n.name: plugin.score(
            state, pod, n, all_nodes=nodes,
            free=score_free if score_free is not None else free,
        )
        for n in feasible
    }
    scores = plugin.normalize_scores(state, pod, scores)
    # deterministic argmax: highest score, first in node order on ties
    best = None
    best_s = -math.inf
    for n in feasible:
        if scores[n.name] > best_s:
            best, best_s = n.name, scores[n.name]
    plugin.pre_bind(state, pod, best)
    for res in free[best]:
        free[best][res] -= pod_resource_request(pod, res)
    return best
