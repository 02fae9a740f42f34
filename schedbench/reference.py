"""The plain reference that decides `correct`: numpy and PyTorch only.

It rebuilds the cluster's state cycle by cycle from the harness's own
records (the node, card and pod draws, each pod's class, the bindings the
program reported, the pods it left unschedulable and the harness's
deletions), never from the program's arrays, and judges every binding of
the run by what it says:

- double_binds: bindings of a pod beyond its first;
- lost_pods: created pods neither bound nor still in the queue;
- unknown_nodes: bindings to a node the cluster does not have;
- over_capacity: (node, resource) pairs whose requests exceed allocatable
  at a cycle's end, summed over cycles;
- anti_affinity_breaks: nodes that hold a pod with required anti-affinity
  and another pod its selector matches, at a cycle's end, summed;
- card_fit_breaks: bindings to a node that fails the pod's GPU-card fit;
- unplaced_with_room: pods the program left unschedulable in a cycle at
  whose end some node still had room for them (resources, anti-affinity
  and card fit, per pod class);
- score_gap: the policy's score (min-max scaled over the nodes that fit
  the pod, resources and cards, at the cycle's start, a superset of those
  with room at its end) of the best available node, less the score of
  the node the pod took; the widest over every bound pod. A node is
  available to a pod where at the cycle's end it has room for the pod
  and, for every class of the cycle's pods whose cards fit it, room for
  a pod of that class's request: the auction rejects a bid only where the
  pod no longer fits, and a class whose cards do not fit never bids, so
  such a node never rejected a bid and its price stayed 0 (with one
  class, every node with room for the pod). A cycle the engine served is
  judged by the engine's float32 scores: its auction admits a pod to the
  node of highest score less price, plus a tie jitter below 1% of the
  row's range; a sound run reads below 0.01. A
  cycle the program's scalar path served (CycleMetrics.used_fallback)
  under the live policy is judged by that path's own arithmetic, the Go
  reference's: the raw score truncated to an integer (algorithm.go:113)
  and the first node of the highest score taken, one pod after the other;
  a sound run reads 0 there. Under the card policy such a cycle is judged
  by the card policy, which the scalar path does not compute;
- k1_score_err: the widest gap, in score points of 0-100, between the
  engine's min-max scaled score and the reference's in float64, over the
  cells the reference finds feasible, for the last engine window of the
  measured window: the rows are the pods the host loop handed the engine,
  in its order, the columns the cluster's nodes in the order the harness
  lists them; the scale is the program's (max and min over all nodes, the
  highest floored at 0). The engine's scores are those it hands its
  assigner (engine.finish_cycle), NEG where infeasible: under the live
  policy K1's output (ops.fused.masked_score), under the card policy,
  which has no fused kernel, the plain-PyTorch scores; the names stay;
- k1_mask_errors: cells of that window where the engine's feasibility (a
  score above NEG / 2) differs from the reference's resource and card fit
  at the window's start (the cycle's start and the bindings of the
  cycle's earlier windows); padding rows and columns are never feasible.

Under preemption (a configuration whose scheduler block sets
"preemption": true) the reference also replays the program's evictions,
which the harness records per cycle (victim, preemptor, the victim's
node) and kills once the cycle has returned: the victims leave the state
with the cycle's deletions. Each preemption (the evictions of one
preemptor in a cycle) nominates the victims' node: its room is reserved
for the preemptor, as the program reserves it (host/scheduler.py's
nomination reservations, a virtual running pod of the preemptor's
request), from the next cycle until the preemptor binds or the
configuration's preemption_nomination_ttl_seconds have passed since the
eviction. Reserved room counts as taken for every other pod in
unplaced_with_room and in score_gap's available set, never for the
preemptor itself. A cycle's own state (its start for the captured
window and score_gap's scale, and its preemption pass) holds the
reservations the program held in it: those whose preemptor the cycle did
not pop. Four exact counts judge each preemption, at the state the
program's pass saw (the cycle's end, before its kills):

- victim_priority_breaks: victims whose priority is not strictly below
  their preemptor's;
- needless_preemptions: preemptions for a pod that was not among its
  cycle's unschedulable pods, or for which some node had room at the
  cycle's end (the cycle's binds and other preemptors' reservations
  taken);
- excess_victims: victims outside the set upstream's
  selectVictimsOnNode (v1.22 default_preemption.go) chooses on the
  preemption's node: every lower-priority pod removed, then each
  reprieved, the most important first (higher priority, then the earlier
  start time), while the preemptor still fits; none on a node where the
  preemptor fits without them or not even with all of them gone. Pods
  alike in priority, start time and request are interchangeable;
- victim_node_breaks: preemptions whose node is not among the best of
  pickOneNodeForPreemption's criteria 1-3 (after the PodDisruptionBudget
  criterion, which no harness budget moves): the lowest highest-victim
  priority, then the lowest sum of victim priorities, then the fewest
  victims, each node's victims as above, over the nodes where the
  preemptor does not fit as things stand and fits once every
  lower-priority pod is gone, in the program's apply order (a cycle's
  preemptions, highest priority first) without the nodes taken by the
  cycle's earlier preemptions (the program applies one preemption a
  node a cycle).

Preemption is judged on resources (cpu, memory, pods) and card fit; a
configuration with pod anti-affinity and preemption, or with
anti-affinity and init_pod, is refused (policy_of).

The policy is the configuration's `scheduler.policy`; any other than
POLICIES, a `score_plugins` list or a normalizer other than min-max
raises ValueError (policy_of), so the reference never judges by a formula
the program was not asked for:

- balanced_cpu_diskio (the live policy): a frozen copy of the numpy
  per-pod emulation in kubernetes_scheduler_tpu_torch/bench.py
  (baseline_rate); the inputs taken as the program receives them, node
  utilisation and the diskIO annotations rounded to float32, the
  arithmetic in float64.
- card: pkg/yoda/collection/collection.go:30-76 and
  pkg/yoda/score/algorithm.go:264-291, per pod class: the maxima of each
  card metric over the cards that meet the class's memory and clock
  demand on the nodes that pass its card fit, seeded at 1; then over the
  cards of each node that meet the demand, the sum of
  weight * metric * 100 / maximum with weights 1, 1, 2, 1, 3, 1. It
  follows the port's deployed defaults where they depart from the Go
  source: the clock is divided by its own maximum, not by the
  bandwidth's (algorithm.go:283), and the division is float, not
  integer; the score is computed on every node and min-max scaled over
  all of them, as the engine scales it.

The card fit (pkg/yoda/filter/filter.go:11-58) is re-implemented in
numpy: a pod with any of the scv/number, scv/memory and scv/clock labels
wants scv/number cards (1 without that label; a label that does not
parse reads 0, as Go's strconv.Atoi with its error dropped); a node fits
when it has that many cards, that many healthy cards with free memory
at least scv/memory, and that many healthy cards whose clock equals
scv/clock. A binding consumes no card, as in the Go source, so the fit
is static.

`control_check` is the control: the reference put in the program's place
and computed in bfloat16, the precision below the float32 the
configuration states. The pods of each engine-served cycle are placed one
by one on the same start states, each on the node of the best bfloat16
score with room (score_gap), and the captured window is scored in
bfloat16 (k1_score_err); its numbers carry the program's names and go
through the same verdict.

This module imports neither jax, the JAX package, nor the program.
"""

from __future__ import annotations

import json
import re
from pathlib import Path

import numpy as np
import torch

from schedbench.gen.cluster import (
    CARD_METRICS,
    init_class_index,
    init_template,
    label_match,
    pod_classes,
    pod_request,
)

LIMITS_FILE = Path(__file__).resolve().parent / "limits.json"
# rows of the [pods, nodes] score matrix handled at once
ROW_BLOCK = 2048
MAX_RAW_SCORE = 10.0
MAX_NODE_SCORE = 100.0
DISK_IO_DIVISOR = 50.0
CPU_DIVISOR = 100.0
# the program's infeasible score; a cell above NEG / 2 is feasible
NEG = -1.0e30
LIVE = "balanced_cpu_diskio"
POLICIES = (LIVE, "card")
# algorithm.go:264-291's weight of each card metric, in CARD_METRICS order
CARD_WEIGHTS = (1.0, 1.0, 2.0, 1.0, 3.0, 1.0)
CARD_LABELS = ("scv/number", "scv/memory", "scv/clock")
CLOCK = CARD_METRICS.index("clock")
FREE_MEMORY = CARD_METRICS.index("free_memory")
_GO_INT = re.compile(r"[+-]?[0-9]+")
PREEMPTION_CHECKS = ("victim_priority_breaks", "needless_preemptions", "excess_victims",
                     "victim_node_breaks")


def limits(config: dict) -> dict:
    """Each check's limit: limits.json, with the configuration's own
    `limits` over it."""
    out = json.loads(LIMITS_FILE.read_text())["limits"]
    out.update(config.get("limits", {}))
    return out


def policy_of(config: dict) -> str:
    """The configuration's scheduler.policy, one of POLICIES; ValueError
    for any other, for scores that policy alone does not give, and for
    pod anti-affinity beside preemption or init_pod."""
    sched = config.get("scheduler", {})
    if config["pod"].get("anti_affinity") and (sched.get("preemption") is True
                                               or config.get("init_pod") is not None):
        raise ValueError("the reference judges preemption and init_pod without pod anti-affinity")
    policy = sched.get("policy", LIVE)
    if policy not in POLICIES:
        raise ValueError(f"the reference judges the policies {POLICIES}, not {policy!r}")
    if sched.get("score_plugins"):
        raise ValueError("the reference judges one policy, not score_plugins")
    if sched.get("normalizer", "min_max") != "min_max":
        raise ValueError(f"the reference judges min-max scaled scores, not {sched['normalizer']!r}")
    return policy


def go_atoi(s: str) -> int:
    """strconv.Atoi with its error dropped, as filter.go reads a label: a
    value that does not parse reads 0."""
    return int(s) if _GO_INT.fullmatch(s) else 0


def card_demand(labels: dict):
    """(number, memory, clock) that a pod with these labels asks of a
    node's cards, memory or clock None where no label asks for it; None
    without any card label (filter.go:11-50)."""
    if not any(k in labels for k in CARD_LABELS):
        return None
    number = go_atoi(labels["scv/number"]) if "scv/number" in labels else 1
    memory = go_atoi(labels["scv/memory"]) if "scv/memory" in labels else None
    clock = go_atoi(labels["scv/clock"]) if "scv/clock" in labels else None
    return number, memory, clock


def card_fit(cards: np.ndarray, healthy: np.ndarray, demand) -> np.ndarray:
    """[n] bool: the nodes whose cards ([n, c, 6], health [n, c]) meet the
    demand (filter.go:11-58)."""
    n, c = healthy.shape
    if demand is None:
        return np.ones(n, bool)
    number, memory, clock = demand
    ok = np.full(n, number <= c)
    if memory is not None:
        ok &= (healthy & (cards[..., FREE_MEMORY] >= memory)).sum(1) >= number
    if clock is not None:
        ok &= (healthy & (cards[..., CLOCK] == clock)).sum(1) >= number
    return ok


def card_scores(cards: np.ndarray, demand, fit: np.ndarray, dtype=torch.float64,
                device="cpu") -> torch.Tensor:
    """[n] the card policy's raw score of one pod class on every node,
    every operation in `dtype`: the cards that meet the class's memory
    and clock demand (free memory and clock at least the label's, health
    not asked, an absent label asking 0) score; each metric's maximum is
    taken over those cards on the nodes in `fit`, seeded at 1
    (collection.go:30-76); a node scores the sum over its scoring cards
    of weight * metric * 100 / maximum (algorithm.go:264-291, the clock
    by its own maximum, float division)."""
    n, c = cards.shape[:2]
    if c == 0:
        return torch.zeros(n, dtype=dtype, device=device)
    x = torch.as_tensor(cards, device=device).to(dtype)
    memory = max(demand[1] or 0, 0) if demand else 0
    clock = max(demand[2] or 0, 0) if demand else 0
    meets = (x[..., FREE_MEMORY] >= memory) & (x[..., CLOCK] >= clock)
    fitting = meets & torch.as_tensor(fit, device=device)[:, None]
    maxima = torch.clamp(torch.where(fitting[..., None], x, 0.0).amax(dim=(0, 1)), min=1.0)
    weights = torch.tensor(CARD_WEIGHTS, dtype=dtype, device=device)
    per_card = (x * 100.0 / maxima * weights).sum(-1)
    return torch.where(meets, per_card, 0.0).sum(-1)


class PodClasses:
    """The pods of one configuration, per class of pod.classes (the
    template alone without them) and, with init_pod, one class more for
    its pods (init_class_index): the request, whether the template's
    anti-affinity selects the class in the namespace of the running pods
    the cell starts with and in that of later pods, the card demand, and
    the nodes whose cards meet it."""

    def __init__(self, config: dict, cluster):
        t = config["pod"]
        anti = t.get("anti_affinity")
        self.has_anti = anti is not None
        classes = pod_classes(t)
        init = init_template(config)
        if init is not None:
            classes.append(({**init["labels"]}, pod_request(init)))

        def matches(labels: dict, ns: str) -> bool:
            if anti is None:
                return False
            nss = anti.get("namespaces")
            return label_match(labels, anti["match_labels"]) and (nss is None or ns in nss)

        init_ns = t.get("init_namespace") or t["namespace"]
        self.req = np.stack([req for _, req in classes])             # [k, 3] int64
        self.match_init = np.array([matches(lb, init_ns) for lb, _ in classes])
        self.match_new = np.array([matches(lb, t["namespace"]) for lb, _ in classes])
        self.demand = [card_demand(lb) for lb, _ in classes]
        n = cluster.alloc.shape[0]
        if cluster.cards is None:
            self.cards = np.zeros((n, 0, len(CARD_METRICS)))
            self.healthy = np.zeros((n, 0), bool)
        else:
            self.cards, self.healthy = cluster.cards, cluster.card_healthy
        self.fit = np.stack([card_fit(self.cards, self.healthy, d) for d in self.demand])

    def card_scores(self, device="cpu") -> torch.Tensor:
        """[k, n] float64 the card policy's raw scores of each class."""
        return torch.stack([card_scores(self.cards, d, f, device=device)
                            for d, f in zip(self.demand, self.fit)])


class State:
    """Requests and anti-affinity counts per node."""

    def __init__(self, alloc: np.ndarray):
        n = alloc.shape[0]
        self.alloc = alloc
        self.req = np.zeros_like(alloc)
        self.match = np.zeros(n, np.int64)
        self.anti = np.zeros(n, np.int64)
        self.both = np.zeros(n, np.int64)

    def copy(self) -> "State":
        s = State(self.alloc)
        s.req, s.match, s.anti, s.both = (
            self.req.copy(), self.match.copy(), self.anti.copy(), self.both.copy()
        )
        return s

    def add(self, nodes: np.ndarray, req: np.ndarray, match: np.ndarray,
            anti: bool, sign: int = 1) -> None:
        """Pods onto `nodes` (sign -1: off them); req [b, 3] their requests."""
        np.add.at(self.req, nodes, sign * req)
        np.add.at(self.match, nodes, sign * match.astype(np.int64))
        if anti:
            np.add.at(self.anti, nodes, sign)
            np.add.at(self.both, nodes, sign * match.astype(np.int64))

    def room(self, req: np.ndarray, match: bool, anti: bool, fit: np.ndarray) -> np.ndarray:
        """[n] bool: a pod of this class fits the node now; fit [n] its
        card fit."""
        ok = ((self.req + req[None, :]) <= self.alloc).all(1) & fit
        if anti:
            ok &= self.match == 0
        if match:
            ok &= self.anti == 0
        return ok

    def room_all(self, reqs: np.ndarray, fits: np.ndarray) -> np.ndarray:
        """[n] bool: resources for a pod of each request of reqs [m, 3]
        whose card fit fits [m, n] holds there."""
        room = ((self.req[None] + reqs[:, None]) <= self.alloc[None]).all(2)
        return (room | ~fits).all(0)

    def over(self) -> int:
        return int((self.req > self.alloc).sum())

    def anti_breaks(self) -> int:
        bad = (self.anti >= 1) & (self.match >= 1)
        alone = (self.anti == 1) & (self.match == 1) & (self.both == 1)
        return int((bad & ~alone).sum())


def live_scores(io: torch.Tensor, cpu_req: float, u: torch.Tensor,
                v: torch.Tensor, trunc: bool = False) -> torch.Tensor:
    """[p, n] float64 raw live-policy scores of pods with diskIO `io`;
    with trunc, truncated to integers as the Go reference does."""
    beta = torch.where(io > 0, 1.0 / (1.0 + cpu_req / torch.clamp(io, min=1e-300)), 0.0)
    alpha = 1.0 - beta
    s = MAX_RAW_SCORE - MAX_RAW_SCORE * torch.abs(
        alpha[:, None] * v[None, :] - beta[:, None] * u[None, :]
    )
    return torch.clamp(torch.trunc(s), min=0.0) if trunc else s


def _gaps(s, feas, avail, chosen) -> torch.Tensor:
    """[p] float64: best score s [p, n] among `avail` nodes less the
    chosen node's, over the span of the `feas` nodes (both [n] bool)."""
    hi = torch.where(feas[None, :], s, -torch.inf).amax(1)
    lo = torch.where(feas[None, :], s, torch.inf).amin(1)
    span = torch.clamp(hi - lo, min=1e-12)
    best = torch.where(avail[None, :], s, -torch.inf).amax(1)
    got = s.gather(1, chosen[:, None])[:, 0]
    gap = torch.where(torch.isfinite(best), (best - got) / span, 0.0)
    return torch.clamp(gap, min=0.0)


def score_gaps(io, cpu_req, u, v, feas, avail, chosen, trunc: bool = False) -> torch.Tensor:
    """[p] float64: best min-max-scaled live score among `avail` nodes
    less the chosen node's, the scale taken over `feas` nodes."""
    out = [_gaps(live_scores(io[a:a + ROW_BLOCK], cpu_req, u, v, trunc), feas, avail,
                 chosen[a:a + ROW_BLOCK])
           for a in range(0, io.shape[0], ROW_BLOCK)]
    return torch.cat(out) if out else torch.zeros(0, dtype=torch.float64)


def min_max(s: torch.Tensor) -> torch.Tensor:
    """s [..., n] scaled to 0-100 over its last axis as the program scales
    it (the highest floored at 0, the lowest lowered by 1 where the two
    are equal), in s's dtype."""
    hi = torch.clamp(s.amax(-1), min=0.0)
    lo = s.amin(-1)
    lo = torch.where(hi == lo, lo - 1.0, lo)
    return (s - lo[..., None]) * MAX_NODE_SCORE / (hi - lo)[..., None]


def norm_scores(io, cpu_req: float, u, v, dtype=torch.float64) -> torch.Tensor:
    """[p, n] live-policy scores min-max scaled to 0-100 over all nodes as
    the program scales them, every operation in `dtype`."""
    io = torch.as_tensor(io, device=u.device).to(dtype)
    u, v = u.to(dtype), v.to(dtype)
    beta = torch.where(io > 0, 1.0 / (1.0 + cpu_req / torch.where(io > 0, io, 1.0)), 0.0)
    alpha = 1.0 - beta
    s = MAX_RAW_SCORE - MAX_RAW_SCORE * torch.abs(alpha[:, None] * v[None, :]
                                                  - beta[:, None] * u[None, :])
    return min_max(s)


class _Run:
    """One run's records as the reference reads them: the policy, the
    pod classes, and per pod its diskIO, class, request and match."""

    def __init__(self, rec, device):
        self.policy = policy_of(rec.config)
        self.cls = cls = PodClasses(rec.config, rec.cluster)
        self.io = _f32(rec.pod_io)
        init = np.asarray(rec.pod_init, dtype=bool)
        pc = rec.pod_class
        self.pod_class = (np.zeros(init.shape[0], np.int64) if pc is None
                          else np.asarray(pc, np.int64))
        if getattr(rec, "pod_from_init", None) is not None:
            self.pod_class = np.where(rec.pod_from_init, init_class_index(rec.config),
                                      self.pod_class)
        self.match = np.where(init, cls.match_init[self.pod_class],
                              cls.match_new[self.pod_class])
        self.req = cls.req[self.pod_class]
        self.dev = dev = torch.device(device)
        self.u = torch.as_tensor(_f32(rec.cluster.disk_io) / DISK_IO_DIVISOR, device=dev)
        self.v = torch.as_tensor(_f32(rec.cluster.cpu_pct) / CPU_DIVISOR, device=dev)
        if self.policy == "card":
            self.card_raw = cls.card_scores(device=dev)
            self.card_norm = min_max(self.card_raw)

    def norm_rows(self, pids: np.ndarray, k: int, dtype=torch.float64) -> torch.Tensor:
        """[len(pids), n] min-max scaled scores of pods of class k, every
        operation in `dtype`."""
        if self.policy == "card":
            if dtype == torch.float64:
                s = self.card_norm[k]
            else:
                cls = self.cls
                s = min_max(card_scores(cls.cards, cls.demand[k], cls.fit[k], dtype, self.dev))
            return s[None, :].expand(len(pids), -1)
        return norm_scores(self.io[pids], float(self.cls.req[k][0]), self.u, self.v, dtype)


def _groups(pod_class: np.ndarray, match: np.ndarray):
    """(class, match, [b] bool) of each pair that occurs."""
    for k in np.unique(pod_class):
        of_k = pod_class == k
        for m in np.unique(match[of_k]):
            yield int(k), bool(m), of_k & (match == m)


def _place_bf16(j: _Run, pids: np.ndarray, state: State) -> np.ndarray:
    """The control's placement: pods one by one, each on the node of the
    highest bfloat16 score among those with room."""
    cls = j.cls
    pc, match = j.pod_class[pids], j.match[pids]
    out = np.full(pids.shape[0], -1, np.int64)
    for a in range(0, pids.shape[0], ROW_BLOCK):
        block = pids[a:a + ROW_BLOCK]
        s = np.empty((block.shape[0], j.u.shape[0]), np.float32)
        for k in np.unique(pc[a:a + ROW_BLOCK]):
            rows = np.flatnonzero(pc[a:a + ROW_BLOCK] == k)
            s[rows] = j.norm_rows(block[rows], int(k), torch.bfloat16).float().cpu().numpy()
        for i in range(s.shape[0]):
            p = a + i
            k = pc[p]
            ok = state.room(cls.req[k], bool(match[p]), cls.has_anti, cls.fit[k])
            if not ok.any():
                continue
            n = int(np.argmax(np.where(ok, s[i], -np.inf)))
            out[p] = n
            state.add(np.array([n]), cls.req[k][None, :], match[p:p + 1], cls.has_anti)
    return out


def check(rec, device="cpu") -> dict:
    """{name: value} of every compared number over all cycles of a run."""
    return _walk(rec, device, control=False)


def control_check(rec, device="cpu") -> dict:
    """The control's numbers, under the names check gives them."""
    return _walk(rec, device, control=True)


def _walk(rec, device, *, control: bool) -> dict:
    j = _Run(rec, device)
    cls = j.cls
    state = State(rec.cluster.alloc.astype(np.int64))
    bound_count = np.zeros(rec.submitted, np.int64)
    out = dict(double_binds=0, lost_pods=0, unknown_nodes=0, over_capacity=0,
               anti_affinity_breaks=0, card_fit_breaks=0, unplaced_with_room=0,
               score_gap=0.0, **dict.fromkeys(PREEMPTION_CHECKS, 0))
    ctrl = dict(score_gap=0.0)
    k1 = rec.k1
    if k1 is None:
        # no engine window was captured: nothing holds the engine's scores
        out.update(k1_score_err=float("inf"), k1_mask_errors=1)
    pre = _Preemption(rec, j) if any(len(_evicted(c)) for c in rec.cycles) else None
    for ci, c in enumerate(rec.cycles):
        pids, nodes = c.bound_pids, c.bound_nodes
        known = nodes >= 0
        out["unknown_nodes"] += int((~known).sum())
        pids, nodes = pids[known], nodes[known]
        np.add.at(bound_count, pids, 1)
        out["card_fit_breaks"] += int((~cls.fit[j.pod_class[pids], nodes]).sum())
        start = state.copy()
        held = standing = []
        if pre is not None:
            # the reservations the program held through this cycle
            held = pre.active(c, np.concatenate([c.bound_pids, c.unsched_pids]))
            pre.reserve(start, held)
        if k1 is not None and ci == k1["cycle"]:
            (ctrl if control else out).update(_k1_numbers(k1, start, pids, nodes, j, control))
        state.add(nodes, j.req[pids], j.match[pids], cls.has_anti)
        out["over_capacity"] += state.over()
        out["anti_affinity_breaks"] += state.anti_breaks()
        end = state
        if pre is not None:
            pre.bind(pids, nodes)
            # the reservations standing at the cycle's end
            standing = pre.active(c)
            if standing:
                end = state.copy()
                pre.reserve(end, standing)
        out["unplaced_with_room"] += _unplaced(j, c.unsched_pids, end, pre, standing)
        if pre is not None and len(_evicted(c)):
            pre.judge(c, state, held, end, standing, out)
        if len(pids):
            scalar = bool(getattr(c.metrics, "used_fallback", False))
            popped = np.unique(j.pod_class[np.concatenate([pids, c.unsched_pids])])
            if not control:
                out["score_gap"] = max(out["score_gap"], _cycle_gap(
                    j, pids, nodes, start, end, popped, trunc=scalar and j.policy == LIVE))
            elif not scalar:
                cstate = start.copy()
                cnodes = _place_bf16(j, pids, cstate)
                placed = cnodes >= 0
                ctrl["score_gap"] = max(ctrl["score_gap"], _cycle_gap(
                    j, pids[placed], cnodes[placed], start, cstate, popped))
        if len(c.deleted_pids):
            # a deleted pod leaves the node it was bound to last
            gone = c.deleted_pids
            where = _last_node(rec, gone)
            ok = where >= 0
            state.add(where[ok], j.req[gone[ok]], j.match[gone[ok]], cls.has_anti, -1)
            if pre is not None:
                pre.delete(gone)
        if pre is not None:
            pre.nominate(c)
    if control:
        return ctrl
    made = getattr(rec, "pod_made", None)
    out["double_binds"] = int(np.clip(bound_count - 1, 0, None).sum())
    out["lost_pods"] = int((rec.submitted if made is None else int(made.sum()))
                           - (bound_count > 0).sum() - rec.queued_at_end)
    return out


def _unplaced(j: _Run, unsched: np.ndarray, state: State, pre=None, standing=()) -> int:
    """Pods a cycle left unschedulable for which a node had room at its
    end; `state` holds the reservations `standing` ([(preemptor, node)]),
    and a preemptor's own reservation is room for it."""
    cls = j.cls
    preemptors = {p for p, _ in standing}
    if preemptors:
        split = np.isin(unsched, list(preemptors))
        count = sum(pre.room_for(int(p), state, standing).any() for p in unsched[split])
        unsched = unsched[~split]
    else:
        count = 0
    for k, m, sel in _groups(j.pod_class[unsched], j.match[unsched]):
        if state.room(cls.req[k], m, cls.has_anti, cls.fit[k]).any():
            count += int(sel.sum())
    return int(count)


def _evicted(c) -> np.ndarray:
    """[e, 3] the cycle's evictions (victim, preemptor, node)."""
    return getattr(c, "evicted", np.zeros((0, 3), np.int64))


class _Preemption:
    """The running set pod by pod, the program's nominations, and the four
    checks of its preemptions (see the module's docstring)."""

    def __init__(self, rec, j: _Run):
        self.j = j
        size = j.req.shape[0]
        self.node_of = np.full(size, -1, np.int64)   # node of each running pod
        prio = getattr(rec, "pod_priority", None)
        self.prio = np.zeros(size, np.int64) if prio is None else np.asarray(prio, np.int64)
        start = getattr(rec, "pod_start", None)
        # a pod without a start time is the newest (upstream's nil-means-now)
        self.start = (np.full(size, np.inf) if start is None
                      else np.where(np.isnan(start), np.inf, start))
        self.ttl = float(rec.effective_config["preemption_nomination_ttl_seconds"])
        self.nominated: dict = {}                    # preemptor -> (node, expiry)

    def active(self, c, skip=None) -> list:
        """[(preemptor, node)] of the nominations unexpired at cycle c's
        start, without those of the preemptors in `skip`."""
        skip = set() if skip is None or not self.nominated else set(skip.tolist())
        return [(p, n) for p, (n, expiry) in self.nominated.items()
                if expiry > getattr(c, "m0", 0.0) and p not in skip]

    def reserve(self, state: State, res: list, sign: int = 1) -> None:
        """Each reservation's room taken on its node (sign -1: given back)."""
        if res:
            p, n = (np.asarray(x, np.int64) for x in zip(*res))
            j = self.j
            state.add(n, j.req[p], j.match[p], j.cls.has_anti, sign)

    def room_for(self, p: int, state: State, res: list) -> np.ndarray:
        """[n] bool: room for pod p in `state`, which holds the reservations
        `res`, less p's own."""
        j = self.j
        mine = [r for r in res if r[0] == p]
        if mine:
            state = state.copy()
            self.reserve(state, mine, -1)
        k = j.pod_class[p]
        return state.room(j.cls.req[k], bool(j.match[p]), j.cls.has_anti, j.cls.fit[k])

    def bind(self, pids: np.ndarray, nodes: np.ndarray) -> None:
        self.node_of[pids] = nodes
        if self.nominated:
            for p in pids.tolist():
                self.nominated.pop(p, None)

    def delete(self, pids: np.ndarray) -> None:
        self.node_of[pids] = -1
        if self.nominated:
            for p in pids.tolist():
                self.nominated.pop(p, None)

    def nominate(self, c) -> None:
        """Each preemption of cycle c reserves its node for its preemptor
        from the eviction on."""
        for p, rows, last in _preemptions(c):
            if rows[0, 2] >= 0:
                self.nominated[p] = (int(rows[0, 2]), float(c.evicted_at[last]) + self.ttl)

    def judge(self, c, state: State, held: list, end: State, standing: list, out: dict) -> None:
        """The four checks over cycle c's preemptions. `state` is the
        cycle's end without reservations, `held` the reservations of the
        program's pass, `end` the cycle's end with the reservations
        `standing`."""
        j = self.j
        cls = j.cls
        seen = state.copy()
        self.reserve(seen, held)
        unsched = set(c.unsched_pids.tolist())
        alive = np.flatnonzero(self.node_of >= 0)
        upstream: dict = {}
        claimed: list = []
        for p, rows, _ in _preemptions(c):
            victims, where = rows[:, 0], rows[:, 2]
            out["victim_priority_breaks"] += int((self.prio[victims] >= self.prio[p]).sum())
            if p not in unsched or self.room_for(p, end, standing).any():
                out["needless_preemptions"] += 1
            key = (int(j.pod_class[p]), int(self.prio[p]))
            if key not in upstream:
                upstream[key] = self._select(seen, alive, *key)
            up = upstream[key]
            node = int(where[0])
            if node < 0 or not _best(up, claimed, node):
                out["victim_node_breaks"] += 1
            out["excess_victims"] += self._excess(up, node, victims, where)
            if node >= 0:
                claimed.append(node)

    def _select(self, state: State, alive: np.ndarray, k: int, prio: int) -> dict:
        """Upstream's selectVictimsOnNode for a preemptor of class k and
        priority `prio` on every node at `state`: {cand [n] bool (fits
        once every lower-priority pod is gone, not as things stand, card
        fit), maxp, sump, count [n] of the victims, ids [n, w] the
        lower-priority pods most important first, victim [n, w] bool}."""
        j = self.j
        q, alloc = j.cls.req[k], state.alloc
        n = alloc.shape[0]
        pot = alive[self.prio[alive] < prio]
        node = self.node_of[pot]
        pot = pot[np.lexsort((pot, self.start[pot], -self.prio[pot], node))]
        node = self.node_of[pot]
        counts = np.bincount(node, minlength=n)
        width = max(int(counts.max(initial=0)), 1)
        first = np.cumsum(counts) - counts
        ids = np.full((n, width), -1, np.int64)
        ids[node, np.arange(pot.shape[0]) - first[node]] = pot
        valid = ids >= 0
        req = np.where(valid[..., None], j.req[np.maximum(ids, 0)], 0)
        vprio = np.where(valid, self.prio[np.maximum(ids, 0)], 0)
        used = state.req - req.sum(1)
        cand = ((used + q) <= alloc).all(1) & ~((state.req + q) <= alloc).all(1) & j.cls.fit[k]
        victim = np.zeros((n, width), bool)
        for i in range(width):
            back = valid[:, i] & ((used + req[:, i] + q) <= alloc).all(1)
            used = used + np.where(back[:, None], req[:, i], 0)
            victim[:, i] = valid[:, i] & ~back
        return dict(cand=cand, maxp=np.where(victim, vprio, np.iinfo(np.int64).min).max(1),
                    sump=np.where(victim, vprio, 0).sum(1), count=victim.sum(1),
                    ids=ids, victim=victim)

    def _excess(self, up: dict, node: int, victims: np.ndarray, where: np.ndarray) -> int:
        """Victims outside upstream's set on `node`, pods alike in
        priority, start time and request taken as interchangeable."""
        chosen = up["ids"][node][up["victim"][node]] if node >= 0 and up["cand"][node] else []
        free: dict = {}
        for v in chosen:
            free[self._key(v)] = free.get(self._key(v), 0) + 1
        count = 0
        for v, at in zip(victims.tolist(), where.tolist()):
            key = self._key(v)
            if at == node and self.node_of[v] == node and free.get(key, 0) > 0:
                free[key] -= 1
            else:
                count += 1
        return count

    def _key(self, v: int) -> tuple:
        return (int(self.prio[v]), float(self.start[v]), *self.j.req[v].tolist())


def _preemptions(c):
    """(preemptor, [e, 3] its evictions, index of its last) of each run of
    one preemptor in cycle c's evictions, in the order they were made."""
    ev = _evicted(c)
    if not len(ev):
        return
    cut = np.flatnonzero(np.diff(ev[:, 1])) + 1
    for a, b in zip(np.concatenate([[0], cut]), np.concatenate([cut, [len(ev)]])):
        yield int(ev[a, 1]), ev[a:b], int(b - 1)


def _best(up: dict, claimed: list, node: int) -> bool:
    """Is `node` among the best candidates of pickOneNodeForPreemption's
    criteria 1-3, the nodes `claimed` left out?"""
    cand = up["cand"].copy()
    cand[claimed] = False
    if not cand[node]:
        return False
    for name in ("maxp", "sump", "count"):
        low = up[name][cand].min()
        if up[name][node] != low:
            return False
        cand &= up[name] == low
    return True


def _k1_numbers(k1, start: State, pids, nodes, j: _Run, control: bool) -> dict:
    """k1_score_err and k1_mask_errors of the captured engine window; with
    control, k1_score_err of the same window scored in bfloat16."""
    cls = j.cls
    got = k1["out"]
    rows, cols = got.shape
    w = k1["window"]
    window = k1["pids"][w * rows:(w + 1) * rows]
    n = j.u.shape[0]
    if cols < n or not len(window):
        # the output does not cover the window's pods and nodes
        return dict(k1_score_err=float("inf"), k1_mask_errors=rows * cols)
    # the window starts from the cycle's start and its earlier windows' bindings
    state = start.copy()
    early = np.isin(pids, k1["pids"][:w * rows])
    state.add(nodes[early], j.req[pids[early]], j.match[pids[early]], cls.has_anti)
    fits = np.stack([state.room(cls.req[k], False, False, cls.fit[k])
                     for k in range(cls.req.shape[0])])
    row_class = j.pod_class[window]
    ref_mask = torch.zeros(rows, cols, dtype=torch.bool, device=j.dev)
    ref_mask[:len(window), :n] = torch.as_tensor(fits[row_class], device=j.dev)
    dtype = torch.bfloat16 if control else torch.float64
    err = 0.0
    for k in np.unique(row_class):
        of_k = np.flatnonzero(row_class == k)
        for a in range(0, len(of_k), ROW_BLOCK):
            r = of_k[a:a + ROW_BLOCK]
            ref = j.norm_rows(window[r], int(k))
            if control:
                mine = j.norm_rows(window[r], int(k), dtype)
            else:
                mine = got[torch.as_tensor(r, device=got.device), :n].to(device=j.dev)
            rt = torch.as_tensor(r, device=j.dev)
            gap = torch.where(ref_mask[rt, :n], (mine.double() - ref).abs(), 0.0)
            err = max(err, float(gap.max()))
    if control:
        return dict(k1_score_err=err)
    mask_errors = int((ref_mask != (got.to(j.dev) > NEG * 0.5)).sum())
    return dict(k1_score_err=err, k1_mask_errors=mask_errors)


def _cycle_gap(j: _Run, pids, nodes, start: State, end: State, popped: np.ndarray,
               trunc: bool = False) -> float:
    """The widest score gap of one cycle's bindings, per pod class and
    match. A node counts as available to a pod where at the cycle's end it
    has room for the pod and resources for a pod of every class in
    `popped`, the classes of the cycle's pods, whose card fit holds there:
    such a node never rejected a bid (the auction rejects a bid only where
    the pod no longer fits, and a pod bids only where its cards fit), so
    its auction price stayed 0. A node that rejected a larger pod's bid
    may end with room for a smaller one, its price raised."""
    cls, dev = j.cls, j.dev
    never = end.room_all(cls.req[popped], cls.fit[popped])
    worst = 0.0
    for k, m, sel in _groups(j.pod_class[pids], j.match[pids]):
        feas = torch.as_tensor(start.room(cls.req[k], False, False, cls.fit[k]), device=dev)
        avail = torch.as_tensor(end.room(cls.req[k], m, cls.has_anti, cls.fit[k]) & never,
                                device=dev)
        chosen = torch.as_tensor(nodes[sel], dtype=torch.int64, device=dev)
        if j.policy == "card":
            s = j.card_raw[k][None, :].expand(chosen.shape[0], -1)
            g = _gaps(s, feas, avail, chosen)
        else:
            io = torch.as_tensor(j.io[pids][sel], dtype=torch.float64, device=dev)
            g = score_gaps(io, float(cls.req[k][0]), j.u, j.v, feas, avail, chosen, trunc)
        if g.numel():
            worst = max(worst, float(g.max()))
    return worst


def _f32(x) -> np.ndarray:
    """float64 copy of x rounded to float32, as the program holds it."""
    return np.asarray(x, dtype=np.float32).astype(np.float64)


def _last_node(rec, pids: np.ndarray) -> np.ndarray:
    """Node of each pod's latest binding (cached on the records)."""
    table = getattr(rec, "_node_of", None)
    if table is None or table.shape[0] < rec.submitted:
        table = np.full(rec.submitted, -1, np.int64)
        for c in rec.cycles:
            ok = c.bound_nodes >= 0
            table[c.bound_pids[ok]] = c.bound_nodes[ok]
        rec._node_of = table
    return table[pids]


def verdict(values: dict, lim: dict) -> tuple[bool, dict]:
    """(correct, {name: {value, limit}}) over the compared numbers."""
    shown = {k: {"value": values[k], "limit": lim[k]} for k in lim if k in values}
    return all(v["value"] <= v["limit"] for v in shown.values()), shown
