"""Nodes, node utilisation and pods of one configuration, drawn from the seed.

The draws are frozen copies of kubernetes_scheduler_tpu_torch/sim/host_gen.py
(node utilisation as a seeded stand-in for Prometheus, the SCV GPU cards of
gen_host_cluster(gpu=True), and Yoda's `diskIO` pod annotation), reshaped to
the configuration's node and pod templates. The draws are plain numpy
arrays; schedbench/loop.py turns them into the program's host objects.
Everything here is a pure function of (configuration, seed), so the
reference rebuilds the same cluster from the same arrays.

Optional configuration keys:

- node.cards: {"per_node": c, "healthy_share": h, and for each metric of
  CARD_METRICS a number (every card the same), a list (a choice among its
  values) or {"integers": [lo, hi]} (a whole number in [lo, hi))}.
- pod.classes: [{"name", "share", "labels", and optionally "cpu",
  "memory" and "priority"}]: a pod of a class carries the template's
  labels and the class's, and the class's request and priority where it
  gives them. Without classes the template is the one class.
- pod.priority, and a class's priority: the pod's spec.priority
  (Pod.priority). Without it the program reads the scv/priority label, as
  pod_priority below does.
- init_pod: {"cpu", "memory", "labels", "priority"}: the template of the
  running pods set-up places (and of the pods that re-create preempted
  ones), in place of pod, in pod's init namespace. It has no classes and
  no anti-affinity; its pods take no class draw of their own. In the
  reference it is one more class, after pod's (init_class_index).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

# stream ids of np.random.default_rng([seed, stream]): one per kind of draw,
# so adding a draw of one kind never shifts another
STREAM_NODES = 0
STREAM_PODS = 1
STREAM_TRAFFIC = 2
STREAM_COMPLETIONS = 3
STREAM_CARDS = 4
STREAM_CLASSES = 5

RESOURCES = ("cpu", "memory", "pods")
HOSTNAME = "kubernetes.io/hostname"
# the card metrics in ops/score.card_score's order (types.Card's fields)
CARD_METRICS = ("bandwidth", "clock", "core", "power", "free_memory", "total_memory")


def rng(seed: int, stream: int) -> np.random.Generator:
    """The generator of one stream; any whole number is a seed."""
    return np.random.default_rng([int(seed) % (1 << 63), stream])


# the values every seed shares: a seed draws their order, not the values,
# so every seed gets the same amount of work
FIXED = 0x5C4ED


@dataclass(frozen=True)
class Cluster:
    names: list            # [n] node names
    alloc: np.ndarray      # [n, 3] int64 cpu millicores, memory bytes, pods
    cpu_pct: np.ndarray    # [n] float64 node CPU utilisation, %
    mem_pct: np.ndarray    # [n] float64
    disk_io: np.ndarray    # [n] float64 MB/s
    net_up: np.ndarray     # [n] float64
    net_down: np.ndarray   # [n] float64
    # [n, c, 6] float64 card metrics in CARD_METRICS order, and [n, c] bool
    # health; None without node.cards
    cards: np.ndarray | None = None
    card_healthy: np.ndarray | None = None


def draw_cluster(config: dict, seed: int) -> Cluster:
    """The configuration's nodes, all of its node template, with
    utilisation (and cards, under node.cards) drawn as
    sim/host_gen.gen_host_cluster draws them: one fixed set of values,
    spread over the nodes in an order drawn from the seed."""
    n = int(config["nodes"])
    node = config["node"]
    r = rng(FIXED, STREAM_NODES)
    util = np.stack([
        r.uniform(0.0, 100.0, n),
        r.uniform(0.0, 100.0, n),
        np.minimum(r.gamma(2.0, 8.0, n), 50.0),
        r.gamma(2.0, 2.0, n),
        r.gamma(2.0, 2.0, n),
    ], axis=1)[rng(seed, STREAM_NODES).permutation(n)]
    alloc = np.tile(
        np.array([node["cpu"], node["memory"], node["pods"]], dtype=np.int64),
        (n, 1),
    )
    return Cluster(
        names=[f"node-{i}" for i in range(n)],
        alloc=alloc,
        cpu_pct=util[:, 0].copy(),
        mem_pct=util[:, 1].copy(),
        disk_io=util[:, 2].copy(),
        net_up=util[:, 3].copy(),
        net_down=util[:, 4].copy(),
        **_draw_cards(node.get("cards"), n, seed),
    )


def _card_values(r: np.random.Generator, spec, size: int) -> np.ndarray:
    if isinstance(spec, dict):
        lo, hi = spec["integers"]
        return r.integers(lo, hi, size).astype(np.float64)
    if isinstance(spec, list):
        return r.choice(np.asarray(spec, np.float64), size)
    return np.full(size, float(spec))


def _draw_cards(spec: dict | None, n: int, seed: int) -> dict:
    """{cards, card_healthy} of gen_host_cluster(gpu=True): each node's
    cards drawn from one fixed set, the nodes' card sets in an order
    drawn from the seed; {} without node.cards."""
    if not spec:
        return {}
    c = int(spec["per_node"])
    r = rng(FIXED, STREAM_CARDS)
    metrics = np.stack([_card_values(r, spec[m], n * c) for m in CARD_METRICS], axis=1)
    healthy = r.random(n * c) < float(spec["healthy_share"])
    order = rng(seed, STREAM_CARDS).permutation(n)
    return dict(cards=metrics.reshape(n, c, len(CARD_METRICS))[order],
                card_healthy=healthy.reshape(n, c)[order])


class PodSource:
    """Pods in creation order: pod `i` has id i, the name `p<i>`, the i-th
    diskIO draw and, under pod.classes, the i-th class draw. The draws
    come in blocks of BLOCK pods: each block holds one fixed set of values
    (diskIO drawn as gen_host_pods draws the annotation; each class's
    share of the block), in an order drawn from the seed, so every seed
    gets the same work and a run that creates more pods than expected
    simply draws on."""

    BLOCK = 1 << 14

    def __init__(self, config: dict, seed: int):
        self.template = config["pod"]
        self._values = np.round(np.clip(
            rng(FIXED, STREAM_PODS).gamma(2.0, 5.0, self.BLOCK), 0.1, 45.0), 1)
        self._r = rng(seed, STREAM_PODS)
        self._io = np.empty(0)
        self.count = 0
        classes = self.template.get("classes")
        self._class_block = None if not classes else class_block(classes, self.BLOCK)
        self._rc = rng(seed, STREAM_CLASSES)
        self._cls = np.empty(0, np.int64)

    def disk_io(self, pid: int) -> float:
        while pid >= self._io.shape[0]:
            block = self._values[self._r.permutation(self.BLOCK)]
            self._io = np.concatenate([self._io, block])
        return float(self._io[pid])

    def draws(self) -> np.ndarray:
        """[count] diskIO of every pod created so far."""
        self.disk_io(max(self.count - 1, 0))
        return self._io[: self.count].copy()

    def pod_class(self, pid: int) -> int:
        """Index into pod.classes of pod `pid`; 0 without classes."""
        if self._class_block is None:
            return 0
        while pid >= self._cls.shape[0]:
            block = self._class_block[self._rc.permutation(self.BLOCK)]
            self._cls = np.concatenate([self._cls, block])
        return int(self._cls[pid])

    def classes(self) -> np.ndarray:
        """[count] class index of every pod created so far."""
        if self._class_block is None:
            return np.zeros(self.count, np.int64)
        self.pod_class(max(self.count - 1, 0))
        return self._cls[: self.count].copy()


def class_block(classes: list, size: int) -> np.ndarray:
    """[size] class indices, each class's share of `size` by largest
    remainder, in class order."""
    share = np.asarray([float(c["share"]) for c in classes])
    if (share < 0).any() or share.sum() <= 0:
        raise ValueError(f"pod.classes shares {share.tolist()} must be >= 0 with a positive sum")
    exact = share / share.sum() * size
    counts = np.floor(exact).astype(np.int64)
    rest = size - int(counts.sum())
    counts[np.argsort(-(exact - counts), kind="stable")[:rest]] += 1
    return np.repeat(np.arange(len(classes)), counts)


def pod_classes(template: dict) -> list:
    """[(labels, request)] of each class: the template's labels with the
    class's over them, and the class's cpu and memory where it gives them
    (request as pod_request gives it). Without classes, the template."""
    base = template.get("labels") or {}
    out = []
    for c in template.get("classes") or [{}]:
        labels = {**base, **(c.get("labels") or {})}
        req = {"cpu": c.get("cpu", template["cpu"]), "memory": c.get("memory", template["memory"])}
        out.append((labels, pod_request(req)))
    return out


def init_template(config: dict) -> dict | None:
    """The configuration's init_pod (labels {} where it gives none); None
    without init_pod."""
    init = config.get("init_pod")
    return None if init is None else {"labels": {}, **init}


def init_class_index(config: dict) -> int:
    """The class index the reference gives pods made from init_pod: one
    after pod's classes."""
    return len(config["pod"].get("classes") or [{}])


def pod_priority(labels: dict, priority) -> int:
    """The priority the program's queue gives a pod (host/queue.pod_priority):
    spec.priority where set, else the integer scv/priority label, else 0."""
    if priority is not None:
        return int(priority)
    try:
        return int(labels.get("scv/priority", 0))
    except (TypeError, ValueError):
        return 0


def class_priorities(template: dict) -> list:
    """[spec.priority or None] of each class of pod_classes(template): the
    class's priority, else the template's."""
    return [c.get("priority", template.get("priority"))
            for c in template.get("classes") or [{}]]


def pod_request(template: dict) -> np.ndarray:
    """[3] int64 request of the template: cpu, memory, one pod."""
    return np.array([template["cpu"], template["memory"], 1], dtype=np.int64)


def label_match(labels: dict, selector: dict) -> bool:
    return all(labels.get(k) == v for k, v in selector.items())
