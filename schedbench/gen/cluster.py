"""Nodes, node utilisation and pods of one configuration, drawn from the seed.

The draws are frozen copies of kubernetes_scheduler_tpu_torch/sim/host_gen.py
(node utilisation as a seeded stand-in for Prometheus, and Yoda's `diskIO`
pod annotation), reshaped to the configuration's node and pod templates.
The draws are plain numpy arrays; `build_nodes` / `make_pod` turn them
into the program's host objects. Everything here is a pure function of
(configuration, seed), so the reference rebuilds the same cluster from the
same arrays.
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

RESOURCES = ("cpu", "memory", "pods")
HOSTNAME = "kubernetes.io/hostname"


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


def draw_cluster(config: dict, seed: int) -> Cluster:
    """The configuration's nodes, all of its node template, with
    utilisation drawn as sim/host_gen.gen_host_cluster draws it: one fixed
    set of values, spread over the nodes in an order drawn from the seed."""
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
    )


class PodSource:
    """Pods in creation order: pod `i` has id i, the name `p<i>` and the
    i-th diskIO draw. The draws come in blocks of BLOCK pods: each block
    holds one fixed set of values (drawn as gen_host_pods draws the
    annotation), in an order drawn from the seed, so a run that creates
    more pods than expected simply draws on."""

    BLOCK = 1 << 14

    def __init__(self, config: dict, seed: int):
        self.template = config["pod"]
        self._values = np.round(np.clip(
            rng(FIXED, STREAM_PODS).gamma(2.0, 5.0, self.BLOCK), 0.1, 45.0), 1)
        self._r = rng(seed, STREAM_PODS)
        self._io = np.empty(0)
        self.count = 0

    def disk_io(self, pid: int) -> float:
        while pid >= self._io.shape[0]:
            block = self._values[self._r.permutation(self.BLOCK)]
            self._io = np.concatenate([self._io, block])
        return float(self._io[pid])

    def draws(self) -> np.ndarray:
        """[count] diskIO of every pod created so far."""
        self.disk_io(max(self.count - 1, 0))
        return self._io[: self.count].copy()


def pod_request(template: dict) -> np.ndarray:
    """[3] int64 request of the template: cpu, memory, one pod."""
    return np.array([template["cpu"], template["memory"], 1], dtype=np.int64)


def label_match(labels: dict, selector: dict) -> bool:
    return all(labels.get(k) == v for k, v in selector.items())
