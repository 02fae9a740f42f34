"""Synthetic cluster/pod generators (counterpart of
kubernetes_scheduler_tpu/sim/cluster_gen.py).

The same numpy `default_rng` call sequence as the reference, so one seed
gives the reference's arrays leaf for leaf; the leaves land as tensors on
`device` (default cuda) through make_snapshot / make_pod_batch.
BENCH_CONFIGS are BASELINE.md's five configs.
"""

from __future__ import annotations

import numpy as np

from kubernetes_scheduler_tpu_torch.engine import (
    PodBatch,
    SnapshotArrays,
    make_pod_batch,
    make_snapshot,
)
from kubernetes_scheduler_tpu_torch.ops.constraints import NO_SCHEDULE, OP_IN, TOL_EQUAL
from kubernetes_scheduler_tpu_torch.ops.resources import (
    DEFAULT_MEMORY_REQUEST,
    DEFAULT_MILLI_CPU_REQUEST,
)

# The five BASELINE.md configs: (name, n_pods, n_nodes, features)
BENCH_CONFIGS = {
    "single-pod": dict(n_pods=1, n_nodes=3),
    "deployment-50": dict(n_pods=100, n_nodes=50),
    "resources-5kx1k": dict(n_pods=5000, n_nodes=1000),
    "constraints-5kx5k": dict(n_pods=5000, n_nodes=5000, constraints=True),
    "gpu-10kx10k": dict(n_pods=10000, n_nodes=10000, gpu=True),
}


def gen_cluster(
    n_nodes: int,
    *,
    seed: int = 0,
    n_resources: int = 3,
    gpu: bool = False,
    cards_per_node: int = 4,
    constraints: bool = False,
    n_taint_keys: int = 4,
    n_label_keys: int = 8,
    n_selectors: int = 8,
    images: bool = False,
    n_images: int = 64,
    device=None,
) -> SnapshotArrays:
    """A cluster snapshot: allocatable/requested resources, utilization
    series (what the advisor would scrape), optional GPU cards, taints on
    ~20%% of nodes, zone-style labels, and selector match counts."""
    rng = np.random.default_rng(seed)
    # resource axis: (cpu milli, memory bytes, pods) [+ extended]
    alloc = np.stack(
        [
            rng.choice([4000, 8000, 16000, 32000], n_nodes).astype(np.float32),
            rng.choice([8, 16, 32, 64], n_nodes).astype(np.float32) * 2**30,
            np.full(n_nodes, 110, np.float32),
        ]
        + [
            rng.choice([0, 0, 4, 8], n_nodes).astype(np.float32)
            for _ in range(n_resources - 3)
        ],
        axis=1,
    )
    util_frac = rng.beta(2, 3, (n_nodes, alloc.shape[1])).astype(np.float32)
    requested = (alloc * util_frac).astype(np.float32)

    kwargs: dict = {}
    if gpu:
        cards = np.stack(
            [
                rng.integers(16, 64, (n_nodes, cards_per_node)),          # bandwidth
                rng.choice([1000, 1500, 2000], (n_nodes, cards_per_node)),  # clock
                rng.integers(1024, 8192, (n_nodes, cards_per_node)),      # core
                rng.integers(100, 400, (n_nodes, cards_per_node)),        # power
                rng.integers(0, 32_000, (n_nodes, cards_per_node)),       # free mem
                np.full((n_nodes, cards_per_node), 32_000),               # total mem
            ],
            axis=-1,
        ).astype(np.float32)
        kwargs.update(
            cards=cards,
            card_mask=rng.random((n_nodes, cards_per_node)) < 0.9,
            card_healthy=rng.random((n_nodes, cards_per_node)) < 0.95,
        )
    if constraints:
        t_max = 2
        taint_key = rng.integers(0, n_taint_keys, (n_nodes, t_max))
        taints = np.stack(
            [taint_key, rng.integers(0, 2, (n_nodes, t_max)),
             np.full((n_nodes, t_max), NO_SCHEDULE)],
            axis=-1,
        ).astype(np.int32)
        taint_mask = rng.random((n_nodes, t_max)) < 0.1
        l_max = 3
        labels = np.stack(
            [rng.integers(0, n_label_keys, (n_nodes, l_max)),
             rng.integers(0, 4, (n_nodes, l_max))],
            axis=-1,
        ).astype(np.int32)
        kwargs.update(
            taints=taints,
            taint_mask=taint_mask,
            node_labels=labels,
            node_label_mask=np.ones((n_nodes, l_max), bool),
            domain_counts=(rng.random((n_nodes, n_selectors)) < 0.3).astype(
                np.float32
            ) * rng.integers(1, 5, (n_nodes, n_selectors)),
            # sparse running avoiders exercising the reverse anti direction
            avoid_counts=(rng.random((n_nodes, n_selectors)) < 0.03).astype(
                np.float32
            ),
        )
    if images:
        # ImageLocality signal (host/snapshot precomputes the same form
        # from node.status.images): presence ~30%, sizes 50MB..2GB,
        # scaled by each image's cross-node spread ratio
        present = rng.random((n_nodes, n_images)) < 0.3
        sizes = rng.uniform(50, 2000, n_images).astype(np.float32) * 2**20
        ratio = present.sum(0).astype(np.float32) / max(n_nodes, 1)
        kwargs["image_scaled"] = (
            present * (sizes * ratio)[None, :]
        ).astype(np.float32)
    return make_snapshot(
        allocatable=alloc,
        requested=requested,
        disk_io=rng.gamma(2.0, 8.0, n_nodes).clip(0, 50),
        cpu_pct=(util_frac[:, 0] * 100).clip(0, 100),
        mem_pct=(util_frac[:, 1] * 100).clip(0, 100),
        net_up=rng.gamma(2.0, 2.0, n_nodes),
        net_down=rng.gamma(2.0, 2.0, n_nodes),
        device=device,
        **kwargs,
    )


def gen_pods(
    n_pods: int,
    *,
    seed: int = 1,
    n_resources: int = 3,
    gpu: bool = False,
    constraints: bool = False,
    n_taint_keys: int = 4,
    n_label_keys: int = 8,
    n_selectors: int = 8,
    images: bool = False,
    n_images: int = 64,
    device=None,
) -> PodBatch:
    """A pending-pod window shaped like example/test-pod.yaml at scale:
    CPU/memory requests (with the k8s non-zero defaults for the ~10%% of
    pods that specify nothing), a diskIO annotation, scv/priority labels,
    and optionally GPU demands / tolerations / affinity."""
    rng = np.random.default_rng(seed)
    cpu = rng.choice([0, 100, 250, 500, 1000, 2000], n_pods).astype(np.float32)
    cpu[cpu == 0] = DEFAULT_MILLI_CPU_REQUEST
    mem = rng.choice([0, 0.25, 0.5, 1, 2, 4], n_pods).astype(np.float32) * 2**30
    mem[mem == 0] = DEFAULT_MEMORY_REQUEST
    request = np.stack(
        [cpu, mem, np.ones(n_pods, np.float32)]
        + [
            (rng.random(n_pods) < (0.5 if gpu else 0.0)).astype(np.float32)
            * rng.integers(1, 3, n_pods)
            for _ in range(n_resources - 3)
        ],
        axis=1,
    )
    kwargs: dict = {}
    if gpu:
        kwargs.update(
            want_number=rng.choice([0, 1, 1, 2, 4], n_pods),
            want_memory=rng.choice([-1, -1, 8000, 16000], n_pods).astype(np.float32),
            want_clock=rng.choice([-1, -1, -1, 1500], n_pods).astype(np.float32),
        )
    if constraints:
        l_max = 2
        tols = np.stack(
            [
                rng.integers(0, n_taint_keys, (n_pods, l_max)),
                rng.integers(0, 2, (n_pods, l_max)),
                np.full((n_pods, l_max), TOL_EQUAL),
                np.zeros((n_pods, l_max)),
            ],
            axis=-1,
        ).astype(np.int32)
        e_max, v_max = 1, 2
        kwargs.update(
            tolerations=tols,
            tol_mask=rng.random((n_pods, l_max)) < 0.3,
            na_key=rng.integers(0, n_label_keys, (n_pods, e_max)),
            na_op=np.full((n_pods, e_max), OP_IN),
            na_vals=rng.integers(0, 4, (n_pods, e_max, v_max)),
            na_val_mask=np.ones((n_pods, e_max, v_max), bool),
            na_mask=rng.random((n_pods, e_max)) < 0.2,
            affinity_sel=np.where(
                rng.random((n_pods, 1)) < 0.15,
                rng.integers(0, n_selectors, (n_pods, 1)),
                -1,
            ),
            anti_affinity_sel=np.where(
                rng.random((n_pods, 1)) < 0.15,
                rng.integers(0, n_selectors, (n_pods, 1)),
                -1,
            ),
            # pending pods themselves match selectors, so placements inside
            # one window interact (the hard case for batched assignment)
            pod_matches=rng.random((n_pods, n_selectors)) < 0.15,
        )
    if images:
        # 1-3 container images per pod from the shared vocabulary
        ki = 3
        ids = rng.integers(0, n_images, (n_pods, ki)).astype(np.int32)
        n_c = rng.integers(1, ki + 1, n_pods).astype(np.int32)
        ids[np.arange(ki)[None, :] >= n_c[:, None]] = -1
        kwargs.update(image_ids=ids, n_containers=n_c)
    return make_pod_batch(
        request=request,
        r_io=rng.gamma(2.0, 5.0, n_pods).clip(0.1, 45),
        priority=rng.integers(0, 10, n_pods),
        device=device,
        **kwargs,
    )


def gen_config(name: str, *, seed: int = 0, device=None):
    """(snapshot, pods) for one of the five BASELINE.md configs."""
    cfg = dict(BENCH_CONFIGS[name])
    n_pods = cfg.pop("n_pods")
    n_nodes = cfg.pop("n_nodes")
    snap = gen_cluster(n_nodes, seed=seed, device=device, **cfg)
    pods = gen_pods(n_pods, seed=seed + 1, device=device, **cfg)
    return snap, pods
