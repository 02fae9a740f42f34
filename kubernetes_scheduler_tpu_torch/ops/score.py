"""Scoring policies over the whole pod x node batch (counterpart of
kubernetes_scheduler_tpu/ops/score.py): the live BalancedCpuDiskIOPriority
(pkg/yoda/score/algorithm.go:99-119), the reference's legacy policies
(balanced disk IO, free capacity, GPU cards) and the k8s 1.22 default
resource-shape scorers of its production configuration. Each returns raw
float32 scores ([p, n], or [n] for the pod-independent free capacity)
with padded nodes left in place; callers mask."""

from __future__ import annotations

import torch

from kubernetes_scheduler_tpu_torch.ops.normalize import F32_MAX
from kubernetes_scheduler_tpu_torch.ops.stats import UtilizationStats

# Legacy per-metric weights from the reference's scoring constants
# (pkg/yoda/score/algorithm.go:24-35).
BANDWIDTH_WEIGHT = 1.0
CLOCK_WEIGHT = 1.0
CORE_WEIGHT = 2.0
POWER_WEIGHT = 1.0
FREE_MEMORY_WEIGHT = 3.0
TOTAL_MEMORY_WEIGHT = 1.0
DISK_IO_WEIGHT = 100.0

# Raw score range of the live policy (pkg/yoda/score/algorithm.go:111).
MAX_RAW_SCORE = 10.0

# The upstream scorers' range (framework.MaxNodeScore), and ImageLocality's
# per-container image footprint thresholds (23 MB and 1000 MB).
MAX_NODE_SCORE = 100.0
IMAGE_MIN_THRESHOLD = 23.0 * 1024 * 1024
IMAGE_MAX_THRESHOLD = 1000.0 * 1024 * 1024


def alpha_beta(
    r_cpu: torch.Tensor, r_io: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """(alpha[p], beta[p]) pod weights: beta = 1/(1 + Rcpu/Rio),
    alpha = 1 - beta. A missing/zero diskIO annotation gives the Go
    Rcpu/0 = +Inf limit (beta = 0, alpha = 1) explicitly. Shared by the
    plain policy below and the fused kernel wrapper (ops/fused.py)."""
    r_cpu = r_cpu.to(torch.float32)
    r_io = r_io.to(torch.float32)
    has_io = r_io > 0
    safe_io = torch.where(has_io, r_io, 1.0)
    beta = torch.where(has_io, 1.0 / (1.0 + r_cpu / safe_io), 0.0)
    return 1.0 - beta, beta


def balanced_cpu_diskio(
    stats: UtilizationStats, r_cpu: torch.Tensor, r_io: torch.Tensor
) -> torch.Tensor:
    """S[p, n] = 10 - 10 * |alpha[p] * V[n] - beta[p] * U[n]| (float32).

    r_cpu: [p] pod CPU request in millicores
    r_io:  [p] pod `diskIO` annotation in MB/s (0 = absent)
    """
    alpha, beta = alpha_beta(r_cpu, r_io)
    load = torch.abs(
        alpha[:, None] * stats.v[None, :] - beta[:, None] * stats.u[None, :]
    )
    return MAX_RAW_SCORE - MAX_RAW_SCORE * load


# ---- legacy policies (algorithm.go:121-198, 264-291) --------------------


def balanced_diskio(
    stats: UtilizationStats,
    disk_io: torch.Tensor,
    r_io: torch.Tensor,
    node_mask: torch.Tensor,
) -> torch.Tensor:
    """BalancedDiskIOPriority (algorithm.go:121-176): the variance Mj of
    disk-IO utilization after placing the pod on node j, min-max rescaled
    to S = 100 - 100 * (Mj - M_min) / (M_max - M_min). The bounds keep the
    reference's seeds (M_max from 0, M_min from 1e6, algorithm.go:122-123),
    so they include those values whenever every Mj is positive (resp.
    below 1e6). disk_io [n] MB/s, r_io [p]; returns S[p, n]."""
    m = balanced_diskio_m(stats, disk_io, r_io)
    m_hi, m_lo = balanced_diskio_local_bounds(m, node_mask)
    return balanced_diskio_from_m(m, m_hi, m_lo)


def balanced_diskio_m(
    stats: UtilizationStats, disk_io: torch.Tensor, r_io: torch.Tensor
) -> torch.Tensor:
    """The per-(pod, node) Mj statistic (algorithm.go:138-151)."""
    n = stats.n_valid
    t = disk_io[None, :] + r_io[:, None].to(torch.float32)   # [p, n]
    # a device divisor, as in ops/stats.py
    f = t / t.new_tensor(100.0)
    u = stats.u[None, :]
    f_avg = stats.u_avg - (u - f) / n
    return stats.m_var - ((u - stats.u_avg) ** 2 - (f - f_avg) ** 2) / n


def balanced_diskio_local_bounds(
    m: torch.Tensor, node_mask: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """(m_max, m_min) [p, 1] over valid nodes with the reference's
    sentinel seeds: m_max at least 0, m_min at most 1e6."""
    m_masked_max = torch.where(node_mask[None, :], m, -F32_MAX)
    m_masked_min = torch.where(node_mask[None, :], m, F32_MAX)
    m_max = torch.clamp(m_masked_max.amax(dim=1, keepdim=True), min=0.0)
    m_min = torch.clamp(m_masked_min.amin(dim=1, keepdim=True), max=1.0e6)
    return m_max, m_min


def balanced_diskio_from_m(
    m: torch.Tensor, m_max: torch.Tensor, m_min: torch.Tensor
) -> torch.Tensor:
    """The rescale of Mj to [0, 100] (algorithm.go:163-172)."""
    denom = m_max - m_min
    safe = torch.where(denom != 0, denom, 1.0)
    return 100.0 - 100.0 * (m - m_min) / safe


def free_capacity(
    cpu_pct: torch.Tensor,
    mem_pct: torch.Tensor,
    disk_io: torch.Tensor,
    *,
    disk_io_weight: float = DISK_IO_WEIGHT,
    cpu_weight: float = CORE_WEIGHT,
    memory_weight: float = FREE_MEMORY_WEIGHT,
) -> torch.Tensor:
    """CalculateBasicScore2 (algorithm.go:178-198), pod-independent:
    S[n] = 100 * (100 - floor(DiskIO)) + 2 * (100 - Cpu) + 3 * (100 - Memory)
    (the reference truncates DiskIO to int64 first, algorithm.go:189)."""
    disk_score = disk_io_weight * (100.0 - torch.floor(disk_io))
    cpu_score = cpu_weight * (100.0 - cpu_pct)
    mem_score = memory_weight * (100.0 - mem_pct)
    return disk_score + cpu_score + mem_score


def card_score(
    cards: torch.Tensor,
    card_mask: torch.Tensor,
    fits: torch.Tensor,
    max_values: torch.Tensor,
    *,
    reference_clock_bug: bool = False,
    integer_parity: bool = False,
) -> torch.Tensor:
    """GPU-card scoring (algorithm.go:264-291): each fitting card adds
    sum_k weight_k * metric_k * 100 / max_k over (bandwidth, clock, core,
    power, free memory, total memory) with weights 1, 1, 2, 1, 3, 1,
    summed per node.

    cards [n, c, 6]; card_mask [n, c]; fits [p, n, c] (feasibility.card_fit);
    max_values [p, 6] (collect.collect_max_card_values).
    reference_clock_bug: normalize clock by the maximum bandwidth, as
    algorithm.go:283 does. integer_parity: each `metric * 100 / max` is
    the Go path's integer division (metrics are integers < 2**24, so int32
    arithmetic is exact). Returns S[p, n]; the [p, n, c, 6] ratio tensor
    lives only inside this call."""
    weights = cards.new_tensor([
        BANDWIDTH_WEIGHT, CLOCK_WEIGHT, CORE_WEIGHT, POWER_WEIGHT,
        FREE_MEMORY_WEIGHT, TOTAL_MEMORY_WEIGHT,
    ])
    denom = max_values
    if reference_clock_bug:
        denom = torch.cat([denom[:, :1], denom[:, :1], denom[:, 2:]], dim=1)
    denom = torch.clamp(denom, min=1.0)
    if integer_parity:
        ratio = (
            cards[None, :, :, :].to(torch.int32) * 100
            // denom[:, None, None, :].to(torch.int32)
        ).to(torch.float32)
    else:
        ratio = cards[None, :, :, :] * 100.0 / denom[:, None, None, :]  # [p, n, c, 6]
    per_card = (ratio * weights).sum(-1)                                   # [p, n, c]
    valid = fits & card_mask[None, :, :]
    return (per_card * valid).sum(-1)


# ---- the k8s 1.22 default resource-shape scorers ------------------------
# The reference's deployed config enables yoda beside the kube-scheduler
# defaults (deploy/yoda-scheduler.yaml:21-47 disables none), so its
# production score is the framework's weighted sum of yoda and these.


def least_allocated(
    allocatable: torch.Tensor,
    requested: torch.Tensor,
    pod_request: torch.Tensor,
    *,
    resource_cols: tuple = (0, 1),
) -> torch.Tensor:
    """NodeResourcesLeastAllocated: the mean over cpu and memory of
    (alloc - req - pod) * 100 / alloc, a resource with alloc == 0 or
    req + pod > alloc adding 0. Returns S[p, n]."""
    cols = list(resource_cols)
    alloc = allocatable[:, cols]                                    # [n, 2]
    req = requested[:, cols][None] + pod_request[:, cols][:, None]  # [p, n, 2]
    free = alloc[None] - req
    frac = torch.where(
        (alloc[None] > 0) & (free >= 0),
        free * MAX_NODE_SCORE / torch.clamp(alloc[None], min=1e-9),
        0.0,
    )
    return frac.mean(-1)


def balanced_allocation(
    allocatable: torch.Tensor,
    requested: torch.Tensor,
    pod_request: torch.Tensor,
    *,
    resource_cols: tuple = (0, 1),
) -> torch.Tensor:
    """NodeResourcesBalancedAllocation (the 1.22 two-resource formula):
    with cpuF and memF the fractions (req + pod) / alloc,
    S = (1 - |cpuF - memF|) * 100, and 0 where a fraction reaches 1 or an
    alloc is 0. Returns S[p, n]."""
    cols = list(resource_cols)
    alloc = allocatable[:, cols]                                    # [n, 2]
    req = requested[:, cols][None] + pod_request[:, cols][:, None]  # [p, n, 2]
    frac = req / torch.clamp(alloc[None], min=1e-9)
    ok = (alloc[None] > 0).all(-1) & (frac < 1.0).all(-1)           # [p, n]
    diff = torch.abs(frac[..., 0] - frac[..., 1])
    return torch.where(ok, (1.0 - diff) * MAX_NODE_SCORE, 0.0)


def image_locality(
    image_scaled: torch.Tensor,
    image_ids: torch.Tensor,
    n_containers: torch.Tensor,
) -> torch.Tensor:
    """ImageLocality: the summed scaled size of the pod's images already on
    the node, ramped between 23 MB and 1000 MB per container to [0, 100].

    image_scaled [n, V]: present * size * (nodes holding it / nodes), the
    host's precomputed upstream scaledImageScore; image_ids [p, Ki] image
    ids, -1 padded; n_containers [p]. Returns S[p, n]."""
    v = image_scaled.shape[1]
    ids = torch.clamp(image_ids, 0, max(v - 1, 0)).long()         # [p, Ki]
    got = image_scaled[:, ids]                                      # [n, p, Ki]
    summed = (got * (image_ids >= 0)[None]).sum(-1).T               # [p, n]
    c = torch.clamp(n_containers.to(torch.float32), min=1.0)[:, None]
    lo = IMAGE_MIN_THRESHOLD * c
    hi = IMAGE_MAX_THRESHOLD * c
    return torch.clamp((summed - lo) / (hi - lo), 0.0, 1.0) * MAX_NODE_SCORE
