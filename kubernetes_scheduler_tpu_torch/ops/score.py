"""The live scoring policy (counterpart of kubernetes_scheduler_tpu/ops/score.py,
`alpha_beta` and `balanced_cpu_diskio` only): BalancedCpuDiskIOPriority
(pkg/yoda/score/algorithm.go:99-119) over the whole pod x node batch."""

from __future__ import annotations

import torch

from kubernetes_scheduler_tpu_torch.ops.stats import UtilizationStats

# Raw score range of the live policy (pkg/yoda/score/algorithm.go:111).
MAX_RAW_SCORE = 10.0


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
