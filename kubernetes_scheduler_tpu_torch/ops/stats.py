"""Cluster-wide utilization statistics (counterpart of
kubernetes_scheduler_tpu/ops/stats.py): U/V per node and the masked mean and
variance of U, the reference's per-node Redis loops
(pkg/yoda/score/algorithm.go:67-89) as tensor reductions."""

from __future__ import annotations

from typing import NamedTuple

import torch

# Normalization divisors hard-coded in the reference
# (pkg/yoda/score/algorithm.go:71: Ui = DiskIO / 50.0, :73: Vi = Cpu / 100.0).
DISK_IO_DIVISOR = 50.0
CPU_DIVISOR = 100.0


class UtilizationStats(NamedTuple):
    u: torch.Tensor        # [n] disk-IO utilization, DiskIO / 50
    v: torch.Tensor        # [n] CPU utilization, Cpu% / 100
    u_avg: torch.Tensor    # [] masked mean of u
    m_var: torch.Tensor    # [] masked population variance of u ("M_tmp")
    n_valid: torch.Tensor  # [] number of valid (unpadded) nodes


def utilization_stats(
    disk_io: torch.Tensor, cpu_pct: torch.Tensor, node_mask: torch.Tensor
) -> UtilizationStats:
    """U, V, u_avg and M_tmp over the valid nodes.

    disk_io:   [n] float32 MB/s per node
    cpu_pct:   [n] float32 CPU% per node
    node_mask: [n] bool, True for real nodes
    """
    mask = node_mask.to(disk_io.dtype)
    n_valid = torch.clamp(mask.sum(), min=1.0)
    # divisors as device tensors: PyTorch's CUDA division by a host scalar
    # multiplies by its reciprocal, which rounds differently from x / 50;
    # new_full fills them on the device (no host copy)
    u = disk_io / disk_io.new_full((), DISK_IO_DIVISOR)
    v = cpu_pct / cpu_pct.new_full((), CPU_DIVISOR)
    u_avg = (u * mask).sum() / n_valid
    m_var = (((u - u_avg) ** 2) * mask).sum() / n_valid
    return UtilizationStats(u=u, v=v, u_avg=u_avg, m_var=m_var, n_valid=n_valid)
