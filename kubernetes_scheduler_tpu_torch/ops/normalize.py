"""Min-max score normalization (counterpart of
kubernetes_scheduler_tpu/ops/normalize.py, `score_bounds` and
`min_max_normalize`): the NormalizeScore extension point
(pkg/yoda/scheduler.go:158-183), with the reference's `highest == lowest`
guard."""

from __future__ import annotations

import torch

# framework.MaxNodeScore in the upstream scheduler framework.
MAX_NODE_SCORE = 100.0

F32_MAX = torch.finfo(torch.float32).max


def score_bounds(
    scores: torch.Tensor, node_mask: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-pod (highest, lowest) over valid nodes, shapes [p, 1] each;
    highest is floored at 0 (scheduler.go:162 seeds it with 0)."""
    masked_hi = torch.where(node_mask[None, :], scores, -F32_MAX)
    masked_lo = torch.where(node_mask[None, :], scores, F32_MAX)
    highest = torch.clamp(masked_hi.amax(dim=1, keepdim=True), min=0.0)
    lowest = masked_lo.amin(dim=1, keepdim=True)
    return highest, lowest


def min_max_normalize(scores: torch.Tensor, node_mask: torch.Tensor) -> torch.Tensor:
    """Per-pod rescale of [p, n] scores to [0, MAX_NODE_SCORE] over valid
    nodes; padded nodes get 0."""
    highest, lowest = score_bounds(scores, node_mask)
    lowest = torch.where(highest == lowest, lowest - 1.0, lowest)
    out = (scores - lowest) * MAX_NODE_SCORE / (highest - lowest)
    return torch.where(node_mask[None, :], out, 0.0)
