"""Score normalization (counterpart of kubernetes_scheduler_tpu/ops/normalize.py):
the NormalizeScore extension point (pkg/yoda/scheduler.go:158-183) as a
per-pod min-max rescale with the reference's `highest == lowest` guard,
and the masked softmax the batched engine offers beside it."""

from __future__ import annotations

import torch

# framework.MaxNodeScore in the upstream scheduler framework.
MAX_NODE_SCORE = 100.0

F32_MAX = torch.finfo(torch.float32).max
F32_TINY = torch.finfo(torch.float32).tiny   # the smallest normal float32

# the softmax's logit on padded nodes
SOFTMAX_MASKED_LOGIT = -1.0e30


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


def min_max_normalize(
    scores: torch.Tensor,
    node_mask: torch.Tensor,
    *,
    max_node_score: float = MAX_NODE_SCORE,
    integer_parity: bool = False,
    bounds: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> torch.Tensor:
    """Per-pod rescale of [p, n] scores to [0, max_node_score] over valid
    nodes; padded nodes get 0.

    integer_parity: the Go path's int64 arithmetic (scores floored, the
    rescale truncated, scheduler.go:154,178). bounds: precomputed
    (highest, lowest) [p, 1], as score_bounds returns them."""
    if integer_parity:
        scores = torch.floor(scores)
    highest, lowest = score_bounds(scores, node_mask) if bounds is None else bounds
    lowest = torch.where(highest == lowest, lowest - 1.0, lowest)
    out = (scores - lowest) * max_node_score / (highest - lowest)
    if integer_parity:
        out = torch.trunc(out)
    return torch.where(node_mask[None, :], out, 0.0)


def softmax_normalize(
    scores: torch.Tensor, node_mask: torch.Tensor, *, temperature: float = 1.0
) -> torch.Tensor:
    """[p, n] masked softmax over the node axis (padded nodes get a -1e30
    logit, so a row with no valid node is uniform, as in the reference).
    Probabilities below the smallest normal float32 are 0: XLA flushes
    subnormal results to zero, so in the reference the nodes whose
    probability underflows tie at 0, and greedy takes the first of them."""
    # a device divisor: CUDA division by a host scalar multiplies by its
    # reciprocal, which rounds differently from the CPU's division
    logits = torch.where(
        node_mask[None, :], scores / scores.new_tensor(temperature),
        SOFTMAX_MASKED_LOGIT,
    )
    out = torch.softmax(logits, dim=-1)
    return torch.where(out >= F32_TINY, out, 0.0)
