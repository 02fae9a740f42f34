"""Per-pod maxima of the GPU-card metrics (counterpart of
kubernetes_scheduler_tpu/ops/collect.py): the reference's host-side walk
over the SCV list (pkg/yoda/collection/collection.go:30-76) as a masked
max over the [node, card] axes, every maximum seeded at 1
(collection.go:31-38) so that `metric * 100 / max` never divides by 0."""

from __future__ import annotations

import torch


def local_max_card_values(cards: torch.Tensor, fits: torch.Tensor) -> torch.Tensor:
    """[p, 6] max per metric over each pod's fitting cards, 0 where none
    fits. cards [n, c, 6]; fits [p, n, c] bool."""
    masked = torch.where(fits[..., None], cards[None, :, :, :], 0.0)
    return masked.amax(dim=(1, 2))


def collect_max_card_values(cards: torch.Tensor, fits: torch.Tensor) -> torch.Tensor:
    """[p, 6] max per metric over each pod's fitting cards, seeded at 1."""
    return torch.clamp(local_max_card_values(cards, fits), min=1.0)
