"""Feasibility masks over the whole batch (counterpart of
kubernetes_scheduler_tpu/ops/feasibility.py): NodeResourcesFit
(pkg/yoda/score/algorithm.go:209-262) and the GPU-card predicates
(pkg/yoda/filter/filter.go:11-58) as boolean [p, n] tensors."""

from __future__ import annotations

import torch


def resource_fit(
    allocatable: torch.Tensor,
    requested: torch.Tensor,
    pod_request: torch.Tensor,
    node_mask: torch.Tensor,
) -> torch.Tensor:
    """F[p, n]: requested + pod_request <= allocatable on every resource
    the pod requests (an unrequested resource never excludes a node).

    allocatable, requested: [n, r] float32; pod_request: [p, r] float32;
    node_mask: [n] bool.
    """
    fits = requested[None, :, :] + pod_request[:, None, :] <= allocatable[None, :, :]
    fits = fits | (pod_request[:, None, :] == 0)
    return fits.all(-1) & node_mask[None, :]


def card_fit(
    cards: torch.Tensor,
    card_mask: torch.Tensor,
    card_healthy: torch.Tensor,
    want_number: torch.Tensor,
    want_memory: torch.Tensor,
    want_clock: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """GPU-card feasibility: (node_fits [p, n] bool, per_card [p, n, c] bool).

    cards [n, c, 6] in metric order (bandwidth, clock, core, power,
    free_memory, total_memory); want_number 0 = no GPU demand (fits every
    node); want_memory / want_clock -1 = label absent (unconstrained).
    A node fits iff it has want_number cards, and want_number healthy
    cards with free memory >= want_memory and clock == want_clock.
    per_card marks the cards that meet both demands for scoring
    (free memory >= want, clock >= want; no health check, as upstream).
    """
    free_mem = cards[..., 4]  # [n, c]
    clock = cards[..., 1]
    healthy = card_healthy & card_mask
    mem_ok = healthy[None, :, :] & (free_mem[None, :, :] >= want_memory[:, None, None])
    clock_ok = healthy[None, :, :] & (clock[None, :, :] == want_clock[:, None, None])

    card_number = card_mask.sum(-1)  # [n]
    n_mem = mem_ok.sum(-1)  # [p, n]
    n_clock = clock_ok.sum(-1)

    number_fits = want_number[:, None] <= card_number[None, :]
    mem_fits = (want_memory < 0)[:, None] | (n_mem >= want_number[:, None])
    clock_fits = (want_clock < 0)[:, None] | (n_clock >= want_number[:, None])
    node_fits = (want_number == 0)[:, None] | (number_fits & mem_fits & clock_fits)

    score_mem = torch.clamp(want_memory, min=0)
    score_clock = torch.clamp(want_clock, min=0)
    per_card = (
        card_mask[None, :, :]
        & (free_mem[None, :, :] >= score_mem[:, None, None])
        & (clock[None, :, :] >= score_clock[:, None, None])
    )
    return node_fits, per_card
