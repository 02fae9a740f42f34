"""Batched pod -> node assignment (counterpart of
kubernetes_scheduler_tpu/ops/assign.py): the price-guided parallel auction
without inter-pod affinity, and the helpers it shares with the engine.

Each auction round, every unassigned pod bids on its best feasible node
by value = score - price; per node, bidders are admitted in priority
order while their cumulative request fits; nodes that rejected bidders
raise their price. The round's bid head is kernel K3
(ops/fused.auction_bid).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

NEG = -1.0e30

# auction rounds between host reads of the any-bid flag
CHECK_EVERY = 8

_U32 = 0xFFFFFFFF


class AssignResult(NamedTuple):
    node_idx: torch.Tensor    # [p] int32, assigned node or -1
    free_after: torch.Tensor  # [n, r] remaining free capacity
    n_assigned: torch.Tensor  # [] int32


def tie_jitter(p: int, n: int, scale: float, *, device: torch.device) -> torch.Tensor:
    """[p, n] float32 deterministic tie-break jitter in [0, scale): a
    counter-based hash of (row, column), bit-identical to the
    reference's uint32 arithmetic. The uint32 wrap-around is emulated in
    int64, masked to 32 bits after every multiply and add; the kept 24
    bits convert to float32 exactly."""
    r = torch.arange(p, dtype=torch.int64, device=device)[:, None]
    c = torch.arange(n, dtype=torch.int64, device=device)[None, :]
    x = (_mul32(r, 0x9E3779B9) + _mul32(c, 0x85EBCA6B) + 1) & _U32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    x = x ^ (x >> 16)
    u = (x >> 8).to(torch.float32) * (1.0 / (1 << 24))
    return u * scale


def _mul32(x: torch.Tensor, k: int) -> torch.Tensor:
    """(x * k) mod 2**32 for int64 x in [0, 2**32) and a 32-bit constant,
    in two 16-bit halves of k so no int64 product overflows."""
    lo = (x * (k & 0xFFFF)) & _U32
    hi = ((x * (k >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _U32


def pod_has_anti_onehot(anti_affinity_sel: torch.Tensor, s: int) -> torch.Tensor:
    """[p, S] bool one-hot union of each pod's selector ids (-1 padded;
    ids are clipped into [0, S) like the reference's scatter)."""
    tc = torch.clamp(anti_affinity_sel, 0, max(s - 1, 0)).long()       # [p, K]
    cols = torch.arange(s, device=anti_affinity_sel.device)
    hot = (tc[:, :, None] == cols) & (anti_affinity_sel >= 0)[:, :, None]
    return hot.any(1)


def _priority_order(priority: torch.Tensor, pod_mask: torch.Tensor) -> torch.Tensor:
    """Stable order: valid pods by descending priority, padding last;
    ties keep queue (index) order (pkg/yoda/sort/sort.go:8-10)."""
    key = torch.where(pod_mask, priority.to(torch.int32), -(2**31) + 1)
    return torch.argsort(-key, stable=True)


def _segmented_admission(
    bid: torch.Tensor,
    has_bid: torch.Tensor,
    pod_request: torch.Tensor,
    free: torch.Tensor,
    by_prio: torch.Tensor,
) -> torch.Tensor:
    """[p] bool: per node, admit bidders in (priority desc, index asc)
    order while the cumulative request including self fits the node's
    free capacity: sort bidders by node (stable over the priority
    order), segmented prefix sum of requests, compare with capacity.

    The prefix sums are exact, in any grouping, while partial sums stay
    representable: true for the generator's integer CPU requests and
    memory requests in multiples of 2**23 bytes."""
    p = bid.shape[0]
    n = free.shape[0]
    dev = bid.device
    has_s = has_bid[by_prio]
    bid_p = torch.where(has_s, bid[by_prio], n)                  # [p]
    by_node = torch.argsort(bid_p, stable=True)
    order = by_prio[by_node]
    bid_s = bid_p[by_node]
    has_o = has_bid[order]
    req_s = torch.where(has_o[:, None], pod_request[order], 0.0)
    total = torch.cumsum(req_s, dim=0)                           # [p, r]
    idx = torch.arange(p, device=dev)
    boundary = torch.ones(p, dtype=torch.bool, device=dev)
    boundary[1:] = bid_s[1:] != bid_s[:-1]
    start = torch.cummax(torch.where(boundary, idx, 0), dim=0).values
    base = torch.where(
        (start > 0)[:, None], total[torch.clamp(start - 1, min=0)], 0.0
    )
    cum = total - base                                           # incl. self
    cap = free[torch.clamp(bid_s, max=n - 1).long()]             # [p, r]
    fits = ((cum <= cap) | (cum == 0)).all(-1) & has_o
    admitted = torch.zeros(p, dtype=torch.bool, device=dev)
    admitted[order] = fits
    return admitted


def auction_values(
    scores: torch.Tensor, feasible: torch.Tensor, price_frac: float
) -> torch.Tensor:
    """[p, n] round-invariant bid values of the auction (K3's `sj`): each
    row min-maxed to [0, 1] over its feasible entries (the price vector is
    shared across pods, so rows must share a scale), plus the tie jitter,
    NEG where infeasible."""
    p, n = scores.shape
    row_hi = torch.where(feasible, scores, -torch.inf).amax(dim=1, keepdim=True)
    row_lo = torch.where(feasible, scores, torch.inf).amin(dim=1, keepdim=True)
    row_ok = torch.isfinite(row_hi) & torch.isfinite(row_lo)
    denom = torch.where(row_ok, torch.clamp(row_hi - row_lo, min=1e-6), 1.0)
    scores = torch.where(
        row_ok, (scores - torch.where(row_ok, row_lo, 0.0)) / denom, 0.0
    )
    jitter = tie_jitter(p, n, 0.01 * price_frac, device=scores.device)
    return torch.where(feasible, scores + jitter, NEG).contiguous()


def auction_assign(
    scores: torch.Tensor,
    feasible: torch.Tensor,
    pod_request: torch.Tensor,
    node_free: torch.Tensor,
    priority: torch.Tensor,
    pod_mask: torch.Tensor,
    *,
    rounds: int = 1024,
    price_frac: float = 1.0,
    affinity=None,
    _plain: bool = False,
) -> AssignResult:
    """Price-guided parallel auction, rounds of bid -> admit -> reprice,
    for windows without inter-pod affinity.

    scores [p, n] float32, feasible [p, n] bool, pod_request [p, r],
    node_free [n, r], priority [p] int, pod_mask [p] bool.

    Stops when no active pod can bid (the assignment is maximal) or
    after `rounds`. The host reads the any-bid flag every CHECK_EVERY
    rounds rather than every round, so the device queue does not drain
    each round. A round in which nobody bids is a no-op (nothing is
    admitted; free capacity and prices are unchanged), so the up to
    CHECK_EVERY - 1 extra rounds leave the result bit-identical to
    stopping at the first such round, as the reference's while_loop does.

    `_plain=True` routes the bid head through K3's plain PyTorch version
    on any device (for holding the kernel path against it on the card).
    """
    if affinity is not None:
        raise NotImplementedError(
            "auction_assign with inter-pod affinity (affinity_aware=True) is "
            "not ported yet: ROADMAP queue A, 'affinity-aware auction and greedy'"
        )
    from kubernetes_scheduler_tpu_torch.ops.fused import auction_bid

    p, n = scores.shape
    sj = auction_values(scores, feasible, price_frac)
    by_prio = _priority_order(priority, pod_mask)
    req = pod_request.to(torch.float32).contiguous()

    assigned = torch.full((p,), -1, dtype=torch.int32, device=scores.device)
    free = node_free.to(torch.float32)
    price = torch.zeros(n, dtype=torch.float32, device=scores.device)
    for rnd in range(rounds):
        active = pod_mask & (assigned < 0)
        bid, has_bid = auction_bid(sj, price, active, req, free, _plain=_plain)
        admitted = _segmented_admission(bid, has_bid, req, free, by_prio)
        assigned = torch.where(admitted, bid, assigned)
        bid_l = bid.long()
        used = torch.zeros_like(free).index_add_(
            0, bid_l, torch.where(admitted[:, None], req, 0.0)
        )
        rejected = torch.zeros(n, dtype=torch.int32, device=scores.device)
        rejected.scatter_reduce_(0, bid_l, (has_bid & ~admitted).to(torch.int32), "amax")
        free = free - used
        price = price + torch.where(rejected > 0, price_frac, 0.0)
        if (rnd + 1) % CHECK_EVERY == 0 and not bool(has_bid.any()):
            break
    return AssignResult(
        node_idx=assigned,
        free_after=free,
        n_assigned=(assigned >= 0).sum().to(torch.int32),
    )
