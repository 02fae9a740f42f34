"""Batched pod -> node assignment (counterpart of
kubernetes_scheduler_tpu/ops/assign.py): the sequential greedy assigner,
the price-guided parallel auction, and the in-window inter-pod
(anti)affinity machinery both share.

- `greedy_assign`: pods in priority order each take their best-scoring
  feasible node that still has capacity, capacity decremented before the
  next pod. Without affinity the scan is kernel K4 (ops/fused.greedy_scan);
  with an AffinityState it is a loop over pods in plain PyTorch carrying
  live domain counts (the reference's XLA scan has no kernel either).
- `auction_assign`: rounds of simultaneous bidding by value = score -
  price; per node, bidders are admitted in priority order while their
  cumulative request fits; nodes that rejected bidders raise their price.
  Without affinity the round's bid head is kernel K3
  (ops/fused.auction_bid); with affinity the bid mask is recomputed per
  round against live counts and same-round conflicts are evicted; on a
  CUDA device those rounds replay as captured CUDA graphs, one a block of
  CHECK_EVERY rounds (RoundGraphCache).

Both return -1 for pods that fit nowhere. Neither reads the device from
the host per pod; the auction reads one any-bid flag every CHECK_EVERY
rounds. Under a published ENGINE_TRACE (trace/engine_context) the
auction counts its rounds and replayed blocks there and, with spans on,
adds an `auction` span, one `auction_round` span an eager round and one
`auction_block` span a replayed block.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import NamedTuple

import torch

from kubernetes_scheduler_tpu_torch.ops.normalize import F32_MAX
from kubernetes_scheduler_tpu_torch.trace.engine_context import ENGINE_TRACE

NEG = -1.0e30

# auction rounds between host reads of the any-bid flag
CHECK_EVERY = 8

# element budgets for trading the dense compare-and-reduce forms against
# the representative-row scatter forms (the reference's, ops/assign.py:55-56);
# tests patch them to hold the two forms equal without large arrays
DENSE_EVICT_BUDGET = 1 << 25   # [p, q, S] same-domain tensor in eviction
DENSE_FOLD_BUDGET = 1 << 27    # [p, n, S] carry fold in the round body

_U32 = 0xFFFFFFFF


class AssignResult(NamedTuple):
    node_idx: torch.Tensor    # [p] int32, assigned node or -1
    free_after: torch.Tensor  # [n, r] remaining free capacity
    n_assigned: torch.Tensor  # [] int32


class AffinityState(NamedTuple):
    """Inter-pod (anti)affinity and hard spread state threaded through
    both assigners (reference: ops/assign.AffinityState), so pod B sees
    pod A's placement inside one window as the upstream scheduler's
    re-snapshot between single-pod cycles would show it."""

    domain_counts: torch.Tensor      # [n, S] base match counts of n's domain
    domain_id: torch.Tensor          # [n, S] int32 representative node of n's domain
    pod_matches: torch.Tensor        # [p, S] bool pending pod matches selector s
    affinity_sel: torch.Tensor       # [p, K] int32 required selectors, -1 pad
    anti_affinity_sel: torch.Tensor  # [p, K] int32 forbidden selectors, -1 pad
    avoid_counts: torch.Tensor       # [n, S] base running avoiders of s in n's domain
    pod_has_anti: torch.Tensor       # [p, S] bool one-hot of each pod's anti selectors
    spread_sel: torch.Tensor         # [p, Ks] int32 hard spread selectors, -1 pad
    spread_max: torch.Tensor         # [p, Ks] int32 maxSkew
    node_mask: torch.Tensor          # [n] bool (the min-over-domains term)


def tie_jitter(
    p: int, n: int, scale: float, *, device: torch.device, col_offset: int = 0
) -> torch.Tensor:
    """[p, n] float32 deterministic tie-break jitter in [0, scale): a
    counter-based hash of (row, column), bit-identical to the
    reference's uint32 arithmetic. The uint32 wrap-around is emulated in
    int64, masked to 32 bits after every multiply and add; the kept 24
    bits convert to float32 exactly. `col_offset` is the global column of
    the first one: a node shard hashes its GLOBAL columns, so the sharded
    auction sees the values the dense one does."""
    r = torch.arange(p, dtype=torch.int64, device=device)[:, None]
    c = torch.arange(col_offset, col_offset + n, dtype=torch.int64, device=device)[None, :]
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


# ---- affinity against live counts ---------------------------------------


def _clip_sel(sel: torch.Tensor, s: int) -> torch.Tensor:
    return torch.clamp(sel, 0, max(s - 1, 0)).long()


def affinity_ok_from_counts(cnt, a_sel, t_sel) -> torch.Tensor:
    """[n] bool from live domain counts cnt [n, S] and one pod's selector
    lists a_sel / t_sel [K] (-1 padded; an id >= S is unsatisfiable)."""
    s = cnt.shape[1]
    aff_ok = ((cnt[:, _clip_sel(a_sel, s)] > 0) | (a_sel[None, :] < 0)).all(-1)
    anti_ok = ((cnt[:, _clip_sel(t_sel, s)] == 0) | (t_sel[None, :] < 0)).all(-1)
    valid = ~((a_sel >= s).any() | (t_sel >= s).any())
    return aff_ok & anti_ok & valid


def _spread_dmin(cnt, node_mask) -> torch.Tensor:
    """[S] per-selector minimum count over schedulable nodes."""
    return torch.where(node_mask[:, None], cnt, F32_MAX).amin(dim=0)


def spread_ok_from_counts(cnt, node_mask, spread_sel, spread_max) -> torch.Tensor:
    """[n] bool: one pod's hard spread constraints (spread_sel, spread_max
    [K]) hold on each node given live counts cnt [n, S]: count + 1 - min
    over schedulable domains <= maxSkew."""
    s = cnt.shape[1]
    dmin = _spread_dmin(cnt, node_mask)
    sel = _clip_sel(spread_sel, s)
    skew = cnt[:, sel] + 1.0 - dmin[sel][None, :]                 # [n, K]
    ok = (skew <= spread_max[None, :]) | (spread_sel < 0)[None, :]
    valid = ~(spread_sel >= s).any()
    return ok.all(-1) & valid


def spread_ok_batched(cnt, node_mask, spread_sel, spread_max, dmin=None) -> torch.Tensor:
    """[p, n] bool: spread_ok_from_counts for every pod (spread_sel and
    spread_max [p, K]); dmin is the [S] minimum, computed from cnt when
    not given."""
    s = cnt.shape[1]
    if dmin is None:
        dmin = _spread_dmin(cnt, node_mask)
    sel = _clip_sel(spread_sel, s)                                # [p, K]
    skew = cnt[:, sel] + 1.0 - dmin[sel][None, :, :]              # [n, p, K]
    ok = (skew <= spread_max[None, :, :]) | (spread_sel < 0)[None, :, :]
    valid = ~(spread_sel >= s).any(-1)                            # [p]
    return ok.all(-1).T & valid[:, None]


def anti_reverse_ok(avoid_cnt, matches) -> torch.Tensor:
    """[n] bool: the node's domain holds no avoider of any selector the
    incoming pod matches (avoid_cnt [n, S], matches [S])."""
    return ~((avoid_cnt > 0) & matches[None, :]).any(-1)


def anti_reverse_bad(matches, avoid_cnt) -> torch.Tensor:
    """[p, n] bool: pod p matches a selector an avoider holds in node n's
    domain; one [p, S] x [S, n] product of 0/1 values (exact)."""
    return (matches.to(torch.float32) @ (avoid_cnt > 0).to(torch.float32).T) > 0


def _expand(table, domain_id) -> torch.Tensor:
    """[n, S] per-node view of a representative-row table: node n reads
    row domain_id[n, s] of column s."""
    cols = torch.arange(table.shape[1], device=table.device)[None, :]
    return table[domain_id.long(), cols]


def _affinity_row_ok(aff: AffinityState, added, added_avoid, i: int) -> torch.Tensor:
    """[n] bool: every (anti)affinity and spread constraint of pod i, and
    every existing avoider's reverse term, holds on each node against the
    base counts plus the in-window placements (`added`, `added_avoid` in
    the representative-row layout)."""
    cnt = aff.domain_counts + _expand(added, aff.domain_id)
    own = affinity_ok_from_counts(cnt, aff.affinity_sel[i], aff.anti_affinity_sel[i])
    avoid_cnt = aff.avoid_counts + _expand(added_avoid, aff.domain_id)
    return (
        own
        & anti_reverse_ok(avoid_cnt, aff.pod_matches[i])
        & spread_ok_from_counts(cnt, aff.node_mask, aff.spread_sel[i], aff.spread_max[i])
    )


def _affinity_update(aff: AffinityState, added, added_avoid, i: int, choice, found):
    """(added, added_avoid) with pod i's placement on node `choice` (a
    one-element tensor) counted into its domains' representative rows;
    adds zeros when `found` is False. Returns new tensors."""
    s = aff.domain_counts.shape[1]
    cols = torch.arange(s, device=added.device)
    dom = aff.domain_id.index_select(0, choice.view(1).long())[0].long()   # [S]
    inc = torch.where(found, aff.pod_matches[i].to(added.dtype), 0.0)
    inc_a = torch.where(found, aff.pod_has_anti[i].to(added.dtype), 0.0)
    return (
        added.index_put((dom, cols), inc, accumulate=True),
        added_avoid.index_put((dom, cols), inc_a, accumulate=True),
    )


# ---- greedy ---------------------------------------------------------------


def _priority_order(priority: torch.Tensor, pod_mask: torch.Tensor) -> torch.Tensor:
    """Stable order: valid pods by descending priority, padding last;
    ties keep queue (index) order (pkg/yoda/sort/sort.go:8-10)."""
    key = torch.where(pod_mask, priority.to(torch.int32), -(2**31) + 1)
    return torch.argsort(-key, stable=True)


def _scan_order(feasible, pod_request, node_free, priority, pod_mask):
    """(order, feasible, req, free0): the greedy scan's priority order and
    its operands in that order (masked pods infeasible everywhere)."""
    order = _priority_order(priority, pod_mask)
    return (
        order,
        (feasible & pod_mask[:, None])[order],
        pod_request.to(torch.float32)[order].contiguous(),
        node_free.to(torch.float32).contiguous(),
    )


def greedy_scan_operands(scores, feasible, pod_request, node_free, priority, pod_mask):
    """(order, sj, req, free0): the scan order and K4's operands in it, as
    greedy_assign builds them on windows without affinity (chip_smoke.py
    holds the kernel against its plain version on these)."""
    order, feasible, req, free0 = _scan_order(
        feasible, pod_request, node_free, priority, pod_mask
    )
    return order, torch.where(feasible, scores[order], NEG).contiguous(), req, free0


def _greedy_affinity_scan(scores, feasible, req, free, aff: AffinityState):
    """(picks [p] int32, free_after) for pods already in scan order: the
    reference's scan body with affinity (ops/assign.py:321-342) as a loop
    over pods on tensors, carrying `free` and the in-window count tables
    (which start at zero). As in K4's plain version, subtracting a zero
    row where no cell was found leaves `free` bitwise unchanged."""
    p = scores.shape[0]
    free = free.clone()
    picks = torch.full((p,), -1, dtype=torch.int32, device=scores.device)
    added = torch.zeros_like(aff.domain_counts)
    added_avoid = torch.zeros_like(aff.domain_counts)
    for i in range(p):
        q = req[i]
        cap_ok = ((q[None, :] <= free) | (q[None, :] == 0)).all(-1)
        mask = feasible[i] & cap_ok & _affinity_row_ok(aff, added, added_avoid, i)
        choice = torch.argmax(torch.where(mask, scores[i], NEG)).view(1)
        found = mask.any()
        picks[i] = torch.where(found, choice[0].to(torch.int32), -1)
        free.index_copy_(0, choice, free.index_select(0, choice)
                         - torch.where(found, q, 0.0)[None, :])
        added, added_avoid = _affinity_update(aff, added, added_avoid, i, choice, found)
    return picks, free


def greedy_assign(
    scores: torch.Tensor,
    feasible: torch.Tensor,
    pod_request: torch.Tensor,
    node_free: torch.Tensor,
    priority: torch.Tensor,
    pod_mask: torch.Tensor,
    affinity: AffinityState | None = None,
    *,
    _plain: bool = False,
) -> AssignResult:
    """Sequential greedy assignment in priority order (reference:
    ops/assign.greedy_assign).

    scores [p, n] (higher better), feasible [p, n] bool, pod_request
    [p, r], node_free [n, r] free capacity, priority [p] int, pod_mask [p].

    Without `affinity` the scan runs on K4 (ops/fused.greedy_scan) over
    the masked scores permuted into scan order; `_plain=True` takes K4's
    plain version on any device. With `affinity` every pod's mask also
    holds its (anti)affinity, reverse-avoider and spread constraints
    against live counts, in a plain PyTorch loop over pods."""
    from kubernetes_scheduler_tpu_torch.ops.fused import greedy_scan

    p = scores.shape[0]
    if affinity is None:
        order, sj, req, free0 = greedy_scan_operands(
            scores, feasible, pod_request, node_free, priority, pod_mask
        )
        picks, free_after = greedy_scan(sj, req, free0, _plain=_plain)
    else:
        order, feasible, req, free0 = _scan_order(
            feasible, pod_request, node_free, priority, pod_mask
        )
        aff = affinity._replace(**{
            f: getattr(affinity, f)[order]
            for f in ("pod_matches", "affinity_sel", "anti_affinity_sel",
                      "pod_has_anti", "spread_sel", "spread_max")
        })
        picks, free_after = _greedy_affinity_scan(scores[order], feasible, req, free0, aff)
    node_idx = torch.full((p,), -1, dtype=torch.int32, device=scores.device)
    node_idx[order] = picks
    return AssignResult(
        node_idx=node_idx,
        free_after=free_after,
        n_assigned=(node_idx >= 0).sum().to(torch.int32),
    )


# ---- auction ---------------------------------------------------------------


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


def _affinity_round_mask(aff: AffinityState, added, added_avoid, dmin=None) -> torch.Tensor:
    """[p, n] bool: every (anti)affinity constraint of each pod, own
    selectors and existing avoiders' reverse terms, and its hard spread,
    hold on each node against live counts. `added` / `added_avoid` are
    per-node EXPANDED [n, S] tables (every member of a domain holds the
    domain's in-window total), so live counts are a plain add. Required
    and forbidden selector sets are one-hot rows, so the masks are
    [p, S] x [S, n] products of 0/1 values (exact)."""
    s = aff.domain_counts.shape[1]
    cnt = aff.domain_counts + added                                # [n, S]
    present = (cnt > 0).to(torch.float32).T                        # [S, n]
    a_hot = pod_has_anti_onehot(aff.affinity_sel, s).to(torch.float32)
    n_req = a_hot.sum(-1, keepdim=True)                            # [p, 1]
    aff_ok = (a_hot @ present) >= n_req                            # all present
    anti_ok = (aff.pod_has_anti.to(torch.float32) @ present) == 0.0  # none present
    valid = ~(
        (aff.affinity_sel >= s).any(-1) | (aff.anti_affinity_sel >= s).any(-1)
    )
    rev_bad = anti_reverse_bad(aff.pod_matches, aff.avoid_counts + added_avoid)
    spread = spread_ok_batched(
        cnt, aff.node_mask, aff.spread_sel, aff.spread_max, dmin=dmin
    )
    return aff_ok & anti_ok & valid[:, None] & ~rev_bad & spread


def _domain_max(same, keyf, dom_p, table_rows: int) -> torch.Tensor:
    """[p, S] per-(domain, selector) maximum of keyf [p, S] int32 >= 0
    over the pods whose bid shares the domain: the dense [p, q, S] form
    when `same` is given, else a scatter over representative rows."""
    if same is not None:
        return torch.where(same, keyf[None, :, :], 0).amax(dim=1)
    s = keyf.shape[1]
    cols = torch.arange(s, device=keyf.device)[None, :]
    flat = (dom_p * s + cols).reshape(-1)
    gmax = torch.zeros(table_rows * s, dtype=keyf.dtype, device=keyf.device)
    gmax.scatter_reduce_(0, flat, keyf.reshape(-1), "amax")
    return gmax[flat].view_as(keyf)


def _domain_sum(samef, vals, dom_p, table_rows: int) -> torch.Tensor:
    """[p, S] per-(domain, selector) sum of vals [p, S] (0/1 floats, so
    exact in any order) over the pods whose bid shares the domain."""
    if samef is not None:
        return torch.einsum("pqs,qs->ps", samef, vals)
    s = vals.shape[1]
    cols = torch.arange(s, device=vals.device)[None, :].expand_as(dom_p)
    adds = torch.zeros((table_rows, s), dtype=vals.dtype, device=vals.device)
    adds.index_put_((dom_p, cols), vals, accumulate=True)
    return adds[dom_p, cols]


def _evict_conflicts_core(
    pod_matches, anti_affinity_sel, pod_has_anti, spread_sel, spread_max,
    admitted, dom_p, prio_key, base_at_bid, added_at_bid, dmin,
    table_rows: int,
) -> torch.Tensor:
    """[p] bool: admitted pods whose hard anti-affinity or spread skew is
    broken by OTHER placements of the same round, minus one survivor per
    conflict group (reference: ops/assign._evict_conflicts_core).

    dom_p [p, S] domain ids of each pod's bid node; base_at_bid and
    added_at_bid [p, S] the base and prior-round counts there; dmin [S]
    the minimum live count over schedulable nodes. The per-(domain,
    selector) aggregates use a dense [p, q, S] same-domain tensor while
    p * p * S <= DENSE_EVICT_BUDGET, the scatter form otherwise; both are
    exact. A pod (anti selector t, domain d) survives iff every matcher
    of t placed in d this round is itself an avoider of t and the pod is
    the group's (priority desc, index asc) maximum; same for spread
    contributors. Evicted pods re-bid next round against counts that
    include the survivors."""
    p, s = pod_matches.shape
    dom_p = dom_p.long()
    f32 = torch.float32
    contrib = torch.where(admitted[:, None], pod_matches.to(f32), 0.0)
    if p * p * s <= DENSE_EVICT_BUDGET:
        same = dom_p[:, None, :] == dom_p[None, :, :]              # [p, q, S]
        samef = same.to(f32)
    else:
        same = samef = None
    cnt_incl = _domain_sum(samef, contrib, dom_p, table_rows)      # [p, S]
    cnt_other = cnt_incl - contrib

    tc = _clip_sel(anti_affinity_sel, s)                           # [p, K]
    viol_t = (anti_affinity_sel >= 0) & (
        torch.gather(cnt_other, 1, tc) > 0
    ) & admitted[:, None]
    # non-avoider matchers are permanent this round and block every avoider
    contrib_nv = torch.where(admitted[:, None] & pod_matches & ~pod_has_anti, 1.0, 0.0)
    blocked_full = _domain_sum(samef, contrib_nv, dom_p, table_rows) > 0
    hard_blocked_t = torch.gather(blocked_full, 1, tc)
    # avoider-matcher groups keep their prio_key maximum (p - priority rank)
    member = admitted[:, None] & pod_has_anti & pod_matches
    keyf = torch.where(member, prio_key[:, None], 0)
    keep_s = member & (keyf == _domain_max(same, keyf, dom_p, table_rows))
    survive_t = torch.gather(keep_s, 1, tc) & ~hard_blocked_t
    evict = (viol_t & ~survive_t).any(-1)

    # same-round spread conflicts: dmin from base + prior rounds only
    # (this round's adds only raise counts, so the check is conservative)
    spc = _clip_sel(spread_sel, s)
    cnt_mine = base_at_bid + added_at_bid + cnt_incl
    skew_t = torch.gather(cnt_mine, 1, spc) - dmin[spc]
    viol_sp = admitted[:, None] & (spread_sel >= 0) & (skew_t > spread_max.to(f32))
    member_sp = admitted[:, None] & pod_has_anti_onehot(spread_sel, s) & pod_matches
    keyf_sp = torch.where(member_sp, prio_key[:, None], 0)
    keep_sp_s = member_sp & (keyf_sp == _domain_max(same, keyf_sp, dom_p, table_rows))
    survive_sp = torch.gather(keep_sp_s, 1, spc)
    return evict | (viol_sp & ~survive_sp).any(-1)


def _evict_round_conflicts(aff: AffinityState, admitted, bid, prio_key, added) -> torch.Tensor:
    """_evict_conflicts_core on the engine's own tables: `added` [n, S]
    holds prior rounds' placements in the per-node expanded layout, so
    the bid-node lookups are plain gathers."""
    bid = bid.long()
    return _evict_conflicts_core(
        aff.pod_matches, aff.anti_affinity_sel, aff.pod_has_anti,
        aff.spread_sel, aff.spread_max, admitted, aff.domain_id[bid], prio_key,
        aff.domain_counts[bid], added[bid],
        _spread_dmin(aff.domain_counts + added, aff.node_mask),
        aff.domain_counts.shape[0],
    )


def _fold_round(aff: AffinityState, admitted, bid, added, added_avoid):
    """(added, added_avoid) with this round's admitted placements folded
    into the per-node expanded tables: node j gains pod i's contribution
    iff j shares the (selector-s) domain of i's bid node. A dense [p, n, S]
    compare-and-reduce while p * n * S <= DENSE_FOLD_BUDGET, else a
    scatter onto representative rows and a gather back to every member.
    Counts are small integers in float32, so both forms are exact."""
    dom_bid = aff.domain_id[bid.long()].long()                     # [p, S]
    inc_m = torch.where(admitted[:, None], aff.pod_matches.to(added.dtype), 0.0)
    inc_a = torch.where(admitted[:, None], aff.pod_has_anti.to(added.dtype), 0.0)
    p, s = dom_bid.shape
    n = added.shape[0]
    if p * n * s <= DENSE_FOLD_BUDGET:
        same = aff.domain_id[None, :, :] == dom_bid[:, None, :]    # [p, n, S]
        return (
            added + torch.where(same, inc_m[:, None, :], 0.0).sum(0),
            added_avoid + torch.where(same, inc_a[:, None, :], 0.0).sum(0),
        )
    cols = torch.arange(s, device=added.device)[None, :].expand_as(dom_bid)
    rep = torch.zeros_like(added).index_put_((dom_bid, cols), inc_m, accumulate=True)
    rep_a = torch.zeros_like(added).index_put_((dom_bid, cols), inc_a, accumulate=True)
    return (
        added + _expand(rep, aff.domain_id),
        added_avoid + _expand(rep_a, aff.domain_id),
    )


class _RoundInputs(NamedTuple):
    """The affinity head's round-invariant inputs."""

    sj: torch.Tensor         # [p, n] auction_values
    feasible: torch.Tensor   # [p, n] bool
    req: torch.Tensor        # [p, r] float32
    by_prio: torch.Tensor    # [p] priority order
    prio_key: torch.Tensor   # [p] int32 conflict-group rank key
    pod_mask: torch.Tensor   # [p] bool
    aff: AffinityState


class _RoundState(NamedTuple):
    """What one auction round hands the next."""

    assigned: torch.Tensor     # [p] int32, node or -1
    free: torch.Tensor         # [n, r] float32
    price: torch.Tensor        # [n] float32
    added: torch.Tensor        # [n, S] in-window matches, per-node expanded
    added_avoid: torch.Tensor  # [n, S] in-window avoiders, the same layout
    has_bid: torch.Tensor      # [p] bool, the round's bidders


def _settle_round(bid, has_bid, admitted, req, assigned, free, price, price_frac):
    """(assigned, free, price) after a round: admitted pods take their bid
    node and its capacity; a node that rejected any bid raises its price
    by price_frac."""
    assigned = torch.where(admitted, bid, assigned)
    bid_l = bid.long()
    used = torch.zeros_like(free).index_add_(
        0, bid_l, torch.where(admitted[:, None], req, 0.0)
    )
    rejected = torch.zeros(free.shape[0], dtype=torch.int32, device=free.device)
    rejected.scatter_reduce_(0, bid_l, (has_bid & ~admitted).to(torch.int32), "amax")
    return assigned, free - used, price + torch.where(rejected > 0, price_frac, 0.0)


def _affinity_round(inv: _RoundInputs, st: _RoundState, price_frac: float) -> _RoundState:
    """One round of the affinity head: the capacity mask and
    _affinity_round_mask against live counts gate `values - price`; the
    argmax bids; admission, then the eviction of same-round conflicts
    (_evict_round_conflicts) and the fold of the survivors into the count
    tables (_fold_round). The eager loop and the captured block both run
    it. It reads nothing back to the host and writes none of its inputs."""
    req, free = inv.req, st.free
    active = inv.pod_mask & (st.assigned < 0)
    cap_ok = ((req[:, None, :] <= free[None, :, :]) | (req[:, None, :] == 0)).all(-1)
    mask = inv.feasible & cap_ok & active[:, None]
    mask &= _affinity_round_mask(inv.aff, st.added, st.added_avoid)
    row = torch.where(mask, inv.sj - st.price[None, :], NEG)
    bid = torch.argmax(row, dim=1).to(torch.int32)
    has_bid = mask.any(dim=1)
    admitted = _segmented_admission(bid, has_bid, req, free, inv.by_prio)
    admitted &= ~_evict_round_conflicts(inv.aff, admitted, bid, inv.prio_key, st.added)
    added, added_avoid = _fold_round(inv.aff, admitted, bid, st.added, st.added_avoid)
    assigned, free, price = _settle_round(
        bid, has_bid, admitted, req, st.assigned, free, st.price, price_frac
    )
    return _RoundState(assigned, free, price, added, added_avoid, has_bid)


# ---- the affinity head's rounds as captured blocks --------------------------

# captured blocks kept for each process; a shape that churns evicts the
# least recently used, so the graphs' memory stays bounded
GRAPH_CACHE_ENTRIES = 4


def _input_tensors(inv: _RoundInputs) -> tuple:
    return (*inv[:-1], *inv.aff)


def _fresh(t: torch.Tensor) -> torch.Tensor:
    return t.clone(memory_format=torch.contiguous_format)


class CudaBlockGraph:
    """A block of rounds as one torch.cuda.CUDAGraph. `capture` runs
    `warm` (one eager round, so that lazy set-up such as a cuBLAS
    workspace happens outside the capture) and records `block` on a side
    stream; capture errors raise and are limited to this thread's calls
    (other threads may run engine calls meanwhile). `replay` launches the
    recorded kernels on the current stream."""

    def __init__(self, device: torch.device):
        self.device = device
        self.graph = torch.cuda.CUDAGraph()

    def capture(self, block, warm) -> None:
        stream = torch.cuda.Stream(self.device)
        stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(stream):
            warm()
        with torch.cuda.graph(self.graph, stream=stream, capture_error_mode="thread_local"):
            block()

    def replay(self) -> None:
        self.graph.replay()


class _RoundBlock:
    """CHECK_EVERY affinity rounds captured once: static copies of the
    round-invariant inputs and of the carried state, which the block
    reads and rewrites in place, and its any-bid flag (the last round's
    has_bid.any()). `lock` is held from a call's load to its last read,
    so one call at a time owns the buffers; every engine call runs on the
    device's default stream, so the next call's load queues behind the
    last one's reads."""

    def __init__(self, graph, inv: _RoundInputs, st: _RoundState, price_frac: float):
        self.inv = _RoundInputs(*map(_fresh, inv[:-1]), AffinityState(*map(_fresh, inv.aff)))
        self.state = _RoundState(*map(_fresh, st))
        self.flag = torch.zeros((), dtype=torch.bool, device=inv.sj.device)
        self.price_frac = price_frac
        self.lock = threading.Lock()
        self.graph = graph
        graph.capture(self._block, self._warm)

    def _warm(self) -> None:
        _affinity_round(self.inv, self.state, self.price_frac)

    def _block(self) -> None:
        st = self.state
        for _ in range(CHECK_EVERY):
            st = _affinity_round(self.inv, st, self.price_frac)
        for buf, new in zip(self.state, st):
            buf.copy_(new)
        self.flag.copy_(st.has_bid.any())

    def load(self, inv: _RoundInputs, st: _RoundState) -> None:
        for buf, t in zip(_input_tensors(self.inv), _input_tensors(inv)):
            buf.copy_(t)
        for buf, t in zip(self.state, st):
            buf.copy_(t)


def _block_key(inv: _RoundInputs, st: _RoundState, price_frac: float) -> tuple:
    """Everything that fixes a block's kernels: the device, every input's
    and state tensor's shape and dtype, the dense or scatter forms that
    _evict_conflicts_core and _fold_round take at these sizes, and the
    price step (a constant of the captured kernels)."""
    p, s = inv.aff.pod_matches.shape
    n = inv.aff.domain_counts.shape[0]
    return (
        str(inv.sj.device), price_frac,
        p * p * s <= DENSE_EVICT_BUDGET, p * n * s <= DENSE_FOLD_BUDGET,
        tuple((tuple(t.shape), t.dtype) for t in (*_input_tensors(inv), *st)),
    )


class RoundGraphCache:
    """Captured blocks by _block_key, at most `entries`, the least
    recently used evicted first. `make_graph(device)` builds a block's
    graph: CudaBlockGraph on a CUDA device; the tests hand a stand-in
    that replays the captured Python."""

    def __init__(self, make_graph=CudaBlockGraph, entries: int = GRAPH_CACHE_ENTRIES):
        self._make_graph = make_graph
        self._entries = entries
        self._blocks: OrderedDict = OrderedDict()
        self._lock = threading.Lock()

    def __len__(self) -> int:
        with self._lock:
            return len(self._blocks)

    def block(self, inv: _RoundInputs, st: _RoundState, price_frac: float):
        """(block, "hit") for a shape captured before, else (a block
        captured now, "capture"). A capture that fails raises."""
        key = _block_key(inv, st, price_frac)
        with self._lock:
            blk = self._blocks.get(key)
            if blk is not None:
                self._blocks.move_to_end(key)
                return blk, "hit"
        blk = _RoundBlock(self._make_graph(inv.sj.device), inv, st, price_frac)
        with self._lock:
            self._blocks[key] = blk
            while len(self._blocks) > self._entries:
                self._blocks.popitem(last=False)
        return blk, "capture"


_CUDA_GRAPHS = RoundGraphCache()


def _graph_cache(device: torch.device) -> RoundGraphCache | None:
    """The cache of captured blocks for a CUDA device; None elsewhere
    (the CPU runs the rounds eagerly)."""
    return _CUDA_GRAPHS if device.type == "cuda" else None


def _eager_rounds(step, st: _RoundState, first: int, rounds: int, starts):
    """(state, rounds run) after rounds first .. rounds - 1 of `step`,
    stopping after a round rnd with (rnd + 1) % CHECK_EVERY == 0 in which
    no pod bid. With `starts` (a list), each round's start is appended."""
    rnd = first - 1
    for rnd in range(first, rounds):
        if starts is not None:
            starts.append(time.perf_counter())
        st = step(st)
        # graftlint: disable=host-transfer -- the auction's exit test: one flag read every CHECK_EVERY rounds, the host loop's only read per round block
        if (rnd + 1) % CHECK_EVERY == 0 and not bool(st.has_bid.any()):
            break
    return st, rnd + 1 - first


def _graphed_rounds(blk: _RoundBlock, outcome: str, inv, st, rounds: int, starts, trace):
    """(assigned, free, rounds run) through a captured block: whole blocks
    replayed, the flag read after each, the rounds past the last whole
    block eager; the same rounds and stopping rule as _eager_rounds. With
    a `trace`, the replayed blocks are counted under `outcome` and, on a
    hit, their rounds as graph rounds; with spans there, each replay is
    one `auction_block` span, to the end of its flag read."""
    spans = None if trace is None else trace.spans
    with blk.lock:
        blk.load(inv, st)
        out, run, blocks = blk.state, 0, 0
        for _ in range(rounds // CHECK_EVERY):
            t0 = time.perf_counter() if spans is not None else 0.0
            blk.graph.replay()
            # graftlint: disable=host-transfer -- the auction's exit test: the block's one flag read, as the eager loop's every CHECK_EVERY rounds
            any_bid = bool(blk.flag)
            blocks += 1
            run += CHECK_EVERY
            if spans is not None:
                spans.add("auction_block", t0, time.perf_counter(),
                          rounds=CHECK_EVERY, outcome=outcome)
            if not any_bid:
                break
        else:
            out, tail = _eager_rounds(lambda s: _affinity_round(blk.inv, s, blk.price_frac),
                                      blk.state, run, rounds, starts)
            run += tail
        assigned, free = out.assigned.clone(), out.free.clone()
    if trace is not None:
        trace.graph_blocks[outcome] = trace.graph_blocks.get(outcome, 0) + blocks
        if outcome == "hit":
            trace.graph_rounds += blocks * CHECK_EVERY
    return assigned, free, run


def _round_operands(scores, feasible, pod_request, node_free, priority, pod_mask,
                    price_frac: float, affinity: AffinityState | None):
    """(round-invariant inputs, start state) of the auction's rounds. With
    `affinity`, the conflict groups' rank key (p - priority rank) and
    count tables and bidders that start at zero; without, those are None
    (K3's head needs none)."""
    p, n = scores.shape
    dev = scores.device
    sj = auction_values(scores, feasible, price_frac)
    by_prio = _priority_order(priority, pod_mask)
    req = pod_request.to(torch.float32).contiguous()
    st = _RoundState(
        assigned=torch.full((p,), -1, dtype=torch.int32, device=dev),
        free=node_free.to(torch.float32),
        price=torch.zeros(n, dtype=torch.float32, device=dev),
        added=None, added_avoid=None, has_bid=None,
    )
    prio_key = None
    if affinity is not None:
        rank = torch.empty(p, dtype=torch.int32, device=dev)
        rank[by_prio] = torch.arange(p, dtype=torch.int32, device=dev)
        prio_key = p - rank
        st = st._replace(added=torch.zeros_like(affinity.domain_counts),
                         added_avoid=torch.zeros_like(affinity.domain_counts),
                         has_bid=torch.zeros(p, dtype=torch.bool, device=dev))
    return _RoundInputs(sj, feasible, req, by_prio, prio_key, pod_mask, affinity), st


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
    affinity: AffinityState | None = None,
    _plain: bool = False,
) -> AssignResult:
    """Price-guided parallel auction, rounds of bid -> admit -> reprice.

    scores [p, n] float32, feasible [p, n] bool, pod_request [p, r],
    node_free [n, r], priority [p] int, pod_mask [p] bool.

    Without `affinity` the round's bid head is K3 over the
    round-invariant values of auction_values. With `affinity` the head
    is plain PyTorch (_affinity_round): the capacity mask and
    _affinity_round_mask against live counts (base + permanent in-window
    placements) gate `values - price`; after admission, same-round
    conflicts are evicted (_evict_round_conflicts) and the survivors are
    folded into the count tables (_fold_round), which start at zero. On a
    CUDA device the affinity head's rounds run as captured blocks of
    CHECK_EVERY rounds (one CUDA graph a block, captured at the first
    call of a shape, RoundGraphCache) replayed with one flag read a
    block; the rounds past the last whole block, and every round on
    other devices, run eagerly. Both run the same round body, so the
    decisions are the same.

    Stops when no active pod can bid (the assignment is maximal) or
    after `rounds`. The host reads the any-bid flag every CHECK_EVERY
    rounds rather than every round, so the device queue does not drain
    each round. A round in which nobody bids is a no-op on both paths:
    nothing is admitted, so nothing is evicted or folded (the tables add
    zeros), free capacity and prices are unchanged. The up to
    CHECK_EVERY - 1 extra rounds therefore leave the result bit-identical
    to stopping at the first such round, as the reference's while_loop
    does.

    `_plain=True` runs every round eagerly and routes the bid head
    through K3's plain PyTorch version on any device (for holding the
    kernel and the captured blocks against them on the card).

    Under a published ENGINE_TRACE (trace/engine_context) the rounds
    run (the host loop's count, no device read) are added to its
    `auction_rounds`, with the bid head ("k3" or "affinity") as its
    `head`, the rounds run by replaying a block an earlier call captured
    to `graph_rounds`, and the replayed blocks by outcome ("hit": captured
    by an earlier call; "capture": by this one) to `graph_blocks`; with a
    SpanSet there, the call is one `auction` span, each eager round one
    `auction_round` span, from the top of the round to the end of its
    any-bid read, and each replayed block one `auction_block` span.
    """
    from kubernetes_scheduler_tpu_torch.ops.fused import auction_bid

    trace = ENGINE_TRACE.get()
    spans = None if trace is None else trace.spans
    inv, st = _round_operands(
        scores, feasible, pod_request, node_free, priority, pod_mask, price_frac, affinity
    )
    # each eager round's start, with spans on; a round ends where the
    # next starts, the last where the loop exits
    starts = None
    if spans is not None:
        starts, t_auction = [], time.perf_counter()
    graphs = None
    if affinity is not None and not _plain and rounds >= CHECK_EVERY:
        graphs = _graph_cache(scores.device)
    if affinity is None:
        def step(s: _RoundState) -> _RoundState:
            active = pod_mask & (s.assigned < 0)
            bid, has_bid = auction_bid(inv.sj, s.price, active, inv.req, s.free, _plain=_plain)
            admitted = _segmented_admission(bid, has_bid, inv.req, s.free, inv.by_prio)
            assigned, free, price = _settle_round(
                bid, has_bid, admitted, inv.req, s.assigned, s.free, s.price, price_frac
            )
            return _RoundState(assigned, free, price, None, None, has_bid)

        st, run = _eager_rounds(step, st, 0, rounds, starts)
        assigned, free = st.assigned, st.free
    elif graphs is None:
        st, run = _eager_rounds(lambda s: _affinity_round(inv, s, price_frac),
                                st, 0, rounds, starts)
        assigned, free = st.assigned, st.free
    else:
        blk, outcome = graphs.block(inv, st, price_frac)
        assigned, free, run = _graphed_rounds(blk, outcome, inv, st, rounds, starts, trace)
    if trace is not None:
        head = "k3" if affinity is None else "affinity"
        trace.auction_rounds += run
        trace.head = head
        if spans is not None:
            t_end = time.perf_counter()
            for t0, t1 in zip(starts, starts[1:] + [t_end]):
                spans.add("auction_round", t0, t1)
            spans.add("auction", t_auction, t_end, rounds=run, head=head)
    return AssignResult(
        node_idx=assigned,
        free_after=free,
        n_assigned=(assigned >= 0).sum().to(torch.int32),
    )
