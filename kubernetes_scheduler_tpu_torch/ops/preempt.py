"""Batched preemption, upstream PostFilter parity (counterpart of
kubernetes_scheduler_tpu/ops/preempt.py): victim selection on the device.

When a pod fits nowhere, the upstream framework looks for a node where
evicting a minimal set of strictly-lower-priority pods makes it feasible,
preferring candidates whose victims matter least. Here victims are laid
out once into per-node prefix tables sorted by priority (freed[n, k, r] =
capacity released by evicting the k+1 lowest-priority victims of node n),
and every (pending pod, node, victim count) combination is one [p, n, K]
tensor op. "Only strictly lower priority may be evicted" falls out of the
sort: prefix k is eligible iff its last (highest-priority) member is below
the preemptor's priority.

Count-based families (inter-pod (anti)affinity, reverse anti-affinity,
topology spread) re-simulate the victims' removal (upstream's RemovePod
accounting): the tables carry per-(node, k) freed selector-match and
freed-avoider counts (cfreed, afreed), and affinity_after_evictions checks
each (pod, node, k) against the counts as they would stand after the
evictions. Node-local families (taints, node affinity, resources against
full allocatable) stay in the caller's `static_ok` mask.

Candidates are ordered as upstream pickOneNodeForPreemption's criteria 2-6:
lowest highest-victim priority, lowest sum of victim priorities, fewest
victims, latest start time of the highest-priority victim, first node
index. PodDisruptionBudgets are enforced on the host and never violated.

Every output is bitwise the reference's: integer tables and selections
are exact, and the float32 prefix sums add the K slices in victim order
(`_prefix_sum`), the order the reference's cumsum takes on the CPU.
Plain PyTorch on tensors of any device; no kernel of its own.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

PRIO_PAD = torch.iinfo(torch.int32).max  # padding sentinel: never evictable
_I32_MAX = torch.iinfo(torch.int32).max
_F32_MAX = torch.finfo(torch.float32).max


class VictimTables(NamedTuple):
    """Per-node victim prefix tables, victims sorted by (priority asc,
    start time desc): the k-th entry is the k-th least important pod in
    upstream util.MoreImportantPod order, so prefix k is always the
    upstream-minimal victim set of size k + 1.

    prio:  [n, K] int32, k-th victim priority (PRIO_PAD past the count)
    freed: [n, K, r] float32, capacity released by evicting victims 0..k
    vid:   [n, K] int32, index into the caller's victim arrays, -1 pad
    psum_hi/psum_lo: [n, K] int32, inclusive prefix sum of victim
           priorities as hi * 2^16 + lo with lo in [0, 2^16) (priorities
           reach 2e9 and a K-victim sum overflows int32), compared
           lexicographically
    start: [n, K] int32, k-th victim's start time (larger = later; 0 pad)
    cfreed/afreed: [n, K, S] float32, selector-match counts and avoider
           counts released by evicting victims 0..k (all zero, S = 1,
           when the caller gives no selector data)
    """

    prio: torch.Tensor
    freed: torch.Tensor
    vid: torch.Tensor
    psum_hi: torch.Tensor
    psum_lo: torch.Tensor
    start: torch.Tensor
    cfreed: torch.Tensor
    afreed: torch.Tensor


class VictimArrays(NamedTuple):
    """Dense victim-side inputs to the preemption pass, as the host builds
    them. Entries with node < 0 (budget-protected, terminating, or
    nomination reservations) never enter the tables.

    node: [m] int32 (-1 = not evictable), prio: [m] int32, req: [m, r]
    float32, mask: [m] bool, start: [m] int32 relative start seconds
    (larger = later), matches: [m, S] bool (victim's labels match
    selector s), anti: [m, S] bool (victim carries a required anti term
    on selector s). matches/anti None = no selector data."""

    node: torch.Tensor
    prio: torch.Tensor
    req: torch.Tensor
    mask: torch.Tensor
    start: torch.Tensor
    matches: torch.Tensor | None = None
    anti: torch.Tensor | None = None


class PreemptAffinity(NamedTuple):
    """Inputs for re-simulating the victims' effect on the count-based
    families per candidate (pod, node, k): node-side tables from the
    snapshot, pod-side selectors from the preemptors' PodBatch."""

    domain_counts: torch.Tensor      # [n, S]
    avoid_counts: torch.Tensor       # [n, S]
    domain_id: torch.Tensor          # [n, S]
    node_mask: torch.Tensor          # [n]
    affinity_sel: torch.Tensor       # [p, Ka] required attract, -1 pad
    anti_affinity_sel: torch.Tensor  # [p, Ka] required anti, -1 pad
    pod_matches: torch.Tensor        # [p, S]
    spread_sel: torch.Tensor         # [p, Ks] hard spread, -1 pad
    spread_max: torch.Tensor         # [p, Ks]


class PreemptResult(NamedTuple):
    """node: [p] int32 chosen node (-1 none); victims: [p, K] int32 victim
    indices to evict (-1 pad); n_victims: [p] int32."""

    node: torch.Tensor
    victims: torch.Tensor
    n_victims: torch.Tensor


def _prefix_sum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum over axis 1, slice after slice in order (K is
    small): the summation order is fixed on every device, where
    torch.cumsum's order on CUDA is not documented."""
    out = torch.empty_like(x)
    acc = x[:, 0]
    out[:, 0] = acc
    for k in range(1, x.shape[1]):
        acc = acc + x[:, k]
        out[:, k] = acc
    return out


def _first_true(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True along the last axis, 0 where there is none
    (jnp.argmax over a bool axis)."""
    k = mask.shape[-1]
    ar = torch.arange(k, device=mask.device)
    first = torch.where(mask, ar, k).amin(-1)
    return torch.where(first == k, 0, first)


def affinity_after_evictions(a: PreemptAffinity, tables: VictimTables) -> torch.Tensor:
    """OK[p, n, K]: do the count-based families hold at node n after
    evicting its k-prefix victims?

    The prefix victims all live on node n, which is in its own domain
    under every topology key, so the post-eviction counts at the
    candidate node are exactly counts - cfreed/afreed. For spread, the
    global minimum can change only through the candidate's own domain:
    min_after = min(min over the other domains, adjusted own count), the
    other domains' minimum from the two smallest domains."""
    n, k_cap, s = tables.cfreed.shape
    dc = a.domain_counts[:, None, :] - tables.cfreed          # [n, K, S]
    av = a.avoid_counts[:, None, :] - tables.afreed
    top = max(s - 1, 0)

    inv_aff = a.affinity_sel >= s                             # [p, Ka]
    sel_a = torch.clamp(a.affinity_sel, 0, top).long()
    aff_ok = ((dc[:, :, sel_a] > 0) | (a.affinity_sel < 0)[None, None]).all(-1)  # [n, K, p]
    inv_anti = a.anti_affinity_sel >= s
    sel_t = torch.clamp(a.anti_affinity_sel, 0, top).long()
    anti_ok = ((dc[:, :, sel_t] <= 0) | (a.anti_affinity_sel < 0)[None, None]).all(-1)
    # reverse direction: bad iff the pod matches s and an avoider of s
    # remains in the domain after the evictions
    rev_bad = ((av > 0)[:, :, None, :] & a.pod_matches[None, None]).any(-1)       # [n, K, p]

    # hard topology spread: the minimum excluding the candidate's own
    # domain, from the two smallest domains
    cols = torch.arange(s, device=dc.device)
    rows = torch.arange(n, device=dc.device)[:, None]
    masked = torch.where(a.node_mask[:, None], a.domain_counts, _F32_MAX)
    min1 = masked.amin(0)                                     # [S]
    at_min = torch.where(masked == min1[None, :], rows, n).amin(0)   # first argmin
    rep1 = a.domain_id[at_min.clamp(max=n - 1), cols]         # [S]
    same1 = a.domain_id == rep1[None, :]                      # [n, S]
    masked2 = torch.where(a.node_mask[:, None] & ~same1, a.domain_counts, _F32_MAX)
    min2 = masked2.amin(0)
    min_excl = torch.where(same1, min2[None, :], min1[None, :])      # [n, S]
    new_min = torch.minimum(min_excl[:, None, :], dc)         # [n, K, S]
    inv_sp = a.spread_sel >= s
    sel_s = torch.clamp(a.spread_sel, 0, top).long()
    sp_ok = (
        (dc[:, :, sel_s] + 1.0 - new_min[:, :, sel_s]
         <= a.spread_max[None, None].to(torch.float32))
        | (a.spread_sel < 0)[None, None]
    ).all(-1)                                                 # [n, K, p]
    valid = ~(inv_aff.any(-1) | inv_anti.any(-1) | inv_sp.any(-1))   # [p]
    ok = aff_ok & anti_ok & ~rev_bad & sp_ok
    return ok.permute(2, 0, 1) & valid[:, None, None]


def build_victim_tables(
    victim_node: torch.Tensor,
    victim_prio: torch.Tensor,
    victim_req: torch.Tensor,
    victim_mask: torch.Tensor,
    *,
    n_nodes: int,
    k_cap: int,
    victim_start: torch.Tensor | None = None,
    victim_matches: torch.Tensor | None = None,
    victim_anti: torch.Tensor | None = None,
) -> VictimTables:
    """Lay the running pods out into per-node prefix tables sorted by
    (priority asc, start time desc). victim_node [m] int32 (entries
    outside [0, n) ignored), victim_prio [m] int32, victim_req [m, r]
    float32, victim_mask [m] bool, victim_start [m] int32 (None = all
    equal: ties keep input order); victim_matches / victim_anti [m, S]
    bool feed cfreed / afreed (None = [n, K, 1] zeros).

    One sort and one scatter over the m running pods. Every scatter lands
    in an [n + 1, K] buffer whose extra row takes the entries that are
    not kept (their duplicates never reach the result), then is sliced."""
    m, r = victim_req.shape
    dev = victim_req.device
    ok = victim_mask & (victim_node >= 0) & (victim_node < n_nodes)
    if victim_start is None:
        victim_start = torch.zeros(m, dtype=torch.int32, device=dev)
    # lexicographic (node asc, prio asc, start desc) by stable argsorts,
    # innermost key first: equal-priority victims evict most-recently-
    # started first (upstream MoreImportantPod: earlier start = more
    # important, evicted later)
    ord0 = torch.argsort(-victim_start, stable=True)
    ord1 = torch.argsort(victim_prio[ord0], stable=True)
    ord01 = ord0[ord1]
    node_or_pad = torch.where(ok, victim_node, n_nodes)
    ord2 = torch.argsort(node_or_pad[ord01], stable=True)
    order = ord01[ord2]                                       # [m]
    node_s = node_or_pad[order]
    prio_s = victim_prio[order]
    start_s = victim_start[order]
    req_s = victim_req[order]
    # position within the node's segment
    idx = torch.arange(m, device=dev)
    boundary = torch.ones(m, dtype=torch.bool, device=dev)
    boundary[1:] = node_s[1:] != node_s[:-1]
    seg_start = torch.cummax(torch.where(boundary, idx, 0), dim=0).values
    pos = idx - seg_start                                     # [m]
    keep = (node_s < n_nodes) & (pos < k_cap)
    row = torch.where(keep, node_s.long(), n_nodes)           # pad row n
    col = torch.where(keep, pos, 0)

    def table(fill, vals, dtype, tail=()):
        out = torch.full((n_nodes + 1, k_cap) + tail, fill, dtype=dtype, device=dev)
        out[row, col] = vals.to(dtype)
        return out[:n_nodes]

    i32 = torch.int32
    prio = table(PRIO_PAD, torch.where(keep, prio_s, PRIO_PAD), i32)
    steps = table(0, torch.where(keep[:, None], req_s, 0.0), req_s.dtype, (r,))
    vid = table(-1, torch.where(keep, order.to(i32), -1), i32)
    # priority prefix sums as two 16-bit limbs (see VictimTables): the
    # arithmetic >> takes negative priorities (hi = floor division by
    # 2^16, lo in [0, 2^16)); the carry after the sums restores lo's range
    kept_prio = torch.where(keep, prio_s, 0)
    hi_v = kept_prio >> 16
    lo_v = kept_prio - (hi_v << 16)
    psum_hi = _prefix_sum(table(0, hi_v, i32))
    psum_lo = _prefix_sum(table(0, lo_v, i32))
    carry = psum_lo >> 16
    psum_hi = psum_hi + carry
    psum_lo = psum_lo - (carry << 16)
    start = table(0, torch.where(keep, start_s, 0), i32)

    def count_table(per_victim):
        """[m, S] bool -> [n, K, S] inclusive prefix counts in victim
        order (as `freed`, for selector-match counts)."""
        if per_victim is None:
            return torch.zeros((n_nodes, k_cap, 1), dtype=torch.float32, device=dev)
        sel_s = per_victim[order].to(torch.float32)           # [m, S]
        sel_steps = table(0, torch.where(keep[:, None], sel_s, 0.0), torch.float32,
                          (sel_s.shape[1],))
        return _prefix_sum(sel_steps)

    return VictimTables(
        prio=prio,
        freed=_prefix_sum(steps),
        vid=vid,
        psum_hi=psum_hi,
        psum_lo=psum_lo,
        start=start,
        cfreed=count_table(victim_matches),
        afreed=count_table(victim_anti),
    )


def preempt_candidates(
    pend_req: torch.Tensor,
    pend_prio: torch.Tensor,
    pend_mask: torch.Tensor,
    static_ok: torch.Tensor,
    free: torch.Tensor,
    tables: VictimTables,
    affinity: PreemptAffinity | None = None,
) -> PreemptResult:
    """Choose a preemption candidate per pending pod.

    pend_req [p, r], pend_prio [p] int32, pend_mask [p] bool, static_ok
    [p, n] bool (node-local families hold: taints, node affinity,
    resources against full allocatable), free [n, r] current free
    capacity. Candidate (pod, node, k) is valid iff its k + 1 victims all
    have priority strictly below the pod's, the request fits free +
    freed[k], and, with `affinity`, the count-based families hold against
    the counts as adjusted by those evictions. Per pod the minimal k per
    node is kept, then nodes compete on pickOneNodeForPreemption's order:
    lowest highest-victim priority, lowest priority sum, fewest victims,
    latest start of the highest-priority victim, first node index."""
    p, r = pend_req.shape
    n, k_cap = tables.prio.shape
    cap = free[None, :, None, :] + tables.freed[None, :, :, :]        # [1, n, K, r]
    req = pend_req[:, None, None, :]
    fits = ((req <= cap) | (req == 0)).all(-1)                        # [p, n, K]
    # victims sorted ascending: prefix k eligible iff its last member is
    # below the preemptor (PRIO_PAD padding fails by itself)
    elig = tables.prio[None, :, :] < pend_prio[:, None, None]
    ok = fits & elig & static_ok[:, :, None] & pend_mask[:, None, None]
    if affinity is not None:
        ok = ok & affinity_after_evictions(affinity, tables)
    has_k = ok.any(-1)                                                # [p, n]
    kstar = _first_true(ok)                                           # [p, n]

    def at_kstar(tab):
        return tab[None].expand(p, n, k_cap).gather(2, kstar[:, :, None])[..., 0]

    maxprio = at_kstar(tables.prio)
    priosum_hi = at_kstar(tables.psum_hi)
    priosum_lo = at_kstar(tables.psum_lo)
    hp_start = at_kstar(tables.start)
    # lexicographic argmin over nodes:
    # (maxprio, priosum (hi, then lo limb), kstar, -hp_start, node index)
    big = _I32_MAX
    mp = torch.where(has_k, maxprio, big)
    tier1 = has_k & (mp == mp.amin(1, keepdim=True))
    ps_hi = torch.where(tier1, priosum_hi, big)
    tier1b = tier1 & (ps_hi == ps_hi.amin(1, keepdim=True))
    ps_lo = torch.where(tier1b, priosum_lo, big)
    tier2 = tier1b & (ps_lo == ps_lo.amin(1, keepdim=True))
    ks = torch.where(tier2, kstar, big)
    tier3 = tier2 & (ks == ks.amin(1, keepdim=True))
    st = torch.where(tier3, hp_start, -big)
    tier4 = tier3 & (st == st.amax(1, keepdim=True))
    node = torch.where(tier4.any(-1), _first_true(tier4), -1).to(torch.int32)  # [p]
    safe = torch.clamp(node, min=0).long()
    rows = torch.arange(p, device=node.device)
    nv = torch.where(node >= 0, kstar[rows, safe] + 1, 0)
    vics = tables.vid[safe]                                           # [p, K]
    live = (torch.arange(k_cap, device=node.device)[None, :] < nv[:, None]) & (node >= 0)[:, None]
    vics = torch.where(live, vics, -1)
    return PreemptResult(node=node, victims=vics, n_victims=nv.to(torch.int32))
