"""The node-sharded scheduling engine (counterpart of
kubernetes_scheduler_tpu/parallel/engine.py).

engine.schedule_batch with the node axis split into contiguous shards
over a mesh (parallel/mesh.py), pods replicated on every shard:

- utilization mean and variance are sums over the gathered per-node
  terms, score-normalization bounds and card maxima are pmax / pmin;
- greedy keeps exact sequential semantics: per pod, each shard takes its
  local masked argmax, one gather elects the global first maximum, and
  only the owning shard takes the request off its capacity;
- the auction runs its rounds with one election per ROUND: each shard
  bids over its columns, the election picks every pod's global first
  maximum, each shard admits the bids on its nodes, and same-round
  conflicts are evicted identically on every shard;
- (anti)affinity and hard spread are evaluated against live counts held
  in the representative-row layout ([n_global, S], indexed by global
  domain id), with the spread minimum a pmin.

Decisions and free capacity are bitwise the dense engine's: every float
reduction that differs from a max or min runs over the gathered dense
vector (utilization statistics, softmax), the auction's tie jitter hashes
GLOBAL columns (ops/assign.tie_jitter's col_offset), and count arithmetic
is exact. The engine is single-controller: one process drives every shard
(several shards may share one device), so on the fused path kernel K1 runs
once per shard per window, on the shard's own node columns. On a 2-D
(dcn, node) mesh (make_mesh_multihost) `node_axes` names both axes and
shard k is the k-th device in row-major order, so the program, and its
results, are the 1-D mesh's over the same devices.

Results come back on the mesh's lead device with the dense result types:
per-node leaves concatenated in shard order.
"""

from __future__ import annotations

import numpy as np
import torch

from kubernetes_scheduler_tpu_torch.engine import (
    POD_DTYPES,
    PRESCALED_PLUGINS,
    SNAPSHOT_DTYPES,
    PendingSchedule,
    PodBatch,
    ScheduleResult,
    SnapshotArrays,
    SnapshotDelta,
    WindowsResult,
    _apply_delta_rows,
    _apply_layout_rows,
    _fused_masked_scores,
    _upload_delta,
    as_leaf,
    build_fused_layout,
    compute_feasibility,
    compute_free_capacity,
    compute_scores,
    compute_soft_scores,
    local_spread_dmin,
    match_matrix,
    snapshot_nbytes,
)
from kubernetes_scheduler_tpu_torch.ops.assign import (
    CHECK_EVERY,
    NEG,
    AffinityState,
    _affinity_round_mask,
    _evict_conflicts_core,
    _priority_order,
    _segmented_admission,
    affinity_ok_from_counts,
    anti_reverse_ok,
    pod_has_anti_onehot,
    tie_jitter,
)
from kubernetes_scheduler_tpu_torch.ops.collect import local_max_card_values
from kubernetes_scheduler_tpu_torch.ops.feasibility import card_fit
from kubernetes_scheduler_tpu_torch.ops.normalize import (
    F32_MAX,
    min_max_normalize,
    score_bounds,
    softmax_normalize,
)
from kubernetes_scheduler_tpu_torch.ops.score import (
    balanced_cpu_diskio,
    balanced_diskio_from_m,
    balanced_diskio_local_bounds,
    balanced_diskio_m,
    card_score,
    free_capacity,
)
from kubernetes_scheduler_tpu_torch.ops.stats import (
    CPU_DIVISOR,
    DISK_IO_DIVISOR,
    UtilizationStats,
)
from kubernetes_scheduler_tpu_torch.parallel.mesh import (
    NODE_AXIS,
    Mesh,
    broadcast,
    gather_cat,
    make_mesh,
    pmax,
    pmin,
    reduce_lead,
    to_lead,
)

_F32, _I32 = torch.float32, torch.int32
_INT32_MAX = 2**31 - 1


# ---- shards -----------------------------------------------------------------


def _n_local(shards) -> int:
    return shards[0].node_mask.shape[0]


def shard_snapshot(snapshot, mesh: Mesh, *, private: bool = False) -> list:
    """[SnapshotArrays per shard]: rows [k * n_local, (k + 1) * n_local) of
    every leaf of `snapshot` (host arrays or tensors) on mesh device k, in
    the dtypes make_snapshot fixes; host rows upload through
    device.to_device. private=True clones a leaf that would alias the
    caller's tensor (the resident folds write the shards in place)."""
    n = int(np.shape(snapshot.node_mask)[0])
    d = mesh.size
    if n % d:
        raise ValueError(
            f"node axis {n} is not divisible by the {d}-shard mesh (host node "
            "buckets are multiples of 8, so this means a hand-built snapshot "
            "bypassed the builder)"
        )
    n_local = n // d
    out = []
    for k, dev in enumerate(mesh.devices):
        rows = slice(k * n_local, (k + 1) * n_local)
        leaves = {}
        for name, x in zip(SnapshotArrays._fields, snapshot):
            # graftlint: disable=host-sync -- np.asarray only on host numpy leaves (tensors are sliced); no device sync
            src = x[rows] if isinstance(x, torch.Tensor) else np.asarray(x)[rows]
            t = as_leaf(src, SNAPSHOT_DTYPES[name], dev)
            if private and isinstance(x, torch.Tensor) and t.data_ptr() == src.data_ptr():
                t = t.clone()
            leaves[name] = t
        out.append(SnapshotArrays(**leaves))
    return out


def _replicate(pods, mesh: Mesh) -> list:
    """[`pods` (a PodBatch of any leaves) on each shard's device], one copy
    per distinct device."""
    per_dev = {}
    for dev in mesh.devices:
        if dev not in per_dev:
            per_dev[dev] = PodBatch(
                **{f: as_leaf(x, POD_DTYPES[f], dev) for f, x in zip(PodBatch._fields, pods)}
            )
    return [per_dev[dev] for dev in mesh.devices]


def _local_pods(pods: PodBatch, offset: int, n_local: int) -> PodBatch:
    """`pods` with spec.nodeName pins in shard-local columns: a pin outside
    the shard becomes n_local (matches nothing), never a negative value
    (which node_name_fit reads as unpinned)."""
    local = pods.target_node - offset
    local = torch.where((local < 0) | (local >= n_local), n_local, local)
    return pods._replace(
        target_node=torch.where(pods.target_node < 0, pods.target_node, local)
    )


# ---- scores -------------------------------------------------------------------


def _sharded_stats(shards, mesh: Mesh) -> list:
    """[UtilizationStats per shard]: u and v per node, the mean and
    variance over the gathered per-node terms (the dense sums)."""
    masks = [s.node_mask.to(_F32) for s in shards]
    us = [s.disk_io / s.disk_io.new_full((), DISK_IO_DIVISOR) for s in shards]
    vs = [s.cpu_pct / s.cpu_pct.new_full((), CPU_DIVISOR) for s in shards]
    n_valid = torch.clamp(gather_cat(masks, mesh).sum(), min=1.0)
    u_avg = gather_cat([u * m for u, m in zip(us, masks)], mesh).sum() / n_valid
    m_var = gather_cat([((u - u_avg.to(u.device)) ** 2) * m for u, m in zip(us, masks)], mesh
                 ).sum() / n_valid
    return [
        UtilizationStats(u=u, v=v, u_avg=a, m_var=mv, n_valid=nv)
        for u, v, a, mv, nv in zip(
            us, vs, broadcast(u_avg, mesh), broadcast(m_var, mesh), broadcast(n_valid, mesh)
        )
    ]


def _sharded_scores(shards, pods_r, policy: str, mesh: Mesh) -> list:
    """[raw [p, n_local] per shard] of one policy, globally exact."""
    if policy == "balanced_cpu_diskio":
        return [
            balanced_cpu_diskio(st, p.request[:, 0], p.r_io)
            for st, p in zip(_sharded_stats(shards, mesh), pods_r)
        ]
    if policy == "balanced_diskio":
        stats = _sharded_stats(shards, mesh)
        ms = [balanced_diskio_m(st, s.disk_io, p.r_io) for st, s, p in zip(stats, shards, pods_r)]
        bounds = [balanced_diskio_local_bounds(m, s.node_mask) for m, s in zip(ms, shards)]
        hi = pmax([b[0] for b in bounds], mesh)
        lo = pmin([b[1] for b in bounds], mesh)
        return [balanced_diskio_from_m(m, h, lw) for m, h, lw in zip(ms, hi, lo)]
    if policy == "free_capacity":
        out = []
        for s, p in zip(shards, pods_r):
            f = free_capacity(s.cpu_pct, s.mem_pct, s.disk_io)
            out.append(f[None, :].expand(p.request.shape[0], f.shape[0]))
        return out
    if policy == "card":
        fits = [
            card_fit(s.cards, s.card_mask, s.card_healthy,
                     p.want_number, p.want_memory, p.want_clock)
            for s, p in zip(shards, pods_r)
        ]
        local = [
            local_max_card_values(s.cards, per_card & node_fits[:, :, None])
            for s, (node_fits, per_card) in zip(shards, fits)
        ]
        maxima = [torch.clamp(m, min=1.0) for m in pmax(local, mesh)]
        return [
            card_score(s.cards, s.card_mask, per_card, mx)
            for s, (_, per_card), mx in zip(shards, fits, maxima)
        ]
    if policy in ("least_allocated", "balanced_allocation", "image_locality"):
        # node-local: the dense scorer on the shard's rows
        return [compute_scores(s, p, policy) for s, p in zip(shards, pods_r)]
    raise ValueError(f"unknown policy {policy!r}")


def _sharded_min_max(raw, shards, mesh: Mesh) -> list:
    """min_max_normalize with the global per-pod bounds."""
    bounds = [score_bounds(r, s.node_mask) for r, s in zip(raw, shards)]
    hi = pmax([b[0] for b in bounds], mesh)
    lo = pmin([b[1] for b in bounds], mesh)
    return [
        min_max_normalize(r, s.node_mask, bounds=(h, lw))
        for r, s, h, lw in zip(raw, shards, hi, lo)
    ]


def _sharded_combined_scores(shards, pods_r, score_plugins: tuple, mesh: Mesh) -> list:
    """engine.combine_scores on the mesh: each plugin's matrix globally
    exact, min-max rescaled with global bounds unless prescaled, then the
    weighted sum in the dense term order."""
    total = None
    for name, weight in score_plugins:
        raw = _sharded_scores(shards, pods_r, name, mesh)
        if name not in PRESCALED_PLUGINS:
            raw = _sharded_min_max(raw, shards, mesh)
        terms = [r * float(weight) for r in raw]
        total = terms if total is None else [t + u for t, u in zip(total, terms)]
    return total


def _sharded_normalize(raw, shards, normalizer: str, mesh: Mesh) -> list:
    if normalizer == "min_max":
        return _sharded_min_max(raw, shards, mesh)
    if normalizer == "softmax":
        # the denominator is a sum of exponentials: the dense softmax over
        # the gathered rows, split back into the shards' columns
        full = softmax_normalize(
            gather_cat(raw, mesh, dim=1), gather_cat([s.node_mask for s in shards], mesh)
        )
        n_local = _n_local(shards)
        return [
            full[:, k * n_local:(k + 1) * n_local].to(dev, non_blocking=True)
            for k, dev in enumerate(mesh.devices)
        ]
    if normalizer == "none":
        return raw
    raise ValueError(f"unknown normalizer {normalizer!r}")


def _sharded_soft_scores(shards, pods_r, mesh: Mesh) -> list:
    """compute_soft_scores on each shard's columns; the ScheduleAnyway
    spread term measures skew from the GLOBAL minimum count (pmin)."""
    dmin = pmin([local_spread_dmin(s) for s in shards], mesh)
    return [
        compute_soft_scores(s, p, spread_dmin=d) for s, p, d in zip(shards, pods_r, dmin)
    ]


def _window_pipeline(shards, pods_r, mesh: Mesh, *, policy, normalizer, soft,
                     score_fn=None, fused=False, score_plugins=None, layouts=None):
    """(raw, norm, feasible), each [per-shard [p, n_local]]: scores, static
    feasibility and normalization for one window, shared by the
    single-window and windows programs.

    score_fn(snapshot, pods) scores one shard's columns (the learned
    scorer's hook; `policy` is then ignored), normalized globally on top.
    fused=True runs K1 on each shard's columns (normalizer "none"; NEG
    where infeasible), from the shard's retained `layouts` when given.
    Inter-pod affinity and spread stay out of the static mask: the
    assigners evaluate them against live counts."""
    n_local = _n_local(shards)
    local = [_local_pods(p, k * n_local, n_local) for k, p in enumerate(pods_r)]
    if fused:
        raw = [
            _fused_masked_scores(
                s, lp, include_pod_affinity=False,
                layout=None if layouts is None else layouts[k],
            )
            for k, (s, lp) in enumerate(zip(shards, local))
        ]
        feasible = [r > NEG * 0.5 for r in raw]
        norm = raw
    else:
        if score_plugins:
            raw = norm = _sharded_combined_scores(shards, pods_r, score_plugins, mesh)
        else:
            raw = (
                [score_fn(s, p) for s, p in zip(shards, pods_r)]
                if score_fn is not None
                else _sharded_scores(shards, pods_r, policy, mesh)
            )
            norm = _sharded_normalize(raw, shards, normalizer, mesh)
        feasible = [
            compute_feasibility(s, lp, include_pod_affinity=False)
            for s, lp in zip(shards, local)
        ]
    if soft:
        norm = [n + t for n, t in zip(norm, _sharded_soft_scores(shards, pods_r, mesh))]
    return raw, norm, feasible


# ---- live counts ------------------------------------------------------------------


def _needs_affinity(shards, pods: PodBatch, matches, mesh: Mesh) -> bool:
    """Can any constraint that the assigners hold against live counts bind
    in this window? False when no pod names an affinity, anti-affinity or
    spread selector and no pod matches a selector that a running avoider
    holds: then every live-count mask is all True and no same-round
    conflict exists, so the assigners skip them (exactly). One host read."""
    avoided = pmax([(s.avoid_counts > 0).any(0).to(_I32) for s in shards], mesh)[0] > 0
    need = (
        (pods.affinity_sel >= 0).any()
        | (pods.anti_affinity_sel >= 0).any()
        | (pods.spread_sel >= 0).any()
        | (matches & avoided[None, :]).any()
    )
    return bool(need)


def _expand_rep(table, domain_id) -> torch.Tensor:
    """[n_local, S] per-node view of a representative-row table."""
    cols = torch.arange(table.shape[1], device=table.device)[None, :]
    return table[domain_id.long(), cols]


def _owner_rows(values, local_idx, mine, mesh: Mesh, fill):
    """Per-pod rows of a per-node table read on the owning shard and
    summed over shards (the owner contributes its row, others `fill`):
    values [n_local, S] per shard, local_idx and mine per shard."""
    parts = [
        torch.where(m[..., None], v[i], fill)
        for v, i, m in zip(values, local_idx, mine)
    ]
    return reduce_lead(torch.add, parts, mesh)


def _fold_rep(added2, dom, inc_m, inc_a) -> torch.Tensor:
    """The [2, n_global, S] match / avoider tables with per-pod increments
    added at their domains' representative rows (dom [..., S])."""
    cols = torch.arange(dom.shape[-1], device=dom.device).expand_as(dom)
    dom = dom.long()
    return torch.stack([
        added2[0].index_put((dom, cols), inc_m, accumulate=True),
        added2[1].index_put((dom, cols), inc_a, accumulate=True),
    ])


# ---- greedy -----------------------------------------------------------------------


def _sharded_greedy(norm, feasible, pods_r, free0, shards, mesh: Mesh):
    """(node_idx [p] on the lead, free_after per shard, added2): exact
    sequential greedy over the sharded node axis, pods in priority order.

    Per pod, each shard takes the first maximum of its qualifying cells
    (feasible, capacity for every requested resource, not <= NEG/2, with
    live affinity and spread when the window needs them; a NaN cell
    qualifies and ranks first, as in K4); one gather elects the first
    shard holding the global first maximum, and the owner subtracts the
    request. added2 [2, n_global, S] holds the window's placements in
    the representative-row layout (matches, avoiders)."""
    d = mesh.size
    n_local = _n_local(shards)
    n_global = n_local * d
    lead = mesh.lead
    pods = pods_r[0]
    s = shards[0].domain_counts.shape[1]
    p = norm[0].shape[0]
    order = _priority_order(pods.priority, pods.pod_mask)
    orders = broadcast(order, mesh)
    sj = [
        torch.where(f & pr.pod_mask[:, None], x, NEG)[o]
        for x, f, pr, o in zip(norm, feasible, pods_r, orders)
    ]
    qual = [~(x <= NEG * 0.5) for x in sj]
    req = [pr.request.to(_F32)[o] for pr, o in zip(pods_r, orders)]
    free = [f.to(_F32).clone() for f in free0]
    matches = match_matrix(pods, s)
    has_anti = pod_has_anti_onehot(pods.anti_affinity_sel, s)
    need = _needs_affinity(shards, pods, matches, mesh)
    added2 = torch.zeros((2, n_global, s), dtype=_F32, device=lead)
    picks = torch.full((p,), -1, dtype=_I32, device=lead)
    shard_ids = [torch.tensor(k, device=dev) for k, dev in enumerate(mesh.devices)]
    offsets = torch.arange(d, dtype=_I32, device=lead) * n_local
    if need:
        sel = [
            tuple(getattr(pr, f)[o] for f in (
                "affinity_sel", "anti_affinity_sel", "spread_sel", "spread_max"))
            for pr, o in zip(pods_r, orders)
        ]
        matches_o = [mo[o] for mo, o in zip(broadcast(matches, mesh), orders)]
        has_anti_o = has_anti[order]
        matches_lead = matches[order]
        dom_plus = [sh.domain_id + 1 for sh in shards]
    for i in range(p):
        aff = [None] * d
        if need:
            added_r = broadcast(added2, mesh)
            cnts = [sh.domain_counts + _expand_rep(a[0], sh.domain_id)
                    for sh, a in zip(shards, added_r)]
            dmin = pmin([torch.where(sh.node_mask[:, None], c, F32_MAX).amin(0)
                         for sh, c in zip(shards, cnts)], mesh)
            for k, sh in enumerate(shards):
                a_sel, t_sel, sp_sel, sp_max = (x[i] for x in sel[k])
                c = cnts[k]
                ok = affinity_ok_from_counts(c, a_sel, t_sel)
                avoid = sh.avoid_counts + _expand_rep(added_r[k][1], sh.domain_id)
                ok = ok & anti_reverse_ok(avoid, matches_o[k][i])
                spc = torch.clamp(sp_sel, 0, max(s - 1, 0)).long()
                skew = c[:, spc] + 1.0 - dmin[k][spc][None, :]
                ok = ok & ((skew <= sp_max[None, :]) | (sp_sel < 0)[None, :]).all(-1)
                aff[k] = ok & ~(sp_sel >= s).any()
        bests, args, founds = [], [], []
        for k in range(d):
            q = req[k][i]
            cap_ok = ((q[None, :] <= free[k]) | (q[None, :] == 0)).all(-1)
            mask = qual[k][i] & cap_ok
            if aff[k] is not None:
                mask = mask & aff[k]
            row = torch.where(mask, sj[k][i], NEG)
            arg = torch.argmax(row).view(1)
            bests.append(row.index_select(0, arg))
            args.append(arg)
            founds.append(mask.any().view(1))
        best_all = torch.cat(to_lead(bests, mesh))
        arg_all = torch.cat(to_lead(args, mesh))
        found = torch.cat(to_lead(founds, mesh)).any()
        win = torch.argmax(best_all).view(1)
        chosen = (offsets.index_select(0, win) + arg_all.index_select(0, win)).to(_I32)
        picks[i] = torch.where(found, chosen[0], -1)
        win = win[0]
        wins, found_r = broadcast(win, mesh), broadcast(found, mesh)
        mine = [f & (w == sid) for f, w, sid in zip(found_r, wins, shard_ids)]
        for k in range(d):
            q = req[k][i]
            free[k].index_copy_(
                0, args[k],
                free[k].index_select(0, args[k]) - torch.where(mine[k], q, 0.0)[None, :],
            )
        if need:
            dom = _owner_rows(
                dom_plus, args,
                [m.view(1) for m in mine], mesh, 0,
            )[0] - 1
            dom = torch.clamp(dom, 0, n_global - 1)
            added2 = _fold_rep(
                added2, dom,
                torch.where(found, matches_lead[i].to(_F32), 0.0),
                torch.where(found, has_anti_o[i].to(_F32), 0.0),
            )
    node_idx = torch.full((p,), -1, dtype=_I32, device=lead)
    node_idx[order] = picks
    if not need:
        added2 = _fold_placements(added2, node_idx, shards, matches, has_anti, mesh)
    return node_idx, free, added2


def _fold_placements(added2, node_idx, shards, matches, has_anti, mesh: Mesh):
    """added2 with the window's placements (node_idx, global columns)
    counted at their domains' representative rows, in one pass."""
    n_local = _n_local(shards)
    found = node_idx >= 0
    local, mine = [], []
    for k, dev in enumerate(mesh.devices):
        li = node_idx.to(dev) - k * n_local
        m = (li >= 0) & (li < n_local)
        local.append(torch.clamp(li, 0, n_local - 1).long())
        mine.append(m)
    dom = _owner_rows([sh.domain_id + 1 for sh in shards], local, mine, mesh, 0) - 1
    dom = torch.clamp(dom, 0, n_local * mesh.size - 1)
    return _fold_rep(
        added2, dom,
        torch.where(found[:, None], matches.to(_F32), 0.0),
        torch.where(found[:, None], has_anti.to(_F32), 0.0),
    )


# ---- auction -----------------------------------------------------------------------


def _sharded_auction(norm, feasible, pods_r, free0, shards, mesh: Mesh, *,
                     rounds: int, price_frac: float):
    """(node_idx [p] on the lead, free_after per shard, added2): the
    price-guided auction of ops/assign.auction_assign over the sharded
    node axis, rounds of bid -> elect -> admit -> evict -> reprice.

    Each row is min-maxed to [0, 1] over its feasible cells with global
    bounds, plus the tie jitter of its GLOBAL columns, so every shard's
    values are the dense ones. Per round: each shard bids over its
    columns, one gather elects each pod's first global maximum, each
    shard admits (in priority order, while the cumulative request fits)
    the bids on its nodes, one reduction ORs the verdicts; when the
    window needs live affinity, same-round conflicts are evicted
    replicated (the bid nodes' domain ids and base counts come from
    their owners, the spread minimum is a pmin); placements fold into the
    representative-row tables; rejected nodes raise their price. The
    host reads the any-bid flag every CHECK_EVERY rounds, as the dense
    auction does."""
    d = mesh.size
    n_local = _n_local(shards)
    n_global = n_local * d
    lead = mesh.lead
    pods = pods_r[0]
    p = norm[0].shape[0]
    s = shards[0].domain_counts.shape[1]
    row_hi = pmax([torch.where(f, x, -torch.inf).amax(dim=1) for x, f in zip(norm, feasible)],
                  mesh)
    row_lo = pmin([torch.where(f, x, torch.inf).amin(dim=1) for x, f in zip(norm, feasible)],
                  mesh)
    sj = []
    for k, (x, f, hi, lo) in enumerate(zip(norm, feasible, row_hi, row_lo)):
        hi, lo = hi[:, None], lo[:, None]
        ok = torch.isfinite(hi) & torch.isfinite(lo)
        denom = torch.where(ok, torch.clamp(hi - lo, min=1e-6), 1.0)
        sc = torch.where(ok, (x - torch.where(ok, lo, 0.0)) / denom, 0.0)
        jitter = tie_jitter(p, n_local, 0.01 * price_frac, device=x.device,
                            col_offset=k * n_local)
        sj.append(torch.where(f, sc + jitter, NEG).contiguous())
    by_prio = _priority_order(pods.priority, pods.pod_mask)
    by_prio_r = broadcast(by_prio, mesh)
    rank = torch.empty(p, dtype=_I32, device=lead)
    rank[by_prio] = torch.arange(p, dtype=_I32, device=lead)
    prio_key = p - rank
    matches = match_matrix(pods, s)
    has_anti = pod_has_anti_onehot(pods.anti_affinity_sel, s)
    need = _needs_affinity(shards, pods, matches, mesh)
    req = [pr.request.to(_F32).contiguous() for pr in pods_r]
    free = [f.to(_F32) for f in free0]
    price = [torch.zeros(n_local, dtype=_F32, device=dev) for dev in mesh.devices]
    offsets = torch.arange(d, dtype=_I32, device=lead)[:, None] * n_local
    cols = torch.arange(s, device=lead)[None, :]
    assigned = torch.full((p,), -1, dtype=_I32, device=lead)
    added2 = torch.zeros((2, n_global, s), dtype=_F32, device=lead)
    if need:
        affs = [
            AffinityState(
                domain_counts=sh.domain_counts, domain_id=sh.domain_id,
                pod_matches=match_matrix(pr, s), affinity_sel=pr.affinity_sel,
                anti_affinity_sel=pr.anti_affinity_sel, avoid_counts=sh.avoid_counts,
                pod_has_anti=pod_has_anti_onehot(pr.anti_affinity_sel, s),
                spread_sel=pr.spread_sel, spread_max=pr.spread_max,
                node_mask=sh.node_mask,
            )
            for sh, pr in zip(shards, pods_r)
        ]
    for rnd in range(rounds):
        active = broadcast(pods.pod_mask & (assigned < 0), mesh)
        added_r = broadcast(added2, mesh)
        aff_ok = [None] * d
        if need:
            exp = [(_expand_rep(a[0], sh.domain_id), _expand_rep(a[1], sh.domain_id))
                   for a, sh in zip(added_r, shards)]
            dmin = pmin([
                torch.where(sh.node_mask[:, None], sh.domain_counts + e[0], F32_MAX).amin(0)
                for sh, e in zip(shards, exp)
            ], mesh)
            aff_ok = [_affinity_round_mask(a, e[0], e[1], dmin=dm)
                      for a, e, dm in zip(affs, exp, dmin)]
        bests, args, hases = [], [], []
        for k in range(d):
            cap_ok = (
                (req[k][:, None, :] <= free[k][None, :, :]) | (req[k][:, None, :] == 0)
            ).all(-1)
            mask = feasible[k] & cap_ok & active[k][:, None]
            if aff_ok[k] is not None:
                mask = mask & aff_ok[k]
            row = torch.where(mask, sj[k] - price[k][None, :], NEG)
            arg = torch.argmax(row, dim=1)
            bests.append(row.gather(1, arg[:, None])[:, 0])
            args.append(arg.to(_I32))
            hases.append(mask.any(dim=1))
        cand_s = torch.stack(to_lead(bests, mesh))                      # [D, p]
        cand_i = torch.stack(to_lead(args, mesh)) + offsets             # [D, p] global
        win = torch.argmax(cand_s, dim=0)                               # first max
        bid = torch.gather(cand_i, 0, win[None, :])[0]
        has_bid = torch.stack(to_lead(hases, mesh)).any(0)
        bids, has_r = broadcast(bid, mesh), broadcast(has_bid, mesh)
        local, mine, adm = [], [], []
        for k in range(d):
            bl = bids[k] - k * n_local
            m = has_r[k] & (bl >= 0) & (bl < n_local)
            local.append(torch.clamp(bl, 0, n_local - 1).long())
            mine.append(m)
            adm.append(_segmented_admission(bl, m, req[k], free[k], by_prio_r[k]))
        admitted = torch.stack(to_lead(adm, mesh)).any(0)
        dom = _owner_rows([sh.domain_id + 1 for sh in shards], local, mine, mesh, 0) - 1
        dom_c = torch.clamp(dom, 0, n_global - 1).long()
        if need:
            base_at_bid = _owner_rows(
                [sh.domain_counts for sh in shards], local, mine, mesh, 0.0)
            admitted = admitted & ~_evict_conflicts_core(
                matches, pods.anti_affinity_sel, has_anti, pods.spread_sel,
                pods.spread_max, admitted, dom_c, prio_key, base_at_bid,
                added2[0][dom_c, cols], dmin[0], n_global,
            )
        added2 = _fold_rep(
            added2, dom_c,
            torch.where(admitted[:, None], matches.to(_F32), 0.0),
            torch.where(admitted[:, None], has_anti.to(_F32), 0.0),
        )
        assigned = torch.where(admitted, bid, assigned)
        adm_r = broadcast(admitted, mesh)
        for k in range(d):
            used = torch.zeros_like(free[k]).index_add_(
                0, local[k], torch.where((adm_r[k] & mine[k])[:, None], req[k], 0.0)
            )
            rejected = torch.zeros(n_local, dtype=_I32, device=free[k].device)
            rejected.scatter_reduce_(0, local[k], (mine[k] & ~adm_r[k]).to(_I32), "amax")
            free[k] = free[k] - used
            price[k] = price[k] + torch.where(rejected > 0, price_frac, 0.0)
        # graftlint: disable=host-transfer -- the auction's exit test: one flag read every CHECK_EVERY rounds, the host loop's only read per round block
        if (rnd + 1) % CHECK_EVERY == 0 and not bool(has_bid.any()):
            break
    return assigned, free, added2


# ---- programs ------------------------------------------------------------------------


def check_node_axes(mesh: Mesh, node_axes) -> None:
    """ValueError unless `node_axes` is `mesh`'s axis tuple (one name for a
    1-D mesh): "lacks axes" for an axis the mesh lacks, as the
    reference's _mesh_specs."""
    axes = mesh.axes(node_axes)
    if axes != mesh.axis_names:
        raise ValueError(f"node_axes {axes} must name every axis of the mesh, in order: "
                         f"{mesh.axis_names}")


def check_options(*, assigner, policy, normalizer, fused, score_fn, score_plugins) -> None:
    """ValueError for options no sharded program serves."""
    if assigner not in ("greedy", "auction"):
        raise ValueError(f"unknown assigner {assigner!r}")
    if score_plugins and (fused or score_fn is not None):
        # the kernel computes the single yoda formula and a custom
        # score_fn replaces the policy outright
        raise ValueError("score_plugins cannot combine with fused=True or score_fn")
    if fused:
        if score_fn is not None:
            raise ValueError("fused=True cannot combine with a custom score_fn")
        if policy != "balanced_cpu_diskio":
            raise ValueError(
                f"fused kernel only implements balanced_cpu_diskio, not {policy!r}"
            )
        if normalizer != "none":
            # the min-max bounds are global values a shard's K1 epilogue
            # cannot see
            raise ValueError(
                f"the sharded fused path requires normalizer 'none', not {normalizer!r}"
            )


def _as_shards(snapshot, mesh: Mesh) -> list:
    """A program's snapshot operand: already-sharded (a list of per-shard
    SnapshotArrays, ShardedEngine's retained state) or a dense one."""
    if isinstance(snapshot, list):
        return snapshot
    return shard_snapshot(snapshot, mesh)


def _assign(assigner, norm, feasible, pods_r, free0, shards, mesh, rounds, price_frac):
    if assigner == "greedy":
        return _sharded_greedy(norm, feasible, pods_r, free0, shards, mesh)
    return _sharded_auction(norm, feasible, pods_r, free0, shards, mesh,
                            rounds=rounds, price_frac=price_frac)


def _with_auction_knobs(run, rounds0: int, price_frac0: float):
    """The program's call surface: (snapshot, pods, *extra) with optional
    per-call auction knobs (the build-time values are the defaults;
    rounds clamp into int32 range, where a larger wire value means "run to
    convergence", which the any-bid check already bounds)."""

    def call(snapshot, pods, *extra, auction_rounds=None, auction_price_frac=None):
        r = rounds0 if auction_rounds is None else auction_rounds
        f = price_frac0 if auction_price_frac is None else auction_price_frac
        return run(snapshot, pods, min(int(r), _INT32_MAX), float(f), *extra)

    return call


def make_sharded_schedule_fn(
    mesh: Mesh,
    *,
    policy: str = "balanced_cpu_diskio",
    normalizer: str = "min_max",
    node_axes: str | tuple[str, ...] = NODE_AXIS,
    soft: bool = False,
    score_fn=None,
    assigner: str = "greedy",
    auction_rounds: int = 1024,
    auction_price_frac: float = 1.0,
    fused: bool = False,
    score_plugins: tuple | None = None,
    resident_layout: bool = False,
):
    """The sharded schedule_batch for `mesh`: call(snapshot, pods) with a
    dense snapshot (host arrays or tensors; split into shards per call)
    or a list of per-shard SnapshotArrays, returning engine.ScheduleResult
    on the mesh's lead device. Options are schedule_batch's; the
    assigners always hold (anti)affinity and spread against live counts
    (exact in both of the dense engine's affinity modes), and gangs are
    not masked (the host's backstop re-masks). fused=True runs K1 per
    shard and needs normalizer "none"; resident_layout=True (fused only)
    takes a third operand, the list of per-shard FusedLayouts.

    node_axes: the mesh's axes, which the node axis shards over in
    row-major order: NODE_AXIS for make_mesh, (DCN_AXIS, NODE_AXIS) for
    make_mesh_multihost. ValueError "lacks axes" for an axis the mesh
    lacks, and for a strict subset (the reference's replication over the
    other axes has no caller here)."""
    check_node_axes(mesh, node_axes)
    if resident_layout and not fused:
        raise ValueError("resident_layout=True requires fused=True")
    check_options(assigner=assigner, policy=policy,
                   normalizer=normalizer, fused=fused, score_fn=score_fn,
                   score_plugins=score_plugins)

    def run(snapshot, pods, rounds, price_frac, *extra):
        shards = _as_shards(snapshot, mesh)
        pods_r = _replicate(pods, mesh)
        raw, norm, feasible = _window_pipeline(
            shards, pods_r, mesh, policy=policy, normalizer=normalizer, soft=soft,
            score_fn=score_fn, fused=fused, score_plugins=score_plugins,
            layouts=extra[0] if resident_layout else None,
        )
        free0 = [compute_free_capacity(s) for s in shards]
        node_idx, free_after, _ = _assign(
            assigner, norm, feasible, pods_r, free0, shards, mesh, rounds, price_frac
        )
        return ScheduleResult(
            node_idx=node_idx,
            scores=gather_cat(norm, mesh, dim=1),
            raw_scores=gather_cat(raw, mesh, dim=1),
            feasible=gather_cat(feasible, mesh, dim=1),
            free_after=gather_cat(free_after, mesh),
            n_assigned=(node_idx >= 0).sum().to(_I32),
        )

    return _with_auction_knobs(run, auction_rounds, auction_price_frac)


def make_sharded_windows_fn(
    mesh: Mesh,
    *,
    policy: str = "balanced_cpu_diskio",
    normalizer: str = "min_max",
    node_axes: str | tuple[str, ...] = NODE_AXIS,
    soft: bool = False,
    score_fn=None,
    assigner: str = "greedy",
    auction_rounds: int = 1024,
    auction_price_frac: float = 1.0,
    fused: bool = False,
    score_plugins: tuple | None = None,
):
    """The sharded schedule_windows for `mesh`: call(snapshot,
    pods_windows) with a leading [w, p, ...] window axis
    (engine.stack_windows), returning engine.WindowsResult on the lead.
    The loop over windows carries each shard's requested capacity and
    its domain match and avoider counts exactly as engine.run_windows_scan
    does, so window k + 1 sees window k's placements. node_axes as for
    make_sharded_schedule_fn."""
    check_node_axes(mesh, node_axes)
    check_options(assigner=assigner, policy=policy,
                   normalizer=normalizer, fused=fused, score_fn=score_fn,
                   score_plugins=score_plugins)

    def run(snapshot, pods_windows, rounds, price_frac):
        shards = _as_shards(snapshot, mesh)
        pods_w = _replicate(pods_windows, mesh)
        requested = [sh.requested for sh in shards]
        counts = [sh.domain_counts for sh in shards]
        avoid = [sh.avoid_counts for sh in shards]
        node_idx, n_assigned = [], []
        for w in range(pods_w[0].request.shape[0]):
            window = [PodBatch(*[f[w] for f in pw]) for pw in pods_w]
            snaps = [
                sh._replace(requested=rq, domain_counts=c, avoid_counts=a)
                for sh, rq, c, a in zip(shards, requested, counts, avoid)
            ]
            _, norm, feasible = _window_pipeline(
                snaps, window, mesh, policy=policy, normalizer=normalizer, soft=soft,
                score_fn=score_fn, fused=fused, score_plugins=score_plugins,
            )
            free0 = [compute_free_capacity(sn) for sn in snaps]
            idx, free_after, added2 = _assign(
                assigner, norm, feasible, window, free0, snaps, mesh, rounds, price_frac
            )
            added_r = broadcast(added2, mesh)
            counts = [c + _expand_rep(a[0], sh.domain_id)
                      for c, a, sh in zip(counts, added_r, shards)]
            avoid = [c + _expand_rep(a[1], sh.domain_id)
                     for c, a, sh in zip(avoid, added_r, shards)]
            requested = [sh.allocatable - f for sh, f in zip(shards, free_after)]
            node_idx.append(idx)
            n_assigned.append((idx >= 0).sum().to(_I32))
        return WindowsResult(
            node_idx=torch.stack(node_idx),
            free_after=gather_cat([sh.allocatable - rq for sh, rq in zip(shards, requested)], mesh),
            n_assigned=torch.stack(n_assigned).sum().to(_I32),
        )

    return _with_auction_knobs(run, auction_rounds, auction_price_frac)


# ---- sharded resident state -------------------------------------------------------------


def sharded_device_count(n_devices: int | None = None) -> int:
    """The automatic ShardedEngine mesh size: the largest of 8, 4, 2 that
    the visible CUDA device count covers, else 1. The host pads node
    buckets to multiples of 8, so any of these divides every snapshot's
    node axis."""
    have = torch.cuda.device_count() if n_devices is None else n_devices
    for d in (8, 4, 2):
        if d <= have:
            return d
    return 1


class _ShardedResident:
    """Per-shard retained snapshots (and kernel layouts on fused paths),
    the epoch the host tags its deltas with, and the host copy of the node
    mask the delta router compares against."""

    __slots__ = ("shards", "layouts", "epoch", "node_mask_host")

    def __init__(self, shards: list, epoch: int, node_mask_host: np.ndarray):
        self.shards = shards
        self.layouts: list | None = None
        self.epoch = epoch
        self.node_mask_host = node_mask_host

    def accepts(self, delta: SnapshotDelta, epoch: int) -> bool:
        """ResidentState.accepts on the global axes: the immediate
        successor epoch, the same node, resource and selector axes."""
        first = self.shards[0]
        return (
            epoch == self.epoch + 1
            and tuple(np.shape(delta.node_mask)) == self.node_mask_host.shape
            and tuple(np.shape(delta.req_vals)[1:]) == tuple(first.requested.shape[1:])
            and np.shape(delta.dom_vals)[1] == first.domain_counts.shape[1]
        )


class ShardedEngine:
    """In-process node-sharded engine with TorchEngine's call surface
    (the host scheduler's config.sharded_engine), over `mesh` (default:
    the first sharded_device_count() CUDA devices; RuntimeError without
    CUDA), the node axis sharded over `node_axes` as in
    make_sharded_schedule_fn: (DCN_AXIS, NODE_AXIS) for a mesh from
    make_mesh_multihost.

    Resident state is per shard: a full upload splits the snapshot into
    each shard's private rows; a later delta is routed to the shards that
    own its rows (host.snapshot.shard_snapshot_delta) and folded there in
    place, so host-to-device bytes scale with the change. A shard whose
    mask slice did not change keeps its retained mask (no mask bytes).
    `shard_delta_bytes` holds the last delta cycle's routed payload per
    shard.

    Not served: gang masking (supports_gangs() is False: the host's
    backstop re-masks), preemption (the host evaluates it in-host) and
    the fused min-max epilogue (supports_fused_min_max() is False: the
    sharded bounds are global values a shard's epilogue cannot see, so
    min_max runs unfused with global bounds). `affinity_aware` is
    absorbed: the sharded assigners always evaluate live counts.

    `score_fn(snapshot, pods)`, when given, scores each shard's columns in
    place of the policy (models.learned.sharded_learned_score_fn puts the
    learned scorer on the mesh); `policy` and `fused` are then absorbed,
    as LearnedEngine absorbs them."""

    def __init__(self, mesh: Mesh | None = None, *, node_axes=NODE_AXIS, score_fn=None):
        self.mesh = mesh if mesh is not None else make_mesh(sharded_device_count())
        check_node_axes(self.mesh, node_axes)
        self.score_fn = score_fn
        self.device = self.mesh.lead
        self._resident: _ShardedResident | None = None
        self.resident_used_delta = False
        self.shard_delta_bytes: tuple = ()

    # ---- capability surface -------------------------------------------

    @property
    def n_shards(self) -> int:
        return self.mesh.size

    def supports_resident(self) -> bool:
        return True

    def supports_windows_resident(self) -> bool:
        return True

    def supports_gangs(self) -> bool:
        return False

    def supports_fused_min_max(self) -> bool:
        return False

    def healthy(self) -> bool:
        return True

    def close(self) -> None:
        self._resident = None

    # ---- programs ---------------------------------------------------------

    @staticmethod
    def _knobs(kw: dict) -> dict:
        return {k: kw[k] for k in ("auction_rounds", "auction_price_frac") if k in kw}

    def _program(self, kind: str, kw: dict, *, resident_layout: bool = False):
        """The program for this call's options (`affinity_aware` absorbed);
        the windows surface defaults to the auction without normalizer, as
        engine.schedule_windows does."""
        schedule = kind == "schedule"
        build = dict(
            policy=kw.get("policy", "balanced_cpu_diskio"),
            assigner=kw.get("assigner", "greedy" if schedule else "auction"),
            normalizer=kw.get("normalizer", "min_max" if schedule else "none"),
            soft=bool(kw.get("soft", False)),
            fused=bool(kw.get("fused", False)) and self.score_fn is None,
            score_plugins=kw.get("score_plugins") or None,
            score_fn=self.score_fn,
        )
        if schedule:
            return make_sharded_schedule_fn(self.mesh, node_axes=self.mesh.axis_names,
                                            resident_layout=resident_layout, **build)
        return make_sharded_windows_fn(self.mesh, node_axes=self.mesh.axis_names, **build)

    def _pending(self, result) -> PendingSchedule:
        if self.device.type != "cuda":
            return PendingSchedule(result)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.device))
        return PendingSchedule(result, event)

    # ---- plain dispatch ----------------------------------------------------

    def schedule_batch(self, snapshot, pods, **kw) -> ScheduleResult:
        return self._program("schedule", kw)(snapshot, pods, **self._knobs(kw))

    def schedule_batch_async(self, snapshot, pods, **kw) -> PendingSchedule:
        return self._pending(self.schedule_batch(snapshot, pods, **kw))

    def schedule_windows(self, snapshot, pods_windows, **kw) -> WindowsResult:
        return self._program("windows", kw)(snapshot, pods_windows, **self._knobs(kw))

    # ---- resident cluster state ---------------------------------------

    def invalidate_resident(self) -> None:
        self._resident = None

    def _fold_delta(self, st: _ShardedResident, delta, epoch: int) -> None:
        """Route one accepted delta to its shards and fold each routed
        block into the shard's snapshot (and layout) in place."""
        from kubernetes_scheduler_tpu_torch.host.snapshot import shard_snapshot_delta

        routed = shard_snapshot_delta(delta, self.n_shards, prev_node_mask=st.node_mask_host)
        stacked = stack_shard_deltas(delta, routed, self.n_shards)
        new_mask = np.array(np.asarray(delta.node_mask), bool)
        n_local = _n_local(st.shards)
        sizes = []
        for k in range(self.n_shards):
            if k not in routed:
                sizes.append(0)
                continue
            rows = slice(k * n_local, (k + 1) * n_local)
            mask_changed = not np.array_equal(st.node_mask_host[rows], new_mask[rows])
            shard = st.shards[k]
            d = SnapshotDelta(*[leaf[k] for leaf in stacked])
            if not mask_changed:
                # the retained slice is current: no mask bytes cross
                d = d._replace(node_mask=shard.node_mask)
            dd = _upload_delta(d, n_local, shard.node_mask.device)
            _apply_delta_rows(shard, dd)
            if st.layouts is not None:
                _apply_layout_rows(st.layouts[k], dd)
            sizes.append(
                snapshot_nbytes(routed[k]) - (0 if mask_changed else routed[k].node_mask.nbytes)
            )
        st.epoch = epoch
        st.node_mask_host = new_mask
        self.shard_delta_bytes = tuple(sizes)
        self.resident_used_delta = True

    def _resident_dispatch(self, snapshot, delta, epoch: int) -> _ShardedResident:
        """Fold an applicable delta into the retained shards, else upload
        `snapshot` in full into private per-shard tensors (any mismatch
        costs a full upload, never the cycle)."""
        st = self._resident
        self.shard_delta_bytes = ()
        if delta is not None and st is not None and st.accepts(delta, epoch):
            self._fold_delta(st, delta, epoch)
            return st
        # graftlint: disable=host-transfer -- deliberate one-time materialization; full uploads ship the whole snapshot by definition
        mask = np.array(
            snapshot.node_mask.cpu().numpy() if isinstance(snapshot.node_mask, torch.Tensor)
            else np.asarray(snapshot.node_mask), bool,
        )
        self._resident = st = _ShardedResident(
            shard_snapshot(snapshot, self.mesh, private=True), epoch, mask
        )
        self.resident_used_delta = False
        return st

    def schedule_resident(self, snapshot, pods, *, delta=None, epoch=0, **kw) -> ScheduleResult:
        st = self._resident_dispatch(snapshot, delta, epoch)
        if kw.get("fused") and self.score_fn is None:
            if st.layouts is None:
                st.layouts = [build_fused_layout(sh) for sh in st.shards]
            return self._program("schedule", kw, resident_layout=True)(
                st.shards, pods, st.layouts, **self._knobs(kw)
            )
        return self._program("schedule", kw)(st.shards, pods, **self._knobs(kw))

    def schedule_resident_async(self, snapshot, pods, *, delta=None, epoch=0, **kw):
        return self._pending(
            self.schedule_resident(snapshot, pods, delta=delta, epoch=epoch, **kw)
        )

    def schedule_windows_resident(self, snapshot, pods_windows, *, delta=None, epoch=0, **kw):
        """The windows program on the retained shards, on the same epoch
        sequence; the backlog's carries stay inside the call (the retained
        state remains the pre-backlog snapshot), and the layouts, when
        built, keep folding deltas so later fused single-window cycles
        stay current."""
        st = self._resident_dispatch(snapshot, delta, epoch)
        return self._program("windows", kw)(st.shards, pods_windows, **self._knobs(kw))


def stack_shard_deltas(delta: SnapshotDelta, routed: dict, n_shards: int) -> SnapshotDelta:
    """Per-shard routed deltas (host.snapshot.shard_snapshot_delta)
    stacked into one SnapshotDelta with a leading [D] shard axis on every
    leaf, block k in shard k's local coordinates: shards that shipped
    nothing contribute all-sentinel row blocks (row bucket = the largest
    shard's, so the stack is rectangular), and the node mask is the whole
    current mask reshaped [D, n_local]. ShardedEngine folds block k into
    shard k (the sentinels drop on the host, before any upload)."""
    mask = np.asarray(delta.node_mask, bool)
    n = mask.shape[0]
    if n_shards <= 0 or n % n_shards:
        raise ValueError(f"node axis {n} does not divide {n_shards} shards")
    n_local = n // n_shards
    r = int(np.asarray(delta.req_vals).shape[1])
    s = int(np.asarray(delta.dom_vals).shape[1])

    def stack(rows_attr: str, vals_attr: str, val_shape: tuple):
        # graftlint: disable=host-sync -- deltas are host numpy (built by host/snapshot.py); no device sync
        k = max((np.asarray(getattr(d, rows_attr)).shape[0] for d in routed.values()),
                default=8)
        rows = np.full((n_shards, k), n_local, np.int32)
        vals = np.zeros((n_shards, k) + val_shape, np.float32)
        for i, d in routed.items():
            # graftlint: disable=host-sync -- deltas are host numpy (built by host/snapshot.py); no device sync
            rr = np.asarray(getattr(d, rows_attr))
            rows[i, : rr.shape[0]] = rr
            # graftlint: disable=host-sync -- the same host numpy delta
            vals[i, : rr.shape[0]] = np.asarray(getattr(d, vals_attr))
        return rows, vals

    req_rows, req_vals = stack("req_rows", "req_vals", (r,))
    util_rows, util_vals = stack("util_rows", "util_vals", (5,))
    dom_rows, dom_vals = stack("dom_rows", "dom_vals", (s, 4))
    return SnapshotDelta(
        req_rows=req_rows, req_vals=req_vals, util_rows=util_rows,
        util_vals=util_vals, dom_rows=dom_rows, dom_vals=dom_vals,
        node_mask=mask.reshape(n_shards, n_local),
    )

