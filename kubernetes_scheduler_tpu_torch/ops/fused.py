"""The fused scheduling path's kernels: CUDA C++ for Hopper, with plain
PyTorch versions (counterpart of kubernetes_scheduler_tpu/ops/pallas_fused.py).

K1 `masked_score` replaces `fused_masked_score` (pallas_fused.py:252,
body `_fused_kernel` :87). Per (pod, node) cell: the live policy score
10 - 10 * |alpha * v - beta * u| where the cell is feasible, NEG
elsewhere, optionally min-max normalized. Feasible means the pod and
node masks, resource fit, spec.nodeName pinning, up to 32 count-based
selector families and the external `other` mask. Bound on the H100: the
bytes of the [p, n] `other` read and the [p, n] output write. Design: a
block owns 1,024 columns and walks a group of 16 pods, so each column's
node operands (u, v, node mask, reqd and alloc, the selector rows folded
into one word of bits each for presence and avoiders) are read once per
group instead of once per cell; resource fit is tested once per group,
one resource at a time, into a word of fit bits, at any r; the group's
pod scalars and selector flags are staged in shared memory; `other` and the output move as
16-byte streaming loads and stores, each byte touched once.

K2 `row_stats` replaces `fused_score_row_stats` (pallas_fused.py:385,
body `_row_stats_kernel` :176). Per pod, the max and min raw score over
node-masked nodes, NaN where any of those scores is NaN. Bound:
operations (p x n scores from O(p + n) input bytes). Since 10 - 10 * x
is non-increasing, the max and min score are those of the min and max
load |alpha * v - beta * u|, so a cell costs two products, a difference,
a min and a max. Design: a block holds 8 pods in registers and walks
every node, so each node's (u, v, mask) serves 8 cells, then reduces the
pods' (min, max) across its threads in the same launch.

K3 `auction_bid` replaces `fused_auction_bid` (pallas_fused.py:581, body
`_bid_kernel` :528). One auction round's bid head: per active pod, the
first column of the row maximum of sj - price over cells with
sj > NEG/2 and capacity for every requested resource. Bound: the bytes
of the active pods' sj rows, read once per round. Design: one block per
pod row, four columns a thread (16-byte loads of sj and price where
n % 4 == 0), (value, column) pairs reduced first-max; a node's capacity
words are read only for a cell whose value beats the thread's running
best, so most cells cost their two loads alone. Inactive pods read
nothing, and no [p, n, r] capacity broadcast or [p, n] bid row is
materialized.

K4 `greedy_scan` replaces `fused_greedy_scan` (pallas_fused.py:476, body
`_greedy_kernel` :421). The greedy assigner's sequential scan over pods
in priority order: per pod, the first column of the row maximum over
cells not <= NEG/2 with capacity for every requested resource (a NaN
cell qualifies and ranks above every number, the first NaN first, as in
the reference's XLA scan body), then
the pod's request subtracted from that column only, before the next pod
reads the free capacity. Bound: the bytes of sj, read once. Design, two
launches: every row's first qualifying cells under the capacity before
the window (up to GREEDY_LIST_LEN), on all SMs; then one block walks the
pods in order and takes the first listed cell that still fits. Requests are never
negative on the main path, so capacity only falls and the cells a pod can
take at its turn are a subset of those it could take before the window:
the walk is exact. A pod whose full list is used up scans its row, over
the cells ranked after its list only (the fallback); from the first
request with a component below zero (or NaN) every pod scans its whole
row. See csrc/fused.cu. `last_greedy_fallbacks` holds the int32 device
scalar of the last launch's row scans (read it after a synchronise).

Every wrapper takes its plain version for tensors on the CPU; for CUDA
tensors it launches its kernel or raises. `_plain=True` (used to hold
the kernels against their plain versions on the card) takes the plain
version on any device. `launches` counts kernel launches per kernel.
"""

from __future__ import annotations

import torch

from kubernetes_scheduler_tpu_torch.ops._build import check_launch, load_library
from kubernetes_scheduler_tpu_torch.ops.assign import NEG
from kubernetes_scheduler_tpu_torch.ops.normalize import F32_MAX, MAX_NODE_SCORE
from kubernetes_scheduler_tpu_torch.ops.score import MAX_RAW_SCORE, alpha_beta

# selector-axis ceiling of the kernels' folded count-based families (the
# reference's MAX_FUSED_SELECTORS), and of the resource axis a kernel
# stages in shared memory
MAX_FUSED_SELECTORS = 32
MAX_RESOURCES = 32
# K4's candidate list length per pod (csrc/fused.cu kListLen: the top 32
# of each of a row block's eight warps, merged)
GREEDY_LIST_LEN = 256

# launches of each kernel since the last reset_launches(); only the
# launch sites below add to these
launches = {"masked_score": 0, "row_stats": 0, "auction_bid": 0, "greedy_scan": 0}
# [1] int32 on the card: pods of K4's last launch that took a row scan;
# None after a plain run
last_greedy_fallbacks: torch.Tensor | None = None


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _use_kernel(t: torch.Tensor, plain: bool) -> bool:
    """True where the wrapper must launch its CUDA kernel."""
    if plain or t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"no kernel for device {t.device}; use cuda or cpu")
    return True


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple,
           device: torch.device) -> None:
    if t.dtype != dtype or tuple(t.shape) != shape or t.device != device:
        raise ValueError(
            f"{name}: expected {dtype} {shape} on {device}, got "
            f"{t.dtype} {tuple(t.shape)} on {t.device}"
        )
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _raw_score_plain(alpha, beta, u, v) -> torch.Tensor:
    """[p, n] 10 - 10 * |alpha * v - beta * u|, each op its own kernel
    (never contracted into an FMA), the expression every kernel mirrors."""
    load = torch.abs(alpha[:, None] * v[None, :] - beta[:, None] * u[None, :])
    return MAX_RAW_SCORE - MAX_RAW_SCORE * load


# ---- K1 ---------------------------------------------------------------


def masked_score_plain(
    alpha, beta, pod_ok, target, u, v, node_mask, pod_request, alloc, reqd,
    *, aff_pod=None, aff_node=None, other=None, stats=None,
) -> torch.Tensor:
    """K1's plain version: the whole-matrix composition."""
    n = u.shape[0]
    score = _raw_score_plain(alpha, beta, u, v)
    fit = pod_ok[:, None] & node_mask[None, :]
    fit &= (
        (reqd[None, :, :] + pod_request[:, None, :] <= alloc[None, :, :])
        | (pod_request[:, None, :] == 0)
    ).all(-1)
    cols = torch.arange(n, device=u.device)
    fit &= (target[:, None] < 0) | (cols[None, :] == target[:, None])
    if aff_pod is not None:
        n_sel = aff_pod.shape[0] // 4
        for s in range(n_sel):
            req_sel = aff_pod[s][:, None] > 0
            anti = aff_pod[n_sel + s][:, None] > 0
            match = aff_pod[2 * n_sel + s][:, None] > 0
            thresh = aff_pod[3 * n_sel + s][:, None]
            present = aff_node[s][None, :] > 0
            avoider = aff_node[n_sel + s][None, :] > 0
            cplus = aff_node[2 * n_sel + s][None, :]
            fit &= ~(
                (req_sel & ~present) | (anti & present) | (match & avoider)
                | (cplus > thresh)
            )
    if other is not None:
        fit &= other > 0
    if stats is not None:
        score = (score - stats[1][:, None]) * MAX_NODE_SCORE / (
            stats[0] - stats[1]
        )[:, None]
    return torch.where(fit, score, NEG)


def masked_score(
    alpha, beta, pod_ok, target, u, v, node_mask, pod_request, alloc, reqd,
    *, aff_pod=None, aff_node=None, other=None, stats=None, _plain=False,
) -> torch.Tensor:
    """K1: [p, n] float32 score where feasible, NEG elsewhere.

    alpha, beta [p] f32; pod_ok [p] bool (pod mask and selector validity);
    target [p] int32 (-1 unpinned); u, v [n] f32; node_mask [n] bool;
    pod_request [p, r], alloc and reqd [n, r] f32; aff_pod [4S, p] and
    aff_node [3S, n] f32 selector rows (engine._fused_affinity_operands);
    other [p, n] f32 (> 0 feasible); stats [2, p] f32 (highest, lowest)
    bounds of the min-max epilogue, applied when given."""
    if not _use_kernel(u, _plain):
        return masked_score_plain(
            alpha, beta, pod_ok, target, u, v, node_mask, pod_request, alloc,
            reqd, aff_pod=aff_pod, aff_node=aff_node, other=other, stats=stats,
        )
    dev = u.device
    p, r = pod_request.shape
    n = u.shape[0]
    f32 = torch.float32
    for name, t, dtype, shape in (
        ("alpha", alpha, f32, (p,)), ("beta", beta, f32, (p,)),
        ("pod_ok", pod_ok, torch.bool, (p,)), ("target", target, torch.int32, (p,)),
        ("u", u, f32, (n,)), ("v", v, f32, (n,)),
        ("node_mask", node_mask, torch.bool, (n,)),
        ("pod_request", pod_request, f32, (p, r)),
        ("alloc", alloc, f32, (n, r)), ("reqd", reqd, f32, (n, r)),
    ):
        _check(name, t, dtype, shape, dev)
    if r > MAX_RESOURCES:
        raise ValueError(f"masked_score: {r} resources > {MAX_RESOURCES}")
    n_sel = 0
    if aff_pod is not None:
        n_sel = aff_pod.shape[0] // 4
        if n_sel > MAX_FUSED_SELECTORS:
            raise ValueError(
                f"masked_score: {n_sel} selectors > {MAX_FUSED_SELECTORS}"
            )
        _check("aff_pod", aff_pod, f32, (4 * n_sel, p), dev)
        _check("aff_node", aff_node, f32, (3 * n_sel, n), dev)
    if other is not None:
        _check("other", other, f32, (p, n), dev)
    if stats is not None:
        _check("stats", stats, f32, (2, p), dev)
    out = torch.empty((p, n), dtype=f32, device=dev)
    lib = load_library()
    with torch.cuda.device(dev):
        rc = lib.ks_masked_score(
            _ptr(alpha), _ptr(beta), _ptr(pod_ok), _ptr(target), _ptr(u),
            _ptr(v), _ptr(node_mask), _ptr(pod_request), _ptr(alloc),
            _ptr(reqd), _ptr(aff_pod), _ptr(aff_node), _ptr(other),
            _ptr(stats), _ptr(out), p, n, r, n_sel, _stream(dev),
        )
    check_launch(lib, rc, "masked_score")
    launches["masked_score"] += 1
    return out


# ---- K2 ---------------------------------------------------------------


def row_stats_plain(alpha, beta, u, v, node_mask) -> torch.Tensor:
    """K2's plain version: [2, p] (max, min) raw score over node-masked
    nodes, +-F32_MAX for rows with none."""
    score = _raw_score_plain(alpha, beta, u, v)
    hi = torch.where(node_mask[None, :], score, -F32_MAX).amax(dim=1)
    lo = torch.where(node_mask[None, :], score, F32_MAX).amin(dim=1)
    return torch.stack([hi, lo])


def row_stats(alpha, beta, u, v, node_mask, *, _plain=False) -> torch.Tensor:
    """K2: [2, p] float32 per-pod (max, min) raw score over node_mask nodes."""
    if not _use_kernel(u, _plain):
        return row_stats_plain(alpha, beta, u, v, node_mask)
    dev = u.device
    p, n = alpha.shape[0], u.shape[0]
    f32 = torch.float32
    for name, t, dtype, shape in (
        ("alpha", alpha, f32, (p,)), ("beta", beta, f32, (p,)),
        ("u", u, f32, (n,)), ("v", v, f32, (n,)),
        ("node_mask", node_mask, torch.bool, (n,)),
    ):
        _check(name, t, dtype, shape, dev)
    out = torch.empty((2, p), dtype=f32, device=dev)
    lib = load_library()
    with torch.cuda.device(dev):
        rc = lib.ks_row_stats(
            _ptr(alpha), _ptr(beta), _ptr(u), _ptr(v), _ptr(node_mask),
            _ptr(out), p, n, _stream(dev),
        )
    check_launch(lib, rc, "row_stats")
    launches["row_stats"] += 1
    return out


def fused_score_row_stats(alpha, beta, u, v, node_mask, *, _plain=False):
    """[2, p] (highest, lowest) min-max bounds with ops/normalize
    semantics: K2's raw (max, min), highest floored at 0 and lowest
    lowered by 1 where the two are equal, outside the kernel exactly as
    pallas_fused.py:413-418 does."""
    raw = row_stats(alpha, beta, u, v, node_mask, _plain=_plain)
    highest = torch.clamp(raw[0], min=0.0)
    lowest = torch.where(highest == raw[1], raw[1] - 1.0, raw[1])
    return torch.stack([highest, lowest])


def fused_masked_score(
    u, v, node_mask, alloc, reqd, r_cpu, r_io, pod_request, pod_mask,
    *, target_node=None, other=None, aff_pod=None, aff_node=None,
    normalizer: str = "none", _plain: bool = False,
) -> torch.Tensor:
    """[p, n] masked score: balanced_cpu_diskio where the pod fits the node
    (resource fit, node and pod masks, nodeName pin, the folded selector
    families, `other`), NEG elsewhere; with normalizer="min_max" the
    feasible cells are min-max normalized with K2's bounds. The
    argument list is the reference function's (pallas_fused.py:252)
    without its tiling and interpreter options."""
    if normalizer not in ("none", "min_max"):
        raise ValueError(
            f"fused kernel epilogue supports normalizer 'none' or "
            f"'min_max', not {normalizer!r}"
        )
    p = pod_request.shape[0]
    alpha, beta = alpha_beta(r_cpu, r_io)
    if target_node is None:
        target = torch.full((p,), -1, dtype=torch.int32, device=u.device)
    else:
        target = target_node.to(torch.int32).contiguous()
    stats = None
    if normalizer == "min_max":
        stats = fused_score_row_stats(alpha, beta, u, v, node_mask, _plain=_plain)
    return masked_score(
        alpha, beta, pod_mask.contiguous(), target, u.contiguous(), v.contiguous(),
        node_mask.contiguous(), pod_request.to(torch.float32).contiguous(),
        alloc.to(torch.float32).contiguous(), reqd.to(torch.float32).contiguous(),
        aff_pod=aff_pod, aff_node=aff_node, other=other, stats=stats,
        _plain=_plain,
    )


# ---- K3 ---------------------------------------------------------------


def auction_bid_plain(sj, price, active, req, free):
    """K3's plain version (the reference's XLA round head,
    ops/assign.py:747-754): (bid [p] int32, has_bid [p] bool)."""
    cap_ok = (
        (req[:, None, :] <= free[None, :, :]) | (req[:, None, :] == 0)
    ).all(-1)
    mask = (sj > NEG * 0.5) & cap_ok & active[:, None]
    row = torch.where(mask, sj - price[None, :], NEG)
    return torch.argmax(row, dim=1).to(torch.int32), mask.any(dim=1)


def auction_bid(sj, price, active, req, free, *, _plain=False):
    """K3: one auction round's bid head, (bid [p] int32, has_bid [p] bool).

    sj [p, n] f32 round-invariant masked jittered scores (NEG where
    infeasible); price [n] f32; active [p] bool; req [p, r] f32;
    free [n, r] f32. bid is the first column of the row maximum, 0 when
    has_bid is False (jnp.argmax of an all-NEG row)."""
    if not _use_kernel(sj, _plain):
        return auction_bid_plain(sj, price, active, req, free)
    dev = sj.device
    p, n = sj.shape
    r = req.shape[1]
    f32 = torch.float32
    for name, t, dtype, shape in (
        ("sj", sj, f32, (p, n)), ("price", price, f32, (n,)),
        ("active", active, torch.bool, (p,)), ("req", req, f32, (p, r)),
        ("free", free, f32, (n, r)),
    ):
        _check(name, t, dtype, shape, dev)
    if r > MAX_RESOURCES:
        raise ValueError(f"auction_bid: {r} resources > {MAX_RESOURCES}")
    bid = torch.empty(p, dtype=torch.int32, device=dev)
    has = torch.empty(p, dtype=torch.int32, device=dev)
    lib = load_library()
    with torch.cuda.device(dev):
        rc = lib.ks_auction_bid(
            _ptr(sj), _ptr(price), _ptr(active), _ptr(req), _ptr(free),
            _ptr(bid), _ptr(has), p, n, r, _stream(dev),
        )
    check_launch(lib, rc, "auction_bid")
    launches["auction_bid"] += 1
    return bid, has > 0


# ---- K4 ---------------------------------------------------------------


def greedy_scan_plain(sj, req, free0):
    """K4's plain version (the reference's scan body without affinity,
    ops/assign.py:321-342): a loop over pods on tensors, with no host read
    per pod. A cell qualifies unless it is <= NEG/2, so a NaN cell does,
    and argmax ranks it above every number, the first NaN first (the XLA
    body's feasible & cap_ok, then jnp.argmax). Subtracting a zero row
    where no cell was found leaves `free` bitwise unchanged, so the update
    needs no branch."""
    p = sj.shape[0]
    free = free0.clone()
    picks = torch.full((p,), -1, dtype=torch.int32, device=sj.device)
    for i in range(p):
        q = req[i]
        cap_ok = ((q[None, :] <= free) | (q[None, :] == 0)).all(-1)
        mask = ~(sj[i] <= NEG * 0.5) & cap_ok
        choice = torch.argmax(torch.where(mask, sj[i], NEG)).view(1)
        found = mask.any()
        picks[i] = torch.where(found, choice[0].to(torch.int32), -1)
        free.index_copy_(0, choice, free.index_select(0, choice)
                         - torch.where(found, q, 0.0)[None, :])
    return picks, free


def greedy_scan(sj, req, free0, *, _plain=False, _list_len=GREEDY_LIST_LEN):
    """K4: the greedy scan, (picks [p] int32, free_after [n, r] f32).

    sj [p, n] f32 masked scores in scan order (NEG where infeasible or the
    pod is masked); req [p, r] f32 requests in the same order; free0
    [n, r] f32 free capacity before the window. picks[i] is pod i's node,
    -1 when no cell qualifies. `_list_len` (1 to GREEDY_LIST_LEN) shortens
    the kernel's candidate lists so that checks can drive its fallback;
    the result does not depend on it."""
    global last_greedy_fallbacks
    if not 1 <= _list_len <= GREEDY_LIST_LEN:
        raise ValueError(f"greedy_scan: _list_len {_list_len} not in 1..{GREEDY_LIST_LEN}")
    if not _use_kernel(sj, _plain):
        last_greedy_fallbacks = None
        return greedy_scan_plain(sj, req, free0)
    dev = sj.device
    p, n = sj.shape
    r = req.shape[1]
    f32, i32 = torch.float32, torch.int32
    for name, t, dtype, shape in (
        ("sj", sj, f32, (p, n)), ("req", req, f32, (p, r)),
        ("free0", free0, f32, (n, r)),
    ):
        _check(name, t, dtype, shape, dev)
    if r > MAX_RESOURCES:
        raise ValueError(f"greedy_scan: {r} resources > {MAX_RESOURCES}")
    picks = torch.empty(p, dtype=i32, device=dev)
    free_after = torch.empty((n, r), dtype=f32, device=dev)
    list_key = torch.empty((p, GREEDY_LIST_LEN), dtype=i32, device=dev)
    list_col = torch.empty((p, GREEDY_LIST_LEN), dtype=i32, device=dev)
    list_cnt = torch.empty(p, dtype=i32, device=dev)
    fallbacks = torch.empty(1, dtype=i32, device=dev)
    lib = load_library()
    with torch.cuda.device(dev):
        rc = lib.ks_greedy_scan(
            _ptr(sj), _ptr(req), _ptr(free0), _ptr(free_after), _ptr(picks),
            _ptr(list_key), _ptr(list_col), _ptr(list_cnt), _ptr(fallbacks),
            p, n, r, _list_len, _stream(dev),
        )
    check_launch(lib, rc, "greedy_scan")
    launches["greedy_scan"] += 1
    last_greedy_fallbacks = fallbacks
    return picks, free_after
