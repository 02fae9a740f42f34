"""The batch scheduling engine on PyTorch (counterpart of
kubernetes_scheduler_tpu/engine.py).

For a window of pending pods and a cluster snapshot, one cycle computes

    scores and feasibility -> soft score terms (soft=True) -> greedy
    (K4 scan) or auction (K3 bid head per round) assignment -> gangs

and returns pod -> node bindings; `schedule_windows` carries node
capacity and domain counts across a backlog of windows. Scores and
feasibility come from one of three paths: fused=True runs the masked
score through kernels K2 and K1 (policy balanced_cpu_diskio, normalizer
"none" or "min_max"); fused=False composes any policy of POLICIES, the
feasibility masks and any normalizer of NORMALIZERS in plain PyTorch;
score_plugins sums weighted policies as the upstream framework does.
With affinity_aware=True the count-based selector families stay out of
the static mask and both assigners enforce them against live in-window
counts. On a selector axis wider than MAX_FUSED_SELECTORS the fused path
evaluates those families outside K1. The types mirror the reference's
NamedTuples field for field, with torch tensors as leaves on one
explicit device.

Resident state: TorchEngine retains the cluster snapshot on the device
(schedule_resident, schedule_windows_resident, schedule_batch_fleet) and
folds a SnapshotDelta's changed rows into it in place, with the kernels'
node operands kept beside it as a FusedLayout (schedule_batch(layout=)).

Preemption: preempt_batch (TorchEngine.preempt) is the PostFilter pass,
victim prefix tables and the candidate choice of ops/preempt.py.

Ported: every option of the reference's schedule_batch and all of
LocalEngine's surface.
"""

from __future__ import annotations

import os
import tempfile
from typing import NamedTuple

import numpy as np
import torch

from kubernetes_scheduler_tpu_torch.device import resolve_device, to_device
from kubernetes_scheduler_tpu_torch.ops.assign import (
    NEG,
    AffinityState,
    AssignResult,
    anti_reverse_bad,
    auction_assign,
    greedy_assign,
    pod_has_anti_onehot,
)
from kubernetes_scheduler_tpu_torch.ops.collect import collect_max_card_values
from kubernetes_scheduler_tpu_torch.ops.constraints import (
    node_affinity_fit,
    node_affinity_preference,
    node_name_fit,
    pod_affinity_fit,
    pod_affinity_preference,
    prefer_no_schedule_penalty,
    taint_toleration_fit,
    topology_spread_fit,
)
from kubernetes_scheduler_tpu_torch.ops.feasibility import card_fit, resource_fit
from kubernetes_scheduler_tpu_torch.ops.fused import (
    MAX_FUSED_SELECTORS,
    fused_masked_score,
)
from kubernetes_scheduler_tpu_torch.ops.gang import gang_mask_assign
from kubernetes_scheduler_tpu_torch.ops.normalize import (
    F32_MAX,
    min_max_normalize,
    softmax_normalize,
)
from kubernetes_scheduler_tpu_torch.ops.score import (
    balanced_allocation,
    balanced_cpu_diskio,
    balanced_diskio,
    card_score,
    free_capacity,
    image_locality,
    least_allocated,
)
from kubernetes_scheduler_tpu_torch.ops.stats import (
    CPU_DIVISOR,
    DISK_IO_DIVISOR,
    utilization_stats,
)

_F32, _I32, _BOOL = torch.float32, torch.int32, torch.bool

POLICIES = (
    "balanced_cpu_diskio", "balanced_diskio", "free_capacity", "card",
    "least_allocated", "balanced_allocation", "image_locality",
)
ASSIGNERS = ("greedy", "auction")
NORMALIZERS = ("min_max", "softmax", "none")
# plugins whose raw output is already on the framework's [0, 100]
# MaxNodeScore scale (upstream runs no NormalizeScore for them); every
# other plugin is min-max normalized per pod before weighting
PRESCALED_PLUGINS = (
    "least_allocated", "balanced_allocation", "image_locality",
    "balanced_diskio",
)


class SnapshotArrays(NamedTuple):
    """Dense node-side cluster state (reference: engine.SnapshotArrays)."""

    allocatable: torch.Tensor      # [n, r] float32
    requested: torch.Tensor        # [n, r] float32 (non-zero defaults applied)
    disk_io: torch.Tensor          # [n] float32 MB/s
    cpu_pct: torch.Tensor          # [n] float32 %
    mem_pct: torch.Tensor          # [n] float32 %
    net_up: torch.Tensor           # [n] float32 MB/s
    net_down: torch.Tensor         # [n] float32 MB/s
    node_mask: torch.Tensor        # [n] bool
    cards: torch.Tensor            # [n, c, 6] float32
    card_mask: torch.Tensor        # [n, c] bool
    card_healthy: torch.Tensor     # [n, c] bool
    taints: torch.Tensor           # [n, T, 3] int32 (key, value, effect)
    taint_mask: torch.Tensor       # [n, T] bool
    node_labels: torch.Tensor      # [n, Ln, 2] int32 (key, value)
    node_label_mask: torch.Tensor  # [n, Ln] bool
    domain_counts: torch.Tensor    # [n, S] float32 selector match counts
    domain_id: torch.Tensor        # [n, S] int32 topology-domain id
    avoid_counts: torch.Tensor     # [n, S] float32 running avoiders
    pref_attract: torch.Tensor     # [n, S] float32
    pref_avoid: torch.Tensor       # [n, S] float32
    image_scaled: torch.Tensor     # [n, V] float32


class PodBatch(NamedTuple):
    """Dense pending-pod window (reference: engine.PodBatch); a windows
    batch carries a leading [w] axis on every leaf."""

    request: torch.Tensor             # [p, r] float32
    r_io: torch.Tensor                # [p] float32 diskIO MB/s
    priority: torch.Tensor            # [p] int32
    pod_mask: torch.Tensor            # [p] bool
    want_number: torch.Tensor         # [p] int32 (0 = no GPU demand)
    want_memory: torch.Tensor         # [p] float32 (-1 = absent)
    want_clock: torch.Tensor          # [p] float32 (-1 = absent)
    tolerations: torch.Tensor         # [p, L, 4] int32
    tol_mask: torch.Tensor            # [p, L] bool
    na_key: torch.Tensor              # [p, E] int32
    na_op: torch.Tensor               # [p, E] int32
    na_vals: torch.Tensor             # [p, E, V] int32
    na_val_mask: torch.Tensor         # [p, E, V] bool
    na_mask: torch.Tensor             # [p, E] bool
    na_term: torch.Tensor             # [p, E] int32 OR-group ids
    affinity_sel: torch.Tensor        # [p, K] int32, -1 pad
    anti_affinity_sel: torch.Tensor   # [p, K] int32, -1 pad
    pod_matches: torch.Tensor         # [p, S] bool
    pna_key: torch.Tensor             # [p, Ep] int32
    pna_op: torch.Tensor              # [p, Ep] int32
    pna_vals: torch.Tensor            # [p, Ep, V] int32
    pna_val_mask: torch.Tensor        # [p, Ep, V] bool
    pna_mask: torch.Tensor            # [p, Ep] bool
    pna_weight: torch.Tensor          # [p, Ep] float32
    pna_term: torch.Tensor            # [p, Ep] int32
    pref_affinity_sel: torch.Tensor   # [p, K] int32
    pref_affinity_weight: torch.Tensor  # [p, K] float32
    pref_anti_sel: torch.Tensor       # [p, K] int32
    pref_anti_weight: torch.Tensor    # [p, K] float32
    target_node: torch.Tensor         # [p] int32, -1 unpinned
    spread_sel: torch.Tensor          # [p, Ks] int32
    spread_max: torch.Tensor          # [p, Ks] int32
    soft_spread_sel: torch.Tensor     # [p, Kss] int32
    image_ids: torch.Tensor           # [p, Ki] int32
    n_containers: torch.Tensor        # [p] int32
    gang_id: torch.Tensor             # [p] int32, -1 = no gang
    gang_size: torch.Tensor           # [p] int32


# leaf dtypes as make_snapshot / make_pod_batch fix them
SNAPSHOT_DTYPES = {
    "node_mask": _BOOL, "card_mask": _BOOL, "card_healthy": _BOOL,
    "taints": _I32, "taint_mask": _BOOL, "node_labels": _I32,
    "node_label_mask": _BOOL, "domain_id": _I32,
}
SNAPSHOT_DTYPES = {f: SNAPSHOT_DTYPES.get(f, _F32) for f in SnapshotArrays._fields}
POD_DTYPES = {
    "request": _F32, "r_io": _F32, "want_memory": _F32, "want_clock": _F32,
    "pna_weight": _F32, "pref_affinity_weight": _F32, "pref_anti_weight": _F32,
    "pod_mask": _BOOL, "tol_mask": _BOOL, "na_val_mask": _BOOL, "na_mask": _BOOL,
    "pod_matches": _BOOL, "pna_val_mask": _BOOL, "pna_mask": _BOOL,
}
POD_DTYPES = {f: POD_DTYPES.get(f, _I32) for f in PodBatch._fields}

_NP_DTYPES = {_F32: np.float32, _I32: np.int32, _BOOL: np.bool_}


def as_leaf(x, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """One array-like leaf (numpy, list, scalar or tensor) as a tensor of
    `dtype` on `device`. A tensor already there in that dtype is returned
    as it is; host data converts on the host and uploads through
    device.to_device (a private copy)."""
    if isinstance(x, torch.Tensor):
        if x.device.type == "cpu" and device.type != "cpu":
            return to_device(x.to(dtype), device)
        return x.to(device=device, dtype=dtype)
    return to_device(np.asarray(x, dtype=_NP_DTYPES[dtype]), device)


def _shape(x) -> tuple:
    return tuple(x.shape) if hasattr(x, "shape") else np.shape(x)


def make_snapshot(
    allocatable, requested, disk_io, cpu_pct, mem_pct, *,
    net_up=None, net_down=None, node_mask=None, cards=None, card_mask=None,
    card_healthy=None, taints=None, taint_mask=None, node_labels=None,
    node_label_mask=None, domain_counts=None, domain_id=None,
    avoid_counts=None, pref_attract=None, pref_avoid=None,
    image_scaled=None, device=None,
) -> SnapshotArrays:
    """SnapshotArrays with the reference's no-op defaults for everything
    optional (no cards, no taints, no labels, one selector column, every
    node its own domain), on `device` (default cuda)."""
    dev = resolve_device(device)
    n = _shape(allocatable)[0]
    s = 1 if domain_counts is None else _shape(domain_counts)[1]
    z = lambda *shape: np.zeros(shape, np.float32)  # noqa: E731
    leaves = dict(
        allocatable=allocatable, requested=requested, disk_io=disk_io,
        cpu_pct=cpu_pct, mem_pct=mem_pct,
        net_up=z(n) if net_up is None else net_up,
        net_down=z(n) if net_down is None else net_down,
        node_mask=np.ones(n, bool) if node_mask is None else node_mask,
        cards=z(n, 1, 6) if cards is None else cards,
        # a provided payload with an omitted mask defaults to all-valid
        card_mask=(
            (z(n, 1) if cards is None else np.ones(_shape(cards)[:2]))
            if card_mask is None else card_mask
        ),
        card_healthy=(
            (z(n, 1) if cards is None else np.ones(_shape(cards)[:2]))
            if card_healthy is None else card_healthy
        ),
        taints=z(n, 1, 3) if taints is None else taints,
        taint_mask=(
            (z(n, 1) if taints is None else np.ones(_shape(taints)[:2]))
            if taint_mask is None else taint_mask
        ),
        node_labels=z(n, 1, 2) if node_labels is None else node_labels,
        node_label_mask=(
            (z(n, 1) if node_labels is None else np.ones(_shape(node_labels)[:2]))
            if node_label_mask is None else node_label_mask
        ),
        domain_counts=z(n, 1) if domain_counts is None else domain_counts,
        domain_id=(
            np.repeat(np.arange(n)[:, None], s, axis=1)
            if domain_id is None else domain_id
        ),
        avoid_counts=z(n, s) if avoid_counts is None else avoid_counts,
        pref_attract=z(n, s) if pref_attract is None else pref_attract,
        pref_avoid=z(n, s) if pref_avoid is None else pref_avoid,
        image_scaled=z(n, 1) if image_scaled is None else image_scaled,
    )
    return SnapshotArrays(
        **{k: as_leaf(v, SNAPSHOT_DTYPES[k], dev) for k, v in leaves.items()}
    )


def make_pod_batch(
    request, *,
    r_io=None, priority=None, pod_mask=None, want_number=None,
    want_memory=None, want_clock=None, tolerations=None, tol_mask=None,
    na_key=None, na_op=None, na_vals=None, na_val_mask=None, na_mask=None,
    na_term=None, affinity_sel=None, anti_affinity_sel=None,
    pod_matches=None, pna_key=None, pna_op=None, pna_vals=None,
    pna_val_mask=None, pna_mask=None, pna_weight=None, pna_term=None,
    pref_affinity_sel=None, pref_affinity_weight=None, pref_anti_sel=None,
    pref_anti_weight=None, target_node=None, spread_sel=None,
    spread_max=None, soft_spread_sel=None, image_ids=None,
    n_containers=None, gang_id=None, gang_size=None, device=None,
) -> PodBatch:
    """PodBatch with the reference's no-op defaults (no GPU demand, no
    tolerations, no affinity, no preferences, no gang), on `device`
    (default cuda)."""
    dev = resolve_device(device)
    p = _shape(request)[0]
    z = lambda *shape: np.zeros(shape, np.float32)  # noqa: E731
    neg = lambda *shape: np.full(shape, -1, np.int32)  # noqa: E731
    ones = lambda x: np.ones(_shape(x))  # noqa: E731
    e_p = 1 if pna_key is None else _shape(pna_key)[1]
    leaves = dict(
        request=request,
        r_io=z(p) if r_io is None else r_io,
        priority=z(p) if priority is None else priority,
        pod_mask=np.ones(p, bool) if pod_mask is None else pod_mask,
        want_number=z(p) if want_number is None else want_number,
        want_memory=np.full(p, -1.0) if want_memory is None else want_memory,
        want_clock=np.full(p, -1.0) if want_clock is None else want_clock,
        tolerations=z(p, 1, 4) if tolerations is None else tolerations,
        tol_mask=(
            (z(p, 1) if tolerations is None else np.ones(_shape(tolerations)[:2]))
            if tol_mask is None else tol_mask
        ),
        na_key=z(p, 1) if na_key is None else na_key,
        na_op=z(p, 1) if na_op is None else na_op,
        na_vals=z(p, 1, 1) if na_vals is None else na_vals,
        na_val_mask=(
            (z(p, 1, 1) if na_vals is None else ones(na_vals))
            if na_val_mask is None else na_val_mask
        ),
        na_mask=(
            (z(p, 1) if na_key is None else ones(na_key))
            if na_mask is None else na_mask
        ),
        na_term=(
            (z(p, 1) if na_key is None else z(*_shape(na_key)))
            if na_term is None else na_term
        ),
        affinity_sel=neg(p, 1) if affinity_sel is None else affinity_sel,
        anti_affinity_sel=(
            neg(p, 1) if anti_affinity_sel is None else anti_affinity_sel
        ),
        pod_matches=z(p, 1) if pod_matches is None else pod_matches,
        pna_key=z(p, 1) if pna_key is None else pna_key,
        pna_op=z(p, 1) if pna_op is None else pna_op,
        pna_vals=z(p, 1, 1) if pna_vals is None else pna_vals,
        pna_val_mask=(
            (z(p, 1, 1) if pna_vals is None else ones(pna_vals))
            if pna_val_mask is None else pna_val_mask
        ),
        pna_mask=(
            (z(p, 1) if pna_key is None else ones(pna_key))
            if pna_mask is None else pna_mask
        ),
        pna_weight=(
            (z(p, 1) if pna_key is None else ones(pna_key))
            if pna_weight is None else pna_weight
        ),
        # default: each expression its own preferred term
        pna_term=(
            np.repeat(np.arange(e_p)[None, :], p, axis=0)
            if pna_term is None else pna_term
        ),
        pref_affinity_sel=(
            neg(p, 1) if pref_affinity_sel is None else pref_affinity_sel
        ),
        pref_affinity_weight=(
            (z(p, 1) if pref_affinity_sel is None else ones(pref_affinity_sel))
            if pref_affinity_weight is None else pref_affinity_weight
        ),
        pref_anti_sel=neg(p, 1) if pref_anti_sel is None else pref_anti_sel,
        pref_anti_weight=(
            (z(p, 1) if pref_anti_sel is None else ones(pref_anti_sel))
            if pref_anti_weight is None else pref_anti_weight
        ),
        target_node=neg(p) if target_node is None else target_node,
        spread_sel=neg(p, 1) if spread_sel is None else spread_sel,
        spread_max=(
            (np.ones((p, 1)) if spread_sel is None else ones(spread_sel))
            if spread_max is None else spread_max
        ),
        soft_spread_sel=neg(p, 1) if soft_spread_sel is None else soft_spread_sel,
        image_ids=neg(p, 1) if image_ids is None else image_ids,
        n_containers=np.ones(p) if n_containers is None else n_containers,
        gang_id=neg(p) if gang_id is None else gang_id,
        gang_size=z(p) if gang_size is None else gang_size,
    )
    return PodBatch(**{k: as_leaf(v, POD_DTYPES[k], dev) for k, v in leaves.items()})


class ScheduleResult(NamedTuple):
    node_idx: torch.Tensor     # [p] int32 assigned node, -1 = unschedulable
    scores: torch.Tensor       # [p, n] normalized (+ soft term; fused: masked)
    raw_scores: torch.Tensor   # [p, n] before normalization (fused: masked)
    feasible: torch.Tensor     # [p, n] bool
    free_after: torch.Tensor   # [n, r]
    n_assigned: torch.Tensor   # [] int32


class WindowsResult(NamedTuple):
    node_idx: torch.Tensor    # [w, p] int32 per-window assignments
    free_after: torch.Tensor  # [n, r] free capacity after the last window
    n_assigned: torch.Tensor  # [] int32 total across windows


# ---- resident state: deltas and the kernel layout ---------------------------


class SnapshotDelta(NamedTuple):
    """Cycle-over-cycle change to a retained SnapshotArrays (reference:
    engine.SnapshotDelta): changed rows BY VALUE (set, never add, so a
    folded snapshot is bitwise the one a full upload would give). Rows
    and values are host arrays (numpy or CPU tensors); the node mask may
    also be a device tensor.

    Row index arrays are bucket-padded with the sentinel n (the node
    axis length), which the folds drop, as the reference's scatter with
    mode="drop" does. Only the leaves that change in steady state ride a
    delta: `requested` rows, the five utilization series, the four float
    domain-count tables and the node mask; any other change makes the
    host send a full upload."""

    req_rows: object   # [k] int32 changed `requested` rows; pad = n
    req_vals: object   # [k, r] float32 full new row contents
    util_rows: object  # [j] int32 changed utilization rows; pad = n
    # [j, 5] float32 columns: disk_io, cpu_pct, mem_pct, net_up, net_down
    util_vals: object
    dom_rows: object   # [d] int32 changed domain-table rows; pad = n
    # [d, S, 4] float32 stacked columns: domain_counts, avoid_counts,
    # pref_attract, pref_avoid
    dom_vals: object
    node_mask: object  # [n] bool, shipped whole every delta


UTIL_SERIES = ("disk_io", "cpu_pct", "mem_pct", "net_up", "net_down")
DOMAIN_TABLES = ("domain_counts", "avoid_counts", "pref_attract", "pref_avoid")


class _Rows(NamedTuple):
    """One row family of a delta on the device, ready for index_copy_:
    every row lies in [0, n), the sentinels already dropped."""

    rows: torch.Tensor  # [k] int64
    vals: torch.Tensor  # [k, ...] float32


def _upload_rows(rows, vals, n: int, device: torch.device) -> _Rows:
    """A delta's row family on `device`. The rows are filtered to [0, n)
    on the host, so only the kept rows cross and nothing is read back (an
    out-of-range index_copy_ on a card is a device-side assert). Rows and
    values must be host arrays (numpy or CPU tensors), as the host's delta
    builder makes them."""
    for x in (rows, vals):
        if isinstance(x, torch.Tensor) and x.device.type != "cpu":
            raise ValueError(
                f"SnapshotDelta rows and values must be host arrays, got a tensor on {x.device}"
            )
    rows = np.asarray(rows)
    vals = np.asarray(vals, dtype=np.float32)
    keep = (rows >= 0) & (rows < n)
    if not keep.all():
        rows, vals = rows[keep], vals[keep]
    return _Rows(to_device(rows, device).long(), to_device(vals, device))


class _DeviceDelta(NamedTuple):
    """A SnapshotDelta uploaded once, shared by the snapshot and layout
    folds of one resident cycle."""

    req: _Rows
    util: _Rows
    dom: _Rows
    node_mask: torch.Tensor


def _upload_delta(delta: SnapshotDelta, n: int, device: torch.device) -> _DeviceDelta:
    return _DeviceDelta(
        req=_upload_rows(delta.req_rows, delta.req_vals, n, device),
        util=_upload_rows(delta.util_rows, delta.util_vals, n, device),
        dom=_upload_rows(delta.dom_rows, delta.dom_vals, n, device),
        node_mask=as_leaf(delta.node_mask, _BOOL, device),
    )


def _apply_delta_rows(snapshot: SnapshotArrays, dd: _DeviceDelta) -> SnapshotArrays:
    """The row folds of apply_snapshot_delta, in place, on an uploaded
    delta: `requested`, the utilization series and the domain tables get
    their rows, the node mask its new contents."""
    snapshot.requested.index_copy_(0, dd.req.rows, dd.req.vals)
    for col, name in enumerate(UTIL_SERIES):
        getattr(snapshot, name).index_copy_(0, dd.util.rows, dd.util.vals[:, col])
    for col, name in enumerate(DOMAIN_TABLES):
        getattr(snapshot, name).index_copy_(0, dd.dom.rows, dd.dom.vals[:, :, col])
    snapshot.node_mask.copy_(dd.node_mask)
    return snapshot


def apply_snapshot_delta(snapshot: SnapshotArrays, delta: SnapshotDelta) -> SnapshotArrays:
    """Fold a SnapshotDelta into the resident snapshot IN PLACE and return
    it (reference: engine.apply_snapshot_delta, whose donated buffers XLA
    reuses). Only the delta's rows and the node mask cross to the device;
    no [n, r] matrix does, and nothing is read back. The snapshot's
    leaves must be the caller's own: a leaf shared with anyone else
    (an input tensor, a uniform-constant cache entry) changes for them
    too."""
    n = snapshot.node_mask.shape[0]
    return _apply_delta_rows(snapshot, _upload_delta(delta, n, snapshot.node_mask.device))


def apply_snapshot_delta_np(snapshot: SnapshotArrays, delta: SnapshotDelta):
    """The numpy twin of apply_snapshot_delta (reference:
    engine.apply_snapshot_delta_np), for a host that keeps the resident
    state off the device: row sets by value on copies, so the result is
    bitwise the snapshot a full upload would ship; the input's leaves are
    not mutated. Returns a new SnapshotArrays with numpy leaves where the
    delta writes."""
    n = snapshot.node_mask.shape[0]

    def folded(name, rows, vals):
        out = np.array(getattr(snapshot, name), np.float32, copy=True)
        keep = (rows >= 0) & (rows < n)
        out[rows[keep]] = vals[keep]
        return out

    rows = np.asarray(delta.req_rows)
    urows, uvals = np.asarray(delta.util_rows), np.asarray(delta.util_vals, np.float32)
    drows, dvals = np.asarray(delta.dom_rows), np.asarray(delta.dom_vals, np.float32)
    return snapshot._replace(
        requested=folded("requested", rows, np.asarray(delta.req_vals, np.float32)),
        **{name: folded(name, urows, uvals[:, col]) for col, name in enumerate(UTIL_SERIES)},
        **{name: folded(name, drows, dvals[:, :, col])
           for col, name in enumerate(DOMAIN_TABLES)},
        node_mask=np.asarray(delta.node_mask, bool),
    )


def snapshot_nbytes(nt) -> int:
    """Total payload bytes of a NamedTuple of numpy arrays or tensors,
    from shapes and dtypes only (reference: engine.snapshot_nbytes)."""
    total = 0
    for a in nt:
        if isinstance(a, torch.Tensor):
            total += a.numel() * a.element_size()
        else:
            total += int(np.prod(a.shape, dtype=np.int64)) * np.dtype(a.dtype).itemsize
    return total


class FusedLayout(NamedTuple):
    """The resident node operands of K2 and K1 (reference:
    engine.FusedLayout), retained across resident cycles so that a delta
    cycle writes only the changed rows into them and skips
    utilization_stats. The reference keeps prep_node_operands' transposed,
    tile-padded TPU layout; the port keeps what its kernels take, [n]
    vectors and row-major [n, r] matrices, field for field:

    - u, v: the reference's node_ft[0, :n] and node_ft[1, :n];
    - node_mask: node_ft[2, :n] (there 0/1 float32, here bool);
    - alloc: alloc_t.T[:n];
    - reqd: reqd_t.T[:n].

    Built by build_fused_layout on a full upload, folded by
    apply_layout_delta with the same expressions on the same row values,
    so a resident cycle is bitwise a full upload's."""

    u: torch.Tensor          # [n] float32 disk_io / 50
    v: torch.Tensor          # [n] float32 cpu_pct / 100
    node_mask: torch.Tensor  # [n] bool
    alloc: torch.Tensor      # [n, r] float32, contiguous
    reqd: torch.Tensor       # [n, r] float32, contiguous


def build_fused_layout(snapshot: SnapshotArrays) -> FusedLayout:
    """FusedLayout of a snapshot, in private tensors (the folds write
    them in place): u and v as utilization_stats computes them."""
    stats = utilization_stats(snapshot.disk_io, snapshot.cpu_pct, snapshot.node_mask)
    return FusedLayout(
        u=stats.u, v=stats.v, node_mask=snapshot.node_mask.clone(),
        alloc=snapshot.allocatable.to(_F32).clone(memory_format=torch.contiguous_format),
        reqd=snapshot.requested.to(_F32).clone(memory_format=torch.contiguous_format),
    )


def _apply_layout_rows(layout: FusedLayout, dd: _DeviceDelta) -> FusedLayout:
    """The layout fold of apply_layout_delta, in place, on an uploaded
    delta: u and v rows are utilization_stats' expressions on the new
    series values (a division by a device tensor, as ops/stats.py
    divides: a host scalar divisor would round differently on a card),
    reqd gets the `requested` rows, node_mask its new contents; alloc
    never rides a delta."""
    util = dd.util.vals
    layout.u.index_copy_(0, dd.util.rows, util[:, 0] / util.new_full((), DISK_IO_DIVISOR))
    layout.v.index_copy_(0, dd.util.rows, util[:, 1] / util.new_full((), CPU_DIVISOR))
    layout.reqd.index_copy_(0, dd.req.rows, dd.req.vals)
    layout.node_mask.copy_(dd.node_mask)
    return layout


def apply_layout_delta(layout: FusedLayout, delta: SnapshotDelta) -> FusedLayout:
    """Fold a SnapshotDelta into a retained FusedLayout IN PLACE and
    return it (reference: engine.apply_layout_delta): bitwise what
    build_fused_layout gives for the folded snapshot."""
    n = layout.node_mask.shape[0]
    return _apply_layout_rows(layout, _upload_delta(delta, n, layout.node_mask.device))


# ---- options and shared pieces -----------------------------------------


def check_fused_contract(policy: str, normalizer: str) -> None:
    """The fused path's (policy, normalizer) domain on the dense surface
    (reference: engine.check_fused_contract with min_max_ok=True): the
    kernel computes one policy, and its epilogue one normalizer; softmax
    stays unfused (its statistics would fold the NEG sentinels)."""
    if policy != "balanced_cpu_diskio":
        raise ValueError(
            f"fused kernel only implements balanced_cpu_diskio, not {policy!r}"
        )
    allowed = ("none", "min_max")
    if normalizer not in allowed:
        raise ValueError(
            f"fused=True requires normalizer in {allowed}, not {normalizer!r}"
        )


def compute_free_capacity(snapshot: SnapshotArrays) -> torch.Tensor:
    """[n, r] free capacity for assignment; padded nodes get 0."""
    return torch.where(
        snapshot.node_mask[:, None],
        snapshot.allocatable - snapshot.requested,
        0.0,
    )


def match_matrix(pods: PodBatch, s: int) -> torch.Tensor:
    """pods.pod_matches aligned to the snapshot's selector dimension `s`."""
    m = pods.pod_matches
    if m.shape[1] < s:
        return torch.nn.functional.pad(m, (0, s - m.shape[1]))
    return m[:, :s]


def local_spread_dmin(snapshot: SnapshotArrays) -> torch.Tensor:
    """[S] per-selector minimum domain count over schedulable nodes, the
    spread families' reference point."""
    return torch.where(
        snapshot.node_mask[:, None], snapshot.domain_counts, F32_MAX
    ).amin(dim=0)


# ---- scores ---------------------------------------------------------------


def compute_scores(
    snapshot: SnapshotArrays, pods: PodBatch, policy: str
) -> torch.Tensor:
    """[p, n] raw scores of one policy of POLICIES (reference:
    engine.compute_scores)."""
    if policy == "balanced_cpu_diskio":
        stats = utilization_stats(snapshot.disk_io, snapshot.cpu_pct, snapshot.node_mask)
        return balanced_cpu_diskio(stats, pods.request[:, 0], pods.r_io)
    if policy == "balanced_diskio":
        stats = utilization_stats(snapshot.disk_io, snapshot.cpu_pct, snapshot.node_mask)
        return balanced_diskio(stats, snapshot.disk_io, pods.r_io, snapshot.node_mask)
    if policy == "free_capacity":
        s = free_capacity(snapshot.cpu_pct, snapshot.mem_pct, snapshot.disk_io)
        return s[None, :].expand(pods.request.shape[0], s.shape[0])
    if policy == "card":
        node_fits, per_card = card_fit(
            snapshot.cards, snapshot.card_mask, snapshot.card_healthy,
            pods.want_number, pods.want_memory, pods.want_clock,
        )
        maxima = collect_max_card_values(
            snapshot.cards, per_card & node_fits[:, :, None]
        )
        return card_score(snapshot.cards, snapshot.card_mask, per_card, maxima)
    if policy == "least_allocated":
        return least_allocated(snapshot.allocatable, snapshot.requested, pods.request)
    if policy == "balanced_allocation":
        return balanced_allocation(snapshot.allocatable, snapshot.requested, pods.request)
    if policy == "image_locality":
        return image_locality(snapshot.image_scaled, pods.image_ids, pods.n_containers)
    raise ValueError(f"unknown policy {policy!r}; expected one of {POLICIES}")


def combine_scores(
    snapshot: SnapshotArrays, pods: PodBatch, score_plugins: tuple
) -> torch.Tensor:
    """[p, n] the upstream framework's weighted multi-plugin score
    (reference: engine.combine_scores): each (policy, weight) pair scores
    every node, a plugin outside PRESCALED_PLUGINS is min-max normalized
    per pod first, and the weighted terms are summed; the sum is final
    (the framework never rescales it)."""
    if not score_plugins:
        raise ValueError("score_plugins must name at least one plugin")
    total = None
    for name, weight in score_plugins:
        raw = compute_scores(snapshot, pods, name)
        if name not in PRESCALED_PLUGINS:
            raw = min_max_normalize(raw, snapshot.node_mask)
        term = raw * float(weight)
        total = term if total is None else total + term
    return total


def normalize_scores(
    raw: torch.Tensor, node_mask: torch.Tensor, normalizer: str
) -> torch.Tensor:
    """Dispatch over NORMALIZERS (reference: engine.normalize_scores)."""
    if normalizer == "min_max":
        return min_max_normalize(raw, node_mask)
    if normalizer == "softmax":
        return softmax_normalize(raw, node_mask)
    if normalizer == "none":
        return raw
    raise ValueError(f"unknown normalizer {normalizer!r}")


def compute_soft_scores(
    snapshot: SnapshotArrays,
    pods: PodBatch,
    *,
    taint_penalty_weight: float = 1.0,
    spread_dmin: torch.Tensor | None = None,
) -> torch.Tensor:
    """[p, n] float32 soft-constraint term (reference:
    engine.compute_soft_scores), upstream's scoring-only families: +weight
    per satisfied preferred node-affinity term, +/-weight per preferred
    (anti)affinity selector matched in the node's domain, the symmetric
    half (running pods' preferred terms whose selector the pod matches:
    +pref_attract, -pref_avoid), -taint_penalty_weight per untolerated
    PreferNoSchedule taint, and -(count - min count) per ScheduleAnyway
    spread constraint. spread_dmin: the [S] minimum to measure skew from
    (default local_spread_dmin). Added to the normalized score when a
    cycle runs with soft=True; it never filters."""
    na = node_affinity_preference(
        snapshot.node_labels, snapshot.node_label_mask,
        pods.pna_key, pods.pna_op, pods.pna_vals, pods.pna_val_mask,
        pods.pna_mask, pods.pna_weight, pods.pna_term,
    )
    pa = pod_affinity_preference(
        snapshot.domain_counts,
        pods.pref_affinity_sel, pods.pref_affinity_weight,
        pods.pref_anti_sel, pods.pref_anti_weight,
    )
    pen = prefer_no_schedule_penalty(
        snapshot.taints, snapshot.taint_mask, pods.tolerations, pods.tol_mask
    )
    matches = match_matrix(pods, snapshot.pref_attract.shape[1]).to(_F32)
    sym = matches @ (snapshot.pref_attract - snapshot.pref_avoid).T       # [p, n]
    s = snapshot.domain_counts.shape[1]
    ssel = pods.soft_spread_sel                                           # [p, K]
    ok = (ssel >= 0) & (ssel < s)
    idx = torch.clamp(ssel, 0, max(s - 1, 0)).long()
    dmin = local_spread_dmin(snapshot) if spread_dmin is None else spread_dmin
    skew = snapshot.domain_counts[:, idx] - dmin[idx][None, :, :]         # [n, p, K]
    soft_spread = torch.where(ok[None, :, :], skew, 0.0).sum(-1).T        # [p, n]
    return na + pa + sym - taint_penalty_weight * pen - soft_spread


# ---- feasibility ----------------------------------------------------------


def other_fit(snapshot: SnapshotArrays, pods: PodBatch) -> torch.Tensor:
    """[p, n] bool: GPU cards, taints and required node affinity, the
    families the fused kernel takes as its one `other` operand."""
    gpu_fits, _ = card_fit(
        snapshot.cards, snapshot.card_mask, snapshot.card_healthy,
        pods.want_number, pods.want_memory, pods.want_clock,
    )
    return gpu_fits & taint_toleration_fit(
        snapshot.taints, snapshot.taint_mask, pods.tolerations, pods.tol_mask
    ) & node_affinity_fit(
        snapshot.node_labels, snapshot.node_label_mask,
        pods.na_key, pods.na_op, pods.na_vals, pods.na_val_mask, pods.na_mask,
        pods.na_term,
    )


def count_families_fit(snapshot: SnapshotArrays, pods: PodBatch) -> torch.Tensor:
    """[p, n] bool: the count-based families against pre-window counts:
    the pod's own (anti)affinity, no avoider of a selector it matches in
    the node's domain (upstream checks running pods' anti terms too), and
    hard topology spread."""
    matches = match_matrix(pods, snapshot.avoid_counts.shape[1])
    return pod_affinity_fit(
        snapshot.domain_counts, pods.affinity_sel, pods.anti_affinity_sel
    ) & ~anti_reverse_bad(matches, snapshot.avoid_counts) & topology_spread_fit(
        snapshot.domain_counts, snapshot.node_mask, pods.spread_sel, pods.spread_max
    )


def compute_feasibility(
    snapshot: SnapshotArrays,
    pods: PodBatch,
    *,
    include_pod_affinity: bool = True,
) -> torch.Tensor:
    """[p, n] bool, every filter ANDed (reference:
    engine.compute_feasibility): resource fit, pod mask, nodeName pin,
    other_fit, and with include_pod_affinity the count-based families
    against pre-window counts (affinity_aware=False); without it the
    assigners hold those against live in-window counts."""
    out = resource_fit(
        snapshot.allocatable, snapshot.requested, pods.request, snapshot.node_mask
    ) & other_fit(snapshot, pods) & pods.pod_mask[:, None]
    out = out & node_name_fit(pods.target_node, snapshot.allocatable.shape[0])
    if include_pod_affinity:
        out = out & count_families_fit(snapshot, pods)
    return out


def _fused_affinity_operands(
    snapshot: SnapshotArrays, pods: PodBatch
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(aff_pod [4S, p], aff_node [3S, n], valid [p]): the count-based
    families (pod affinity, anti-affinity, reverse avoiders, topology
    spread) as per-selector rows K1 folds; a stale selector id >= S makes
    the pod infeasible everywhere through `valid`."""
    s = snapshot.domain_counts.shape[1]
    p = pods.request.shape[0]
    dev = pods.request.device
    a_hot = pod_has_anti_onehot(pods.affinity_sel, s).to(_F32)
    t_hot = pod_has_anti_onehot(pods.anti_affinity_sel, s).to(_F32)
    matches = match_matrix(pods, s).to(_F32)
    # per-(pod, selector) spread threshold: the tightest maxSkew of the
    # pod's constraints on that selector (+F32_MAX when unconstrained)
    sel = torch.clamp(pods.spread_sel, 0, max(s - 1, 0)).long()
    thresh = torch.full((p, s), F32_MAX, dtype=_F32, device=dev).scatter_reduce(
        1, sel,
        torch.where(pods.spread_sel >= 0, pods.spread_max.to(_F32), F32_MAX),
        "amin",
    )
    aff_pod = torch.cat([a_hot.T, t_hot.T, matches.T, thresh.T], dim=0)
    present = (snapshot.domain_counts > 0).to(_F32).T
    avoid_present = (snapshot.avoid_counts > 0).to(_F32).T
    dmin = local_spread_dmin(snapshot)
    cnt_plus = (snapshot.domain_counts + 1.0 - dmin[None, :]).T
    aff_node = torch.cat([present, avoid_present, cnt_plus], dim=0)
    valid = ~(
        (pods.affinity_sel >= s).any(-1)
        | (pods.anti_affinity_sel >= s).any(-1)
        | (pods.spread_sel >= s).any(-1)
    )
    return aff_pod.contiguous(), aff_node.contiguous(), valid


def fused_score_operands(
    snapshot: SnapshotArrays,
    pods: PodBatch,
    *,
    include_pod_affinity: bool = True,
    layout: FusedLayout | None = None,
) -> dict:
    """Keyword arguments of ops.fused.fused_masked_score for one window:
    the utilization vectors, resources, pod mask, nodeName pins, and the
    `other` mask (other_fit, plain PyTorch, as in the reference). With a
    resident `layout` the node operands (u, v, node_mask, alloc, reqd)
    are the layout's and utilization_stats is skipped; the selector
    operands, `other` and the pod side still come from the snapshot. With
    include_pod_affinity (affinity_aware=False) the count-based selector
    families are evaluated against pre-window counts: on a selector axis
    of up to MAX_FUSED_SELECTORS K1 folds their selector rows and the pod
    mask carries selector validity; on a wider axis they join `other`
    (count_families_fit) and K1 gets no selector rows. Without it
    (affinity_aware=True) K1 gets no selector rows: the assigners enforce
    those families against live counts."""
    if layout is None:
        stats = utilization_stats(snapshot.disk_io, snapshot.cpu_pct, snapshot.node_mask)
        layout = FusedLayout(
            u=stats.u, v=stats.v, node_mask=snapshot.node_mask,
            alloc=snapshot.allocatable, reqd=snapshot.requested,
        )
    fold = (
        include_pod_affinity
        and snapshot.domain_counts.shape[1] <= MAX_FUSED_SELECTORS
    )
    aff_pod = aff_node = None
    pod_ok = pods.pod_mask
    if fold:
        aff_pod, aff_node, valid = _fused_affinity_operands(snapshot, pods)
        pod_ok = pod_ok & valid
    other = other_fit(snapshot, pods)
    if include_pod_affinity and not fold:
        other = other & count_families_fit(snapshot, pods)
    return dict(
        u=layout.u, v=layout.v, node_mask=layout.node_mask,
        alloc=layout.alloc, reqd=layout.reqd,
        r_cpu=pods.request[:, 0], r_io=pods.r_io, pod_request=pods.request,
        pod_mask=pod_ok, target_node=pods.target_node,
        other=other.to(_F32),
        aff_pod=aff_pod, aff_node=aff_node,
    )


def _fused_masked_scores(
    snapshot: SnapshotArrays,
    pods: PodBatch,
    *,
    include_pod_affinity: bool,
    normalizer: str = "none",
    layout: FusedLayout | None = None,
    _plain: bool = False,
) -> torch.Tensor:
    """[p, n] score where feasible, NEG elsewhere, through K2 and K1 (the
    score, resource fit, nodeName pin, the selector families when they
    fold, and the `other` mask in one kernel pass); the node operands from
    `layout` when one is given."""
    ops = fused_score_operands(
        snapshot, pods, include_pod_affinity=include_pod_affinity, layout=layout
    )
    return fused_masked_score(**ops, normalizer=normalizer, _plain=_plain)


def make_affinity_state(snapshot: SnapshotArrays, pods: PodBatch) -> AffinityState:
    """Live inter-pod (anti)affinity state for the assigners: base domain
    match and avoider counts from the snapshot plus the pod-side selector
    structure, selector dimensions aligned."""
    s = snapshot.domain_counts.shape[1]
    return AffinityState(
        domain_counts=snapshot.domain_counts,
        domain_id=snapshot.domain_id,
        pod_matches=match_matrix(pods, s),
        affinity_sel=pods.affinity_sel,
        anti_affinity_sel=pods.anti_affinity_sel,
        avoid_counts=snapshot.avoid_counts,
        pod_has_anti=pod_has_anti_onehot(pods.anti_affinity_sel, s),
        spread_sel=pods.spread_sel,
        spread_max=pods.spread_max,
        node_mask=snapshot.node_mask,
    )


# ---- the cycle ------------------------------------------------------------


def finish_cycle(
    snapshot: SnapshotArrays,
    pods: PodBatch,
    raw: torch.Tensor,
    norm: torch.Tensor,
    feasible: torch.Tensor,
    *,
    assigner: str = "greedy",
    affinity_aware: bool = True,
    soft: bool = False,
    auction_rounds: int = 1024,
    auction_price_frac: float = 1.0,
    _plain: bool = False,
) -> ScheduleResult:
    """Cycle tail: the soft score terms (soft=True) added to the
    normalized score (on the fused path NEG cells stay about NEG), greedy
    or auction assignment (with live in-window affinity when
    affinity_aware), then the all-or-nothing gang pass."""
    if soft:
        norm = norm + compute_soft_scores(snapshot, pods)
    free = compute_free_capacity(snapshot)
    affinity = make_affinity_state(snapshot, pods) if affinity_aware else None
    if assigner == "greedy":
        res: AssignResult = greedy_assign(
            norm, feasible, pods.request, free, pods.priority, pods.pod_mask,
            affinity=affinity, _plain=_plain,
        )
    else:
        res = auction_assign(
            norm, feasible, pods.request, free, pods.priority, pods.pod_mask,
            rounds=auction_rounds, price_frac=auction_price_frac,
            affinity=affinity, _plain=_plain,
        )
    node_idx, free_after, n_assigned = gang_mask_assign(
        pods.gang_id, pods.gang_size, pods.pod_mask,
        res.node_idx, pods.request, res.free_after, res.n_assigned,
    )
    return ScheduleResult(
        node_idx=node_idx,
        scores=norm,
        raw_scores=raw,
        feasible=feasible,
        free_after=free_after,
        n_assigned=n_assigned,
    )


def schedule_batch(
    snapshot: SnapshotArrays,
    pods: PodBatch,
    *,
    policy: str = "balanced_cpu_diskio",
    assigner: str = "greedy",
    normalizer: str = "min_max",
    fused: bool = False,
    affinity_aware: bool = True,
    soft: bool = False,
    auction_rounds: int = 1024,
    auction_price_frac: float = 1.0,
    score_plugins: tuple | None = None,
    layout=None,
    _plain: bool = False,
) -> ScheduleResult:
    """One scheduling cycle for the whole pending window, on the device
    the tensors live on (reference: engine.schedule_batch; the defaults
    are the reference's).

    fused=True: K2 and K1 build the masked score matrix (policy
    balanced_cpu_diskio, normalizer "none" or "min_max", else ValueError);
    as in the reference's fused replies, `scores` and `raw_scores` are
    that masked matrix. fused=False: compute_scores, compute_feasibility
    and normalize_scores in plain PyTorch, for any policy and normalizer.
    score_plugins=((policy, weight), ...): combine_scores replaces
    `policy`, which is then ignored with `normalizer`; it needs
    fused=False (ValueError otherwise). soft=True adds
    compute_soft_scores to the normalized score. The greedy scan runs K4
    and the auction's rounds run K3 when affinity_aware=False; with
    affinity_aware=True the count-based selector families leave the
    static mask and the assigner enforces them against live in-window
    counts (plain PyTorch, as the reference's XLA bodies). `layout`: a
    resident FusedLayout (TorchEngine.schedule_resident), whose node
    operands K2 and K1 take; consulted on the fused path only.

    `_plain=True` runs every kernel's plain PyTorch version instead, on
    any device, to hold the kernel path against it."""
    if assigner not in ASSIGNERS:
        raise ValueError(f"assigner must be one of {ASSIGNERS}, not {assigner!r}")
    include_pod_affinity = not affinity_aware
    if score_plugins:
        if fused:
            raise ValueError(
                "score_plugins is incompatible with fused=True (the fused "
                "kernel computes the single yoda formula)"
            )
        raw = norm = combine_scores(snapshot, pods, score_plugins)
        feasible = compute_feasibility(
            snapshot, pods, include_pod_affinity=include_pod_affinity
        )
    elif fused:
        check_fused_contract(policy, normalizer)
        raw = norm = _fused_masked_scores(
            snapshot, pods, include_pod_affinity=include_pod_affinity,
            normalizer=normalizer, layout=layout, _plain=_plain,
        )
        feasible = raw > NEG * 0.5
    else:
        raw = compute_scores(snapshot, pods, policy)
        feasible = compute_feasibility(
            snapshot, pods, include_pod_affinity=include_pod_affinity
        )
        norm = normalize_scores(raw, snapshot.node_mask, normalizer)
    return finish_cycle(
        snapshot, pods, raw, norm, feasible,
        assigner=assigner, affinity_aware=affinity_aware, soft=soft,
        auction_rounds=auction_rounds, auction_price_frac=auction_price_frac,
        _plain=_plain,
    )


def schedule_batch_fleet(
    snapshot: SnapshotArrays, requests: tuple, **options
) -> tuple:
    """N independent cycles on one shared base snapshot (reference:
    engine.schedule_batch_fleet, behind the host's shared engine pool):
    `requests` holds (delta | None, pods) pairs, and each element is
    scheduled by schedule_batch(**options) against the base with its own
    delta folded in OUT OF PLACE: the leaves a delta writes are cloned
    first, so the base is never touched and every element sees exactly
    the state its own engine would have held. The reference folds each
    delta in fixed-size chunks (_delta_row_chunks,
    _apply_delta_rows_chunked) only so that XLA compiles one scatter
    shape; that fold is a bitwise twin of the unchunked one, and PyTorch
    compiles nothing, so here it is the one fold of apply_snapshot_delta.
    No layout is used: each element's delta would invalidate it."""
    out = []
    n = snapshot.node_mask.shape[0]
    written = ("requested", *UTIL_SERIES, *DOMAIN_TABLES, "node_mask")
    for delta, pods in requests:
        snap = snapshot
        if delta is not None:
            snap = snapshot._replace(**{f: getattr(snapshot, f).clone() for f in written})
            _apply_delta_rows(snap, _upload_delta(delta, n, snapshot.node_mask.device))
        out.append(schedule_batch(snap, pods, **options))
    return tuple(out)


def stack_windows(pods: PodBatch, window: int) -> PodBatch:
    """Reshape a [P, ...] PodBatch into [P // window, window, ...] for
    schedule_windows; P must be a multiple of `window` (pad first with
    utils.padding.pad_pod_batch). numpy leaves stay numpy."""
    p = pods.request.shape[0]
    if p % window:
        raise ValueError(f"pod count {p} not a multiple of window {window}")
    return PodBatch(
        *[f.reshape((p // window, window) + tuple(f.shape[1:])) for f in pods]
    )


def fold_window_counts(snapshot, pods, node_idx, domain_counts, avoid_counts):
    """Fold one window's placements into the per-node replicated domain
    match and avoider counts, so the next window's selector families see
    them: increments scatter onto each domain's representative row
    (domain_id) and gather back to every member node."""
    found = node_idx >= 0
    s = domain_counts.shape[1]
    n = snapshot.domain_id.shape[0]
    cols = torch.arange(s, device=node_idx.device)[None, :]
    dom = snapshot.domain_id[torch.clamp(node_idx, 0, n - 1).long()].long()  # [p, S]
    dom_all = snapshot.domain_id.long()

    def fold(counts, per_pod):
        inc = torch.where(found[:, None], per_pod.to(counts.dtype), 0.0)
        added = torch.zeros_like(counts).index_put_(
            (dom, cols.expand_as(dom)), inc, accumulate=True
        )
        return counts + added[dom_all, cols]

    return (
        fold(domain_counts, match_matrix(pods, s)),
        fold(avoid_counts, pod_has_anti_onehot(pods.anti_affinity_sel, s)),
    )


def run_windows_scan(snapshot, pods_windows, cycle_fn) -> WindowsResult:
    """The capacity- and domain-count-carrying loop over stacked windows
    (reference: engine.run_windows_scan's lax.scan): each window is
    scheduled against the requested capacity and counts the previous
    windows left behind."""
    requested = snapshot.requested
    domain_counts, avoid_counts = snapshot.domain_counts, snapshot.avoid_counts
    node_idx, counts = [], []
    for w in range(pods_windows.request.shape[0]):
        window = PodBatch(*[f[w] for f in pods_windows])
        snap = snapshot._replace(
            requested=requested, domain_counts=domain_counts,
            avoid_counts=avoid_counts,
        )
        res = cycle_fn(snap, window)
        domain_counts, avoid_counts = fold_window_counts(
            snapshot, window, res.node_idx, domain_counts, avoid_counts
        )
        requested = snapshot.allocatable - res.free_after
        node_idx.append(res.node_idx)
        counts.append(res.n_assigned)
    return WindowsResult(
        node_idx=torch.stack(node_idx),
        free_after=snapshot.allocatable - requested,
        n_assigned=torch.stack(counts).sum().to(_I32),
    )


def schedule_windows(
    snapshot: SnapshotArrays,
    pods_windows: PodBatch,
    *,
    policy: str = "balanced_cpu_diskio",
    assigner: str = "auction",
    normalizer: str = "none",
    fused: bool = False,
    affinity_aware: bool = True,
    soft: bool = False,
    auction_rounds: int = 1024,
    auction_price_frac: float = 1.0,
    score_plugins: tuple | None = None,
    layout=None,
    _plain: bool = False,
) -> WindowsResult:
    """Schedule a backlog of windows in one call (reference:
    engine.schedule_windows): a loop over the leading window axis of
    `pods_windows` (see stack_windows), carrying node capacity and
    domain counts between windows. Options are schedule_batch's.

    layout (fused=True only, else ValueError): a resident FusedLayout.
    Utilization and allocatable do not change within a backlog, so every
    window reuses its u, v, node_mask and alloc, and takes reqd from the
    carried `requested` (the reference rebuilds reqd_t with
    prep_requested); the layout itself is never written."""
    if layout is not None and not fused:
        raise ValueError("layout requires fused=True (the kernels' resident node operands)")

    def cycle(snap, window):
        return schedule_batch(
            snap, window, policy=policy, assigner=assigner,
            normalizer=normalizer, fused=fused, affinity_aware=affinity_aware,
            soft=soft, auction_rounds=auction_rounds,
            auction_price_frac=auction_price_frac,
            score_plugins=score_plugins,
            layout=None if layout is None else layout._replace(reqd=snap.requested),
            _plain=_plain,
        )

    return run_windows_scan(snapshot, pods_windows, cycle)


VICTIM_DTYPES = {
    "node": _I32, "prio": _I32, "req": _F32, "mask": _BOOL, "start": _I32,
    "matches": _BOOL, "anti": _BOOL,
}


def victims_on(victims, device: torch.device):
    """An ops.preempt.VictimArrays (of any NamedTuple type with its
    fields; numpy or tensor leaves) with every leaf on `device` in its
    dtype; host leaves upload through device.to_device. None leaves stay
    None."""
    from kubernetes_scheduler_tpu_torch.ops.preempt import VictimArrays

    return VictimArrays(**{
        name: None if x is None else as_leaf(x, VICTIM_DTYPES[name], device)
        for name, x in zip(VictimArrays._fields, victims)
    })


def preempt_batch(snapshot: SnapshotArrays, pods: PodBatch, victims, *, k_cap: int):
    """The preemption pass, upstream PostFilter parity (reference:
    engine.preempt_batch): static feasibility against FULL allocatable
    (could this pod ever fit here after evictions), per-node victim
    prefix tables, and the candidate choice in upstream's
    pickOneNodeForPreemption order (ops/preempt.py). `victims` is an
    ops.preempt.VictimArrays on the snapshot's device; the host sets
    non-evictable pods (budget-exhausted, terminating, nomination
    reservations) to node -1. Plain PyTorch; no host sync."""
    from kubernetes_scheduler_tpu_torch.ops.preempt import (
        PreemptAffinity,
        build_victim_tables,
        preempt_candidates,
    )

    # node-local families only: the count-based ones are evaluated per
    # (pod, node, k) against the counts as adjusted by the candidate
    # evictions (ops/preempt.affinity_after_evictions)
    static_ok = compute_feasibility(
        snapshot._replace(requested=torch.zeros_like(snapshot.requested)),
        pods,
        include_pod_affinity=False,
    )
    s = snapshot.domain_counts.shape[1]
    m = victims.req.shape[0]
    dev = snapshot.allocatable.device
    matches = victims.matches if victims.matches is not None else torch.zeros(
        (m, s), dtype=torch.bool, device=dev)
    anti = victims.anti if victims.anti is not None else torch.zeros(
        (m, s), dtype=torch.bool, device=dev)
    tables = build_victim_tables(
        victims.node, victims.prio, victims.req, victims.mask,
        n_nodes=snapshot.allocatable.shape[0], k_cap=k_cap,
        victim_start=victims.start, victim_matches=matches, victim_anti=anti,
    )
    affinity = PreemptAffinity(
        domain_counts=snapshot.domain_counts,
        avoid_counts=snapshot.avoid_counts,
        domain_id=snapshot.domain_id,
        node_mask=snapshot.node_mask,
        affinity_sel=pods.affinity_sel,
        anti_affinity_sel=pods.anti_affinity_sel,
        pod_matches=pods.pod_matches,
        spread_sel=pods.spread_sel,
        spread_max=pods.spread_max,
    )
    return preempt_candidates(
        pods.request, pods.priority, pods.pod_mask, static_ok,
        compute_free_capacity(snapshot), tables, affinity=affinity,
    )


def preempt_on_host(snapshot, pods, victims, *, k_cap: int):
    """The in-host preemption pass (the host loop's fallback when the
    engine's preempt is missing or fails, reference: the host's CPU jax
    call of engine.preempt_batch): preempt_batch on CPU tensors of the
    same inputs."""
    cpu = torch.device("cpu")
    snap = SnapshotArrays(*[
        as_leaf(x, SNAPSHOT_DTYPES[f], cpu) for f, x in zip(SnapshotArrays._fields, snapshot)
    ])
    batch = PodBatch(*[as_leaf(x, POD_DTYPES[f], cpu) for f, x in zip(PodBatch._fields, pods)])
    return preempt_batch(snap, batch, victims_on(victims, cpu), k_cap=k_cap)


class ResidentMismatch(RuntimeError):
    """A SnapshotDelta arrived for resident state this engine does not
    hold (wrong epoch, shape or layout churn, or no state at all); the
    caller must re-upload in full (reference: engine.ResidentMismatch)."""


class ResidentState:
    """Device-owned steady-state cluster arrays (reference:
    engine.ResidentState): the retained snapshot plus the epoch the host
    tags its deltas with, and the kernel layout, built on the first fused
    dispatch and then folded in lockstep. The leaves are PRIVATE tensors
    (never the caller's, never the uniform-constant cache's), because
    the delta folds write them in place."""

    __slots__ = ("snapshot", "epoch", "layout")

    def __init__(self, snapshot: SnapshotArrays, epoch: int):
        self.snapshot = snapshot
        self.epoch = epoch
        self.layout: FusedLayout | None = None

    def accepts(self, delta: SnapshotDelta, epoch: int) -> bool:
        """Is `delta` (tagged to produce `epoch`) applicable? The epoch
        must be the immediate successor and the delta's node, resource and
        selector axes those of the retained state; anything else is churn
        that needs a full upload."""
        snap = self.snapshot
        return (
            epoch == self.epoch + 1
            and tuple(np.shape(delta.node_mask)) == tuple(snap.node_mask.shape)
            and tuple(np.shape(delta.req_vals)[1:]) == tuple(snap.requested.shape[1:])
            and np.shape(delta.dom_vals)[1] == snap.domain_counts.shape[1]
        )


def _bits(a: np.ndarray) -> np.ndarray:
    """The flat bit patterns of a numpy array (unsigned ints of its item
    size), so that compares are bitwise: -0.0 differs from 0.0, a NaN
    equals the same NaN."""
    return np.ascontiguousarray(a).reshape(-1).view(f"u{a.itemsize}")


class _UniformDeviceCache:
    """Device tensors for host leaves that do not need another upload
    (reference: engine._UniformDeviceCache). Most leaves of a host-built
    window are uniform defaults (-1 selector pads, zero tolerations,
    False masks) and many node-side leaves repeat cycle after cycle
    (allocatable, labels): a uniform leaf maps to one memoised tensor per
    (field, shape, dtype, value), and a leaf bitwise equal to the last
    one seen for its field reuses that upload. The cache keeps its own
    host copy for the compare. Tensors pass through as_leaf. The tensors
    it hands out are shared: nothing may write them."""

    MAX_ENTRIES = 256

    def __init__(self, device: torch.device):
        self.device = device
        self._cache: dict = {}
        # field name -> (shape, host bits, device tensor) of the last
        # non-uniform leaf
        self._last: dict = {}

    def swap(self, nt):
        """`nt` (a SnapshotArrays or PodBatch of any NamedTuple type with
        those fields) as the port's type, every leaf on the device in the
        dtype make_snapshot / make_pod_batch fix."""
        kind, dtypes = (
            (SnapshotArrays, SNAPSHOT_DTYPES) if nt._fields == SnapshotArrays._fields
            else (PodBatch, POD_DTYPES)
        )
        out = []
        for name, arr in zip(nt._fields, nt):
            dtype = dtypes[name]
            if isinstance(arr, torch.Tensor):
                out.append(as_leaf(arr, dtype, self.device))
                continue
            # graftlint: disable=host-sync -- leaves here are host numpy (tensors taken above); no device sync
            a = np.asarray(arr, dtype=_NP_DTYPES[dtype])
            bits = _bits(a)
            if a.size and (bits == bits[0]).all():
                key = (name, a.shape, a.dtype.str, int(bits[0]))
                dev = self._cache.get(key)
                if dev is None:
                    if len(self._cache) >= self.MAX_ENTRIES:
                        self._cache.clear()
                    dev = self._cache[key] = to_device(a, self.device)
                out.append(dev)
                continue
            prev = self._last.get(name)
            if prev is not None and prev[0] == a.shape and np.array_equal(prev[1], bits):
                out.append(prev[2])
                continue
            dev = to_device(a, self.device)
            self._last[name] = (a.shape, bits.copy(), dev)
            out.append(dev)
        return kind(*out)


class PendingSchedule:
    """Handle of a dispatched cycle (reference: engine.PendingSchedule),
    the pipelined host loop's async surface: the result's tensors, and a
    CUDA event recorded on the stream after the dispatch, so the host can
    do the next cycle's work before it waits. `result()` waits on the
    event (no wait on the CPU, where the work is done when the call
    returns). The auction's host loop reads its any-bid flag every
    CHECK_EVERY rounds, so its dispatch itself waits on the card then."""

    __slots__ = ("_result", "_event")

    def __init__(self, result, event: torch.cuda.Event | None = None):
        self._result = result
        self._event = event

    def result(self):
        if self._event is not None:
            # graftlint: disable=host-sync -- the pipelined cycle's one wait on its dispatch: result() is where the host loop hands the cycle back, by contract
            self._event.synchronize()
        return self._result


class TorchEngine:
    """In-process engine with LocalEngine's call surface, on one device
    (default cuda; raises without CUDA unless device="cpu" is passed):
    schedule_batch / schedule_windows / their async twins, and resident
    cluster state with delta uploads (schedule_resident,
    schedule_windows_resident, schedule_batch_fleet). Host leaves reach
    the device through a uniform-constant cache, in the dtypes
    make_snapshot / make_pod_batch fix; tensors already on the device
    pass as they are."""

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self._consts = _UniformDeviceCache(self.device)
        # retained cluster state; None until the first full resident upload
        self._resident: ResidentState | None = None
        # did the LAST resident call fold a delta (True) or upload in full?
        self.resident_used_delta = False
        # the host's trace id for the next call, and the outstanding
        # profile arm (the next N calls under torch.profiler)
        self._trace_id = 0
        self._profile_left = 0
        self._profile_dir: str | None = None
        # calls of preempt() (the host loop's preemption pass on this
        # engine, against its in-host fallback)
        self.preempt_calls = 0

    # ---- telemetry context --------------------------------------------

    def set_trace_id(self, trace_id: int, seq: int = -1) -> None:
        """Span context for the NEXT call (the host cycle's trace id); it
        names on-demand profile dumps."""
        self._trace_id = int(trace_id)

    def arm_profile(self, cycles: int, out_dir: str | None = None) -> dict:
        """Profile the next `cycles` calls under torch.profiler, each into
        <out_dir>/step-<trace_id> (host.observe.profile_device_step)."""
        if out_dir is None:
            out_dir = tempfile.mkdtemp(prefix="yoda-profile-")
        self._profile_dir = out_dir
        self._profile_left = int(cycles)
        return {"armed": self._profile_left, "out_dir": out_dir}

    def _maybe_profile(self, call):
        if self._profile_left <= 0:
            return call()
        from kubernetes_scheduler_tpu_torch.host.observe import profile_device_step

        self._profile_left -= 1
        tag = "step-%08d" % self._trace_id if self._trace_id else "step-unlabeled"
        return profile_device_step(call, os.path.join(self._profile_dir, tag))

    def _pending(self, result) -> PendingSchedule:
        if self.device.type != "cuda":
            return PendingSchedule(result)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.device))
        return PendingSchedule(result, event)

    # ---- stateless calls -------------------------------------------------

    def schedule_batch(self, snapshot, pods, **kw) -> ScheduleResult:
        return self._maybe_profile(
            lambda: schedule_batch(self._consts.swap(snapshot), self._consts.swap(pods), **kw)
        )

    def schedule_batch_async(self, snapshot, pods, **kw) -> PendingSchedule:
        """schedule_batch, returning once the cycle is enqueued."""
        return self._pending(self.schedule_batch(snapshot, pods, **kw))

    def schedule_windows(self, snapshot, pods_windows, **kw) -> WindowsResult:
        return self._maybe_profile(
            lambda: schedule_windows(
                self._consts.swap(snapshot), self._consts.swap(pods_windows), **kw
            )
        )

    # ---- resident cluster state (delta uploads) -----------------------

    def supports_resident(self) -> bool:
        return True

    def supports_windows_resident(self) -> bool:
        return True

    def invalidate_resident(self) -> None:
        """Drop the retained state; the next resident call uploads in full."""
        self._resident = None

    def _private_snapshot(self, snapshot) -> SnapshotArrays:
        """`snapshot` on the device in tensors of its own: a leaf that as_leaf
        would hand back as it is (the caller's tensor) is cloned."""
        leaves = {}
        for name, x in zip(SnapshotArrays._fields, snapshot):
            t = as_leaf(x, SNAPSHOT_DTYPES[name], self.device)
            if isinstance(x, torch.Tensor) and t.data_ptr() == x.data_ptr():
                t = t.clone()
            leaves[name] = t
        return SnapshotArrays(**leaves)

    def _resident_dispatch(self, snapshot, delta, epoch: int, kw: dict):
        """The front half shared by every resident call: fold an
        applicable delta into the retained snapshot and layout (one
        upload of its rows), else upload `snapshot` in full into private
        tensors; on the fused path inject the layout, built on first need.
        Returns (state, kw)."""
        st = self._resident
        if delta is not None and st is not None and st.accepts(delta, epoch):
            dd = _upload_delta(delta, st.snapshot.node_mask.shape[0], self.device)
            _apply_delta_rows(st.snapshot, dd)
            if st.layout is not None:
                _apply_layout_rows(st.layout, dd)
            st.epoch = epoch
            self.resident_used_delta = True
        else:
            self._resident = st = ResidentState(self._private_snapshot(snapshot), epoch)
            self.resident_used_delta = False
        if kw.get("fused"):
            if st.layout is None:
                st.layout = build_fused_layout(st.snapshot)
            kw = dict(kw, layout=st.layout)
        return st, kw

    def schedule_resident(self, snapshot, pods, *, delta=None, epoch=0, **kw) -> ScheduleResult:
        """schedule_batch against the retained state. `snapshot` is always
        the host's full build, the fallback payload; an applicable `delta`
        (tagged with the retained epoch's successor, same axes) folds in
        instead, so only its rows cross to the device. Any mismatch
        degrades to a full upload; `resident_used_delta` says which ran."""
        st, kw = self._resident_dispatch(snapshot, delta, epoch, kw)
        return self._maybe_profile(
            lambda: schedule_batch(st.snapshot, self._consts.swap(pods), **kw)
        )

    def schedule_resident_async(
        self, snapshot, pods, *, delta=None, epoch=0, **kw
    ) -> PendingSchedule:
        return self._pending(
            self.schedule_resident(snapshot, pods, delta=delta, epoch=epoch, **kw)
        )

    def schedule_windows_resident(
        self, snapshot, pods_windows, *, delta=None, epoch=0, **kw
    ) -> WindowsResult:
        """schedule_windows against the retained state, on the same epoch
        sequence as schedule_resident. The backlog's capacity and count
        carries stay inside the call: the retained state remains the
        pre-backlog snapshot, as the host's delta accounting assumes."""
        st, kw = self._resident_dispatch(snapshot, delta, epoch, kw)
        return self._maybe_profile(
            lambda: schedule_windows(st.snapshot, self._consts.swap(pods_windows), **kw)
        )

    def schedule_batch_fleet(self, snapshot, requests, *, delta=None, epoch=None, **kw) -> tuple:
        """Coalesced fleet dispatch: every (delta | None, pods) request
        against the shared base (see the free schedule_batch_fleet). With
        `epoch` the base rides the resident front half (a delta folds
        into the retained state, a mismatch uploads in full); with
        epoch=None the uploaded `snapshot` is not retained. The retained
        layout is never used: the elements' deltas would invalidate it."""
        if epoch is None:
            snap = self._consts.swap(snapshot)
        else:
            st, kw = self._resident_dispatch(snapshot, delta, epoch, kw)
            snap = st.snapshot
        kw.pop("layout", None)
        reqs = tuple((d, self._consts.swap(p)) for d, p in requests)
        return self._maybe_profile(lambda: schedule_batch_fleet(snap, reqs, **kw))

    # ---- capabilities ----------------------------------------------------

    def supports_fused_min_max(self) -> bool:
        """K1 runs the min-max epilogue with K2's bounds on every device."""
        return True

    def supports_gangs(self) -> bool:
        return True

    def preempt(self, snapshot, pods, victims, *, k_cap: int):
        """preempt_batch on this engine's device: host leaves of the
        snapshot, the preemptors' batch and the victims upload through
        the uniform cache and device.to_device. Counted in
        `preempt_calls`."""
        self.preempt_calls += 1
        return preempt_batch(
            self._consts.swap(snapshot), self._consts.swap(pods),
            victims_on(victims, self.device), k_cap=k_cap,
        )

    def healthy(self) -> bool:
        return True

    def close(self) -> None:
        """Release the retained state and the cached device tensors."""
        self._resident = None
        self._consts = _UniformDeviceCache(self.device)
