#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (kubernetes_scheduler_tpu_torch) on
one CUDA card:  python3 chip_smoke.py

Phases; the first failure exits non-zero and no result line is printed:

1. device: the card's name, and its name and power limit from nvidia-smi;
2. build: compile csrc/fused.cu with nvcc (first use) and load it;
3. kernels: each hand-written kernel (K1 masked_score, K2 row_stats,
   K3 auction_bid, K4 greedy_scan) against its plain PyTorch version on
   the card, at the main path's shapes (1,024 pods x 10,000 nodes x 3
   resources of the gpu-10kx10k config), bitwise (NaN where the plain
   version has NaN); K1 also at S=8 and S=32 selectors, n = 9,999
   (scalar loads), p = 1,000 (not a multiple of the pod group), every pod
   pinned, without `other`, on NaN bounds, and at r = 4 (the fourth
   resource unrequested: equal to r = 3) and r = 7; K2 also at
   n = 9,999, p = 1,000, with no node-masked node, with NaN in u on
   node-masked nodes (every row NaN) and on a masked-out node (no
   change); K3 also on planted ties and on a late round (~5% of pods
   active, nonzero prices, the capacity left after a first round); K4
   also on contended capacity, planted ties, all-NEG rows with zero
   requests on oversubscribed resources and r = 7, one-entry candidate
   lists, lists that run out at a tie boundary, a negative request that trips its exactness guard, and
   NaN cells (in several rows, beside +inf, without capacity, and at a
   one-entry list's boundary: a NaN qualifies and ranks above every
   number, the first NaN first), each
   line with the pods that took K4's row-scan fallback; K3 and K4 also at
   an odd width (n % 4 != 0: scalar loads); kernel times are device time
   per launch behind a held stream, plain versions' times CUDA events
   around one call, median of 25 (5 for K4's plain version); the launch
   floor is a one-element add_ timed the same way;
4. the auction slice through TorchEngine(): schedule_batch on one
   1,024-pod window and schedule_windows on the 8 x 1,024-pod backlog
   (the first main path; K1-K3's launch counts are read from this run),
   each equal to the same call on the plain versions; one cycle and one
   backlog under torch.profiler;
5. the greedy backlog (8 x 1,024 pods, affinity_aware=False: the second
   main path, K4's launch count is read from it) equal to its plain run,
   with K4 launched once per window, and under torch.profiler;
6. the affinity paths on constraints-5kx5k (5,000 pods padded to
   5 x 1,024, 8 selectors, affinity_aware=True) for greedy and for the
   auction, each equal to its plain run and breaking no hard affinity,
   anti-affinity or reverse-avoider constraint in its final placements;
   then both greedy scans on one window under torch's sync debug mode,
   which must see no host read;
7. small clusters scheduled on the card must equal the port's CPU path
   (which the tests hold against the JAX reference), for the auction,
   greedy, and both assigners with affinity, and greedy on fault C1's
   cluster (NaN scores, all 24 pods placed); then one window with each
   option of the scoring surface (every policy x normalizer on both
   assigners, score_plugins, soft on both paths, 40 selectors): masks
   equal, scores within score_tolerance (the CPU tests' bound), decisions
   equal or a near-tie greedy flip;
8. the weighted multi-scorer backlog (the reference bench's production
   score, 10,000 nodes with images, 8 x 1,024 pods, score_plugins, the
   composed path): the bench's own call (auction, affinity_aware=True),
   then affinity_aware=False on the auction (K3 every round) and greedy
   (K4 once a window), each equal to its plain run and placing at least
   half the backlog; the first under torch.profiler;
9. every policy with min-max on the auction, and softmax and no
   normalizer on balanced_cpu_diskio and least_allocated on both
   assigners, one gpu-10kx10k window each (affinity_aware=False), each
   equal to its plain run, scores and masks included;
10. soft=True on constraints-5kx5k with soft_terms(seed 0) (kernel path,
   affinity_aware=True, both assigners), each equal to its plain run,
   with no hard-constraint break and some pods placed elsewhere than with
   soft=False; the soft term's device time on one window;
11. 40 selectors (above the kernel's 32) on 5,000 nodes, both assigners,
   affinity_aware False and True, each equal to its plain run, no
   hard-constraint break with affinity_aware=True;
12. resident cluster state at gpu-10kx10k (run_resident): a full upload
   and 8 delta cycles of one 1,024-pod window each, on the auction and
   on greedy, every cycle bitwise a full upload's, the retained snapshot
   and layout bitwise a fresh build's, the delta fold free of host reads,
   host-to-device bytes (equal to the profiler's on a delta cycle) and
   wall ms per delta and per full-upload cycle (a warm engine uploading in
   full); epoch-gap and invalidate flushes, the resident backlog and a
   fleet dispatch, each equal to its non-resident call; K1-K4 launches
   counted per delta cycle, backlog and fleet call;
13. the kernels line, then the result line.

Phases 7-12 print their seconds. Timed runs are medians of 3; equality
runs are one each (phase 11 reports its one run's time).

Needs torch with CUDA, and nothing of JAX.

    python3 chip_smoke.py --parent-tree DIR

also builds the csrc/fused.cu of DIR, a checkout of an earlier commit
whose K1, K2 and K4 have this tree's C interfaces (e09185f or later),
with the same flags into DIR, and times its K1, K2 and K4 beside this
tree's on every K1, K2 and K4 case of phase 3, in turns (parent, this
tree, this tree, parent): `parent_ms`. Each line says whether the parent
equalled the plain version (`parent_bitwise`; e09185f's K2 drops a NaN,
and up to commit 86ed4fd K4 never takes a NaN cell).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

# H100 SXM published peaks (NVIDIA data sheet, dense, at the 700 W limit).
# The data sheet's 67 TFLOP/s of float32 counts an FMA as two operations;
# the kernels round every product and sum on its own (no contraction, to
# stay bitwise), so their float32 operations issue at half that rate.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_NONFMA_OPS_PER_S = 33.5e12
WINDOW = 1024
N_WINDOWS = 8
TIMED_LAUNCHES = 25
SLEEP_CYCLES_PER_S = 2.0e9   # torch.cuda._sleep's unit: SM clock cycles
# float32 ulps by which two evaluations of one short score expression may
# differ (score_tolerance); the CPU tests hold the port to the reference
# with the same bound
SCORE_ULPS = 8
SLICE_KW = dict(
    assigner="auction", normalizer="min_max", fused=True, affinity_aware=False
)
GREEDY_KW = dict(SLICE_KW, assigner="greedy")
AFFINITY_KW = {
    "greedy": dict(SLICE_KW, assigner="greedy", affinity_aware=True),
    "auction": dict(SLICE_KW, affinity_aware=True),
}
AFFINITY_WINDOWS = 5   # constraints-5kx5k: 5,000 pods padded to 5 x 1,024
# the reference bench's production score (bench.py's weighted
# multi-scorer row): yoda at weight 2 beside the k8s 1.22 default scorers
MULTI_SCORER = (
    ("balanced_cpu_diskio", 2.0), ("least_allocated", 1.0),
    ("balanced_allocation", 1.0), ("image_locality", 1.0),
)
MULTI_KW = {
    "auction_affinity": dict(assigner="auction", fused=False, affinity_aware=True,
                             score_plugins=MULTI_SCORER),
    "auction": dict(assigner="auction", fused=False, affinity_aware=False,
                    score_plugins=MULTI_SCORER),
    "greedy": dict(assigner="greedy", fused=False, affinity_aware=False,
                   score_plugins=MULTI_SCORER),
}
REPLACES = {
    "masked_score": "kubernetes_scheduler_tpu/ops/pallas_fused.py:252",
    "row_stats": "kubernetes_scheduler_tpu/ops/pallas_fused.py:385",
    "auction_bid": "kubernetes_scheduler_tpu/ops/pallas_fused.py:581",
    "greedy_scan": "kubernetes_scheduler_tpu/ops/pallas_fused.py:476",
}
# each kernel's case on the main path, reported in the kernels line
MAIN_CASE = {
    "masked_score": "S=1 minmax=True",
    "row_stats": "gpu-10kx10k window",
    "auction_bid": "first round",
    "greedy_scan": "(a) main path",
}
# each kernel's device symbols, as the profiler names them
SYMBOLS = {
    "masked_score": ("masked_score_kernel",),
    "row_stats": ("row_stats_kernel",),
    "auction_bid": ("auction_bid_kernel",),
    "greedy_scan": ("greedy_lists_kernel", "greedy_pass_kernel"),
}
# the backlog whose run each kernel's launch count is read from
MAIN_PATH = {
    "masked_score": "auction", "row_stats": "auction", "auction_bid": "auction",
    "greedy_scan": "greedy",
}


def soft_terms(snapshot, pods, seed: int):
    """(snapshot, pods) of the port with seeded soft terms, integer weights
    1-100, on the tensors' device: a PreferNoSchedule taint on ~10% of the
    nodes (a third taint column, keys 0-3 and values 0-1 like the
    generator's hard taints); 1-2 preferred node-affinity terms on ~30% of
    the pods (up to three expressions, keys 0-7 and values 0-3 like the
    generator's labels, mostly In, some terms an AND of two expressions);
    preferred pod affinity on ~20% and preferred anti-affinity on ~10%
    over the snapshot's selectors; one soft spread constraint on ~15%; a
    weight on ~3% of the pref_attract and of the pref_avoid cells."""
    from kubernetes_scheduler_tpu_torch.engine import POD_DTYPES, SNAPSHOT_DTYPES, as_leaf
    from kubernetes_scheduler_tpu_torch.ops.constraints import PREFER_NO_SCHEDULE

    rng = np.random.default_rng(seed)
    n, p = snapshot.allocatable.shape[0], pods.request.shape[0]
    s = snapshot.domain_counts.shape[1]
    dev = snapshot.allocatable.device
    weight = lambda *shape: rng.integers(1, 101, shape)  # noqa: E731

    def sel(share):
        return np.where(rng.random((p, 1)) < share, rng.integers(0, s, (p, 1)), -1)

    taint = np.stack([rng.integers(0, 4, n), rng.integers(0, 2, n),
                      np.full(n, PREFER_NO_SCHEDULE)], -1)[:, None, :]
    snap = dict(
        taints=np.concatenate([snapshot.taints.cpu().numpy(), taint], 1),
        taint_mask=np.concatenate([snapshot.taint_mask.cpu().numpy(),
                                   rng.random((n, 1)) < 0.1], 1),
        pref_attract=np.where(rng.random((n, s)) < 0.03, weight(n, s), 0),
        pref_avoid=np.where(rng.random((n, s)) < 0.03, weight(n, s), 0),
    )
    # expression 0 opens term 0; expression 1 joins it or opens term 1;
    # expression 2 joins expression 1's term
    has = rng.random(p) < 0.3
    second_term = rng.random(p) < 0.5
    mask = np.stack([has, has & (rng.random(p) < 0.6), has & (rng.random(p) < 0.3)], 1)
    term = np.stack([np.zeros(p, int), second_term.astype(int), second_term.astype(int)], 1)
    term_w = weight(p, 2)
    pod = dict(
        pna_key=rng.integers(0, 8, (p, 3)),
        pna_op=rng.choice([0, 0, 0, 1, 2, 3], (p, 3)),
        pna_vals=rng.integers(0, 4, (p, 3, 2)),
        pna_val_mask=np.ones((p, 3, 2), bool),
        pna_mask=mask, pna_term=term,
        pna_weight=np.take_along_axis(term_w, term, 1),
        pref_affinity_sel=sel(0.2), pref_affinity_weight=weight(p, 1),
        pref_anti_sel=sel(0.1), pref_anti_weight=weight(p, 1),
        soft_spread_sel=sel(0.15),
    )
    return (
        snapshot._replace(**{k: as_leaf(v, SNAPSHOT_DTYPES[k], dev) for k, v in snap.items()}),
        pods._replace(**{k: as_leaf(v, POD_DTYPES[k], dev) for k, v in pod.items()}),
    )


def _np(t) -> np.ndarray:
    """A tensor or array as a float64 numpy array on the host."""
    return np.asarray(t.cpu().numpy() if hasattr(t, "cpu") else t, dtype=np.float64)


def _ulp(x) -> float:
    """One float32 ulp at the largest |x|."""
    return float(np.spacing(np.float32(np.abs(_np(x)).max())))


def raw_score_tolerance(snap, pods, policy: str):
    """Bound on |a - b| between two float32 evaluations of
    engine.compute_scores(policy) that may round each operation
    differently (FMA contraction, another summation order, another exp):
    SCORE_ULPS ulp of the scores' scale over valid nodes. balanced_diskio
    rescales its statistic Mj inside the policy, so there an error of
    that size in Mj and in its row bounds becomes at most
    4 * SCORE_ULPS ulp(Mj) * 100 / (M_max - M_min), plus SCORE_ULPS ulp
    of 100. A float, or [p, 1] per row."""
    from kubernetes_scheduler_tpu_torch.engine import compute_scores
    from kubernetes_scheduler_tpu_torch.ops import score, stats

    valid = snap.node_mask.cpu().numpy()
    if policy == "balanced_diskio":
        st = stats.utilization_stats(snap.disk_io, snap.cpu_pct, snap.node_mask)
        m = score.balanced_diskio_m(st, snap.disk_io, pods.r_io)
        hi, lo = (_np(b) for b in score.balanced_diskio_local_bounds(m, snap.node_mask))
        span = np.where(hi != lo, hi - lo, 1.0)
        return (4 * SCORE_ULPS * _ulp(_np(m)[:, valid]) * 100.0 / span
                + SCORE_ULPS * _ulp(100.0))
    return SCORE_ULPS * _ulp(_np(compute_scores(snap, pods, policy))[:, valid])


def normalized_tolerance(normalizer: str, raw_tol, raw, norm, node_mask):
    """The bound after `normalizer` on raw scores within raw_tol: min-max
    turns an error d in the values and in the row bounds into at most
    4 d * 100 / (highest - lowest), plus SCORE_ULPS ulp of 100; softmax
    adds a relative exp(2 d) - 1 to its own 1e-6 (exp and the sum differ
    in the last bits), plus twice the smallest normal float32 (values
    below it are 0)."""
    if normalizer == "none":
        return raw_tol
    if normalizer == "min_max":
        r, valid = _np(raw), _np(node_mask).astype(bool)
        hi = np.maximum(np.where(valid, r, -np.inf).max(1, keepdims=True), 0.0)
        lo = np.where(valid, r, np.inf).min(1, keepdims=True)
        lo = np.where(hi == lo, lo - 1.0, lo)
        return 4 * raw_tol * 100.0 / (hi - lo) + SCORE_ULPS * _ulp(100.0)
    tiny = float(np.finfo(np.float32).tiny)
    return np.abs(_np(norm)) * (np.expm1(2 * raw_tol) + 1e-6) + 2 * tiny


def score_tolerance(snap, pods, scores, feasible, kw: dict) -> np.ndarray:
    """[p, n] bound on |a - b| between two evaluations of
    schedule_batch(snap, pods, **kw).scores, `scores` and `feasible` being
    one's, on the feasible cells: the policy's raw_score_tolerance
    (balanced_cpu_diskio on the kernel path) through its normalizer; under
    score_plugins each plugin's (min-max normalized outside
    PRESCALED_PLUGINS) times |weight|, summed, plus SCORE_ULPS ulp of the
    total; with soft=True plus SCORE_ULPS ulp of the scores for adding
    the soft term, itself exact (sums of integers)."""
    from kubernetes_scheduler_tpu_torch.engine import PRESCALED_PLUGINS, compute_scores

    feas = _np(feasible).astype(bool)
    scale = _ulp(_np(scores)[feas]) if feas.any() else 0.0
    if kw.get("score_plugins"):
        tol = SCORE_ULPS * scale
        for name, weight in kw["score_plugins"]:
            t = raw_score_tolerance(snap, pods, name)
            if name not in PRESCALED_PLUGINS:
                t = normalized_tolerance("min_max", t, compute_scores(snap, pods, name),
                                         None, snap.node_mask)
            tol = tol + abs(weight) * t
    else:
        policy = ("balanced_cpu_diskio" if kw.get("fused")
                  else kw.get("policy", "balanced_cpu_diskio"))
        tol = normalized_tolerance(
            kw.get("normalizer", "min_max"), raw_score_tolerance(snap, pods, policy),
            compute_scores(snap, pods, policy), scores, snap.node_mask)
    if kw.get("soft"):
        tol = tol + SCORE_ULPS * scale
    return np.broadcast_to(tol, feas.shape)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(torch, fn, n: int = TIMED_LAUNCHES, warmup: int = 3) -> float:
    """Median ms of `n` single calls, each bracketed by CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(torch, fn, n: int = TIMED_LAUNCHES) -> tuple[float, bool]:
    """(device ms per call of `fn`, whether the stream was held throughout):
    `n` calls back to back behind torch.cuda._sleep, which keeps the card
    busy while the host enqueues them, so the wrapper's host time between
    launches is not counted. The sleep is four times an unheld run of the
    same calls (at least 20 ms); a run whose enqueueing outlasted it is
    taken again, up to three times."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    sleep_s = min(max(4 * (time.perf_counter() - t0), 0.02), 2.0)
    for _ in range(3):
        slept, start, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        slept.record()
        torch.cuda._sleep(int(sleep_s * SLEEP_CYCLES_PER_S))
        start.record()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        enqueue_ms = (time.perf_counter() - t0) * 1e3
        end.record()
        end.synchronize()
        held = slept.elapsed_time(start) > enqueue_ms
        if held:
            break
    return start.elapsed_time(end) / n, held


def wall_ms(torch, fn, n: int = 3) -> tuple[list, object]:
    """Host ms of `n` synchronized calls, and the last result."""
    times, out = [], None
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times, out


def device_profile(torch, fn, wall_unprofiled_ms: float) -> dict:
    """One call of `fn` under torch.profiler: device time by kernel, the
    number of device kernels, and the device's idle share of the call's
    wall time (against the profiled and the unprofiled wall time). Device
    numbers are None when the profiler saw no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    n_kernels = sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA)
    if not n_kernels:
        return {"profiled_wall_ms": wall, "device_busy_ms": None,
                "device_kernels": 0, "idle_share": None}
    busy = sum(by_name.values())
    ours = {k: sum(v for name, v in by_name.items() if any(x in name for x in syms))
            for k, syms in SYMBOLS.items()}
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {
        "profiled_wall_ms": wall, "device_busy_ms": busy,
        "device_kernels": n_kernels,
        "idle_share_profiled": 1.0 - busy / wall,
        "idle_share": 1.0 - busy / wall_unprofiled_ms,
        "port_kernels_ms": ours,
        "greedy_phase_ms": {x: sum(v for name, v in by_name.items() if x in name)
                            for x in SYMBOLS["greedy_scan"]},
        "other_device_ms": busy - sum(ours.values()),
        "top_device_ms": [[name[:80], ms] for name, ms in top],
    }


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    """(least ms, what bounds it) at the published peaks, float32
    operations at the rate without FMA."""
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = ops / PEAK_F32_NONFMA_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def same(torch, a, b) -> bool:
    """Equal shape, type and values, NaN equal to NaN: the NaN positions
    must match, and torch.equal holds on the rest."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if not a.is_floating_point():
        return bool(torch.equal(a, b))
    nan = torch.isnan(a)
    return bool(torch.equal(nan, torch.isnan(b))) and bool(torch.equal(a[~nan], b[~nan]))


def max_abs_err(a, b) -> float:
    """Largest |a - b| where neither is NaN (inf where only one is)."""
    if not a.numel():
        return 0.0
    a, b = a.double(), b.double()
    if bool(((a != a) != (b != b)).any()):
        return float("inf")
    both = a == a
    return float((a[both] - b[both]).abs().max()) if bool(both.any()) else 0.0


def load_parent(build, tree: str) -> ctypes.CDLL:
    """K1's, K2's and K4's launchers of an earlier tree's csrc/fused.cu,
    built with this tree's flags into that tree (their C interfaces are
    this tree's since commit e09185f)."""
    pkg = Path(tree) / "kubernetes_scheduler_tpu_torch"
    path, _ = build.build(pkg / "csrc" / "fused.cu", pkg / "_build")
    lib = ctypes.CDLL(str(path))
    ptr, num = ctypes.c_void_p, ctypes.c_int
    # alpha, beta, pod_ok, target, u, v, node_mask, pod_req, alloc, reqd,
    # aff_pod, aff_node, other, stats, out, p, n, r, n_sel, stream
    lib.ks_masked_score.argtypes = [ptr] * 15 + [num] * 4 + [ptr]
    # alpha, beta, u, v, node_mask, out, p, n, stream
    lib.ks_row_stats.argtypes = [ptr] * 6 + [num] * 2 + [ptr]
    # sj, req, free0, free_after, picks, list_key, list_col, list_cnt,
    # fallbacks, p, n, r, list_len, stream
    lib.ks_greedy_scan.argtypes = [ptr] * 9 + [num] * 4 + [ptr]
    for fn in (lib.ks_masked_score, lib.ks_row_stats, lib.ks_greedy_scan):
        fn.restype = ctypes.c_int
    return lib


def _addr(t):
    return None if t is None else t.data_ptr()


def parent_k1(torch, lib, pos, kw):
    """The parent's K1 on masked_score's arguments."""
    p, n, r = pos[0].shape[0], pos[4].shape[0], pos[7].shape[1]
    n_sel = 0 if kw["aff_pod"] is None else kw["aff_pod"].shape[0] // 4
    out = torch.empty((p, n), dtype=torch.float32, device=pos[0].device)
    rc = lib.ks_masked_score(*[_addr(t) for t in pos], _addr(kw["aff_pod"]),
                             _addr(kw["aff_node"]), _addr(kw["other"]),
                             _addr(kw["stats"]), out.data_ptr(), p, n, r, n_sel,
                             torch.cuda.current_stream().cuda_stream)
    if rc:
        fail(f"the parent's masked_score failed to launch ({rc})")
    return out


def parent_k2(torch, lib, alpha, beta, u, v, node_mask):
    """The parent's K2 on row_stats's arguments."""
    p, n = alpha.shape[0], u.shape[0]
    out = torch.empty((2, p), dtype=torch.float32, device=alpha.device)
    rc = lib.ks_row_stats(alpha.data_ptr(), beta.data_ptr(), u.data_ptr(), v.data_ptr(),
                          node_mask.data_ptr(), out.data_ptr(), p, n,
                          torch.cuda.current_stream().cuda_stream)
    if rc:
        fail(f"the parent's row_stats failed to launch ({rc})")
    return out


def parent_k4(torch, lib, sj, req, free0, list_len):
    """The parent's K4 on greedy_scan's arguments: (picks, free_after)."""
    p, n = sj.shape
    r, dev, L = req.shape[1], sj.device, 256
    picks = torch.empty(p, dtype=torch.int32, device=dev)
    free_after = torch.empty((n, r), dtype=torch.float32, device=dev)
    scratch = (torch.empty((p, L), dtype=torch.float32, device=dev),
               torch.empty((p, L), dtype=torch.int32, device=dev),
               torch.empty(p, dtype=torch.int32, device=dev),
               torch.empty(1, dtype=torch.int32, device=dev))
    rc = lib.ks_greedy_scan(sj.data_ptr(), req.data_ptr(), free0.data_ptr(),
                            free_after.data_ptr(), picks.data_ptr(),
                            *[t.data_ptr() for t in scratch], p, n, r, list_len,
                            torch.cuda.current_stream().cuda_stream)
    if rc:
        fail(f"the parent's greedy_scan failed to launch ({rc})")
    return picks, free_after


def kernel_times(torch, new_fn, old_fn=None) -> dict:
    """A kernel's device time per launch (`kernel_ms`, device_ms) and the
    time of one bracketed call (`call_ms`, cuda_ms: it also counts the
    wrapper's host work before the launch); with the parent's launcher on
    the same inputs, both device times in turns: parent, this tree, this
    tree, parent."""
    if old_fn is None:
        ms, held = device_ms(torch, new_fn)
        return {"kernel_ms": ms, "device_held": held, "call_ms": cuda_ms(torch, new_fn)}
    old_a, held_a = device_ms(torch, old_fn)
    new_a, held_b = device_ms(torch, new_fn)
    new_b, held_c = device_ms(torch, new_fn)
    old_b, held_d = device_ms(torch, old_fn)
    return {"kernel_ms": new_a, "kernel_ms_2": new_b, "parent_ms": old_a,
            "parent_ms_2": old_b, "parent_over_kernel": (old_a + old_b) / (new_a + new_b),
            "device_held": held_a and held_b and held_c and held_d,
            "call_ms": cuda_ms(torch, new_fn), "parent_call_ms": cuda_ms(torch, old_fn)}


def check_kernels(torch, port, snap, window, sel_snap, sel_pods, parent=None) -> dict:
    """Phase 3: {kernel: [result line per case]}. `parent`: the parent
    tree's library, timed beside K1 and K2."""
    fused, NEG = port["fused"], port["NEG"]
    dev = snap.allocatable.device
    results: dict = {name: [] for name in REPLACES}

    def record(line, ok):
        emit(line)
        results[line["kernel"]].append(line)
        if not ok:
            fail(f"{line['kernel']} ({line['case']}) differs from its plain version")

    def with_parent(tag, got_parent, want, nan_input):
        """The parent's result checked (its K2 drops a NaN, so only inputs
        without NaN must match) and timed beside this tree's."""
        torch.cuda.synchronize()
        ok = same(torch, got_parent, want)
        if not ok and not nan_input:
            fail(f"the parent's kernel ({tag}) differs from the plain version")
        return {"parent_bitwise": ok}

    def k1_inputs(s, w):
        ops = port["fused_score_operands"](s, w)
        alpha, beta = port["alpha_beta"](ops["r_cpu"], ops["r_io"])
        stats = fused.fused_score_row_stats(alpha, beta, ops["u"], ops["v"],
                                            ops["node_mask"])
        pos = (alpha, beta, ops["pod_mask"], ops["target_node"], ops["u"],
               ops["v"], ops["node_mask"], ops["pod_request"], ops["alloc"],
               ops["reqd"])
        kw = dict(aff_pod=ops["aff_pod"], aff_node=ops["aff_node"],
                  other=ops["other"])
        return pos, kw, stats

    def k1_case(tag, pos, kw, stats, nan_input=False):
        kwm = dict(kw, stats=stats)
        got = fused.masked_score(*pos, **kwm)
        want = fused.masked_score_plain(*pos, **kwm)
        torch.cuda.synchronize()
        ok = same(torch, got, want)
        p, n = got.shape
        r = pos[7].shape[1]
        n_sel = 0 if kwm["aff_pod"] is None else kwm["aff_pod"].shape[0] // 4
        # a pod's `other` cells matter where the pod is unmasked: all n of
        # them, or its pinned one
        pinned = pos[3] >= 0
        other_cells = int((pos[2] & ~pinned).sum()) * n + int((pos[2] & pinned).sum())
        moved = nbytes(*pos, kwm["aff_pod"], kwm["aff_node"], kwm["stats"], got)
        moved += 4 * other_cells if kwm["other"] is not None else 0
        b_ms, b_by = bound(moved, p * n * (5 + 2 * r + n_sel + 1 + 3 * (stats is not None)))
        extra, old_fn = {}, None
        if parent is not None:
            extra = with_parent(tag, parent_k1(torch, parent, pos, kwm), want, nan_input)
            old_fn = lambda: parent_k1(torch, parent, pos, kwm)  # noqa: E731
        record({
            "kernel": "masked_score", "case": tag, "p": p, "n": n, "r": r,
            "selectors": n_sel, "pinned": int(pinned.sum()),
            "other": kwm["other"] is not None, "bitwise": ok,
            "max_abs_err": max_abs_err(got, want), **extra,
            **kernel_times(torch, lambda: fused.masked_score(*pos, **kwm), old_fn),
            "plain_ms": cuda_ms(torch, lambda: fused.masked_score_plain(*pos, **kwm)),
            "bound_us": b_ms * 1e3, "bound_by": b_by, "library_ms": None,
            "feasible_cells": int((want > NEG * 0.5).sum()),
            "nan_cells": int(torch.isnan(want).sum()),
        }, ok)
        return got

    def k2_case(tag, args, nan_input=False):
        got = fused.row_stats(*args)
        want = fused.row_stats_plain(*args)
        torch.cuda.synchronize()
        ok = same(torch, got, want)
        p, n = args[0].shape[0], args[2].shape[0]
        # 5 operations a node-masked cell: a * v, b * u, the difference,
        # and a min and a max of its magnitude (the max and min score are
        # 10 - 10 x of the min and max magnitude, once a row)
        b_ms, b_by = bound(nbytes(*args, got), p * int(args[4].sum()) * 5)
        extra, old_fn = {}, None
        if parent is not None:
            extra = with_parent(tag, parent_k2(torch, parent, *args), want, nan_input)
            old_fn = lambda: parent_k2(torch, parent, *args)  # noqa: E731
        record({
            "kernel": "row_stats", "case": tag, "p": p, "n": n,
            "node_masked": int(args[4].sum()), "bitwise": ok,
            "max_abs_err": max_abs_err(got, want), **extra,
            **kernel_times(torch, lambda: fused.row_stats(*args), old_fn),
            "plain_ms": cuda_ms(torch, lambda: fused.row_stats_plain(*args)),
            "bound_us": b_ms * 1e3, "bound_by": b_by, "library_ms": None,
            "nan_rows": int(torch.isnan(want).any(0).sum()),
        }, ok)
        return got

    # K1: with and without the min-max epilogue, at S=1 and S=8
    pos, kw, stats = k1_inputs(snap, window)
    for tag, (s, w) in (("S=1", (snap, window)), ("S=8", (sel_snap, sel_pods))):
        pos_s, kw_s, stats_s = k1_inputs(s, w)
        for minmax in (False, True):
            k1_case(f"{tag} minmax={minmax}", pos_s, kw_s, stats_s if minmax else None)
    p, n = window.request.shape[0], pos[4].shape[0]
    # S = 32 selectors, every bit in use: required, forbidden and matched
    # selectors on a few pods each, thresholds on 5% of (selector, pod)
    gen = torch.Generator().manual_seed(2)
    n_sel = 32

    def flags(rows, cols, prob):
        return (torch.rand(rows, cols, generator=gen) < prob).float()

    thresh = torch.where(torch.rand(n_sel, p, generator=gen) < 0.05,
                         torch.randint(0, 3, (n_sel, p), generator=gen).float(),
                         torch.finfo(torch.float32).max)
    wide = dict(kw, aff_pod=torch.cat([flags(n_sel, p, 0.01), flags(n_sel, p, 0.01),
                                       flags(n_sel, p, 0.03), thresh]).to(dev),
                aff_node=torch.cat([flags(n_sel, n, 0.95), flags(n_sel, n, 0.01),
                                    torch.randint(0, 4, (n_sel, n), generator=gen).float()
                                    ]).to(dev))
    k1_case("S=32 minmax=True", pos, wide, stats)
    # n % 4 != 0: rows are not 16-byte aligned, so scalar loads
    c = lambda t: t.contiguous()  # noqa: E731
    odd = pos[:4] + tuple(c(t[: n - 1]) for t in pos[4:])
    odd_kw = dict(aff_pod=kw["aff_pod"], aff_node=c(kw["aff_node"][:, : n - 1]),
                  other=c(kw["other"][:, : n - 1]))
    odd_stats = fused.fused_score_row_stats(odd[0], odd[1], odd[4], odd[5], odd[6])
    k1_case("n=9,999 minmax=True", odd, odd_kw, odd_stats)
    # p = 1,000: the last pod group is partial
    few = tuple(c(t[:1000]) for t in pos[:4]) + pos[4:7] + (c(pos[7][:1000]),) + pos[8:]
    few_kw = dict(aff_pod=c(kw["aff_pod"][:, :1000]), aff_node=kw["aff_node"],
                  other=c(kw["other"][:1000]))
    k1_case("p=1,000 minmax=True", few, few_kw, c(stats[:, :1000]))
    # every pod pinned to a node (a few out of range)
    pins = torch.randint(0, n + 8, (p,), generator=gen).to(dev, torch.int32)
    k1_case("every pod pinned minmax=True", pos[:3] + (pins,) + pos[4:], kw, stats)
    k1_case("without other minmax=True", pos, dict(kw, other=None), stats)
    # other resource counts: at r = 4 with the fourth resource requested
    # by no pod the cells are those of r = 3; at r = 7 four more
    # resources, each requested (1 or 2) by ~30% of the pods, with room
    # for a request of 1 on half the nodes and of 2 on a quarter
    base = fused.masked_score(*pos, **dict(kw, stats=stats))
    gen_r = torch.Generator().manual_seed(4)
    r4 = pos[:7] + tuple(torch.cat([t, x.to(dev)], 1).contiguous() for t, x in zip(pos[7:], (
        torch.zeros(p, 1), torch.rand(n, 1, generator=gen_r),
        2 * torch.rand(n, 1, generator=gen_r))))
    if not same(torch, k1_case("r=4 unrequested minmax=True", r4, kw, stats), base):
        fail("masked_score at r=4 with the fourth resource unrequested differs from r=3")
    extra = torch.randint(1, 3, (p, 4), generator=gen_r).float()
    extra *= torch.rand(p, 4, generator=gen_r) < 0.3
    r7 = pos[:7] + tuple(torch.cat([t, x.to(dev)], 1).contiguous() for t, x in zip(pos[7:], (
        extra, torch.full((n, 4), 4.0),
        torch.randint(0, 4, (n, 4), generator=gen_r).float() + 1.5)))
    k1_case("r=7 minmax=True", r7, kw, stats)
    # NaN in u on three node-masked nodes: every row's bounds are NaN, so
    # is every feasible cell
    valid = torch.nonzero(pos[6]).flatten()
    u_nan = pos[4].clone()
    u_nan[valid[[0, valid.numel() // 2, -1]]] = float("nan")
    nan_pos = pos[:4] + (u_nan,) + pos[5:]
    nan_stats = fused.fused_score_row_stats(pos[0], pos[1], u_nan, pos[5], pos[6])
    torch.cuda.synchronize()
    if not bool(torch.isnan(nan_stats).all()):
        fail("fused_score_row_stats dropped a NaN on a node-masked node")
    got = k1_case("NaN bounds minmax=True", nan_pos, kw, nan_stats, nan_input=True)
    if bool(((got != NEG) & ~torch.isnan(got)).any()) or not bool(torch.isnan(got).any()):
        fail("masked_score kept a finite score under NaN bounds")

    # K2 on the main path's window, then at an odd width and a partial pod
    # group, with no node-masked node, and with NaN in u
    args = (pos[0], pos[1], pos[4], pos[5], pos[6])  # alpha, beta, u, v, node_mask
    k2_case("gpu-10kx10k window", args)
    k2_case("n=9,999", (odd[0], odd[1], odd[4], odd[5], odd[6]))
    k2_case("p=1,000", (few[0], few[1], few[4], few[5], few[6]))
    none = k2_case("no node-masked node", args[:4] + (torch.zeros_like(args[4]),))
    if not (bool((none[0] == -torch.finfo(torch.float32).max).all())
            and bool((none[1] == torch.finfo(torch.float32).max).all())):
        fail("row_stats with no node-masked node is not (-F32_MAX, F32_MAX)")
    got = k2_case("NaN on node-masked nodes", (args[0], args[1], u_nan, args[3], args[4]),
                  nan_input=True)
    if not bool(torch.isnan(got).all()):
        fail("row_stats dropped a NaN on a node-masked node")
    # a NaN on a node that is masked out changes nothing
    holes = args[4].clone()
    holes[::97] = False
    u_hole = args[2].clone()
    u_hole[97] = float("nan")
    got = k2_case("NaN on a masked-out node", (args[0], args[1], u_hole, args[3], holes),
                  nan_input=True)
    if not same(torch, got, fused.row_stats(args[0], args[1], args[2], args[3], holes)):
        fail("row_stats changed with a NaN on a masked-out node")

    # the launch floor: a one-element add_, timed as the kernels are
    one = torch.zeros(1, device=dev)
    floor_ms, held = device_ms(torch, lambda: one.add_(1.0))
    emit({"phase": "launch_floor", "what": "one-element add_", "kernel_ms": floor_ms,
          "device_held": held})

    # K3 on the first auction round of the main path's window, then on
    # rows with planted ties within and across thread strides and blocks
    raw = fused.fused_masked_score(**port["fused_score_operands"](snap, window),
                                   normalizer="min_max")
    sj = port["auction_values"](raw, raw > NEG * 0.5, 1.0)
    req = window.request.contiguous()
    free = port["compute_free_capacity"](snap).contiguous()
    price = torch.zeros(sj.shape[1], dtype=torch.float32, device=dev)
    p, n = sj.shape
    r = req.shape[1]
    tie_sj = sj.clone()
    tie_rows = torch.arange(0, p, 3, device=dev)
    first = (tie_rows * 37) % (n // 10)
    for col in (first, first + 256, first + 2 * n // 5, n - 1 - (tie_rows % 50)):
        tie_sj[tie_rows, col] = 5.0
    no_cell = torch.arange(p, device=dev) % 7 == 1
    tie_sj[no_cell] = NEG                   # rows with no feasible cell
    tie_active = window.pod_mask.clone()
    tie_active[2::11] = False               # inactive rows
    big_free = torch.full_like(free, 3.0e38)
    # a late round: the capacity left after the first round's admissions,
    # prices of a few rounds (multiples of price_frac = 1), ~5% of the pods
    # still active
    bid0, has0 = fused.auction_bid_plain(sj, price, window.pod_mask, req, free)
    by_prio = port["assign"]._priority_order(window.priority, window.pod_mask)
    admitted = port["assign"]._segmented_admission(bid0, has0, req, free, by_prio)
    late_free = (free - torch.zeros_like(free).index_add_(
        0, bid0.long(), torch.where(admitted[:, None], req, 0.0))).contiguous()
    cpu_gen = torch.Generator().manual_seed(1)
    late_price = torch.randint(0, 16, (n,), generator=cpu_gen).float().to(dev)
    left = torch.nonzero((window.pod_mask & ~admitted).cpu()).flatten()
    left = left[torch.randperm(left.numel(), generator=cpu_gen)[: round(0.05 * p)]]
    late_active = torch.zeros(p, dtype=torch.bool)
    late_active[left] = True
    k3_cases = {
        "first round": (sj, price, window.pod_mask, req, free),
        "planted ties": (tie_sj, price, tie_active, req, big_free),
        "late round": (sj, late_price, late_active.to(dev), req, late_free),
        # n % 4 != 0: rows are not 16-byte aligned, so scalar loads
        "odd width": (sj[:, : n - 1].contiguous(), price[: n - 1].contiguous(),
                      window.pod_mask, req, free[: n - 1].contiguous()),
    }
    for tag, k3 in k3_cases.items():
        got_b, got_h = fused.auction_bid(*k3)
        want_b, want_h = fused.auction_bid_plain(*k3)
        torch.cuda.synchronize()
        ok = same(torch, got_b, want_b) and same(torch, got_h, want_h)
        if tag == "planted ties":
            hit = k3[2][tie_rows] & ~no_cell[tie_rows]
            ok = ok and bool((got_b[tie_rows][hit] == first[hit].int()).all())
        n_act, n_k = int(k3[2].sum()), k3[0].shape[1]
        moved = n_act * n_k * 4 + nbytes(*k3[1:]) + 8 * p
        b_ms, b_by = bound(moved, n_act * n_k * (3 + 2 * r))
        record({
            "kernel": "auction_bid", "case": tag, "p": p, "n": n_k, "r": r,
            "active": n_act, "bitwise": ok,
            "max_abs_err": max(max_abs_err(got_b, want_b),
                               max_abs_err(got_h.int(), want_h.int())),
            **kernel_times(torch, lambda: fused.auction_bid(*k3)),
            "plain_ms": cuda_ms(torch, lambda: fused.auction_bid_plain(*k3)),
            "bound_us": b_ms * 1e3, "bound_by": b_by, "library_ms": None,
            "bidders": int(got_h.sum()),
        }, ok)

    # K4 on the greedy cycle's operands in scan order, then on contended
    # capacity, planted ties, NEG rows with zero requests at r = 7, one-entry
    # lists, lists that run out at a tie boundary, a negative request, an
    # odd width, and NaN cells (several rows, beside +inf, without
    # capacity, at a one-entry list's boundary)
    _, sj, req, free = port["greedy_scan_operands"](
        raw, raw > NEG * 0.5, window.request, free, window.priority, window.pod_mask)
    p, n = sj.shape
    r = req.shape[1]
    rows = torch.arange(p, device=dev)
    cpu_gen = torch.Generator().manual_seed(0)
    cases = {"(a) main path": ((sj, req, free), {})}
    # every pod ranks the nodes alike and a node holds one or two pods, so
    # the decrement decides where later pods go
    rank = torch.randperm(n, generator=cpu_gen).to(dev, torch.float32)
    cases["(b) contended capacity"] = ((
        torch.where(sj > NEG * 0.5, rank[None, :], NEG).contiguous(), req,
        (req.amax(0) * 1.5).clamp(min=2.0).expand(n, r).contiguous(),
    ), {})
    # exact ties in neighbouring threads, warps, and one thread's strides
    tie_sj = sj.clone()
    tie_rows = torch.arange(0, p, 3, device=dev)
    first = (tie_rows * 37) % (n // 10)
    for off in (0, 1, 32, 1024, 1025, n // 2):
        tie_sj[tie_rows, first + off] = 1000.0
    cases["(c) planted ties"] = ((tie_sj, req, torch.full_like(free, 3.0e38)), {})
    # all-NEG rows; four more resources, zero for most pods, oversubscribed
    # (negative) on half the nodes; n * r * 4 B = 280 KB > 227 KB of smem
    neg_sj = sj.clone()
    neg_sj[rows % 7 == 1] = NEG
    extra = torch.randint(1, 3, (p, 4), generator=cpu_gen).float()
    extra *= torch.rand(p, 4, generator=cpu_gen) < 0.3
    over = torch.where(torch.rand(n, 4, generator=cpu_gen) < 0.5, -1.0, 4.0)
    cases["(d) NEG rows, zero requests, r=7"] = ((
        neg_sj, torch.cat([req, extra.to(dev)], 1).contiguous(),
        torch.cat([free, over.to(dev)], 1).contiguous(),
    ), {})
    # (a) with one-entry candidate lists: the fallback runs whenever a
    # pod's best node is taken
    cases["(e) list length 1"] = ((sj, req, free), {"_list_len": 1})
    # 2 L equal maxima at spread columns, the same in every row, on nodes
    # that hold one pod each: the lists run out at a tie boundary
    n_ties = 2 * fused.GREEDY_LIST_LEN
    tie_cols = torch.arange(n_ties, device=dev) * (n // n_ties) + 5
    bound_sj = sj.clone()
    bound_sj[:, tie_cols] = 1000.0
    one_pod = req.amax(0).clamp(min=1.0)
    cases["(f) tie boundary"] = ((
        bound_sj, one_pod.expand(p, r).contiguous(), one_pod.expand(n, r).contiguous(),
    ), {})
    # (a) with a negative request component on one pod in the first third:
    # capacity grows, so every later pod scans its whole row
    neg_pod = p // 5
    neg_req = req.clone()
    neg_req[neg_pod, 0] = -1.0
    cases["(g) negative request"] = ((sj, neg_req, free), {})
    # n % 4 != 0: rows are not 16-byte aligned, so scalar loads
    cases["(h) odd width"] = ((sj[:, : n - 1].contiguous(), req, free[: n - 1].contiguous()), {})
    # NaN cells, which qualify and rank above every number (the first NaN
    # first): in every fifth row at two columns those rows share (taken by
    # the first pods, so later ones find them full) and one of their own
    nan = float("nan")
    nan_rows = torch.arange(0, p, 5, device=dev)
    nan_sj = sj.clone()
    nan_sj[nan_rows, 17] = nan
    nan_sj[nan_rows, n // 2 + 3] = nan
    nan_sj[nan_rows, (nan_rows * 53) % n] = nan
    cases["(i) NaN cells"] = ((nan_sj, req, free), {})
    # rows holding +inf and NaN: the NaN wins, at a column after the +inf
    inf_rows = torch.arange(1, p, 7, device=dev)
    inf_sj = sj.clone()
    inf_sj[inf_rows, 40] = float("inf")
    inf_sj[inf_rows, n - 2] = float("inf")
    inf_sj[inf_rows, 2 * n // 3] = nan
    inf_sj[inf_rows[::2], 2 * n // 3 + 1] = nan
    cases["(j) NaN and +inf"] = ((inf_sj, req, free), {})
    # NaN cells on nodes with no capacity (every request is positive on the
    # main path): passed over
    full_cols = torch.arange(11, n, n // 16, device=dev)
    cap_sj = sj.clone()
    cap_sj[:, full_cols] = nan
    cap_free = free.clone()
    cap_free[full_cols] = 0.0
    cases["(k) NaN without capacity"] = ((cap_sj, req, cap_free.contiguous()), {})
    # one-entry lists on nodes that hold one pod each, every row NaN at
    # columns 5 and 900: pod 0 takes 5, pod 1's list entry (NaN, 5) is taken
    # and its row scan, restricted to cells ranked after a NaN, finds 900
    bnd_sj = sj.clone()
    bnd_sj[:, 5] = nan
    bnd_sj[:, 900] = nan
    cases["(l) NaN at a list boundary"] = ((
        bnd_sj, one_pod.expand(p, r).contiguous(), one_pod.expand(n, r).contiguous(),
    ), {"_list_len": 1})
    for tag, (k4, kw) in cases.items():
        got_p, got_f = fused.greedy_scan(*k4, **kw)
        torch.cuda.synchronize()
        fallbacks = int(fused.last_greedy_fallbacks)
        want_p, want_f = fused.greedy_scan_plain(*k4)
        torch.cuda.synchronize()
        ok = same(torch, got_p, want_p) and same(torch, got_f, want_f)
        if tag == "(c) planted ties":
            ok = ok and bool((got_p[tie_rows] == first.int()).all())
        if tag.startswith("(d)"):
            ok = ok and bool((got_p[rows % 7 == 1] == -1).all())
        if tag == "(f) tie boundary":
            ok = ok and bool((got_p[:n_ties] == tie_cols[:p].int()).all())
        placed = torch.nonzero(got_p >= 0).flatten()
        nan_picks = int(torch.isnan(k4[0][placed, got_p[placed].long()]).sum())
        if tag in ("(i) NaN cells", "(j) NaN and +inf", "(l) NaN at a list boundary"):
            ok = ok and nan_picks > 0
        if tag == "(k) NaN without capacity":
            ok = ok and nan_picks == 0
        if tag == "(l) NaN at a list boundary":
            ok = ok and got_p[:2].tolist() == [5, 900]
        n_k, rk = k4[0].shape[1], k4[1].shape[1]
        b_ms, b_by = bound(nbytes(*k4, got_p, got_f), p * n_k * (2 + 3 * rk))
        extra, old_fn = {}, None
        if parent is not None:
            list_len = kw.get("_list_len", fused.GREEDY_LIST_LEN)
            old_p, old_f = parent_k4(torch, parent, *k4, list_len)
            torch.cuda.synchronize()
            extra = {"parent_bitwise": same(torch, old_p, want_p) and same(torch, old_f, want_f)}
            if not extra["parent_bitwise"] and not bool(torch.isnan(k4[0]).any()):
                fail(f"the parent's greedy_scan ({tag}) differs from the plain version")
            old_fn = lambda: parent_k4(torch, parent, *k4, list_len)  # noqa: E731
        record({
            "kernel": "greedy_scan", "case": tag, "p": p, "n": n_k, "r": rk,
            "list_len": kw.get("_list_len", fused.GREEDY_LIST_LEN), "bitwise": ok,
            "max_abs_err": max(max_abs_err(got_p, want_p), max_abs_err(got_f, want_f)),
            "fallbacks": fallbacks, "nan_cells": int(torch.isnan(k4[0]).sum()),
            "nan_picks": nan_picks, **extra,
            **kernel_times(torch, lambda: fused.greedy_scan(*k4, **kw), old_fn),
            "plain_ms": cuda_ms(torch, lambda: fused.greedy_scan_plain(*k4), n=5, warmup=1),
            "bound_us": b_ms * 1e3, "bound_by": b_by, "library_ms": None,
            "placed": int((got_p >= 0).sum()),
        }, ok)
        if tag == "(g) negative request" and fallbacks < p - neg_pod:
            fail(f"greedy_scan's guard did not trip: {fallbacks} row scans, "
                 f"fewer than the {p - neg_pod} pods from the negative request on")
    return results


def check_equal(torch, what, got, want) -> None:
    for field in ("node_idx", "free_after", "n_assigned"):
        if not same(torch, getattr(got, field), getattr(want, field)):
            fail(f"{what} {field} differs")


def check_backlog(torch, what, out, n_windows, n_nodes, min_share) -> int:
    """Shape, range, capacity and placement-count checks of one backlog;
    returns n_assigned."""
    assigned = int(out.n_assigned)
    if tuple(out.node_idx.shape) != (n_windows, WINDOW) or bool((out.node_idx >= n_nodes).any()):
        fail(f"{what} node_idx has the wrong shape or range")
    if not bool(torch.isfinite(out.free_after).all()) or bool((out.free_after < 0).any()):
        fail(f"{what} free_after is not finite and non-negative")
    if assigned < min_share * n_windows * WINDOW:
        fail(f"{what} assigned only {assigned}/{n_windows * WINDOW} pods")
    return assigned


def run_slice(torch, port, snap, pods, window) -> dict:
    """Phase 4: the auction slice through TorchEngine; returns its main
    path's kernel launch counts."""
    fused, TorchEngine = port["fused"], port["TorchEngine"]
    engine = TorchEngine()

    cycle_runs, res = wall_ms(torch, lambda: engine.schedule_batch(snap, window, **SLICE_KW))
    check_equal(torch, "schedule_batch (vs the plain path)", res,
                engine.schedule_batch(snap, window, **SLICE_KW, _plain=True))
    cycle_ms = statistics.median(cycle_runs)
    emit({"phase": "schedule_batch", "pods": WINDOW,
          "nodes": snap.allocatable.shape[0], "cycle_ms": cycle_ms,
          "cycle_ms_runs": cycle_runs, "n_assigned": int(res.n_assigned),
          "equal_to_plain": True})

    backlog = type(pods)(*[f[: WINDOW * N_WINDOWS] for f in pods])
    pods_w = port["stack_windows"](backlog, WINDOW)
    run_backlog = lambda: engine.schedule_windows(snap, pods_w, **SLICE_KW)  # noqa: E731
    run_backlog()                                             # warm-up
    torch.cuda.synchronize()
    fused.reset_launches()
    main_runs, out = wall_ms(torch, run_backlog, n=1)         # the main path
    launches = dict(fused.launches)
    more_runs, _ = wall_ms(torch, run_backlog, n=2)
    check_equal(torch, "schedule_windows (vs the plain path)", out,
                engine.schedule_windows(snap, pods_w, **SLICE_KW, _plain=True))
    for name, path in MAIN_PATH.items():
        if path == "auction" and launches[name] <= 0:
            fail(f"kernel {name} was not launched on the main path")
    n_pods = WINDOW * N_WINDOWS
    n_nodes = snap.allocatable.shape[0]
    assigned = check_backlog(torch, "schedule_windows", out, N_WINDOWS, n_nodes, 0.5)
    backlog_runs = main_runs + more_runs
    backlog_ms = statistics.median(backlog_runs)
    emit({"phase": "schedule_windows", "windows": N_WINDOWS, "window": WINDOW,
          "nodes": n_nodes, "backlog_ms": backlog_ms, "backlog_ms_runs": backlog_runs,
          "pods_per_s": n_pods / (backlog_ms / 1e3), "n_assigned": assigned,
          "auction_rounds_per_window": launches["auction_bid"] / N_WINDOWS,
          "launches": launches, "equal_to_plain": True})

    # where the time goes: one cycle and one backlog under torch.profiler
    emit({"phase": "profile_schedule_batch", **device_profile(
        torch, lambda: engine.schedule_batch(snap, window, **SLICE_KW), cycle_ms)})
    emit({"phase": "profile_schedule_windows",
          **device_profile(torch, run_backlog, backlog_ms)})

    # small cluster: the card's kernel path equals the port's CPU path
    small = port["gen_cluster"](300, seed=3, gpu=True, device="cpu")
    small_w = port["stack_windows"](
        port["gen_pods"](96, seed=4, gpu=True, device="cpu"), 32)
    cpu_out = TorchEngine(device="cpu").schedule_windows(small, small_w, **SLICE_KW)
    gpu_out = engine.schedule_windows(small, small_w, **SLICE_KW)
    check_equal(torch, "small cluster (card vs CPU path)",
                type(gpu_out)(*[f.cpu() for f in gpu_out]), cpu_out)
    emit({"phase": "card_vs_cpu", "nodes": 300, "pods": 96,
          "n_assigned": int(gpu_out.n_assigned), "equal": True})
    return launches


def run_greedy(torch, port, snap, pods) -> dict:
    """Phase 5: the greedy backlog through TorchEngine; returns its main
    path's kernel launch counts."""
    fused = port["fused"]
    engine = port["TorchEngine"]()
    backlog = type(pods)(*[f[: WINDOW * N_WINDOWS] for f in pods])
    pods_w = port["stack_windows"](backlog, WINDOW)
    run_backlog = lambda: engine.schedule_windows(snap, pods_w, **GREEDY_KW)  # noqa: E731
    run_backlog()                                             # warm-up
    torch.cuda.synchronize()
    fused.reset_launches()
    main_runs, out = wall_ms(torch, run_backlog, n=1)         # the main path
    launches = dict(fused.launches)
    more_runs, _ = wall_ms(torch, run_backlog, n=2)
    check_equal(torch, "greedy schedule_windows (vs the plain path)", out,
                engine.schedule_windows(snap, pods_w, **GREEDY_KW, _plain=True))
    want = {"masked_score": N_WINDOWS, "row_stats": N_WINDOWS, "auction_bid": 0,
            "greedy_scan": N_WINDOWS}
    if launches != want:
        fail(f"greedy backlog launched {launches}, not {want}")
    n_nodes = snap.allocatable.shape[0]
    assigned = check_backlog(torch, "greedy schedule_windows", out, N_WINDOWS, n_nodes, 0.5)
    # K4's row-scan fallbacks in each window, from one more run
    real, per_window = fused.greedy_scan, []

    def keeping_fallbacks(*args, **kw):
        picks_free = real(*args, **kw)
        per_window.append(fused.last_greedy_fallbacks)
        return picks_free

    fused.greedy_scan = keeping_fallbacks
    try:
        run_backlog()
    finally:
        fused.greedy_scan = real
    torch.cuda.synchronize()
    backlog_runs = main_runs + more_runs
    backlog_ms = statistics.median(backlog_runs)
    n_pods = WINDOW * N_WINDOWS
    emit({"phase": "greedy_schedule_windows", "windows": N_WINDOWS, "window": WINDOW,
          "nodes": n_nodes, "backlog_ms": backlog_ms, "backlog_ms_runs": backlog_runs,
          "pods_per_s": n_pods / (backlog_ms / 1e3), "n_assigned": assigned,
          "fallbacks_per_window": [int(t) for t in per_window],
          "launches": launches, "equal_to_plain": True})
    emit({"phase": "profile_greedy_schedule_windows",
          **device_profile(torch, run_backlog, backlog_ms)})
    return launches


def one_hot(torch, sel, s: int):
    """[P, S] bool: each pod's selector ids as a set (ids outside [0, S)
    left out)."""
    hot = torch.zeros(sel.shape[0], s + 1, dtype=torch.bool)
    ok = (sel >= 0) & (sel < s)
    hot.scatter_(1, torch.where(ok, sel, s).long(), True)
    return hot[:, :s]


def final_violations(torch, snap, pods, node_idx) -> dict:
    """Hard (anti)affinity breaks in a backlog's final placements, counted
    independently of the engine's code: for every placed pod, from the
    base counts plus every placement of the backlog, less the pod itself,
    in each of its node's domains, a required selector must be present, a
    forbidden one absent, and no avoider of a selector the pod matches
    may be there. Counts only grow during a backlog, so each holds at the
    end whenever it held when the pod was placed."""
    dom = snap.domain_id.cpu().long()
    base, base_avoid = snap.domain_counts.cpu(), snap.avoid_counts.cpu()
    n, s = base.shape
    idx = node_idx.reshape(-1).cpu().long()
    placed = idx >= 0
    at_node = idx.clamp(min=0)
    matches = pods.pod_matches.cpu()
    matches = torch.nn.functional.pad(matches, (0, max(s - matches.shape[1], 0)))[:, :s]
    aff_sel, anti_sel = pods.affinity_sel.cpu(), pods.anti_affinity_sel.cpu()
    has_anti, needs = one_hot(torch, anti_sel, s), one_hot(torch, aff_sel, s)
    cols = torch.arange(s).expand(int(placed.sum()), s)
    rows = dom[idx[placed]]
    added = torch.zeros(n, s).index_put_((rows, cols), matches[placed].float(), accumulate=True)
    added_av = torch.zeros(n, s).index_put_((rows, cols), has_anti[placed].float(),
                                            accumulate=True)
    at = dom[at_node]
    all_cols = torch.arange(s).expand_as(at)
    others = base[at_node] + added[at, all_cols] - matches.float()
    avoiders = base_avoid[at_node] + added_av[at, all_cols] - has_anti.float()
    stale = (aff_sel >= s).any(-1) | (anti_sel >= s).any(-1)
    bad = {
        "anti_affinity": (has_anti & (others > 0)).any(-1),
        "affinity": (needs & ~(others > 0)).any(-1) | stale,
        "reverse_avoider": (matches & (avoiders > 0)).any(-1),
    }
    out = {k: int((placed & v).sum()) for k, v in bad.items()}
    out["placed_checked"] = int(placed.sum())
    return out


def count_rounds(port, fn):
    """(fn(), auction rounds it ran): one segmented admission per round."""
    mod = port["assign"]
    real, calls = mod._segmented_admission, []

    def counting(*args):
        calls.append(1)
        return real(*args)

    mod._segmented_admission = counting
    try:
        return fn(), len(calls)
    finally:
        mod._segmented_admission = real


def run_affinity(torch, port, dev) -> None:
    """Phase 6: both assigners with affinity_aware=True on
    constraints-5kx5k, each equal to its plain run and free of hard
    (anti)affinity breaks."""
    fused = port["fused"]
    engine = port["TorchEngine"]()
    snap, pods = port["gen_config"]("constraints-5kx5k", seed=0, device=dev)
    padded = port["pad_pod_batch"](pods, AFFINITY_WINDOWS * WINDOW)
    pods_w = port["stack_windows"](padded, WINDOW)
    n_nodes = snap.allocatable.shape[0]
    for name, kw in AFFINITY_KW.items():
        run = lambda: engine.schedule_windows(snap, pods_w, **kw)  # noqa: E731
        torch.cuda.synchronize()
        fused.reset_launches()
        runs, out = wall_ms(torch, run, n=1)
        launches = dict(fused.launches)
        more_runs, _ = wall_ms(torch, run, n=1 if name == "greedy" else 2)
        plain, rounds = count_rounds(
            port, lambda: engine.schedule_windows(snap, pods_w, **kw, _plain=True))
        check_equal(torch, f"affinity {name} schedule_windows (vs the plain path)", out, plain)
        want = {"masked_score": AFFINITY_WINDOWS, "row_stats": AFFINITY_WINDOWS,
                "auction_bid": 0, "greedy_scan": 0}
        if launches != want:
            fail(f"affinity {name} backlog launched {launches}, not {want}")
        assigned = check_backlog(torch, f"affinity {name} schedule_windows", out,
                                 AFFINITY_WINDOWS, n_nodes, 0.5)
        viol = final_violations(torch, snap, padded, out.node_idx)
        if any(v for k, v in viol.items() if k != "placed_checked"):
            fail(f"affinity {name} backlog breaks hard constraints: {viol}")
        all_runs = runs + more_runs
        backlog_ms = statistics.median(all_runs)
        emit({"phase": f"affinity_{name}_schedule_windows", "config": "constraints-5kx5k",
              "windows": AFFINITY_WINDOWS, "window": WINDOW, "nodes": n_nodes,
              "pods": int(pods.request.shape[0]),
              "selectors": int(snap.domain_counts.shape[1]),
              "backlog_ms": backlog_ms, "backlog_ms_runs": all_runs,
              "pods_per_s": AFFINITY_WINDOWS * WINDOW / (backlog_ms / 1e3),
              "n_assigned": assigned,
              "auction_rounds_per_window": (rounds / AFFINITY_WINDOWS
                                            if name == "auction" else None),
              "launches": launches, "violations": viol, "equal_to_plain": True})
        if name == "auction":
            emit({"phase": "profile_affinity_auction_schedule_windows",
                  **device_profile(torch, run, backlog_ms)})


def check_greedy_host_reads(torch, port, dev) -> None:
    """Phase 6b: neither greedy scan reads from the card per pod. Both run
    on one constraints window under torch.cuda.set_sync_debug_mode("error"),
    which raises on a synchronising call (a prototype detector: it does
    not see every kind of sync)."""
    snap = port["gen_cluster"](5_000, seed=0, constraints=True, device=dev)
    pods = port["gen_pods"](256, seed=1, constraints=True, device=dev)
    raw = port["fused"].fused_masked_score(
        **port["fused_score_operands"](snap, pods, include_pod_affinity=False),
        normalizer="min_max")
    args = (raw, raw > port["NEG"] * 0.5, pods.request,
            port["compute_free_capacity"](snap), pods.priority, pods.pod_mask)
    aff = port["make_affinity_state"](snap, pods)
    for name, kw in (("greedy", {}), ("affinity_greedy", {"affinity": aff})):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = port["assign"].greedy_assign(*args, **kw)
        except RuntimeError as e:
            fail(f"{name} scan synchronised with the host: {e}")
        finally:
            torch.cuda.set_sync_debug_mode(0)
        emit({"phase": f"host_reads_{name}", "pods": 256, "nodes": 5_000,
              "n_assigned": int(out.n_assigned), "host_syncs_detected": 0})


def decisions_match(torch, port, got, want, pods, assigner: str) -> str:
    """'equal' when node_idx, free_after and n_assigned are equal; for
    greedy, which has no tie jitter, 'near-tie' when the decisions first
    differ (in priority order) at a pod whose two picks score within 2 d
    of each other under `want`'s scores, d being the largest |got - want|
    score difference on that pod's feasible cells; '' otherwise."""
    g, w = got.node_idx.cpu(), want.node_idx.cpu()
    if torch.equal(g, w):
        ok = (same(torch, got.free_after.cpu(), want.free_after.cpu())
              and int(got.n_assigned) == int(want.n_assigned))
        return "equal" if ok else ""
    if assigner != "greedy":
        return ""
    order = port["assign"]._priority_order(pods.priority.cpu(), pods.pod_mask.cpu())
    first = next(int(i) for i in order if g[i] != w[i])
    gi, wi = int(g[first]), int(w[first])
    if gi < 0 or wi < 0:
        return ""
    feas = want.feasible[first].cpu()
    w_row, g_row = want.scores[first].cpu().double(), got.scores[first].cpu().double()
    d = float((g_row - w_row).abs()[feas].max())
    return "near-tie" if float(w_row[gi]) >= float(w_row[wi]) - 2 * d else ""


def option_cases(port) -> list:
    """Phase 7's new options: (family, case, snapshot, pods, kwargs) on
    small CPU clusters: every policy x normalizer on both assigners
    (composed path), score_plugins, soft on both paths, and S = 40."""
    gen_cluster, gen_pods = port["gen_cluster"], port["gen_pods"]
    feats = dict(gpu=True, constraints=True, images=True)
    snap = gen_cluster(300, seed=3, device="cpu", **feats)
    pods = gen_pods(96, seed=4, device="cpu", **feats)
    soft_snap, soft_pods = soft_terms(snap, pods, seed=7)
    wide = dict(constraints=True, n_selectors=40)
    wide_snap = gen_cluster(200, seed=3, device="cpu", **wide)
    wide_pods = gen_pods(96, seed=4, device="cpu", **wide)
    cases = []
    for policy in port["POLICIES"]:
        for normalizer in port["NORMALIZERS"]:
            for assigner in ("greedy", "auction"):
                cases.append(("policies", f"{policy} {normalizer} {assigner}", snap, pods,
                              dict(policy=policy, normalizer=normalizer, assigner=assigner,
                                   fused=False, affinity_aware=False)))
    for assigner, aa in (("auction", True), ("auction", False), ("greedy", False)):
        cases.append(("score_plugins", f"{assigner} affinity_aware={aa}", snap, pods,
                      dict(MULTI_KW["auction"], assigner=assigner, affinity_aware=aa)))
    for fused, aa in ((True, True), (False, False)):
        for assigner in ("greedy", "auction"):
            cases.append(("soft", f"fused={fused} {assigner}", soft_snap, soft_pods,
                          dict(assigner=assigner, normalizer="min_max", fused=fused,
                               affinity_aware=aa, soft=True)))
    for aa in (True, False):
        for assigner in ("greedy", "auction"):
            cases.append(("S=40", f"{assigner} affinity_aware={aa}", wide_snap, wide_pods,
                          dict(SLICE_KW, assigner=assigner, affinity_aware=aa)))
    return cases


def run_card_vs_cpu(torch, port) -> None:
    """Phase 7: small clusters, the card's path against the port's CPU
    path: backlogs with the second slice's options, then one window with
    each new option: masks equal, scores within score_tolerance,
    decisions equal or a near-tie greedy flip."""
    small = port["gen_cluster"](300, seed=3, constraints=True, device="cpu")
    small_w = port["stack_windows"](
        port["gen_pods"](96, seed=4, constraints=True, device="cpu"), 32)
    for name, kw in (("greedy", GREEDY_KW), ("affinity_greedy", AFFINITY_KW["greedy"]),
                     ("affinity_auction", AFFINITY_KW["auction"])):
        cpu_out = port["TorchEngine"](device="cpu").schedule_windows(small, small_w, **kw)
        gpu_out = port["TorchEngine"]().schedule_windows(small, small_w, **kw)
        check_equal(torch, f"small constraints cluster, {name} (card vs CPU path)",
                    type(gpu_out)(*[f.cpu() for f in gpu_out]), cpu_out)
        emit({"phase": f"card_vs_cpu_{name}", "nodes": 300, "pods": 96,
              "n_assigned": int(gpu_out.n_assigned), "equal": True})
    # fault C1's cluster: NaN disk IO on one node turns every min-max score
    # NaN; greedy must still place all 24 pods, as the reference does
    nan_snap = port["gen_cluster"](40, seed=1, constraints=True, device="cpu")
    nan_snap.disk_io[3] = float("nan")
    nan_pods = port["gen_pods"](24, seed=2, constraints=True, device="cpu")
    c1_kw = dict(fused=False, normalizer="min_max", assigner="greedy", affinity_aware=False)
    cpu_out = port["TorchEngine"](device="cpu").schedule_batch(nan_snap, nan_pods, **c1_kw)
    gpu_out = port["TorchEngine"]().schedule_batch(nan_snap, nan_pods, **c1_kw)
    check_equal(torch, "C1 cluster, greedy with NaN scores (card vs CPU path)",
                type(gpu_out)(*[f.cpu() for f in gpu_out]), cpu_out)
    if int(gpu_out.n_assigned) != 24:
        fail(f"C1 cluster placed {int(gpu_out.n_assigned)} of 24 pods")
    emit({"phase": "card_vs_cpu_c1_nan_greedy", "nodes": 40, "pods": 24,
          "n_assigned": int(gpu_out.n_assigned), "equal": True})
    cpu_engine, card_engine = port["TorchEngine"](device="cpu"), port["TorchEngine"]()
    families: dict = {}
    for family, case, snap, pods, kw in option_cases(port):
        cpu = cpu_engine.schedule_batch(snap, pods, **kw)
        card = card_engine.schedule_batch(snap, pods, **kw)
        card = type(card)(*[f.cpu() for f in card])
        if not torch.equal(card.feasible, cpu.feasible):
            fail(f"card vs CPU path, {family} {case}: the masks differ")
        tol = score_tolerance(snap, pods, cpu.scores, cpu.feasible, kw)
        feas = cpu.feasible.numpy()
        err = np.abs(_np(card.scores) - _np(cpu.scores))[feas]
        if not (err <= tol[feas]).all():
            fail(f"card vs CPU path, {family} {case}: scores differ by {err.max()}")
        verdict = decisions_match(torch, port, card, cpu, pods, kw["assigner"])
        if not verdict:
            fail(f"card vs CPU path, {family} {case}: the decisions differ")
        families.setdefault(family, []).append(
            [case, verdict, float(err.max()) if err.size else 0.0,
             float((err / np.maximum(tol[feas], 1e-300)).max()) if err.size else 0.0])
    for family, rows in families.items():
        emit({"phase": f"card_vs_cpu_{family}", "cases": len(rows),
              "equal": sum(r[1] == "equal" for r in rows),
              "near_tie": sum(r[1] == "near-tie" for r in rows),
              "largest_err_over_tolerance": max(r[3] for r in rows),
              "rows": [[r[0], r[1], r[2]] for r in rows]})


def timed_backlog(torch, port, run, n_timed: int = 3):
    """(wall ms of n_timed runs, launches of the first, its result): the
    launch counts are reset just before the first run and read just
    after it."""
    torch.cuda.synchronize()
    port["fused"].reset_launches()
    runs, out = wall_ms(torch, run, n=1)
    launches = dict(port["fused"].launches)
    if n_timed > 1:
        more, _ = wall_ms(torch, run, n=n_timed - 1)
        runs += more
    return runs, launches, out


def expect_launches(name: str, launches: dict, want: dict) -> None:
    """Fail unless every kernel in `want` launched exactly so often (None:
    at least once)."""
    for kernel, n in want.items():
        got = launches[kernel]
        if (n is None and got <= 0) or (n is not None and got != n):
            fail(f"{name} launched {launches}, expected {want} (None: at least once)")


def run_multi_scorer(torch, port, dev) -> dict:
    """Phase 8: the weighted multi-scorer backlog (the reference bench's
    production score: gen_cluster(10_000, images=True), the first 8 x
    1,024 of gen_pods(16_384, images=True)), the bench's own call (the
    auction, affinity_aware=True) and affinity_aware=False on both
    assigners (K3 every round, K4 once a window); each equal to its plain
    run. Returns the affinity_aware=False runs' launch counts."""
    engine = port["TorchEngine"]()
    snap = port["gen_cluster"](10_000, seed=0, images=True, device=dev)
    pods = port["gen_pods"](16_384, seed=1, images=True, device=dev)
    backlog = type(pods)(*[f[: WINDOW * N_WINDOWS] for f in pods])
    pods_w = port["stack_windows"](backlog, WINDOW)
    n_nodes, n_pods = snap.allocatable.shape[0], WINDOW * N_WINDOWS
    none = {"masked_score": 0, "row_stats": 0}
    expected = {
        "auction_affinity": dict(none, auction_bid=0, greedy_scan=0),
        "auction": dict(none, auction_bid=None, greedy_scan=0),
        "greedy": dict(none, auction_bid=0, greedy_scan=N_WINDOWS),
    }
    out_launches = {}
    for name, kw in MULTI_KW.items():
        run = lambda: engine.schedule_windows(snap, pods_w, **kw)  # noqa: E731
        runs, launches, out = timed_backlog(torch, port, run)
        plain, rounds = count_rounds(
            port, lambda: engine.schedule_windows(snap, pods_w, **kw, _plain=True))
        check_equal(torch, f"multi-scorer {name} backlog (vs the plain path)", out, plain)
        expect_launches(f"multi-scorer {name} backlog", launches, expected[name])
        assigned = check_backlog(torch, f"multi-scorer {name} backlog", out, N_WINDOWS,
                                 n_nodes, 0.5)
        backlog_ms = statistics.median(runs)
        emit({"phase": f"multi_scorer_{name}_schedule_windows",
              "plugins": kw["score_plugins"], "affinity_aware": kw["affinity_aware"],
              "windows": N_WINDOWS, "window": WINDOW, "nodes": n_nodes,
              "backlog_ms": backlog_ms, "backlog_ms_runs": runs,
              "pods_per_s": n_pods / (backlog_ms / 1e3), "n_assigned": assigned,
              "auction_rounds_per_window": (rounds / N_WINDOWS
                                            if kw["assigner"] == "auction" else None),
              "launches": launches, "equal_to_plain": True})
        if name == "auction_affinity":
            emit({"phase": "profile_multi_scorer_auction_affinity_schedule_windows",
                  **device_profile(torch, run, backlog_ms)})
        out_launches[name] = launches
    return out_launches


def run_policies(torch, port, snap, window) -> None:
    """Phase 9: one gpu-10kx10k window on the composed path
    (affinity_aware=False): every policy with min-max on the auction, and
    softmax and no normalizer on balanced_cpu_diskio and least_allocated
    on both assigners; each equal to its plain run, masks and scores
    included."""
    engine = port["TorchEngine"]()
    cases = [(p, "min_max", "auction") for p in port["POLICIES"]] + [
        (p, nz, a) for p in ("balanced_cpu_diskio", "least_allocated")
        for nz in ("softmax", "none") for a in ("greedy", "auction")]
    for policy, normalizer, assigner in cases:
        kw = dict(policy=policy, normalizer=normalizer, assigner=assigner, fused=False,
                  affinity_aware=False)
        what = f"{policy} {normalizer} {assigner} cycle"
        run = lambda: engine.schedule_batch(snap, window, **kw)  # noqa: E731
        runs, launches, res = timed_backlog(torch, port, run)
        plain = engine.schedule_batch(snap, window, **kw, _plain=True)
        check_equal(torch, f"{what} (vs the plain path)", res, plain)
        if not (same(torch, res.scores, plain.scores)
                and same(torch, res.feasible, plain.feasible)):
            fail(f"{what}: scores or masks differ from the plain path")
        expect_launches(what, launches, {
            "masked_score": 0, "row_stats": 0,
            "auction_bid": None if assigner == "auction" else 0,
            "greedy_scan": 1 if assigner == "greedy" else 0})
        emit({"phase": "policy_cycle", "policy": policy, "normalizer": normalizer,
              "assigner": assigner, "pods": WINDOW, "nodes": snap.allocatable.shape[0],
              "cycle_ms": statistics.median(runs), "cycle_ms_runs": runs,
              "n_assigned": int(res.n_assigned), "launches": launches,
              "equal_to_plain": True})
        del res, plain


def run_soft(torch, port, dev) -> None:
    """Phase 10: soft=True on constraints-5kx5k with soft_terms(seed 0),
    kernel path, min-max, affinity_aware=True, both assigners, 5 x 1,024
    pods: each equal to its plain run, no hard-constraint break, and
    placing some pods elsewhere than soft=False; then the soft term's
    device time on one window, and its device ops under torch.profiler."""
    engine = port["TorchEngine"]()
    snap, pods = port["gen_config"]("constraints-5kx5k", seed=0, device=dev)
    snap, pods = soft_terms(snap, pods, seed=0)
    padded = port["pad_pod_batch"](pods, AFFINITY_WINDOWS * WINDOW)
    pods_w = port["stack_windows"](padded, WINDOW)
    n_nodes = snap.allocatable.shape[0]
    for name, base in AFFINITY_KW.items():
        kw = dict(base, soft=True)
        run = lambda: engine.schedule_windows(snap, pods_w, **kw)  # noqa: E731
        runs, launches, out = timed_backlog(torch, port, run)
        check_equal(torch, f"soft {name} backlog (vs the plain path)", out,
                    engine.schedule_windows(snap, pods_w, **kw, _plain=True))
        expect_launches(f"soft {name} backlog", launches, {
            "masked_score": AFFINITY_WINDOWS, "row_stats": AFFINITY_WINDOWS,
            "auction_bid": 0, "greedy_scan": 0})
        assigned = check_backlog(torch, f"soft {name} backlog", out, AFFINITY_WINDOWS,
                                 n_nodes, 0.5)
        viol = final_violations(torch, snap, padded, out.node_idx)
        if any(v for k, v in viol.items() if k != "placed_checked"):
            fail(f"soft {name} backlog breaks hard constraints: {viol}")
        hard_only = engine.schedule_windows(snap, pods_w, **base)
        moved = int((hard_only.node_idx != out.node_idx).sum())
        if moved <= 0:
            fail(f"soft {name} backlog placed every pod as soft=False does")
        backlog_ms = statistics.median(runs)
        emit({"phase": f"soft_{name}_schedule_windows", "config": "constraints-5kx5k",
              "windows": AFFINITY_WINDOWS, "window": WINDOW, "nodes": n_nodes,
              "backlog_ms": backlog_ms, "backlog_ms_runs": runs,
              "pods_per_s": AFFINITY_WINDOWS * WINDOW / (backlog_ms / 1e3),
              "n_assigned": assigned, "moved_by_soft": moved, "violations": viol,
              "launches": launches, "equal_to_plain": True})
    window = type(padded)(*[f[:WINDOW] for f in padded])
    soft_fn = lambda: port["compute_soft_scores"](snap, window)  # noqa: E731
    ms, held = device_ms(torch, soft_fn, n=10)
    call_ms = cuda_ms(torch, soft_fn, n=10)
    emit({"phase": "soft_term_device_ms", "pods": WINDOW, "nodes": n_nodes,
          "selectors": int(snap.domain_counts.shape[1]), "device_ms_per_window": ms,
          "device_held": held, "call_ms": call_ms})
    emit({"phase": "profile_soft_term", **device_profile(torch, soft_fn, call_ms)})


def run_wide(torch, port, dev) -> None:
    """Phase 11: 40 selectors (above MAX_FUSED_SELECTORS) on 5,000 nodes
    and 5,000 pods padded to 5 x 1,024, both assigners, kernel path with
    min-max: affinity_aware=False (K1 without selector rows, the
    count-based families outside it) and affinity_aware=True; each equal
    to its plain run, the affinity_aware=True runs without a
    hard-constraint break."""
    engine = port["TorchEngine"]()
    feats = dict(constraints=True, n_selectors=40)
    snap = port["gen_cluster"](5_000, seed=0, device=dev, **feats)
    pods = port["gen_pods"](5_000, seed=1, device=dev, **feats)
    padded = port["pad_pod_batch"](pods, AFFINITY_WINDOWS * WINDOW)
    pods_w = port["stack_windows"](padded, WINDOW)
    n_nodes = snap.allocatable.shape[0]
    for assigner in ("greedy", "auction"):
        for aa in (False, True):
            kw = dict(SLICE_KW, assigner=assigner, affinity_aware=aa)
            what = f"S=40 {assigner} affinity_aware={aa} backlog"
            run = lambda: engine.schedule_windows(snap, pods_w, **kw)  # noqa: E731
            runs, launches, out = timed_backlog(torch, port, run, n_timed=1)
            check_equal(torch, f"{what} (vs the plain path)", out,
                        engine.schedule_windows(snap, pods_w, **kw, _plain=True))
            expect_launches(what, launches, {
                "masked_score": AFFINITY_WINDOWS, "row_stats": AFFINITY_WINDOWS,
                "auction_bid": None if (assigner == "auction" and not aa) else 0,
                "greedy_scan": AFFINITY_WINDOWS if (assigner == "greedy" and not aa) else 0})
            assigned = check_backlog(torch, what, out, AFFINITY_WINDOWS, n_nodes, 0.5)
            viol = final_violations(torch, snap, padded, out.node_idx)
            if aa and any(v for k, v in viol.items() if k != "placed_checked"):
                fail(f"{what} breaks hard constraints: {viol}")
            emit({"phase": "wide_selectors_schedule_windows", "assigner": assigner,
                  "affinity_aware": aa, "selectors": int(snap.domain_counts.shape[1]),
                  "windows": AFFINITY_WINDOWS, "window": WINDOW, "nodes": n_nodes,
                  "backlog_ms": runs[0], "n_assigned": assigned, "violations": viol,
                  "launches": launches, "equal_to_plain": True})


def snapshot_delta_np(port, prev, new):
    """The SnapshotDelta from host snapshot `prev` to `new` (numpy leaves),
    built as the reference's host builds it (host/snapshot.py:252-323):
    changed rows of `requested`, of the five utilization series and of
    the four domain tables, by value, each row vector bucket-padded with
    the sentinel n to a power of two of at least 8; the node mask whole."""
    n = new.node_mask.shape[0]

    def changed(names, axis_any):
        diff = np.zeros(n, bool)
        for name in names:
            d = getattr(prev, name) != getattr(new, name)
            diff |= d.any(1) if axis_any else d
        return np.flatnonzero(diff)

    def padded(rows, vals):
        k = 8
        while k < len(rows):
            k *= 2
        out_rows = np.full(k, n, np.int32)
        out_rows[: len(rows)] = rows
        out_vals = np.zeros((k,) + vals.shape[1:], np.float32)
        out_vals[: len(rows)] = vals
        return out_rows, out_vals

    util, dom = port["UTIL_SERIES"], port["DOMAIN_TABLES"]
    req = changed(("requested",), True)
    req_rows, req_vals = padded(req, new.requested[req])
    u = changed(util, False)
    util_rows, util_vals = padded(u, np.stack([getattr(new, f)[u] for f in util], -1))
    d = changed(dom, True)
    dom_rows, dom_vals = padded(d, np.stack([getattr(new, f)[d] for f in dom], -1))
    return port["SnapshotDelta"](req_rows, req_vals, util_rows, util_vals, dom_rows,
                                 dom_vals, new.node_mask.copy())


def next_host_snapshot(prev, free_after, rng):
    """The next cycle's host build after a cycle whose result left
    `free_after` [n, r] (on the card): the nodes it placed pods on get
    requested = allocatable - free_after, a seeded 10% of the nodes new
    utilization (each series scaled by 0.8-1.2), and two nodes flip their
    mask."""
    new = {f: getattr(prev, f).copy() for f in prev._fields}
    alloc = prev.allocatable
    free = free_after.cpu().numpy()
    was = np.where(prev.node_mask[:, None], alloc - prev.requested, 0.0)
    placed = np.flatnonzero((free != was).any(1))
    new["requested"][placed] = alloc[placed] - free[placed]
    n = alloc.shape[0]
    moved = rng.choice(n, n // 10, replace=False)
    for name in ("disk_io", "cpu_pct", "mem_pct", "net_up", "net_down"):
        new[name][moved] = (new[name][moved] * rng.uniform(0.8, 1.2, moved.size)).astype(
            np.float32)
    new["node_mask"][rng.choice(n, 2, replace=False)] ^= True
    return type(prev)(**new), placed.size


def profiled_h2d_bytes(torch, step):
    """(bytes, copies, memcpy names) of the host-to-device memcpy events
    in torch.profiler's Chrome trace (their `bytes` argument) of the
    second of two calls of `step`: the first is the profiler's warm-up
    step, since a session can miss the device records of its first
    activity; bytes is None when the trace has no such event."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile, schedule

    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1),
                     on_trace_ready=lambda prof: prof.export_chrome_trace(str(path))) as prof:
            for _ in range(2):
                step()
                torch.cuda.synchronize()
                prof.step()
        events = json.loads(path.read_text()).get("traceEvents", [])
    names = sorted({str(e.get("name")) for e in events if "Memcpy" in str(e.get("name", ""))})
    copies = [e for e in events if "HtoD" in str(e.get("name", ""))
              and e.get("ph") == "X" and "bytes" in e.get("args", {})]
    if not copies:
        return None, 0, names
    return sum(int(e["args"]["bytes"]) for e in copies), len(copies), names


def same_tuple(torch, a, b) -> bool:
    return all(same(torch, x, y) for x, y in zip(a, b))


def run_resident(torch, port, snap, pods) -> dict:
    """Phase 12: resident cluster state at gpu-10kx10k through TorchEngine()
    at the main path's options, on the auction and then on greedy: a
    full upload, then 8 delta cycles of one 1,024-pod window each (the
    8 x 1,024-pod backlog of phase 4), each delta built here in numpy
    from the previous cycle's placements, a seeded 10% of the nodes'
    utilization and two node-mask flips. Every delta cycle is bitwise a
    fresh engine's full-upload schedule_batch (scores and masks
    included); after each delta the retained snapshot and layout are
    bitwise a fresh upload's and build_fused_layout's; the fold (the
    engine's resident front half, on a second engine that follows the
    same epochs) runs under torch.cuda.set_sync_debug_mode("error").
    Then an epoch gap and invalidate_resident flush to full uploads,
    schedule_windows_resident over the backlog equals schedule_windows,
    and schedule_batch_fleet with two elements equals two schedule_batch
    calls. Host-to-device bytes per cycle come from the port's upload
    points (device.transfers), cross-checked with torch.profiler on one
    delta cycle; wall ms per cycle against a full-upload cycle of the
    same window on a second long-lived engine (its uniform-leaf cache as
    warm as the resident engine's) that uploads the snapshot in full every
    cycle. The kernel launches are counted per run, set to 0 just before
    each delta cycle, the resident backlog and the fleet call and read just
    after: one K1, K2 and K4 (greedy) or at least one K3 (auction) a delta
    cycle, 8 of each for the backlog, 2 for the fleet. Returns those
    counts, per path and run."""
    TorchEngine, transfers = port["TorchEngine"], port["transfers"]
    nbytes_of = port["snapshot_nbytes"]
    fused = port["fused"]
    host0 = type(snap)(*[t.cpu().numpy() for t in snap])
    backlog = type(pods)(*[f[: WINDOW * N_WINDOWS].cpu().numpy() for f in pods])
    windows = [type(pods)(*[f[c * WINDOW:(c + 1) * WINDOW] for f in backlog])
               for c in range(N_WINDOWS)]
    n_nodes = host0.allocatable.shape[0]
    launches = {}

    def counted(what, run, calls, auction):
        """(run(), its launches, its wall ms): the launch counts set to 0
        just before the run and read just after it. Fails unless K1 and
        K2 launched `calls` times each, and the path's assigner kernel as
        often (K4) or at least as often (K3, one launch a round)."""
        torch.cuda.synchronize()
        fused.reset_launches()
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        got = dict(fused.launches)
        expect_launches(what, got, {
            "masked_score": calls, "row_stats": calls,
            "auction_bid": None if auction else 0, "greedy_scan": 0 if auction else calls})
        if auction and got["auction_bid"] < calls:
            fail(f"{what}: K3 launched {got['auction_bid']} times, fewer than {calls} cycles")
        return out, got, ms

    for name, kw in (("auction", SLICE_KW), ("greedy", GREEDY_KW)):
        rng = np.random.default_rng(12)
        # `full` uploads the snapshot in full every cycle (no delta): the
        # baseline, with a uniform-leaf cache as warm as the resident engine's
        engine, audit, full = TorchEngine(), TorchEngine(), TorchEngine()
        prev, epoch = host0, 1
        res = engine.schedule_resident(prev, windows[0], epoch=epoch, **kw)
        full.schedule_resident(prev, windows[0], epoch=epoch, **kw)
        audit._resident_dispatch(prev, None, epoch, dict(kw))
        if engine.resident_used_delta:
            fail(f"resident {name}: the first call did not upload in full")
        delta_launches = dict.fromkeys(fused.launches, 0)
        delta_ms, full_ms, delta_bytes, full_bytes, bound_bytes, placed = [], [], [], [], [], []
        for c in range(N_WINDOWS):
            new, n_placed = next_host_snapshot(prev, res.free_after, rng)
            delta = snapshot_delta_np(port, prev, new)
            epoch += 1
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                st, _ = audit._resident_dispatch(new, delta, epoch, dict(kw))
            except RuntimeError as e:
                fail(f"resident {name}: the delta fold synchronised with the host: {e}")
            finally:
                torch.cuda.set_sync_debug_mode(0)
            if not audit.resident_used_delta:
                fail(f"resident {name}: the audit engine did not fold delta {c}")
            port["reset_transfers"]()
            res, got, ms = counted(
                f"resident {name} delta cycle {c}",
                lambda: engine.schedule_resident(new, windows[c], delta=delta, epoch=epoch,
                                                 **kw), 1, name == "auction")
            delta_ms.append(ms)
            delta_bytes.append(transfers["h2d_bytes"])
            for k, v in got.items():
                delta_launches[k] += v
            bound_bytes.append(nbytes_of(delta) + nbytes_of(windows[c]))
            placed.append(n_placed)
            if not engine.resident_used_delta:
                fail(f"resident {name}: delta cycle {c} uploaded in full")
            # a full-upload cycle of the same window, timed the same way
            port["reset_transfers"]()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            want = full.schedule_resident(new, windows[c], epoch=epoch, **kw)
            torch.cuda.synchronize()
            full_ms.append((time.perf_counter() - t0) * 1e3)
            full_bytes.append(transfers["h2d_bytes"])
            if full.resident_used_delta:
                fail(f"resident {name}: the baseline engine folded a delta")
            fresh = TorchEngine().schedule_batch(new, windows[c], **kw)
            if not (same_tuple(torch, res, fresh) and same_tuple(torch, want, fresh)):
                fail(f"resident {name}: delta cycle {c} differs from a full upload")
            if delta_bytes[-1] > bound_bytes[-1]:
                fail(f"resident {name}: delta cycle {c} moved {delta_bytes[-1]} B to the "
                     f"card, above the delta's and window's {bound_bytes[-1]} B")
            upload = port["make_snapshot"](**new._asdict(), device=snap.node_mask.device)
            layout = port["build_fused_layout"](upload)
            for eng in (engine, audit):
                st = eng._resident
                if not (same_tuple(torch, st.snapshot, upload)
                        and same_tuple(torch, st.layout, layout)):
                    fail(f"resident {name}: the retained state after delta {c} differs "
                         f"from a fresh upload and build_fused_layout")
            prev = new
        # torch.profiler's view of a delta cycle's host-to-device copies: two
        # more delta cycles, the first the profiler's warm-up; each takes
        # another window than the cycle before it, so its leaves cross too
        state = {"prev": prev, "epoch": epoch, "res": res}

        def delta_cycle():
            new, _ = next_host_snapshot(state["prev"], state["res"].free_after, rng)
            delta = snapshot_delta_np(port, state["prev"], new)
            state["epoch"] += 1
            window = windows[state["epoch"] % N_WINDOWS]
            port["reset_transfers"]()
            state["res"] = engine.schedule_resident(new, window, delta=delta,
                                                    epoch=state["epoch"], **kw)
            state["prev"], state["bound"] = new, nbytes_of(delta) + nbytes_of(window)

        prof_bytes, prof_copies, memcpy_names = profiled_h2d_bytes(torch, delta_cycle)
        counted_bytes = transfers["h2d_bytes"]
        prev, epoch, res = state["prev"], state["epoch"], state["res"]
        if prof_bytes != counted_bytes:
            fail(f"resident {name}: the profiler saw {prof_bytes} B host-to-device in a "
                 f"delta cycle ({memcpy_names}), the upload points counted {counted_bytes} B")
        if counted_bytes > state["bound"]:
            fail(f"resident {name}: a profiled delta cycle moved {counted_bytes} B to the "
                 f"card, above the delta's and window's {state['bound']} B")
        # an epoch gap flushes to a full upload, and so does invalidate_resident
        trail = []
        for step in ("gap", "invalidate"):
            new, _ = next_host_snapshot(prev, res.free_after, rng)
            delta = snapshot_delta_np(port, prev, new)
            epoch += 2 if step == "gap" else 1
            if step == "invalidate":
                engine.invalidate_resident()
            res = engine.schedule_resident(new, windows[1], delta=delta, epoch=epoch, **kw)
            trail.append(engine.resident_used_delta)
            if not same_tuple(torch, res, TorchEngine().schedule_batch(new, windows[1], **kw)):
                fail(f"resident {name}: the {step} flush differs from a full upload")
            prev = new
        if any(trail):
            fail(f"resident {name}: an epoch gap or invalidate_resident folded a delta")
        # the resident backlog, then a fleet dispatch of two elements
        new, _ = next_host_snapshot(prev, res.free_after, rng)
        delta = snapshot_delta_np(port, prev, new)
        epoch += 1
        pods_w = port["stack_windows"](backlog, WINDOW)
        out, backlog_launches, backlog_ms = counted(
            f"resident {name} backlog",
            lambda: engine.schedule_windows_resident(new, pods_w, delta=delta, epoch=epoch,
                                                     **kw), N_WINDOWS, name == "auction")
        if not (engine.resident_used_delta and same_tuple(
                torch, out, TorchEngine().schedule_windows(new, pods_w, **kw))):
            fail(f"resident {name}: schedule_windows_resident differs from schedule_windows")
        upload = port["make_snapshot"](**new._asdict(), device=snap.node_mask.device)
        if not same_tuple(torch, engine._resident.snapshot, upload):
            fail(f"resident {name}: the backlog wrote into the retained snapshot")
        other, _ = next_host_snapshot(new, out.free_after, rng)
        el_delta = snapshot_delta_np(port, new, other)
        got, fleet_launches, _ = counted(
            f"resident {name} fleet call",
            lambda: engine.schedule_batch_fleet(
                new, ((None, windows[2]), (el_delta, windows[3])), **kw), 2, name == "auction")
        want = (TorchEngine().schedule_batch(new, windows[2], **kw),
                TorchEngine().schedule_batch(other, windows[3], **kw))
        if not all(same_tuple(torch, g, w) for g, w in zip(got, want)):
            fail(f"resident {name}: schedule_batch_fleet differs from schedule_batch")
        launches[name] = {"delta_cycles": delta_launches, "backlog": backlog_launches,
                          "fleet": fleet_launches}
        emit({"phase": f"resident_{name}", "config": "gpu-10kx10k", "nodes": n_nodes,
              "window": WINDOW, "delta_cycles": N_WINDOWS,
              "delta_cycle_ms": statistics.median(delta_ms), "delta_cycle_ms_runs": delta_ms,
              "full_upload_cycle_ms": statistics.median(full_ms),
              "full_upload_cycle_ms_runs": full_ms,
              "h2d_bytes_delta_cycle": statistics.median(delta_bytes),
              "h2d_bytes_delta_cycle_runs": delta_bytes,
              "h2d_bytes_full_upload_cycle": statistics.median(full_bytes),
              "bytes_bound_delta_plus_window": bound_bytes,
              "snapshot_nbytes": nbytes_of(host0), "window_nbytes": nbytes_of(windows[0]),
              "nodes_placed_per_cycle": placed,
              "profiled_h2d_bytes_delta_cycle": prof_bytes,
              "profiled_h2d_copies": prof_copies,
              "counted_h2d_bytes_same_cycle": counted_bytes,
              "profiled_memcpy_names": memcpy_names,
              "flush_trail": trail, "resident_backlog_ms": backlog_ms,
              "launches": launches[name], "fold_host_syncs_detected": 0,
              "equal_to_full_upload": True})
    return launches


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent-tree", default=None,
                    help="a checkout of an earlier commit (e09185f or later): time its "
                         "K1, K2 and K4 beside this tree's")
    args = ap.parse_args()
    try:
        import torch
    except ImportError as e:
        fail(f"torch is not importable: {e}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this run needs a CUDA card")
    try:
        from kubernetes_scheduler_tpu_torch import TorchEngine, stack_windows
        from kubernetes_scheduler_tpu_torch.device import reset_transfers, transfers
        from kubernetes_scheduler_tpu_torch.engine import (
            DOMAIN_TABLES,
            NORMALIZERS,
            POLICIES,
            UTIL_SERIES,
            SnapshotDelta,
            build_fused_layout,
            compute_free_capacity,
            compute_soft_scores,
            fused_score_operands,
            make_affinity_state,
            make_snapshot,
            snapshot_nbytes,
        )
        from kubernetes_scheduler_tpu_torch.ops import _build, assign, fused
        from kubernetes_scheduler_tpu_torch.ops.assign import (
            NEG,
            auction_values,
            greedy_scan_operands,
        )
        from kubernetes_scheduler_tpu_torch.ops.score import alpha_beta
        from kubernetes_scheduler_tpu_torch.sim import gen_cluster, gen_config, gen_pods
        from kubernetes_scheduler_tpu_torch.utils.padding import pad_pod_batch
    except ImportError as e:
        fail(f"the port is not importable (run from the repository root): {e}")
    if "jax" in sys.modules:
        fail("jax was imported")
    port = dict(
        TorchEngine=TorchEngine, stack_windows=stack_windows, fused=fused,
        compute_free_capacity=compute_free_capacity, NEG=NEG,
        fused_score_operands=fused_score_operands, auction_values=auction_values,
        alpha_beta=alpha_beta, gen_cluster=gen_cluster, gen_pods=gen_pods,
        gen_config=gen_config, greedy_scan_operands=greedy_scan_operands,
        assign=assign, pad_pod_batch=pad_pod_batch,
        make_affinity_state=make_affinity_state, POLICIES=POLICIES,
        NORMALIZERS=NORMALIZERS, compute_soft_scores=compute_soft_scores,
        UTIL_SERIES=UTIL_SERIES, DOMAIN_TABLES=DOMAIN_TABLES, SnapshotDelta=SnapshotDelta,
        snapshot_nbytes=snapshot_nbytes, make_snapshot=make_snapshot,
        build_fused_layout=build_fused_layout, transfers=transfers,
        reset_transfers=reset_transfers,
    )

    # ---- 1. device -------------------------------------------------------
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    print(f"device: {kind} (count {count}); torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)  # name, power limit
    dev = torch.device("cuda", 0)
    # the soft term's matrix products must run in full float32 (integer
    # weights are then exact, so the card equals the CPU)
    if torch.backends.cuda.matmul.allow_tf32 or torch.get_float32_matmul_precision() != "highest":
        fail("TF32 is enabled for float32 matrix products")

    # ---- 2. build --------------------------------------------------------
    t0 = time.perf_counter()
    lib_path, log = _build.build()
    _build.load_library()
    print(f"build: {lib_path.name} in {time.perf_counter() - t0:.3f} s", flush=True)
    for ln in log.splitlines():
        if "registers" in ln or "spill" in ln or "Compiling entry" in ln:
            print(f"  {ln.strip()}", flush=True)

    # ---- 3. kernels against their plain versions ------------------------
    snap, pods = gen_config("gpu-10kx10k", seed=0, device=dev)
    window = type(pods)(*[f[:WINDOW] for f in pods])
    sel_snap = gen_cluster(10_000, seed=0, constraints=True, device=dev)
    sel_pods = gen_pods(WINDOW, seed=1, constraints=True, device=dev)
    parent = None
    if args.parent_tree is not None:
        t0 = time.perf_counter()
        parent = load_parent(_build, args.parent_tree)
        print(f"parent build: {args.parent_tree} in {time.perf_counter() - t0:.3f} s",
              flush=True)
    results = check_kernels(torch, port, snap, window, sel_snap, sel_pods, parent)

    # ---- 4. the auction slice through TorchEngine -----------------------
    launches = {"auction": run_slice(torch, port, snap, pods, window)}

    # ---- 5. the greedy backlog ------------------------------------------
    launches["greedy"] = run_greedy(torch, port, snap, pods)

    # ---- 6. the affinity paths on constraints-5kx5k ---------------------
    run_affinity(torch, port, dev)
    check_greedy_host_reads(torch, port, dev)

    # ---- 7. the new options, card vs the port's CPU path ----------------
    t0 = time.perf_counter()
    run_card_vs_cpu(torch, port)
    emit({"phase": "card_vs_cpu_seconds", "seconds": time.perf_counter() - t0})

    # ---- 8. the weighted multi-scorer backlog ---------------------------
    t0 = time.perf_counter()
    multi = run_multi_scorer(torch, port, dev)
    emit({"phase": "multi_scorer_seconds", "seconds": time.perf_counter() - t0})

    # ---- 9. every policy and normalizer on one gpu-10kx10k window -------
    t0 = time.perf_counter()
    run_policies(torch, port, snap, window)
    emit({"phase": "policies_seconds", "seconds": time.perf_counter() - t0})

    # ---- 10. soft scores on constraints-5kx5k ---------------------------
    t0 = time.perf_counter()
    run_soft(torch, port, dev)
    emit({"phase": "soft_seconds", "seconds": time.perf_counter() - t0})

    # ---- 11. 40 selectors ------------------------------------------------
    t0 = time.perf_counter()
    run_wide(torch, port, dev)
    emit({"phase": "wide_selectors_seconds", "seconds": time.perf_counter() - t0})

    # ---- 12. resident cluster state ---------------------------------------
    t0 = time.perf_counter()
    resident = run_resident(torch, port, snap, pods)
    emit({"phase": "resident_seconds", "seconds": time.perf_counter() - t0})

    # ---- 13. the kernels line and the result ----------------------------
    kernels = []
    for name, lines in results.items():
        main_line = next(x for x in lines if x["case"] == MAIN_CASE[name])
        kernels.append({
            "name": name, "route": "cuda",
            "source": "kubernetes_scheduler_tpu_torch/csrc/fused.cu",
            "replaces": REPLACES[name],
            "launches": launches[MAIN_PATH[name]][name],
            "max_abs_err": max(x["max_abs_err"] for x in lines),
            "ms": main_line["kernel_ms"], "plain_ms": main_line["plain_ms"],
            "bound_ms": main_line["bound_us"] / 1e3,
            "bound_by": main_line["bound_by"], "library_ms": None,
            "parity": "bitwise", "case": MAIN_CASE[name],
            "main_path": f"{MAIN_PATH[name]} backlog",
            "multi_scorer_launches": {k: v[name] for k, v in multi.items()},
            "resident_launches": {path: {run: counts[name] for run, counts in runs.items()}
                                  for path, runs in resident.items()},
        })
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}})


if __name__ == "__main__":
    main()
