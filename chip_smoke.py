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
   lists, lists that run out at a tie boundary, and a negative request that trips its exactness guard, each
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
   greedy, and both assigners with affinity;
8. the kernels line, then the result line.

Needs torch with CUDA, and nothing of JAX.

    python3 chip_smoke.py --parent-tree DIR

also builds the csrc/fused.cu of DIR, a checkout of commit e09185f (the K1
and K2 kernels before their redesign), with the same flags into DIR, and
times its K1 and K2 beside this tree's on every K1 and K2 case of phase 3,
in turns (parent, this tree, this tree, parent): `parent_ms`. Each line
says whether the parent equalled the plain version (`parent_bitwise`; the
parent's K2 drops a NaN).
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
SLICE_KW = dict(
    assigner="auction", normalizer="min_max", fused=True, affinity_aware=False
)
GREEDY_KW = dict(SLICE_KW, assigner="greedy")
AFFINITY_KW = {
    "greedy": dict(SLICE_KW, assigner="greedy", affinity_aware=True),
    "auction": dict(SLICE_KW, affinity_aware=True),
}
AFFINITY_WINDOWS = 5   # constraints-5kx5k: 5,000 pods padded to 5 x 1,024
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
    """K1's and K2's launchers of commit e09185f's csrc/fused.cu (the
    kernels before their redesign), built with this tree's flags into that
    tree, with that commit's C interfaces."""
    pkg = Path(tree) / "kubernetes_scheduler_tpu_torch"
    path, _ = build.build(pkg / "csrc" / "fused.cu", pkg / "_build")
    lib = ctypes.CDLL(str(path))
    ptr, num = ctypes.c_void_p, ctypes.c_int
    # alpha, beta, pod_ok, target, u, v, node_mask, pod_req, alloc, reqd,
    # aff_pod, aff_node, other, stats, out, p, n, r, n_sel, stream
    lib.ks_masked_score.argtypes = [ptr] * 15 + [num] * 4 + [ptr]
    # alpha, beta, u, v, node_mask, out, p, n, stream
    lib.ks_row_stats.argtypes = [ptr] * 6 + [num] * 2 + [ptr]
    for fn in (lib.ks_masked_score, lib.ks_row_stats):
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
    # lists, lists that run out at a tie boundary, and a negative request
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
        n_k, rk = k4[0].shape[1], k4[1].shape[1]
        b_ms, b_by = bound(nbytes(*k4, got_p, got_f), p * n_k * (2 + 3 * rk))
        record({
            "kernel": "greedy_scan", "case": tag, "p": p, "n": n_k, "r": rk,
            "list_len": kw.get("_list_len", fused.GREEDY_LIST_LEN), "bitwise": ok,
            "max_abs_err": max(max_abs_err(got_p, want_p), max_abs_err(got_f, want_f)),
            "fallbacks": fallbacks,
            **kernel_times(torch, lambda: fused.greedy_scan(*k4, **kw)),
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


def run_card_vs_cpu(torch, port) -> None:
    """Phase 7: the new options on a small constraints cluster, the card's
    path against the port's CPU path."""
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


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent-tree", default=None,
                    help="a checkout of commit e09185f: time its K1 and K2 beside this tree's")
    args = ap.parse_args()
    try:
        import torch
    except ImportError as e:
        fail(f"torch is not importable: {e}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this run needs a CUDA card")
    try:
        from kubernetes_scheduler_tpu_torch import TorchEngine, stack_windows
        from kubernetes_scheduler_tpu_torch.engine import (
            compute_free_capacity,
            fused_score_operands,
            make_affinity_state,
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
        make_affinity_state=make_affinity_state,
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
    run_card_vs_cpu(torch, port)

    # ---- 8. the kernels line and the result -----------------------------
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
        })
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}})


if __name__ == "__main__":
    main()
