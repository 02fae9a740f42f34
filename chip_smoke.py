#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (kubernetes_scheduler_tpu_torch) on
one CUDA card:  python3 chip_smoke.py

Phases; the first failure exits non-zero and no result line is printed:

1. device: the card's name, and its name and power limit from nvidia-smi;
2. build: compile csrc/fused.cu with nvcc (first use) and load it;
   then the kernel resources (run_kernel_resources): a second build into
   a fresh temporary directory, so ptxas's report is never the empty log
   of a reused library; every kernel and template instantiation's
   registers, static shared memory, stack frame, spill stores, spill
   loads and local memory, held EXACTLY against
   csrc/kernel_budget.json (spills and local memory must be 0); and
   greedy_pass_kernel's dynamic shared memory at the main path's n and r
   beside the card's opt-in limit, with whether the pass runs in shared
   memory there. One `{"phase": "kernel_resources", ...}` line; a reading
   that does not parse, a missing nvcc or a stale budget fails the run;
   then the contracts (run_contracts, phase 2c): layer 2 of the port's
   checker on the card — every engine entry point and the four kernel
   wrappers at the checker's grid and at the main path's width (10,000
   nodes x 1,024 pods x 3 resources, 8 windows), each output's shapes and
   dtypes against the declared spec; the sharded surfaces on a 4-shard
   and a 2 x 2 (dcn, node) mesh of the card at the grid and at full width
   with 2 windows; the collective call sites read on the card equal to
   analysis/COLLECTIVE_BUDGET.json (written on the CPU); the SPMD mutant
   harness on the card. One `{"phase": "contracts", ...}` line with the
   K1-K4 launches of the phase; any violation, or a kernel that never
   launched, fails the run;
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
13. the port's own host loop (host.scheduler.Scheduler on TorchEngine())
   at 10,000 nodes, the bench's loop_rate shape: a warm 8,192-pod backlog
   and 3 measured ones, 8 windows of 1,024 a cycle, the engine path
   pinned and every other option at its default, with resident_state
   False and True: pods/s, cycle p50/p99, engine seconds and
   host-to-device bytes a cycle, K1-K4 launches around each measured
   cycle (8 K1, 8 K2, >= 8 K3 an 8-window cycle); bindings equal to the
   same drain on the kernels' plain versions, no cycle on the scalar
   route; then 1,000 nodes, both assigners, card against CPU bindings;
14. preemption through the host loop at 10,000 nodes full of low-priority
   pods (run_host_preemption): the pass on the card, bitwise its CPU run,
   victims below their preemptors, one proposal a node, its ms, peak
   memory and bytes; then the preemptors bind to their nominated nodes;
15. the flight recorder, spans and the journal-replay gate at 10,000
   nodes (run_journal): the bench's traced shape (8,192 pods, one
   1,024-pod window a cycle, pipeline_depth 1, resident_state on)
   drained untraced and with trace_path and span_path (pods/s of both,
   bindings equal, no record or span dropped); the journal replayed
   through TorchEngine() in all four modes (serial and pipelined, full
   and resident uploads) with 0 binding diffs, every device cycle
   replayed, pods/s per mode; two recorded replays with a zero trace
   diff; phase 13's 8-window cycle recorded as a backlog record and
   replayed; the stage table of the span files (trace.analyze, every
   stage in SHIPPED_SPANS, shares summing to 100); the JAX package's
   committed journals (tests/torch_fixtures, 1,000 nodes) replayed on
   the card: the auction's with 0 diffs, greedy's with 0 or counted
   near-tie flips;
16. the fleet-shared engine and shadow serving (run_fleet_and_shadow):
   ReplicaFleet(n_replicas=4) at 10,000 nodes over 8,192 pods in 8
   namespaces, one window a cycle, pipelined, drained by rounds, on one
   shared TorchEngine and on four private ones: union pod -> node maps
   equal, the pool coalesced (fewer than 4 device dispatches a round),
   uploaded in full once and then by delta or dedup, no double bind,
   pods/s of both; ShadowScheduler on TorchEngine() over phase 15's
   journal with the primary's config (0 divergence, every record
   applied), and a divergent candidate twice (bindings moved, the same
   both times);
17. scenarios (run_scenarios): soak, compound-storm (faults on) and
   replica-conflict-storm (shared engine) at 4,096 nodes, each run twice
   with seed 0 (equal summaries, zero trace diff), each journal
   replayed with 0 diffs, and at 64 nodes the card's journal equal in
   decisions to the port's CPU run; seconds and pods bound of each;
18. the sidecar on the card (run_bridge): the port's gRPC server
   (bridge.server.make_server on cuda) in this process and the port's
   RemoteEngine, on gpu-10kx10k: ScheduleBatch on one window,
   ScheduleWindows on the backlog (auction and greedy), a resident
   session of 8 delta cycles and one Preempt on phase 14's inputs, every
   reply bitwise the in-process TorchEngine's, K1-K4 launches counted
   through the server, Health on the card; RPC ms against the in-process
   call, the server's engine seconds, request bytes (field cache cold and
   warm) and bytes uploaded per RPC;
19. the live-cluster path (run_live_cluster): `scheduler --source kube`
   through the port's CLI against the tests' fake API server with 10,000
   nodes and 8,192 pending pods, once on the in-process engine and once
   through phase 18's sidecar: every pod bound once through the server's
   Binding POSTs, both runs' bindings equal, K1 and K3 launched; wall
   seconds, cycles, pods/s and seconds in the binds' POSTs;
20. the learned two-tower scorer at full width on gpu-10kx10k
   (run_learned): train_steps on the card (TF32 off; the loss falls), a
   checkpoint round trip, the restored engine's auction and greedy
   backlogs with affinity_aware=False equal to their plain runs (K3 once
   a round, K4 once a window, counted), the card against the CPU on four
   small clusters (raw scores within LEARNED_RAW_TOL, which TF32
   products must exceed), the Scheduler with
   policy="learned" on a host-10k backlog, and the sidecar with
   --learned-checkpoint (replies bitwise the in-process engine's); train
   step, forward and backlog ms;
21. the node-sharded engine on one card (run_mesh): meshes of cuda:0
   four times and once, the fused (K1 once per shard per window) and
   composed min-max backlogs for both assigners, resident delta cycles
   with bytes per shard, the learned scorer on the mesh, the Scheduler
   with sharded_engine on a host-10k backlog and a 4-shard sidecar, each
   bitwise the dense engine's; ms beside the dense call's;
22. the (dcn, node) mesh of a slice spanning hosts on one card
   (run_mesh_2d): make_mesh_multihost(2, 2) with node_axes (dcn, node),
   the fused auction and greedy backlogs bitwise the dense engine and
   phase 21's 1-D mesh (K1 once per shard per window, counted), resident
   delta cycles, the learned scorer, the sidecar with --mesh-hosts 2; the
   learned scorer's dp x node training step against the dense step (loss,
   parameters, ms, peak memory);
23. the port's bench (run_bench): bench.main(["--device", "cuda"]) in
   this process, the reference bench's default mode: the deployed-default,
   weighted multi-scorer and headline engine rows at the reference's sizes
   (10,000 nodes with images, 16,384 pods, windows of 512; BENCH_REPS
   timed calls, not 12) and the host-loop block with BENCH_LOOP_CUTS;
   K1-K4's launches and the seconds of each row; the backend line first
   and no other diag, exit 0, the headline last, every row held to the
   reference smoke test's assertions (check_bench_rows); then suite_rate
   over gpu-10kx10k (the greedy oracle launches K4); each engine row's
   first untimed call, and the suite's first auction and greedy call,
   equal to the same call on the plain versions;
24. the kernels line (with the launches of phases 2c and 12-23), then
   the result line.

Phases 7-23 print their seconds. Timed runs are medians of 3; equality
runs are one each (phase 11 reports its one run's time).

Needs torch with CUDA, grpc and protobuf, and nothing of JAX.

    python3 chip_smoke.py --parent-tree DIR

also builds the csrc/fused.cu of DIR, a checkout of an earlier commit
whose K1, K2 and K4 have this tree's C interfaces (e09185f or later),
with the same flags into DIR, and times its K1, K2 and K4 beside this
tree's on every K1, K2 and K4 case of phase 3, in turns (parent, this
tree, this tree, parent): `parent_ms`. Each line says whether the parent
equalled the plain version (`parent_bitwise`; e09185f's K2 drops a NaN,
and up to commit 86ed4fd K4 never takes a NaN cell).

    python3 chip_smoke.py --mesh-cards

needs MESH_SHARDS (4) cards: it builds the kernels and runs phases 20-22
alone, each mesh over the first four cards in place of cuda:0 repeated
(make_mesh(4), make_mesh_multihost(2, 2), the dp x node grid over
cuda:0-3, the sidecars' --device cuda), so every copy between shards
crosses cards; the same checks hold. Its last line is the result line.

    python3 chip_smoke.py --bench

builds the kernels and runs phase 23 alone, with the same checks; its
last line is the result line.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import importlib.util
import io
import json
import os
import shutil
import statistics
import subprocess
import sys
import threading
import time
import urllib.parse
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


# ---- phases 13 and 14: the port's own host loop -----------------------------

HOST_NODES = 10_000        # the north-star cluster (BASELINE.md, 10k nodes)
HOST_BACKLOG = N_WINDOWS * WINDOW
HOST_MEASURED_SEEDS = (2, 3, 4)
HOST_SMALL_NODES = 1_000
HOST_CFG = dict(batch_window=WINDOW, max_windows_per_cycle=N_WINDOWS,
                adaptive_dispatch=False, min_device_work=1)
QUEUE_TICK_S = 30.0        # virtual queue clock per cycle: past max_backoff_seconds
PREEMPTORS = 128           # SchedulerConfig.preemption_max_candidates
VICTIMS_PER_NODE = 4


def engine_variant(port, *, plain=False, record=False):
    """A TorchEngine subclass: with `plain` every schedule call runs the
    kernels' plain versions (`_plain=True`); with `record` it keeps each
    schedule_batch's (pods, result) and the last preempt's inputs and
    result."""
    base = port["TorchEngine"]
    extra = {"_plain": True} if plain else {}

    class Engine(base):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.batches, self.last_preempt = [], None

        def schedule_batch(self, s, p, **kw):
            res = super().schedule_batch(s, p, **kw, **extra)
            if record:
                self.batches.append((p, res))
            return res

        def schedule_windows(self, s, p, **kw):
            return super().schedule_windows(s, p, **kw, **extra)

        def schedule_resident(self, s, p, **kw):
            return super().schedule_resident(s, p, **kw, **extra)

        def schedule_windows_resident(self, s, p, **kw):
            return super().schedule_windows_resident(s, p, **kw, **extra)

        def preempt(self, snapshot, pods, victims, *, k_cap):
            res = super().preempt(snapshot, pods, victims, k_cap=k_cap)
            if record:
                self.last_preempt = ((snapshot, pods, victims), k_cap, res)
            return res

    return Engine


def host_scheduler(port, engine, nodes, advisor, running, cfg, evictor=None):
    """(the port's Scheduler over `nodes`, its virtual queue clock)."""
    clock = [0.0]
    sched = port["Scheduler"](
        port["SchedulerConfig"](**cfg), advisor=advisor, evictor=evictor,
        list_nodes=lambda: nodes, list_running_pods=lambda: running,
        engine=engine, queue_clock=lambda: clock[0])
    return sched, clock


def host_backlog(port, n: int, seed: int) -> list:
    """gen_host_pods(n, seed), names prefixed by the seed (each backlog's
    pods are distinct running pods once bound)."""
    pods = port["gen_host_pods"](n, seed=seed)
    for pod in pods:
        pod.name = f"s{seed}-{pod.name}"
    return pods


def drain_cycles(torch, port, sched, clock, running, max_cycles: int = 16) -> list:
    """Cycles until the queue is empty or a cycle pops nothing, binds fed
    back as running pods and the queue clock advanced past the retry
    backoff after each. The launch counts and device.transfers are set to
    0 just before each cycle and read just after. Returns [(CycleMetrics,
    launches, transfers)] of the cycles that popped pods."""
    out = []
    seen = len(sched.binder.bindings)
    for _ in range(max_cycles):
        if len(sched.queue) == 0 and sched._prefetched is None:
            break
        torch.cuda.synchronize()
        port["fused"].reset_launches()
        port["reset_transfers"]()
        m = sched.run_cycle()
        torch.cuda.synchronize()
        launches = dict(port["fused"].launches)
        io = dict(port["transfers"])
        clock[0] += QUEUE_TICK_S
        for b in sched.binder.bindings[seen:]:
            running.append(b.pod)
        seen = len(sched.binder.bindings)
        if m.pods_in == 0:
            break
        out.append((m, launches, io))
    return out


def check_device_route(what: str, sched, cycles) -> None:
    """Fail unless every cycle ran on the engine: no scalar fallback, the
    engine breaker closed, the engine rung on top."""
    for m, _, _ in cycles:
        if m.used_fallback or m.engine_seconds <= 0:
            fail(f"{what}: a cycle took the scalar route ({m})")
    if (sched.totals["fallback_cycles"] or sched.engine_breaker.state() != "closed"
            or sched.ladder.depth("engine")):
        fail(f"{what}: degraded engine path: totals {sched.totals}, breaker "
             f"{sched.engine_breaker.state()}")


def host_drain(torch, port, engine, nodes, advisor, cfg, seeds, n_pods, profile=False):
    """One Scheduler: a warm backlog (seed 1), then one backlog per seed.
    Returns (scheduler, measured cycles, bindings as (pod, node) names,
    host profile): with `profile`, one more backlog drains under
    cProfile after the measured ones (its binds are not returned), and
    the profile is the port's functions by cumulative host time."""
    running = []
    sched, clock = host_scheduler(port, engine, nodes, advisor, running, cfg)
    for pod in host_backlog(port, n_pods, 1):
        sched.submit(pod)
    drain_cycles(torch, port, sched, clock, running)
    cycles = []
    for seed in seeds:
        for pod in host_backlog(port, n_pods, seed):
            sched.submit(pod)
        cycles += drain_cycles(torch, port, sched, clock, running)
    binds = [(b.pod.name, b.node_name) for b in sched.binder.bindings]
    prof = None
    if profile:
        for pod in host_backlog(port, n_pods, max(seeds, default=1) + 1):
            sched.submit(pod)
        prof = profiled(lambda: drain_cycles(torch, port, sched, clock, running))
    return sched, cycles, binds, prof


def profiled(fn, top: int = 14) -> dict:
    """fn() under cProfile: its wall ms (profiled) and the port's
    functions with the most cumulative host time, [name, ms, calls]."""
    import cProfile
    import pstats

    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    fn()
    prof.disable()
    wall = (time.perf_counter() - t0) * 1e3
    rows = []
    for (path, line, func), (_, calls, _, cum, _) in pstats.Stats(prof).stats.items():
        if "kubernetes_scheduler_tpu_torch" in path and func not in (
                "run_cycle", "_run_cycle_serial", "_maybe_profile", "<lambda>"):
            mod = path.split("kubernetes_scheduler_tpu_torch/")[-1]
            rows.append([f"{mod}:{func}", cum * 1e3, calls])
    rows.sort(key=lambda r: -r[1])
    return {"profiled_wall_ms": wall, "top_cumulative_ms": rows[:top]}


def run_host_loop(torch, port) -> dict:
    """Phase 13: the bench's loop_rate shape through the port's own
    Scheduler at 10,000 nodes (gen_host_cluster(10_000, seed=0)): a warm
    backlog of gen_host_pods(8_192, seed=1), then 3 measured backlogs
    (seeds 2-4), binds fed back as running pods, at batch_window 1,024,
    8 windows a cycle, the engine path pinned (adaptive_dispatch off,
    min_device_work 1) and every other option at its default (auction,
    min-max, fused, the snapshot mirror, preemption), with resident_state
    False and then True. Per run: pods/s, cycle p50/p99 ms, engine
    seconds a cycle, host-to-device bytes a cycle, and K1-K4 launches
    counted around each measured cycle (an 8-window cycle: exactly 8 K1
    and 8 K2, at least 8 K3, no K4; one device-to-host read of the
    result, device.to_host); one more backlog under cProfile for
    the host's breakdown. Every run's bindings equal the same
    drain on an engine running every kernel's plain version, and no cycle
    took the scalar route. Then on 1,000 nodes, 2 x 1,024 pods a window a
    cycle, both assigners: the card's bindings equal the port's CPU
    bindings, or differ first at a greedy near-tie (decisions_match).
    Returns the launches per measured cycle, per run."""
    nodes, advisor = port["gen_host_cluster"](HOST_NODES, seed=0)
    launches = {}
    for resident in (False, True):
        name = "resident" if resident else "full_upload"
        cfg = dict(HOST_CFG, resident_state=resident)
        binds = {}
        for plain in (False, True):
            t0 = time.perf_counter()
            sched, cycles, binds[plain], prof = host_drain(
                torch, port, engine_variant(port, plain=plain)(), nodes, advisor, cfg,
                HOST_MEASURED_SEEDS, HOST_BACKLOG, profile=not plain)
            check_device_route(f"host loop {name}", sched, cycles)
            if plain:
                emit({"phase": f"host_loop_{name}_plain", "seconds": time.perf_counter() - t0,
                      "pods_bound": sum(m.pods_bound for m, _, _ in cycles)})
                continue
            per_cycle = []
            for m, ln, _ in cycles:
                windows = -(-m.pods_in // WINDOW)
                want = {"masked_score": windows, "row_stats": windows,
                        "auction_bid": None, "greedy_scan": 0}
                expect_launches(f"host loop {name} cycle", ln, want)
                if ln["auction_bid"] < windows:
                    fail(f"host loop {name}: {ln['auction_bid']} K3 launches in a "
                         f"{windows}-window cycle")
                per_cycle.append(ln)
            if any(io["d2h_reads"] != 1 for _, _, io in cycles):
                fail(f"host loop {name}: a cycle read results from the card other than "
                     f"once: {[io['d2h_reads'] for _, _, io in cycles]}")
            if not any(-(-m.pods_in // WINDOW) == N_WINDOWS for m, _, _ in cycles):
                fail(f"host loop {name}: no measured cycle ran {N_WINDOWS} windows")
            launches[name] = per_cycle
            lat = [m.cycle_seconds for m, _, _ in cycles]
            eng = [m.engine_seconds for m, _, _ in cycles]
            bound = sum(m.pods_bound for m, _, _ in cycles)
            if bound < len(HOST_MEASURED_SEEDS) * HOST_BACKLOG // 2:
                fail(f"host loop {name}: {bound} pods bound")
            emit({"phase": f"host_loop_{name}", "config": "host-10k", "nodes": HOST_NODES,
                  "backlog": HOST_BACKLOG, "measured_backlogs": len(HOST_MEASURED_SEEDS),
                  "cycles": len(cycles), "pods_bound": bound,
                  "pods_per_s": bound / sum(lat),
                  "cycle_p50_ms": float(np.percentile(lat, 50)) * 1e3,
                  "cycle_p99_ms": float(np.percentile(lat, 99)) * 1e3,
                  "cycle_ms_runs": [x * 1e3 for x in lat],
                  "engine_s_per_cycle": statistics.mean(eng),
                  "engine_s_runs": eng, "engine_share": sum(eng) / sum(lat),
                  "h2d_bytes_per_cycle": [io["h2d_bytes"] for _, _, io in cycles],
                  "h2d_copies_per_cycle": [io["h2d_copies"] for _, _, io in cycles],
                  "pods_in_per_cycle": [m.pods_in for m, _, _ in cycles],
                  "delta_uploads": sched.totals["delta_uploads"],
                  "full_uploads": sched.totals["full_uploads"],
                  "launches_per_cycle": per_cycle,
                  "seconds": time.perf_counter() - t0})
            emit({"phase": f"host_loop_{name}_profile", "backlog": HOST_BACKLOG, **prof})
        if binds[False] != binds[True]:
            first = next(i for i, (a, b) in enumerate(zip(binds[False], binds[True])) if a != b)
            fail(f"host loop {name}: bindings differ from the plain-kernel run "
                 f"({len(binds[False])} vs {len(binds[True])}; first at {first})")
        emit({"phase": f"host_loop_{name}_vs_plain", "bindings": len(binds[False]),
              "equal": True})
    run_host_card_vs_cpu(torch, port)
    return launches


def run_host_card_vs_cpu(torch, port) -> None:
    """Phase 13's small cluster: 1,000 nodes, one backlog of 2 x 1,024
    pods, one window a cycle, both assigners, card against the port's
    CPU path (the CPU tests hold that path against the reference's
    Scheduler)."""
    nodes, advisor = port["gen_host_cluster"](HOST_SMALL_NODES, seed=0)
    for assigner in ("auction", "greedy"):
        cfg = dict(HOST_CFG, max_windows_per_cycle=1, assigner=assigner)
        card, cpu = engine_variant(port, record=True)(), engine_variant(port, record=True)(
            device="cpu")
        got = host_drain(torch, port, card, nodes, advisor, cfg, (), 2 * WINDOW)[2]
        want = host_drain(torch, port, cpu, nodes, advisor, cfg, (), 2 * WINDOW)[2]
        verdict = "equal"
        if got != want:
            verdict = ""
            for (pods, g), (_, w) in zip(card.batches, cpu.batches):
                tpods = type(pods)(*[torch.as_tensor(np.asarray(x)) for x in pods])
                verdict = decisions_match(torch, port, g, w, tpods, assigner)
                if verdict != "equal":
                    break
            if verdict != "near-tie":
                fail(f"host loop card vs cpu ({assigner}): bindings differ")
        emit({"phase": f"host_loop_card_vs_cpu_{assigner}", "nodes": HOST_SMALL_NODES,
              "pods": 2 * WINDOW, "bindings": len(got), "cycles": len(card.batches),
              "decisions": verdict})


def preemption_cluster(port, n_nodes: int, seed: int = 14):
    """(nodes, advisor, running, preemptors): gen_host_cluster(n_nodes)
    with every node full of VICTIMS_PER_NODE low-priority running pods
    (priorities 0-3, a quarter of the node's cpu and memory each, seeded
    start times), each node labelled with one of PREEMPTORS groups, and
    PREEMPTORS priority-9 pods that fit nowhere, preemptor k held by
    required node affinity to group k (its ~n/128 candidate nodes)."""
    nodes, advisor = port["gen_host_cluster"](n_nodes, seed=0)
    Pod, Container, Expr = port["Pod"], port["Container"], port["MatchExpression"]
    rng = np.random.default_rng(seed)
    running = []
    for i, nd in enumerate(nodes):
        nd.labels = {**nd.labels, "yoda/group": f"g{i % PREEMPTORS}"}
        for j in range(VICTIMS_PER_NODE):
            running.append(Pod(
                name=f"low-{i}-{j}", labels={"scv/priority": str(int(rng.integers(0, 4)))},
                containers=[Container(requests={
                    "cpu": nd.allocatable["cpu"] / VICTIMS_PER_NODE,
                    "memory": nd.allocatable["memory"] / VICTIMS_PER_NODE})],
                node_name=nd.name, start_time=float(rng.integers(0, 1 << 20))))
    preemptors = [Pod(
        name=f"urgent-{k}", labels={"scv/priority": "9"}, annotations={"diskIO": "5"},
        containers=[Container(requests={"cpu": float(rng.choice([1000, 2000, 3000])),
                                        "memory": float(2 ** 30)})],
        node_affinity=[Expr(key="yoda/group", operator="In", values=[f"g{k}"])])
        for k in range(PREEMPTORS)]
    return nodes, advisor, running, preemptors


def run_host_preemption(torch, port, n_nodes: int = HOST_NODES):
    """Phase 14: preemption at 10,000 nodes through the port's Scheduler
    (preemption_cluster): one cycle with a RecordingEvictor, whose pass
    must run on the card (TorchEngine.preempt, one call, no in-host
    fallback) and equal, bitwise, preempt_batch on CPU copies of the same
    inputs; every eviction's victim below its preemptor's priority, at
    most one proposal per node. The pass's ms (median of 5, synchronised,
    on the recorded inputs), its peak device memory and its host-to-device
    bytes (a fresh engine's first call). Then, once the victims have left
    the running list (and the mirror), one more cycle binds every
    preemptor to its nominated node. Returns the pass's recorded inputs
    and k_cap (phase 18 sends them over the wire)."""
    nodes, advisor, running, preemptors = preemption_cluster(port, n_nodes)
    engine = engine_variant(port, record=True)()
    evictor = port["RecordingEvictor"]()
    cfg = dict(HOST_CFG, preemption_max_victims=8)
    sched, clock = host_scheduler(port, engine, nodes, advisor, running, cfg, evictor)
    for pod in preemptors:
        sched.submit(pod)
    t0 = time.perf_counter()
    m = sched.run_cycle()
    cycle_s = time.perf_counter() - t0
    if m.pods_bound or engine.preempt_calls != 1 or engine.last_preempt is None:
        fail(f"preemption: {m.pods_bound} bound, {engine.preempt_calls} engine passes")
    check_device_route("preemption", sched, [(m, None, None)])
    inputs, k_cap, res = engine.last_preempt
    cpu = port["preempt_on_host"](*inputs, k_cap=k_cap)
    for leaf in ("node", "victims", "n_victims"):
        got, want = getattr(res, leaf), getattr(cpu, leaf)
        if got.device.type != "cuda" or not torch.equal(got.cpu(), want):
            fail(f"preemption: the card's {leaf} differs from preempt_batch on the CPU")
    prio = {p.name: int(p.labels["scv/priority"]) for p in running + preemptors}
    where = {p.name: p.node_name for p in running}
    nominated = {}
    for e in evictor.evictions:
        if prio[e.victim.name] >= prio[e.preemptor.name]:
            fail(f"preemption: {e.victim.name} is not below {e.preemptor.name}")
        node = nominated.setdefault(e.preemptor.name, where[e.victim.name])
        if node != where[e.victim.name]:
            fail(f"preemption: {e.preemptor.name}'s victims span nodes")
    if len(set(nominated.values())) != len(nominated) or not nominated:
        fail(f"preemption: {len(nominated)} proposals on {len(set(nominated.values()))} nodes")
    # the pass alone on the recorded inputs: bytes of a cold engine, then ms
    fresh = port["TorchEngine"]()
    torch.cuda.synchronize()
    port["reset_transfers"]()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    fresh.preempt(*inputs, k_cap=k_cap)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    h2d = port["transfers"]["h2d_bytes"]
    ms, _ = wall_ms(torch, lambda: fresh.preempt(*inputs, k_cap=k_cap), n=5)
    snapshot, pods, victims = inputs
    emit({"phase": "host_preemption", "config": "host-10k full", "nodes": len(nodes),
          "node_bucket": int(np.asarray(snapshot.allocatable).shape[0]),
          "running": len(running), "victim_slots": int(np.asarray(victims.node).shape[0]),
          "preemptors": len(preemptors), "k_cap": k_cap,
          "proposals": len(nominated), "victims_evicted": len(evictor.evictions),
          "pass_ms": statistics.median(ms), "pass_ms_runs": ms,
          "peak_device_bytes": peak, "peak_over_resident_bytes": peak - base,
          "h2d_bytes": h2d, "cycle_s": cycle_s, "bitwise_vs_cpu": True})
    # the victims terminate (the informer's delete events reach the mirror)
    gone = {e.victim.name for e in evictor.evictions}
    for victim in [p for p in running if p.name in gone]:
        running.remove(victim)
        if sched.mirror is not None:
            sched.mirror.apply_pod_event("DELETED", victim)
    clock[0] += QUEUE_TICK_S
    m2 = sched.run_cycle()
    placed = {b.pod.name: b.node_name for b in sched.binder.bindings}
    wrong = [k for k, node in nominated.items() if placed.get(k) != node]
    if wrong:
        fail(f"preemption: {len(wrong)} preemptors did not bind to their nominated "
             f"nodes (first {wrong[0]}: {placed.get(wrong[0])} vs {nominated[wrong[0]]})")
    emit({"phase": "host_preemption_rebind", "pods_bound": m2.pods_bound,
          "on_nominated_node": len(nominated) - len(wrong)})
    return inputs, k_cap


# ---- phases 15-17: journal, replay, spans, fleet, shadow, scenarios ---------

# journals, span files and replays of phases 15-17, inside the checkout
# (git-ignored), removed when the run ends
SMOKE_WORK = "_smoke_work"
TRACE_CFG = dict(HOST_CFG, max_windows_per_cycle=1, pipeline_depth=1, resident_state=True)
REPLAY_MODES = (("serial", False), ("serial", True), ("pipelined", False), ("pipelined", True))
FIXTURES = Path(__file__).resolve().parent / "tests" / "torch_fixtures"
REF_JOURNALS = {"auction": "ref-auction", "greedy": "ref-greedy"}
FLEET_REPLICAS = 4
FLEET_NAMESPACES = 8
FLEET_CFG = dict(HOST_CFG, max_windows_per_cycle=1, pipeline_depth=1)
SCENARIO_NODES = 4096
SCENARIO_SMALL_NODES = 64
# scenario -> (intensity, SchedulerConfig overrides on top of its own).
# Cut to keep each run under ~30 s: soak at intensity 0.25 took 67 s a run
# on an H100 (700 W), 17 s at 0.125; its time grows with the square of the
# running pods (ScenarioWorld.fail_node takes each evicted pod out of the
# running list with list.remove)
SCENARIO_RUNS = {
    "soak": (0.125, {}),
    "compound-storm": (0.5, {}),
    "replica-conflict-storm": (1.0, {"shared_engine": True}),
}


def launches_of(runs: dict, name: str) -> dict:
    """One kernel's count from each run of a {run: launches} dict (nested
    dicts of runs flatten to run/sub keys)."""
    out = {}
    for run, counts in runs.items():
        if name in counts:
            out[run] = counts[name]
        else:
            out.update({f"{run}/{k}": v for k, v in launches_of(counts, name).items()})
    return out


def counted(torch, port, fn):
    """(fn(), K1-K4 launches during it): the counts set to 0 just before
    and read just after, behind a synchronise on both sides."""
    torch.cuda.synchronize()
    port["fused"].reset_launches()
    out = fn()
    torch.cuda.synchronize()
    return out, dict(port["fused"].launches)


def record_drain(torch, port, nodes, advisor, cfg, n_pods, seed=1):
    """One Scheduler on TorchEngine() drains gen_host_pods(n_pods, seed)
    under `cfg`: (scheduler, cycles, bindings, drain wall seconds,
    launches summed over the cycles, each counted by drain_cycles)."""
    running = []
    sched, clock = host_scheduler(port, port["TorchEngine"](), nodes, advisor, running, cfg)
    for pod in host_backlog(port, n_pods, seed):
        sched.submit(pod)
    t0 = time.perf_counter()
    cycles = drain_cycles(torch, port, sched, clock, running)
    wall = time.perf_counter() - t0
    ln = {k: sum(c[1][k] for c in cycles) for k in port["fused"].launches}
    check_device_route("traced drain", sched, cycles)
    if sched.recorder is not None:
        sched.recorder.close()
    if sched.spans is not None:
        sched.spans.close()
    binds = [(b.pod.name, b.node_name) for b in sched.binder.bindings]
    return sched, cycles, binds, wall, ln


def replay_checked(torch, port, path, n_cycles, what, **kw):
    """replay_journal on a fresh TorchEngine(); fails on a binding diff
    or a replayed count other than n_cycles. Returns (report, launches)."""
    rep, ln = counted(torch, port, lambda: port["replay_journal"](
        str(path), engine=port["TorchEngine"](), **kw))
    if rep.binding_diffs or rep.replayed != n_cycles:
        fail(f"{what}: {rep.binding_diffs} binding diffs, {rep.replayed} of {n_cycles} "
             f"cycles replayed ({rep.to_dict()['diff_cycles'][:3]})")
    return rep, ln


def stage_table(port, span_dir) -> dict:
    """The span report of `span_dir` (trace.analyze.build_report): each
    attributed stage's p50 ms and share of the cycle; fails unless every
    emitted stage is in SHIPPED_SPANS and the shares sum to 100."""
    events = [e for e in port["read_spans"](str(span_dir)) if e.get("ph") == "X"]
    names = {e["name"] for e in events}
    if not names <= set(port["SHIPPED_SPANS"]):
        fail(f"spans: unregistered stages {sorted(names - set(port['SHIPPED_SPANS']))}")
    report = port["build_report"](str(span_dir))
    shares = report["attribution_pct"]
    if abs(sum(shares.values()) - 100.0) > 0.5:
        fail(f"spans: stage shares sum to {sum(shares.values())}")
    table = {s: {"p50_ms": report["stages"].get(s, {}).get("p50_ms"), "share_pct": pct}
             for s, pct in shares.items()}
    # stages outside the attribution (host_overlap runs beside the engine
    # step in the reference's pipelined loop): their p50 alone
    table.update({s: {"p50_ms": d["p50_ms"], "share_pct": None}
                  for s, d in report["stages"].items() if s not in shares})
    return {"cycles": report["cycles"], "cycle_p50_ms": report["cycle_ms"]["p50_ms"],
            "stages": table, "share_sum": sum(shares.values())}


def near_tie_flip(torch, port, snapshot, pods, kw, recorded_idx, replay_idx) -> bool:
    """Whether a greedy replay's first difference from the recording (in
    priority order) is a near-tie: the recorded and the replayed node
    score within 2 score_tolerance of each other on the card's scores."""
    eng = port["TorchEngine"]()
    snap, tpods = eng._consts.swap(snapshot), eng._consts.swap(pods)
    res = port["schedule_batch"](snap, tpods, **kw)
    order = port["assign"]._priority_order(tpods.priority, tpods.pod_mask).cpu()
    first = next(int(i) for i in order if recorded_idx[i] != replay_idx[i])
    gi, wi = int(replay_idx[first]), int(recorded_idx[first])
    if gi < 0 or wi < 0:
        return False
    tol = score_tolerance(snap, tpods, res.scores, res.feasible, kw)[first]
    row = res.scores[first].cpu().double()
    return abs(float(row[gi]) - float(row[wi])) <= 2 * float(max(tol[gi], tol[wi]))


def replay_reference_journal(torch, port, assigner: str) -> dict:
    """One committed reference journal (tests/torch_fixtures, recorded by
    the JAX package on the CPU) replayed on the card, serial with full
    uploads and pipelined with resident ones: the auction's must give 0
    diffs; greedy's may differ only at counted near-tie flips."""
    path = FIXTURES / REF_JOURNALS[assigner]
    if not path.is_dir():
        fail(f"reference journal {path} is missing")
    out = {}
    for mode, resident in (("serial", False), ("pipelined", True)):
        rep, ln = counted(torch, port, lambda: port["replay_journal"](
            str(path), engine=port["TorchEngine"](), mode=mode, resident=resident))
        flips = 0
        for d in rep.diffs:
            if assigner != "greedy":
                break
            rec, snapshot = next((r, s) for r, s in port["reconstruct_cycles"](str(path))
                                 if r.get("seq") == d.seq)
            pods = port["pod_batch_from_record"](rec["pods"])
            kw = port["engine_kw_from_record"](rec)
            want = np.asarray(rec["assign"]["node_idx"])
            got = port["TorchEngine"]().schedule_batch(snapshot, pods, **kw).node_idx.cpu()
            if not near_tie_flip(torch, port, snapshot, pods, kw, want, got.numpy()):
                fail(f"reference {assigner} journal: seq {d.seq} differs beyond a near-tie")
            flips += 1
        if rep.replayed != 2 or (rep.diffs and assigner != "greedy"):
            fail(f"reference {assigner} journal ({mode}, resident={resident}): "
                 f"{rep.to_dict()}")
        out[f"{mode}{'_resident' if resident else ''}"] = {
            "binding_diffs": rep.binding_diffs, "near_tie_flips": flips,
            "pods_replayed": rep.pods_replayed, "seconds": rep.seconds, "launches": ln}
    return out


def run_journal(torch, port, work: Path) -> dict:
    """Phase 15: the flight recorder, spans and the journal-replay gate at
    host-10k through the port's Scheduler on TorchEngine(): the bench's
    traced shape (bench.py:738-746; gen_host_cluster(10_000, seed=0),
    8,192 pods of gen_host_pods(seed=1), one 1,024-pod window a cycle,
    pipeline_depth 1, resident_state on, the engine path pinned), drained
    untraced and with trace_path and span_path set, in turns (untraced,
    traced, untraced, traced; bindings equal, no record or span dropped,
    one record a cycle); the first traced run's journal replayed
    through TorchEngine() in all four modes (0 binding diffs, every
    device cycle replayed, pods/s and launches per mode); two recorded
    replays diffing to zero (trace.inspect.diff); phase 13's 8-window
    cycle recorded (a backlog record) and replayed; the span files
    through trace.analyze.build_report (every stage shipped, shares
    summing to 100); the committed reference journals replayed on the
    card. Returns (launches per run, the traced journal's path)."""
    nodes, advisor = port["gen_host_cluster"](HOST_NODES, seed=0)
    journal, spans = work / "host10k", work / "host10k-spans"
    runs, launches = {}, {}
    for turn, traced in enumerate((False, True, False, True)):
        cfg = dict(TRACE_CFG, **({"trace_path": str(journal) + "-2" * (turn > 1),
                                  "span_path": str(spans) + "-2" * (turn > 1)}
                                 if traced else {}))
        sched, cycles, binds, wall, ln = record_drain(
            torch, port, nodes, advisor, cfg, HOST_BACKLOG)
        name = ("traced" if traced else "untraced") + ("_2" if turn > 1 else "")
        launches[f"drain_{name}"] = ln
        bound = sum(m.pods_bound for m, _, _ in cycles)
        runs[name] = (binds, len(cycles))
        row = {"phase": f"journal_drain_{name}", "config": "host-10k", "nodes": HOST_NODES,
               "pods": HOST_BACKLOG, "cycles": len(cycles), "pods_bound": bound,
               "pods_per_s": bound / wall, "drain_s": wall,
               "cycle_pods_per_s": bound / sum(m.cycle_seconds for m, _, _ in cycles),
               "cycle_p50_ms": float(np.percentile(
                   [m.cycle_seconds for m, _, _ in cycles], 50)) * 1e3,
               "launches": ln}
        if traced:
            rec, sp = sched.recorder, sched.spans
            if rec.records_dropped or sp.spans_dropped:
                fail(f"journal: {rec.records_dropped} records and {sp.spans_dropped} span "
                     "sets dropped on a clean run")
            if rec.cycles_recorded != len(cycles):
                fail(f"journal: {rec.cycles_recorded} records for {len(cycles)} cycles")
            row.update(records=rec.cycles_recorded, trace_bytes=rec.bytes_written,
                       recorder_s=rec.seconds_spent, spans_written=sp.spans_written,
                       records_dropped=0, spans_dropped=0)
        emit(row)
    if any(b != runs["untraced"][0] for b, _ in runs.values()):
        fail("journal: a traced drain's bindings differ from the untraced drain's")
    n_dev = runs["traced"][1]
    st = port["inspect"].stats(str(journal))
    if st["by_path"] != {"device": n_dev} or st["delta_records"] < 1:
        fail(f"journal: unexpected records {st}")
    for mode, resident in REPLAY_MODES:
        rep, ln = replay_checked(torch, port, journal, n_dev,
                                 f"replay {mode} resident={resident}", mode=mode,
                                 resident=resident)
        key = f"replay_{mode}{'_resident' if resident else ''}"
        launches[key] = ln
        emit({"phase": f"journal_{key}", "cycles": rep.replayed, "binding_diffs": 0,
              "pods_replayed": rep.pods_replayed, "seconds": rep.seconds,
              "pods_per_s": rep.pods_replayed / rep.seconds, "launches": ln})
    a, b = work / "replay-a", work / "replay-b"
    replay_checked(torch, port, journal, n_dev, "recorded replay a", record_path=str(a))
    replay_checked(torch, port, journal, n_dev, "recorded replay b", mode="pipelined",
                   resident=True, record_path=str(b))
    for x, y in ((a, b), (journal, a)):
        d = port["inspect"].diff(str(x), str(y))
        if d["differences"] or d["extra_records_a"] or d["extra_records_b"]:
            fail(f"trace diff {x.name} vs {y.name}: {d}")
    emit({"phase": "journal_trace_diff", "records_compared": n_dev, "differences": 0})
    # phase 13's 8-window cycle as one backlog record
    backlog = work / "host10k-backlog"
    _, cycles, _, _, _ = record_drain(torch, port, nodes, advisor,
                                      dict(HOST_CFG, trace_path=str(backlog)), HOST_BACKLOG,
                                      seed=2)
    st = port["inspect"].stats(str(backlog))
    if st["by_path"].get("backlog") != len(cycles) or not cycles:
        fail(f"journal: the 8-window cycle recorded {st['by_path']}")
    for resident in (False, True):
        rep, ln = replay_checked(torch, port, backlog, len(cycles),
                                 f"backlog replay resident={resident}", resident=resident)
        launches[f"backlog_replay{'_resident' if resident else ''}"] = ln
    emit({"phase": "journal_backlog_replay", "windows": N_WINDOWS, "cycles": len(cycles),
          "binding_diffs": 0, "launches": ln})
    emit({"phase": "journal_span_report", **stage_table(port, spans)})
    refs = {a: replay_reference_journal(torch, port, a) for a in REF_JOURNALS}
    emit({"phase": "journal_reference_replay", "nodes": 1000, "cycles": 2,
          "pods": 2 * WINDOW, **refs})
    launches["reference_replays"] = {
        f"{a}_{m}": r["launches"] for a, rs in refs.items() for m, r in rs.items()}
    return launches, journal


def fleet_namespaces(port) -> list:
    """FLEET_NAMESPACES tenant names, as many on each of the
    FLEET_REPLICAS partitions (queue.namespace_partition)."""
    per = FLEET_NAMESPACES // FLEET_REPLICAS
    by_part = {p: [] for p in range(FLEET_REPLICAS)}
    i = 0
    while any(len(v) < per for v in by_part.values()):
        ns = f"tenant-{i}"
        part = port["namespace_partition"](ns, FLEET_REPLICAS)
        if len(by_part[part]) < per:
            by_part[part].append(ns)
        i += 1
    return [ns for p in range(FLEET_REPLICAS) for ns in by_part[p]]


def fleet_drain(torch, port, nodes, advisor, pods, shared: bool):
    """A ReplicaFleet of FLEET_REPLICAS Schedulers, each a TorchEngine()
    (shared=False) or views of one SharedEnginePool over one TorchEngine()
    (shared=True), drained round by round through run_round_split (every
    replica dispatches before any completes), binds fed back as running
    pods after each round. Returns (pod -> node map, evidence, rounds,
    wall seconds, launches)."""
    running = []
    cfg = port["SchedulerConfig"](shared_engine=shared, **FLEET_CFG)
    fleet = port["ReplicaFleet"](
        cfg, n_replicas=FLEET_REPLICAS, advisor_factory=lambda i: advisor,
        list_nodes=lambda: nodes, list_running_pods=lambda: running,
        engine_factory=lambda i: port["TorchEngine"]())
    for pod in pods:
        fleet.submit(pod)
    seen = [0] * FLEET_REPLICAS

    def drain():
        rounds = 0
        while any(len(s.queue) or s._prefetched is not None for s in fleet.schedulers):
            if rounds >= 64:
                fail("fleet: the drain did not finish in 64 rounds")
            fleet.run_round_split()
            rounds += 1
            for i, s in enumerate(fleet.schedulers):
                running.extend(b.pod for b in s.binder.bindings[seen[i]:])
                seen[i] = len(s.binder.bindings)
        for s in fleet.schedulers:
            s.drain_pipeline()
        return rounds

    t0 = time.perf_counter()
    rounds, ln = counted(torch, port, drain)
    wall = time.perf_counter() - t0
    for s in fleet.schedulers:
        check_device_route(f"fleet shared={shared}", s, [])
    bound = {(b.pod.namespace, b.pod.name): b.node_name
             for s in fleet.schedulers for b in s.binder.bindings}
    return bound, fleet.evidence(), rounds, wall, ln


def run_fleet_and_shadow(torch, port, journal: Path) -> dict:
    """Phase 16: ReplicaFleet(n_replicas=4) at 10,000 nodes over 8,192 pods
    in FLEET_NAMESPACES namespaces (2 a partition), one 1,024-pod window
    a cycle, pipeline_depth 1, drained by rounds: shared_engine=True
    (one TorchEngine behind the SharedEnginePool) against four private
    TorchEngines. The union pod -> node maps must be equal; the pool must
    have coalesced (coalesced_dispatches > 0, fewer than 4 device
    dispatches a round), uploaded in full once, then by delta or dedup,
    and no pod may be bound twice. Then ShadowScheduler on TorchEngine()
    over phase 15's journal with the primary's config (0 divergence,
    every record applied), and a divergent candidate (policy
    least_allocated) twice (it moves bindings, the same way both times).
    Returns the launches per run."""
    nodes, advisor = port["gen_host_cluster"](HOST_NODES, seed=0)
    names = fleet_namespaces(port)
    out, launches = {}, {}
    for shared in (True, False):
        pods = host_backlog(port, HOST_BACKLOG, 5)
        for k, pod in enumerate(pods):
            pod.namespace = names[k % len(names)]
        name = "shared" if shared else "private"
        bound, ev, rounds, wall, ln = fleet_drain(torch, port, nodes, advisor, pods, shared)
        out[name] = bound
        launches[f"fleet_{name}"] = ln
        if ev["double_binds"] or ev["total_binds"] != len(bound):
            fail(f"fleet {name}: {ev['double_binds']} double binds, {ev['total_binds']} "
                 f"binds for {len(bound)} pods")
        row = {"phase": f"fleet_{name}", "config": "host-10k", "nodes": HOST_NODES,
               "replicas": FLEET_REPLICAS, "namespaces": len(names), "pods": len(pods),
               "pods_bound": len(bound), "rounds": rounds, "seconds": wall,
               "pods_per_s": len(bound) / wall, "launches": ln,
               "binds_per_replica": ev["binds_per_replica"]}
        if shared:
            st = ev["shared_engine"]
            up = st["uploads"]
            if not (st["coalesced_dispatches"] > 0
                    and st["device_dispatches"] / rounds < FLEET_REPLICAS
                    and up["full"] == 1 and up["delta"] + up["dedup"] > 0):
                fail(f"fleet shared: the pool's evidence {st} over {rounds} rounds")
            row.update(shared_engine=st, dispatches_per_round=st["device_dispatches"] / rounds)
        emit(row)
    if out["shared"] != out["private"]:
        diff = sum(out["shared"].get(k) != v for k, v in out["private"].items())
        fail(f"fleet: the shared engine's union map differs from the private fleet's at "
             f"{diff} pods")
    emit({"phase": "fleet_shared_vs_private", "pods": len(out["shared"]), "equal": True})
    cfg = port["SchedulerConfig"](**TRACE_CFG)
    n_records = port["inspect"].stats(str(journal))["records"]
    t0 = time.perf_counter()
    s, ln = counted(torch, port, lambda: port["ShadowScheduler"](
        str(journal), cfg, engine=port["TorchEngine"]()).run())
    launches["shadow_identical"] = ln
    if (s["bindings_changed"] or s["divergence_ratio"] != 0.0 or s["candidate_errors"]
            or s["records_applied"] != n_records):
        fail(f"shadow, identical candidate: {s}")
    emit({"phase": "shadow_identical", "records_applied": s["records_applied"],
          "pods_compared": s["pods_compared"], "divergence_ratio": s["divergence_ratio"],
          "candidate_engine_seconds": s["candidate_engine_seconds"],
          "latency_ratio": s["latency_ratio"], "seconds": time.perf_counter() - t0,
          "launches": ln})
    keys = ("records_applied", "pods_compared", "bindings_changed", "divergence_ratio",
            "gangs_diverged", "score_delta_mean")
    div = []
    for _ in range(2):
        s = port["ShadowScheduler"](str(journal), port["SchedulerConfig"](
            **dict(TRACE_CFG, policy="least_allocated")), engine=port["TorchEngine"]()).run()
        div.append({k: s[k] for k in keys})
    if div[0]["bindings_changed"] <= 0 or div[0] != div[1]:
        fail(f"shadow, divergent candidate: {div}")
    emit({"phase": "shadow_divergent", "policy": "least_allocated", **div[0],
          "deterministic": True})
    return launches


def decisions_of(summary: dict) -> dict:
    """A scenario summary without its wall-clock fields (seconds, rates,
    the shared engine's execute seconds) and journal paths."""
    out = {k: v for k, v in summary.items()
           if k not in ("seconds", "pods_per_sec", "journal", "journals", "wall_s")}
    if "shared_engine" in out:
        out["shared_engine"] = {k: v for k, v in out["shared_engine"].items()
                                if k != "execute_seconds"}
    return out


def scenario_journals(summary, path: Path) -> list:
    return [Path(j) for j in summary.get("journals") or [path]]


def run_scenarios(torch, port, work: Path) -> dict:
    """Phase 17: soak, compound-storm (its fault plan on) and
    replica-conflict-storm (shared_engine) at SCENARIO_NODES nodes on
    TorchEngine(), each at its SCENARIO_RUNS intensity with a journal:
    run twice with seed 0 (summaries equal, trace diff of the journals
    zero), each journal replayed with 0 binding diffs; then at the
    default 64 nodes the card's journal against the port's CPU run of
    the same scenario (no decision difference: the scenarios run the
    auction, whose tie jitter leaves no near-tie). Returns the launches
    of each scenario's first run."""
    launches = {}
    for name, (intensity, overrides) in SCENARIO_RUNS.items():
        cfg = port["scenario_config"]({**port["SCENARIOS"][name].config_overrides,
                                       **overrides})
        summaries = []
        for k in ("a", "b"):
            path = work / f"{name}-{k}"
            t0 = time.perf_counter()
            s, ln = counted(torch, port, lambda: port["run_scenario"](
                name, n_nodes=SCENARIO_NODES, intensity=intensity, seed=0,
                trace_path=str(path), config=cfg))
            s["wall_s"] = time.perf_counter() - t0
            if k == "a":
                launches[name] = ln
            summaries.append((s, path))
        (sa, pa), (sb, pb) = summaries
        if decisions_of(sa) != decisions_of(sb):
            fail(f"scenario {name}: two runs of seed 0 differ")
        replayed = 0
        for ja, jb in zip(scenario_journals(sa, pa), scenario_journals(sb, pb), strict=True):
            d = port["inspect"].diff(str(ja), str(jb))
            if d["differences"] or d["extra_records_a"] or d["extra_records_b"]:
                fail(f"scenario {name}: trace diff of two seed-0 runs {d}")
            n_dev = sum(v for p, v in port["inspect"].stats(str(ja))["by_path"].items()
                        if p in ("device", "backlog"))
            rep, _ = replay_checked(torch, port, ja, n_dev, f"scenario {name} replay")
            replayed += rep.replayed
        if sa["pods_bound"] <= 0 or (port["SCENARIOS"][name].chaos and not sa["recovered"]):
            fail(f"scenario {name}: {sa}")
        small = {}
        for device in ("cuda", "cpu"):
            path = work / f"{name}-small-{device}"
            small[device] = (port["run_scenario"](
                name, n_nodes=SCENARIO_SMALL_NODES, seed=0, trace_path=str(path),
                config=cfg, device=device), path)
        for ja, jb in zip(scenario_journals(*small["cuda"]),
                          scenario_journals(*small["cpu"]), strict=True):
            d = port["inspect"].diff(str(ja), str(jb))
            if d["differences"] or d["extra_records_a"] or d["extra_records_b"]:
                fail(f"scenario {name}: the card's decisions at {SCENARIO_SMALL_NODES} "
                     f"nodes differ from the CPU's ({d['differing'][:3]})")
        row = {"phase": f"scenario_{name}", "nodes": SCENARIO_NODES, "intensity": intensity,
               "config_overrides": overrides, "cycles": sa["cycles"],
               "pods_submitted": sa["pods_submitted"], "pods_bound": sa["pods_bound"],
               "seconds": sa["seconds"], "seconds_second_run": sb["seconds"],
               "wall_s": sa["wall_s"], "cycles_replayed": replayed,
               "fallback_cycles": sa["fallback_cycles"], "recovered": sa["recovered"],
               "trace_diff_of_two_runs": 0, "card_vs_cpu_64_nodes": "equal",
               "launches": launches[name]}
        for key in ("faults_injected", "shared_engine", "bind_conflicts", "double_binds",
                    "trace_records_dropped"):
            if key in sa:
                row[key] = sa[key]
        emit(row)
    return launches


# ---- phases 18-19: the sidecar on the card, the live-cluster path -------

BRIDGE_TIMED = 3           # medians of 3: RPC against the in-process call
LIVE_NODES = HOST_NODES    # the fake API server's cluster
LIVE_PODS = N_WINDOWS * WINDOW
LIVE_CFG = dict(batch_window=WINDOW, max_windows_per_cycle=N_WINDOWS,
                min_device_work=0, adaptive_dispatch=False)


def request_sizes(client, attr: str) -> list:
    """Wrap the client's `attr` stub so every request's serialized size is
    appended to the returned list (bytes on the wire, before gRPC framing)."""
    sizes, real = [], getattr(client, attr)

    def sized(request, **kw):
        sizes.append(request.ByteSize())
        return real(request, **kw)

    setattr(client, attr, sized)
    return sizes


def check_bridge_equal(what, got, want, leaves=("node_idx", "free_after", "n_assigned")):
    """`got` (numpy, from the wire) bitwise `want` (the in-process call)."""
    for leaf in leaves:
        a, b = np.asarray(getattr(got, leaf)), getattr(want, leaf).cpu().numpy()
        if a.shape != b.shape or a.dtype != b.dtype or a.tobytes() != b.tobytes():
            fail(f"{what}: the reply's {leaf} differs from the in-process engine's")


def rpc_timing(torch, port, client, call, inproc) -> dict:
    """Median wall ms of BRIDGE_TIMED RPCs (the reply read on the host)
    against the same in-process call followed by its device.to_host read,
    in turns; the engine seconds the server reported; the bytes uploaded to
    the card per RPC (device.transfers, set to 0 just before each)."""
    rpc, local, engine_s, h2d = [], [], [], []
    for _ in range(BRIDGE_TIMED):
        torch.cuda.synchronize()
        port["reset_transfers"]()
        t0 = time.perf_counter()
        call()
        rpc.append((time.perf_counter() - t0) * 1e3)
        h2d.append(port["transfers"]["h2d_bytes"])
        engine_s.append(client.last_engine_seconds)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        port["to_host"](*inproc())
        local.append((time.perf_counter() - t0) * 1e3)
    return {"rpc_ms": statistics.median(rpc), "rpc_ms_runs": rpc,
            "inprocess_ms": statistics.median(local), "inprocess_ms_runs": local,
            "engine_seconds": statistics.median(engine_s), "h2d_bytes_per_rpc": h2d}


def run_bridge(torch, port, snap, pods, preempt_inputs):
    """Phase 18: the port's sidecar (bridge.server.make_server on cuda) in
    this process, the port's RemoteEngine connected to it, on gpu-10kx10k
    (the inputs of phases 3-4, sent as host arrays): ScheduleBatch on one
    1,024-pod window (auction, kernel path, min-max), ScheduleWindows on
    the 8 x 1,024-pod backlog with the auction and with greedy, a
    resident session of 8 delta cycles (deltas built as phase 12 builds
    them), and one Preempt on phase 14's recorded inputs. Every reply
    equals, bitwise, the same call on an in-process TorchEngine
    (node_idx, free_after, n_assigned; node, victims, n_victims). K1-K4
    launches are counted around each RPC in this (the server's) process:
    1 K1 and K2 and >= 1 K3 for the window and each delta cycle, 8 K1 and
    K2 and >= 8 K3 for the auction backlog, 8 K1, K2 and K4 for greedy.
    Health must say platform "gpu" and fused_min_max. Prints RPC ms
    against the in-process call (median of 3, window and backlogs; the
    window also with decisions_only, whose reply leaves out the [p, n]
    matrices), the
    server's engine_seconds, request bytes with the field cache cold and
    warm, and bytes uploaded to the card per RPC. Returns (the launches
    by RPC, the server, its address)."""
    TorchEngine = port["TorchEngine"]
    server, port_no, service = port["make_server"]("127.0.0.1:0", device="cuda")
    server.start()
    address = f"127.0.0.1:{port_no}"
    client = port["RemoteEngine"](address, deadline_seconds=600.0)
    try:
        info = client.health_info(timeout=60.0)
        if info is None or info.platform != "gpu" or not info.fused_min_max:
            fail(f"bridge: health {info}")
        host0 = type(snap)(*[t.cpu().numpy() for t in snap])   # what a host sends
        backlog = type(pods)(*[f[: WINDOW * N_WINDOWS].cpu().numpy() for f in pods])
        windows = [type(pods)(*[f[c * WINDOW:(c + 1) * WINDOW] for f in backlog])
                   for c in range(N_WINDOWS)]
        pods_w = port["stack_windows"](backlog, WINDOW)
        local = TorchEngine()
        batch_sizes = request_sizes(client, "_schedule")
        windows_sizes = request_sizes(client, "_schedule_windows")
        launches, rows = {}, {}

        def expect(what, got, calls, k3=False, k4=False):
            expect_launches(what, got, {
                "masked_score": calls, "row_stats": calls,
                "auction_bid": None if k3 else 0, "greedy_scan": calls if k4 else 0})
            if k3 and got["auction_bid"] < calls:
                fail(f"{what}: K3 launched {got['auction_bid']} times for {calls} windows")

        # ScheduleBatch: one window
        res, launches["batch"] = counted(
            torch, port, lambda: client.schedule_batch(host0, windows[0], **SLICE_KW))
        expect("bridge batch", launches["batch"], 1, k3=True)
        check_bridge_equal("bridge batch", res,
                           local.schedule_batch(host0, windows[0], **SLICE_KW))
        cold = batch_sizes[-1]       # the session's first ScheduleBatch
        rows["batch"] = rpc_timing(
            torch, port, client, lambda: client.schedule_batch(host0, windows[0], **SLICE_KW),
            lambda: local.schedule_batch(host0, windows[0], **SLICE_KW))
        rows["batch"].update(request_bytes_cold=cold, request_bytes_warm=batch_sizes[-1])
        # the same window with decisions_only: the reply drops the [p, n]
        # score and mask matrices, which the host loop never reads
        slim = port["RemoteEngine"](address, deadline_seconds=600.0, decisions_only=True)
        try:
            check_bridge_equal("bridge batch, decisions only",
                               slim.schedule_batch(host0, windows[0], **SLICE_KW),
                               local.schedule_batch(host0, windows[0], **SLICE_KW))
            rows["batch_decisions_only"] = rpc_timing(
                torch, port, slim, lambda: slim.schedule_batch(host0, windows[0], **SLICE_KW),
                lambda: local.schedule_batch(host0, windows[0], **SLICE_KW))
        finally:
            slim.close()
        # ScheduleWindows: the backlog on each assigner
        for name, kw, k3, k4 in (("backlog_auction", SLICE_KW, True, False),
                                 ("backlog_greedy", GREEDY_KW, False, True)):
            res, launches[name] = counted(
                torch, port, lambda kw=kw: client.schedule_windows(host0, pods_w, **kw))
            expect(f"bridge {name}", launches[name], N_WINDOWS, k3=k3, k4=k4)
            check_bridge_equal(f"bridge {name}", res,
                               local.schedule_windows(host0, pods_w, **kw))
            first = windows_sizes[-1]
            rows[name] = rpc_timing(
                torch, port, client,
                lambda kw=kw: client.schedule_windows(host0, pods_w, **kw),
                lambda kw=kw: local.schedule_windows(host0, pods_w, **kw))
            rows[name].update(request_bytes_warm=windows_sizes[-1],
                              n_assigned=int(res.n_assigned))
            if len(windows_sizes) == 1 + BRIDGE_TIMED:
                # the session's first ScheduleWindows: the field cache is cold
                rows[name]["request_bytes_cold"] = first
        # a resident session: a full upload, then 8 delta cycles
        rng = np.random.default_rng(18)
        prev, epoch = host0, 1
        res = client.schedule_resident(prev, windows[0], epoch=epoch, **SLICE_KW)
        check_bridge_equal("bridge resident full", res,
                           local.schedule_batch(prev, windows[0], **SLICE_KW))
        resident = dict.fromkeys(port["fused"].launches, 0)
        delta_bytes, delta_ms, h2d = [], [], []
        for c in range(N_WINDOWS):
            new, _ = next_host_snapshot(prev, torch.from_numpy(np.array(res.free_after)), rng)
            delta = snapshot_delta_np(port, prev, new)
            epoch += 1
            port["reset_transfers"]()
            t0 = time.perf_counter()
            res, ln = counted(torch, port, lambda: client.schedule_resident(
                new, windows[c], delta=delta, epoch=epoch, **SLICE_KW))
            delta_ms.append((time.perf_counter() - t0) * 1e3)
            h2d.append(port["transfers"]["h2d_bytes"])
            expect(f"bridge resident cycle {c}", ln, 1, k3=True)
            if not client.resident_used_delta:
                fail(f"bridge resident: delta cycle {c} was resent in full")
            delta_bytes.append(batch_sizes[-1])
            check_bridge_equal(f"bridge resident cycle {c}", res,
                               TorchEngine().schedule_batch(new, windows[c], **SLICE_KW))
            for k, v in ln.items():
                resident[k] += v
            prev = new
        launches["resident_deltas"] = resident
        if service.resident_deltas_served != N_WINDOWS:
            fail(f"bridge resident: {service.resident_deltas_served} deltas served")
        rows["resident"] = {"delta_cycles": N_WINDOWS, "rpc_ms_runs": delta_ms,
                            "rpc_ms": statistics.median(delta_ms),
                            "request_bytes": delta_bytes, "h2d_bytes_per_rpc": h2d}
        # one Preempt on phase 14's inputs
        (psnap, ppods, victims), k_cap = preempt_inputs
        got, ln = counted(torch, port, lambda: client.preempt(psnap, ppods, victims,
                                                               k_cap=k_cap))
        check_bridge_equal("bridge preempt", got,
                           local.preempt(psnap, ppods, victims, k_cap=k_cap),
                           leaves=("node", "victims", "n_victims"))
        expect_launches("bridge preempt", ln, dict.fromkeys(ln, 0))
        rows["preempt"] = {"k_cap": k_cap, "proposals": int((got.node >= 0).sum()),
                           "engine_seconds": client.last_engine_seconds}
        emit({"phase": "bridge", "config": "gpu-10kx10k", "address": address,
              "health": {"platform": info.platform, "device_count": info.device_count,
                         "fused_min_max": info.fused_min_max},
              "parity": "bitwise", "rpcs": rows, "launches": launches})
    except BaseException:
        server.stop(grace=None)
        raise
    finally:
        client.close()
    return launches, server, address


def load_fake_kube():
    """tests/fake_kube.py, the stdlib fake API server (and Prometheus
    endpoint) of the tests, loaded by path."""
    path = Path(__file__).resolve().parent / "tests" / "fake_kube.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_fake_kube", path)
    if spec is None or not path.exists():
        fail(f"{path} is missing")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def fill_live_cluster(fake_kube, fake, n_nodes: int, n_pods: int, profiles: int = 32,
                      seed: int = 19) -> None:
    """The fake API server's cluster for the live path: n_nodes nodes with
    their Prometheus values and n_pods pending pods with seeded CPU
    requests, priorities and diskIO annotations.

    The live loop schedules pods as the watch delivers them, so how the
    queue is cut into windows depends on timing; for two runs to compare
    binding for binding, each pod's placement must not depend on that
    cut. So every node can hold every pod (no node fills), and each pod
    has one best node by a margin above the auction's tie jitter (1% of
    a row's range): `profiles` nodes have disk I/O at half the divisor
    and CPU t_k times that (t_k spread over (0, 1.9]), every other node is
    CPU-hot with no disk I/O, and each pod's diskIO / CPU-millicores
    ratio equals one t_k, so BalancedCpuDiskIO scores that node 10 and
    the next profile at least 3% of the row's range lower."""
    rng = np.random.default_rng(seed)
    ratios = 1.9 * np.arange(1, profiles + 1) / profiles
    for i in range(n_nodes):
        node = fake_kube.make_node_obj(f"node-{i:05d}", cpu=str(n_pods),
                                       memory=f"{n_pods * 2}Gi")
        node["status"]["allocatable"]["pods"] = str(n_pods)
        fake.add_node(node)
        good = i < profiles
        fake.prom[node["metadata"]["name"]] = {
            "cpu_pct": float(50.0 * ratios[i]) if good else 95.0,
            "mem_pct": float(rng.uniform(5.0, 95.0)),
            "disk_io": 25.0 if good else 0.0}
    cpu = rng.integers(1, 10, n_pods) * 100
    shape = rng.integers(0, profiles, n_pods)
    for j in range(n_pods):
        fake.add_pod(fake_kube.make_pod_obj(
            f"pod-{j:05d}", cpu=f"{cpu[j]}m", labels={"scv/priority": str(j % 4)},
            annotations={"diskIO": repr(float(ratios[shape[j]] * cpu[j]))}))


def resume_watches(fake) -> None:
    """Make the fake API server's watches an API server's: its lists carry
    a resourceVersion, a watch from that resourceVersion streams nothing
    (no object changes behind the scheduler's back in phase 19), and every
    watch stream stays open for its timeoutSeconds. The tests' fake lists
    without a resourceVersion and closes each watch as soon as it has sent
    every object again, so the informer would relist 10,000 nodes and
    reseed the snapshot mirror every 0.2 s, and the pending-pod feeder
    would re-read every pending pod in a busy loop; either starves the
    binds of the interpreter lock. The feeder watches without a
    resourceVersion and still gets every pending pod, as from a real API
    server."""
    handler = fake.server.RequestHandlerClass
    real_send, real_get = handler._send, handler.do_GET

    def send(self, code, obj):
        if code == 200 and isinstance(obj, dict) and "items" in obj:
            obj = {**obj, "metadata": {"resourceVersion": "1"}}
        return real_send(self, code, obj)

    def do_get(self):
        query = dict(urllib.parse.parse_qsl(urllib.parse.urlparse(self.path).query))
        if query.get("watch") != "true":
            return real_get(self)
        if "resourceVersion" in query:
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.end_headers()
        else:
            real_get(self)
        self.wfile.flush()
        time.sleep(float(query.get("timeoutSeconds", 0)))
        return None

    handler._send, handler.do_GET = send, do_get


def kube_scheduler_run(torch, port, fake_kube, work: Path, engine: str) -> dict:
    """One `scheduler --source kube --engine <engine> --device cuda`
    through the port's CLI against a fresh fake API server holding
    fill_live_cluster(LIVE_NODES, LIVE_PODS),
    until the queue is idle: its bindings (the server's Binding POSTs),
    the CLI's totals, wall seconds, seconds inside the binder's POSTs and
    the K1-K4 launches (counted in this process, which also holds the
    server of phase 18)."""
    fake = fake_kube.FakeKube()
    resume_watches(fake)
    fake.start()
    binder = port["KubeBinder"]
    real_bind, post_s = binder.bind, [0.0]

    def timed_bind(self, pod, node_name):
        t0 = time.perf_counter()
        try:
            return real_bind(self, pod, node_name)
        finally:
            post_s[0] += time.perf_counter() - t0

    try:
        fill_live_cluster(fake_kube, fake, LIVE_NODES, LIVE_PODS)
        cfg = work / "live-config.json"
        cfg.write_text(json.dumps({
            **LIVE_CFG, "advisor": {"prometheus_host": fake.url.removeprefix("http://"),
                                    "refresh_interval_seconds": 0}}))
        argv = ["scheduler", "--source", "kube", "--kube-server", fake.url,
                "--config", str(cfg), "--watch-timeout", "2", "--engine", engine,
                "--device", "cuda"]
        out = io.StringIO()
        binder.bind = timed_bind
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc, ln = counted(torch, port, lambda: port["cli_main"](argv))
        wall = time.perf_counter() - t0
    finally:
        binder.bind = real_bind
        fake.stop()
    if rc != 0:
        fail(f"live cluster ({engine}): the CLI exited {rc}")
    totals = json.loads(out.getvalue().strip().splitlines()[-1])
    keys = [k for k, _ in fake.bindings]
    if len(keys) != LIVE_PODS or len(set(keys)) != LIVE_PODS or set(keys) != set(fake.pods):
        fail(f"live cluster ({engine}): {len(keys)} Binding POSTs for {len(set(keys))} "
             f"distinct pods of {LIVE_PODS}")
    return {"bindings": sorted(fake.bindings), "totals": totals, "wall_s": wall,
            "bind_post_s": post_s[0], "launches": ln}


def run_live_cluster(torch, port, work: Path, address: str | None) -> dict:
    """Phase 19: the live-cluster path through the port's CLI. A fake API
    server (tests/fake_kube.py, its watches resumed as an API server's:
    resume_watches) with LIVE_NODES nodes and their Prometheus
    values and LIVE_PODS pending pods (batch_window 1,024, up to 8 windows
    a cycle); `scheduler --source kube --engine E --device cuda` runs until
    the queue is idle, once with E = local and once with E = phase 18's
    sidecar. Every pod must be bound exactly once through the server's
    Binding POSTs, the two runs' bindings must be equal, and K1 and K3 must
    have launched in each. Prints wall seconds, cycles, pods/s and the
    seconds spent in the binds' POSTs. Returns the launches by run."""
    fake_kube = load_fake_kube()
    runs = {"local": "local"}
    if address is not None:
        runs["sidecar"] = address
    launches, first = {}, None
    for name, engine in runs.items():
        r = kube_scheduler_run(torch, port, fake_kube, work, engine)
        launches[name] = r["launches"]
        if r["launches"]["masked_score"] < 1 or r["launches"]["auction_bid"] < 1:
            fail(f"live cluster ({name}): K1 or K3 never launched: {r['launches']}")
        if first is None:
            first = r["bindings"]
        elif r["bindings"] != first:
            diff = sum(a != b for a, b in zip(first, r["bindings"]))
            fail(f"live cluster: the {name} run bound {diff} pods elsewhere than local")
        emit({"phase": f"live_cluster_{name}", "nodes": LIVE_NODES, "pods": LIVE_PODS,
              "engine": engine, "cycles": r["totals"]["cycles"],
              "pods_bound": r["totals"]["pods_bound"], "wall_s": r["wall_s"],
              "pods_per_s": LIVE_PODS / r["wall_s"], "bind_post_s": r["bind_post_s"],
              "bindings_equal_local": True, "launches": r["launches"]})
    return launches


LEARNED_STEPS = 300        # train_step calls on the card before the checkpoint
LEARNED_TIMED_STEPS = 20   # more steps, timed by CUDA events
# |card - CPU| raw two-tower score with float32 products, over the
# clusters of LEARNED_RAW_SEEDS, where the largest |raw| is 10.3-11.1.
# Read on an H100 (700 W): float32 products differ by 4.8e-6 to 5.7e-6
# (5-6 ulp of 11), TF32 products by 1.7e-3 to 2.1e-3; the limit sits
# between them, about 17x from each
LEARNED_RAW_TOL = 1e-4
LEARNED_RAW_SEEDS = (3, 5, 7, 9)
LEARNED_KW = dict(normalizer="min_max", affinity_aware=False)
MESH_SHARDS = 4
# greedy backlog depth on the mesh: its election is a chain of small
# launches per pod (8 windows on 4 shards took 7.3-11.5 s a call on an
# H100 at 700 W), cut from N_WINDOWS so every case runs warm and 3 times
MESH_GREEDY_WINDOWS = 2
MESH_RESIDENT_CYCLES = 8
# phase 22: MESH_SHARDS shards in MESH2D_HOSTS host groups of one card; the
# dp x node training step's grid
MESH2D_HOSTS = 2
MESH2D_RESIDENT_CYCLES = 2
TRAIN_GRID = (2, 2)
TRAIN_TIMED_STEPS = 20
TRAIN_STEPS_CHECKED = 5
# |dp x node step - dense step|: the loss relative, each parameter
# absolute after 1 and 5 AdamW steps. Read on an H100 (700 W): losses
# within 9.1e-8, parameters within 1.64e-6 (the CPU at full width, 256
# pods x 2,000 nodes: equal losses, 4.0e-7)
TRAIN_LOSS_RTOL = 1e-5
TRAIN_PARAM_TOL = 1e-5
MESH_CASES = {
    "k1_auction": dict(assigner="auction", normalizer="none", fused=True),
    "k1_greedy": dict(assigner="greedy", normalizer="none", fused=True),
    "minmax_auction": dict(assigner="auction", normalizer="min_max"),
    "minmax_greedy": dict(assigner="greedy", normalizer="min_max"),
}


def check_no_tf32(torch, what: str) -> None:
    if torch.backends.cuda.matmul.allow_tf32 or torch.get_float32_matmul_precision() != "highest":
        fail(f"{what}: TF32 is enabled for float32 matrix products")


def backlog_windows(port, pods, n_windows: int = N_WINDOWS):
    backlog = type(pods)(*[f[: WINDOW * n_windows] for f in pods])
    return backlog, port["stack_windows"](backlog, WINDOW)


def run_learned(torch, port, snap, pods, work: Path):
    """Phase 20: the learned two-tower scorer at full width (NodeScorer()
    defaults: d_model 128, width 256, depth 2) on gpu-10kx10k. TF32 must
    be off. LEARNED_STEPS train_steps on the card against
    balanced_cpu_diskio's raw scores of one 1,024-pod window (the loss
    must fall by more than 10%), LEARNED_TIMED_STEPS more timed by CUDA
    events; save_checkpoint, then load_learned_engine, whose parameters
    must equal the trained ones bitwise. The restored engine's auction
    and greedy 8 x 1,024-pod backlogs with affinity_aware=False, each
    equal to the same call on the plain kernels (_plain=True), K3
    launched once per auction round (rounds counted at the admission)
    and K4 once per window, both counted; on four 300-node clusters
    (LEARNED_RAW_SEEDS) raw scores within LEARNED_RAW_TOL of the engine on
    the CPU with the same parameters, and equal auction decisions, while
    the same products in TF32 differ by more than LEARNED_RAW_TOL (the
    tolerance would catch them); Scheduler(policy="learned",
    learned_checkpoint=...) draining one host-10k backlog on the engine
    path; the in-process sidecar built by the server's command line with
    --learned-checkpoint, its replies (one window, the greedy backlog)
    bitwise the in-process engine's. Prints backlog ms and pods/s, train
    step ms and the forward's ms. Returns (the launches by run, the
    engine, the checkpoint path)."""
    L = port["learned"]
    check_no_tf32(torch, "learned")
    t0 = time.perf_counter()
    window = type(pods)(*[f[:WINDOW] for f in pods])
    state, model, tx = L.init_train_state(0)
    pod_x, node_x = L.make_features(snap, window)
    teacher = port["compute_scores"](snap, window, "balanced_cpu_diskio")

    def step():
        nonlocal state
        state, loss = L.train_step(state, model, tx, pod_x, node_x, teacher,
                                   snap.node_mask, window.pod_mask)
        return loss

    torch.cuda.synchronize()
    t_train = time.perf_counter()
    losses = torch.stack([step() for _ in range(LEARNED_STEPS)]).cpu().tolist()
    train_s = time.perf_counter() - t_train
    if not all(np.isfinite(losses)) or not losses[-1] < 0.9 * losses[0]:
        fail(f"learned: the loss did not fall: {losses[:3]} ... {losses[-3:]}")
    step_ms = cuda_ms(torch, step, n=LEARNED_TIMED_STEPS, warmup=1)
    path = work / "learned-state"
    L.save_checkpoint(str(path), state)
    engine = L.load_learned_engine(str(path))
    for name, t in state.params.items():
        if not same(torch, engine.params[name], t.detach()):
            fail(f"learned: restored parameter {name} differs from the trained one")
    with torch.no_grad():
        forward_ms = cuda_ms(torch, lambda: engine.model(pod_x, node_x))
    emit({"phase": "learned_train", "config": "gpu-10kx10k", "pods": WINDOW,
          "nodes": snap.allocatable.shape[0], "steps": LEARNED_STEPS + LEARNED_TIMED_STEPS + 1,
          "loss_first": losses[0], "loss_last": losses[-1], "train_s": train_s,
          "step_ms": step_ms, "forward_ms": forward_ms,
          "params": sum(t.numel() for t in state.params.values())})

    launches = {}
    _, pods_w = backlog_windows(port, pods)
    n_nodes = snap.allocatable.shape[0]
    for assigner in ("auction", "greedy"):
        kw = dict(LEARNED_KW, assigner=assigner)
        run = lambda: engine.schedule_windows(snap, pods_w, **kw)  # noqa: E731
        run()                                                       # warm-up
        torch.cuda.synchronize()
        port["fused"].reset_launches()
        out, rounds = count_rounds(port, run)
        torch.cuda.synchronize()
        ln = dict(port["fused"].launches)
        if assigner == "auction":
            want = {"masked_score": 0, "row_stats": 0, "auction_bid": rounds, "greedy_scan": 0}
        else:
            want = {"masked_score": 0, "row_stats": 0, "auction_bid": 0,
                    "greedy_scan": N_WINDOWS}
        expect_launches(f"learned {assigner} backlog", ln, want)
        check_equal(torch, f"learned {assigner} backlog (vs the plain path)", out,
                    engine.schedule_windows(snap, pods_w, _plain=True, **kw))
        assigned = check_backlog(torch, f"learned {assigner} backlog", out, N_WINDOWS,
                                 n_nodes, 0.5)
        runs, _ = wall_ms(torch, run, n=3)
        launches[assigner] = ln
        emit({"phase": f"learned_{assigner}_schedule_windows", "config": "gpu-10kx10k",
              "windows": N_WINDOWS, "window": WINDOW, "nodes": n_nodes,
              "backlog_ms": statistics.median(runs), "backlog_ms_runs": runs,
              "pods_per_s": N_WINDOWS * WINDOW / (statistics.median(runs) / 1e3),
              "n_assigned": assigned, "auction_rounds": rounds, "launches": ln,
              "equal_to_plain": True})

    # the card against the CPU on small clusters, same parameters; the
    # same product with TF32 on shows what the tolerance must catch
    cpu_engine = L.LearnedEngine({k: v.cpu() for k, v in engine.params.items()}, device="cpu")
    kw = dict(LEARNED_KW, assigner="auction")
    errs, tf32_errs, raw_abs = [], [], []
    for seed in LEARNED_RAW_SEEDS:
        small = port["gen_cluster"](300, seed=seed, gpu=True, device="cpu")
        small_pods = port["gen_pods"](96, seed=seed + 1, gpu=True, device="cpu")
        got = engine.schedule_batch(small, small_pods, **kw)
        want = cpu_engine.schedule_batch(small, small_pods, **kw)
        errs.append(max_abs_err(got.raw_scores.cpu(), want.raw_scores))
        raw_abs.append(float(want.raw_scores.abs().max()))
        got_cpu = type(got)(*[f.cpu() for f in got])
        if decisions_match(torch, port, got_cpu, want, small_pods, "auction") != "equal":
            fail(f"learned: the card's auction decisions differ from the CPU path's "
                 f"(seed {seed})")
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            tf32 = engine.schedule_batch(small, small_pods, **kw).raw_scores.cpu()
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        tf32_errs.append(max_abs_err(tf32, want.raw_scores))
    check_no_tf32(torch, "learned")
    if not max(errs) <= LEARNED_RAW_TOL:
        fail(f"learned: raw scores differ from the CPU path by {max(errs)}")
    if not min(tf32_errs) > LEARNED_RAW_TOL:
        fail(f"learned: TF32 products differ from the CPU path by only {min(tf32_errs)}, "
             f"within the tolerance {LEARNED_RAW_TOL}")
    emit({"phase": "learned_card_vs_cpu", "nodes": 300, "pods": 96,
          "seeds": list(LEARNED_RAW_SEEDS), "raw_max_abs_err": max(errs),
          "raw_max_abs_err_runs": errs, "raw_max_abs": raw_abs,
          "tf32_max_abs_err_runs": tf32_errs, "tolerance": LEARNED_RAW_TOL,
          "decisions": "equal"})

    # the host loop: Scheduler(policy="learned", learned_checkpoint=...)
    nodes, advisor = port["gen_host_cluster"](HOST_NODES, seed=0)
    cfg = dict(HOST_CFG, policy="learned", learned_checkpoint=str(path))
    running = []
    sched, clock = host_scheduler(port, None, nodes, advisor, running, cfg)
    if (not isinstance(sched.engine, L.LearnedEngine)
            or sched.engine.device.type != snap.allocatable.device.type):
        fail(f"learned: the Scheduler built {type(sched.engine).__name__}")
    for pod in host_backlog(port, HOST_BACKLOG, 1):
        sched.submit(pod)
    cycles = drain_cycles(torch, port, sched, clock, running)
    check_device_route("learned host loop", sched, cycles)
    bound = sum(m.pods_bound for m, _, _ in cycles)
    if bound < HOST_BACKLOG // 2:
        fail(f"learned host loop: {bound} pods bound")
    host_launches = {k: sum(ln[k] for _, ln, _ in cycles) for k in port["fused"].launches}
    if host_launches["auction_bid"] < len(cycles):
        fail(f"learned host loop: K3 launched {host_launches}")
    launches["host_loop"] = host_launches
    lat = [m.cycle_seconds for m, _, _ in cycles]
    emit({"phase": "learned_host_loop", "config": "host-10k", "nodes": HOST_NODES,
          "backlog": HOST_BACKLOG, "cycles": len(cycles), "pods_bound": bound,
          "pods_per_s": bound / sum(lat), "cycle_ms_runs": [x * 1e3 for x in lat],
          "engine_s_runs": [m.engine_seconds for m, _, _ in cycles],
          "launches": host_launches})

    # the sidecar as `--learned-checkpoint` builds it
    srv = port["server"]
    args = srv.build_parser().parse_args(
        ["--host", "127.0.0.1", "--port", "0", "--device", "cuda",
         "--learned-checkpoint", str(path)])
    server, port_no, service = srv.server_from_args(args)
    server.start()
    client = port["RemoteEngine"](f"127.0.0.1:{port_no}", deadline_seconds=600.0)
    try:
        if not isinstance(service._engine, L.LearnedEngine):
            fail("learned sidecar: the server does not serve a LearnedEngine")
        host0 = type(snap)(*[t.cpu().numpy() for t in snap])
        win0 = type(window)(*[f.cpu().numpy() for f in window])
        host_w = type(pods_w)(*[f.cpu().numpy() for f in pods_w])
        rows = {}
        for name, call, inproc in (
            ("batch", lambda: client.schedule_batch(host0, win0, policy="learned",
                                                    assigner="auction", **LEARNED_KW),
             lambda: engine.schedule_batch(snap, window, assigner="auction", **LEARNED_KW)),
            ("greedy_backlog", lambda: client.schedule_windows(
                host0, host_w, policy="learned", assigner="greedy", **LEARNED_KW),
             lambda: engine.schedule_windows(snap, pods_w, assigner="greedy", **LEARNED_KW)),
        ):
            reply, ln = counted(torch, port, call)
            check_bridge_equal(f"learned sidecar {name}", reply, inproc())
            launches[f"sidecar_{name}"] = ln
            rows[name] = rpc_timing(torch, port, client, call, inproc)
        emit({"phase": "learned_sidecar", "config": "gpu-10kx10k", "bitwise": True,
              **{f"{k}_{m}": v for k, r in rows.items() for m, v in r.items()
                 if m in ("rpc_ms", "inprocess_ms", "engine_seconds")}})
    finally:
        client.close()
        server.stop(grace=None)
    emit({"phase": "learned_seconds", "seconds": time.perf_counter() - t0})
    return launches, engine


def warm_pair(torch, what, run, run_dense) -> dict:
    """A sharded call against its dense counterpart: each once untimed
    (the results bitwise equal), then each the median of 3."""
    check_equal(torch, f"{what} (vs dense)", run(), run_dense())
    runs, _ = wall_ms(torch, run)
    dense_runs, _ = wall_ms(torch, run_dense)
    return {"ms": statistics.median(runs), "ms_runs": runs,
            "dense_ms": statistics.median(dense_runs), "dense_ms_runs": dense_runs}


def mesh_delta_cycles(torch, port, se, dense, snap, window, kw, rng,
                      n_cycles: int = MESH_RESIDENT_CYCLES) -> dict:
    """Phase 12's resident delta cycles on the mesh: one full upload, then
    `n_cycles` delta cycles (next_host_snapshot, snapshot_delta_np),
    each bitwise the dense engine's schedule_batch of the same host build;
    per delta cycle the routed bytes per shard, the host-to-device bytes
    and wall ms, and K1-K4 launches."""
    host = type(snap)(*[t.cpu().numpy() for t in snap])
    se.invalidate_resident()
    res = se.schedule_resident(host, window, delta=None, epoch=1, **kw)
    if se.resident_used_delta:
        fail("mesh resident: the first cycle did not upload in full")
    rows = []
    for epoch in range(2, 2 + n_cycles):
        new, _ = next_host_snapshot(host, res.free_after, rng)
        delta = snapshot_delta_np(port, host, new)
        torch.cuda.synchronize()
        port["reset_transfers"]()
        port["fused"].reset_launches()
        t0 = time.perf_counter()
        res = se.schedule_resident(new, window, delta=delta, epoch=epoch, **kw)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        ln = dict(port["fused"].launches)
        io = dict(port["transfers"])
        if not se.resident_used_delta:
            fail(f"mesh resident: delta cycle {epoch} uploaded in full")
        check_equal(torch, f"mesh resident cycle {epoch} (vs dense)", res,
                    dense.schedule_batch(new, window, **kw))
        rows.append({"ms": ms, "shard_delta_bytes": list(se.shard_delta_bytes),
                     "h2d_bytes": io["h2d_bytes"], "launches": ln})
        host = new
    return {"cycles": rows}


def mesh_sidecar(torch, port, snap, pods_w, dense, phase: str, axes: tuple, mesh_argv,
                 spread: bool) -> dict:
    """The in-process sidecar built by the server's command line with
    `mesh_argv` and the fused auction (--assigner auction --normalizer
    none --fused) on the card: it must serve a ShardedEngine of
    MESH_SHARDS shards over a mesh with axes `axes`, and its backlog reply
    must be bitwise the in-process dense call, with K1 MESH_SHARDS times a
    window and no other kernel. Its --device is the card of `snap`, or
    with `spread` "cuda" (the mesh over the first cards). Prints RPC and
    in-process ms; returns the reply's launches."""
    P, srv = port["parallel"], port["server"]
    device = "cuda" if spread else str(snap.allocatable.device)
    args = srv.build_parser().parse_args(
        ["--host", "127.0.0.1", "--port", "0", "--device", device, *mesh_argv,
         "--assigner", "auction", "--normalizer", "none", "--fused"])
    server, port_no, service = srv.server_from_args(args)
    engine = service._engine
    if (not isinstance(engine, P.ShardedEngine) or service.mesh_devices != MESH_SHARDS
            or engine.mesh.axis_names != axes):
        fail(f"{phase}: the server serves {type(engine).__name__} "
             f"({service.mesh_devices} shards)")
    server.start()
    client = port["RemoteEngine"](f"127.0.0.1:{port_no}", deadline_seconds=600.0)
    try:
        host0 = type(snap)(*[t.cpu().numpy() for t in snap])
        host_w = type(pods_w)(*[f.cpu().numpy() for f in pods_w])
        kw = MESH_CASES["k1_auction"]
        call = lambda: client.schedule_windows(host0, host_w, **kw)  # noqa: E731
        inproc = lambda: dense.schedule_windows(  # noqa: E731
            snap, pods_w, affinity_aware=False, **kw)
        reply, ln = counted(torch, port, call)
        expect_launches(f"{phase} backlog", ln, {
            "masked_score": N_WINDOWS * MESH_SHARDS, "row_stats": 0, "auction_bid": 0,
            "greedy_scan": 0})
        check_bridge_equal(f"{phase} backlog", reply, inproc())
        timing = rpc_timing(torch, port, client, call, inproc)
        if 'sharded_cycles_total{rpc="schedule_windows"}' not in service.render_metrics():
            fail(f"{phase}: sharded_cycles_total did not count the backlog")
        emit({"phase": phase, "shards": MESH_SHARDS, "mesh_shape": list(engine.mesh.shape),
              "bitwise_dense": True, "launches": ln,
              **{k: v for k, v in timing.items()
                 if k in ("rpc_ms", "inprocess_ms", "engine_seconds")}})
    finally:
        client.close()
        server.stop(grace=None)
    return ln


def run_mesh(torch, port, snap, pods, learned_engine, spread: bool = False):
    """Phase 21: the node-sharded engine on one card, gpu-10kx10k, meshes of
    cuda:0 four times and once (make_mesh(n, device=cuda:0)). Per mesh, the
    8 x 1,024-pod backlog through ShardedEngine on the fused path
    (normalizer "none": K1 once per shard per window, counted, and no other
    kernel) and on the composed min-max path, for the auction and for
    greedy (greedy over MESH_GREEDY_WINDOWS windows: its election is a
    chain of small launches per pod), each bitwise (decisions, free_after,
    n_assigned) the dense TorchEngine's with affinity_aware=False. Every
    timed call, sharded or dense, runs once untimed first (the sharded
    one counted and checked there), then is the median of 3; phase
    12's resident delta cycles on the 4-shard fused auction with bytes per
    shard; make_sharded_learned_fn on phase 20's engine (both assigners,
    one window and the auction backlog) bitwise the dense LearnedEngine's;
    Scheduler(sharded_engine=True) on the host-10k loop (the default mesh:
    one shard on one card) with bindings equal to the Scheduler on
    TorchEngine(); the in-process sidecar built by the server's command
    line with the shipped manifest's options (--mesh-devices 4 on cuda:0,
    the fused auction), its backlog reply bitwise the in-process dense
    call. Prints each call's ms beside the dense call's. Returns (the
    launches by run, the 4-shard fused backlogs' outputs, dense outputs
    and medians for phase 22). With `spread` the 4-shard mesh is
    make_mesh(4), one shard a card, and the Scheduler's default mesh has
    every card."""
    P, L = port["parallel"], port["learned"]
    t0 = time.perf_counter()
    dev = snap.allocatable.device
    dense = port["TorchEngine"]()
    meshes = {MESH_SHARDS: P.make_mesh(MESH_SHARDS, device=None if spread else dev),
              1: P.make_mesh(1, device=dev)}
    window = type(pods)(*[f[:WINDOW] for f in pods])
    n_nodes = snap.allocatable.shape[0]
    launches, flat = {}, {}
    for shards, mesh in meshes.items():
        se = P.ShardedEngine(mesh)
        for name, kw in MESH_CASES.items():
            n_windows = MESH_GREEDY_WINDOWS if kw["assigner"] == "greedy" else N_WINDOWS
            _, pods_w = backlog_windows(port, pods, n_windows)
            run_dense = lambda: dense.schedule_windows(  # noqa: E731
                snap, pods_w, affinity_aware=False, **kw)
            run = lambda: se.schedule_windows(snap, pods_w, **kw)  # noqa: E731
            want = run_dense()
            dense_runs, _ = wall_ms(torch, run_dense)
            torch.cuda.synchronize()
            port["fused"].reset_launches()
            got = run()
            torch.cuda.synchronize()
            ln = dict(port["fused"].launches)
            k1 = n_windows * shards if kw.get("fused") else 0
            expect_launches(f"mesh {shards} {name}", ln, {
                "masked_score": k1, "row_stats": 0, "auction_bid": 0, "greedy_scan": 0})
            check_equal(torch, f"mesh {shards} {name} (vs dense)", got, want)
            check_backlog(torch, f"mesh {shards} {name}", got, n_windows, n_nodes, 0.5)
            launches[f"{shards}_{name}"] = ln
            runs, _ = wall_ms(torch, run)
            if shards == MESH_SHARDS and kw.get("fused"):
                flat[name] = {"out": got, "dense": want, "ms": statistics.median(runs),
                              "dense_ms": statistics.median(dense_runs)}
            emit({"phase": f"mesh{shards}_{name}_schedule_windows", "config": "gpu-10kx10k",
                  "shards": shards, "windows": n_windows, "window": WINDOW,
                  "ms": statistics.median(runs), "ms_runs": runs,
                  "dense_ms": statistics.median(dense_runs),
                  "dense_ms_runs": dense_runs, "n_assigned": int(got.n_assigned),
                  "launches": ln, "bitwise_dense": True})

    se = P.ShardedEngine(meshes[MESH_SHARDS])
    kw = MESH_CASES["k1_auction"]
    resident = mesh_delta_cycles(torch, port, se, dense, snap, window, kw,
                                 np.random.default_rng(21))
    for i, row in enumerate(resident["cycles"]):
        expect_launches(f"mesh resident delta cycle {i}", row["launches"], {
            "masked_score": MESH_SHARDS, "row_stats": 0, "auction_bid": 0, "greedy_scan": 0})
    launches["resident"] = {k: sum(r["launches"][k] for r in resident["cycles"])
                            for k in port["fused"].launches}
    emit({"phase": "mesh_resident", "config": "gpu-10kx10k", "shards": MESH_SHARDS,
          **resident})

    # the learned scorer on the mesh
    _, pods_w = backlog_windows(port, pods)
    rows = {}
    for assigner in ("auction", "greedy"):
        kw = dict(assigner=assigner, normalizer="min_max")
        fn = L.make_sharded_learned_fn(learned_engine.params, meshes[MESH_SHARDS],
                                       model=learned_engine.model, **kw)
        rows[f"{assigner}_window"] = warm_pair(
            torch, f"mesh learned {assigner} window", lambda: fn(snap, window),
            lambda: learned_engine.schedule_batch(snap, window, affinity_aware=False, **kw))
    wfn = L.make_sharded_learned_fn(learned_engine.params, meshes[MESH_SHARDS], windows=True,
                                    model=learned_engine.model, assigner="auction",
                                    normalizer="min_max")
    rows["auction_backlog"] = warm_pair(
        torch, "mesh learned auction backlog", lambda: wfn(snap, pods_w),
        lambda: learned_engine.schedule_windows(
            snap, pods_w, assigner="auction", affinity_aware=False, normalizer="min_max"))
    emit({"phase": "mesh_learned", "shards": MESH_SHARDS, "bitwise_dense": True, **rows})

    # the host loop on ShardedEngine (the default mesh: every card, here one)
    nodes, advisor = port["gen_host_cluster"](HOST_NODES, seed=0)
    binds, cycle_ms, sharded_cycles, host_shards = {}, {}, 0, 0
    for name, cfg in (("dense", dict(HOST_CFG)), ("sharded", dict(HOST_CFG, sharded_engine=True))):
        running = []
        engine = port["TorchEngine"]() if name == "dense" else None
        sched, clock = host_scheduler(port, engine, nodes, advisor, running, cfg)
        for pod in host_backlog(port, HOST_BACKLOG, 1):
            sched.submit(pod)
        cycles = drain_cycles(torch, port, sched, clock, running)
        check_device_route(f"mesh host loop ({name})", sched, cycles)
        binds[name] = [(b.pod.name, b.node_name) for b in sched.binder.bindings]
        cycle_ms[name] = [m.cycle_seconds * 1e3 for m, _, _ in cycles]
        if name == "sharded":
            if not isinstance(sched.engine, P.ShardedEngine):
                fail(f"mesh host loop: the Scheduler built {type(sched.engine).__name__}")
            sharded_cycles = sched.totals["sharded_cycles"]
            host_shards = sched.engine.n_shards
            launches["host_loop"] = {k: sum(ln[k] for _, ln, _ in cycles)
                                     for k in port["fused"].launches}
    if binds["sharded"] != binds["dense"] or sharded_cycles <= 0:
        fail(f"mesh host loop: bindings differ from the dense Scheduler's "
             f"({len(binds['sharded'])} vs {len(binds['dense'])}), {sharded_cycles} "
             "sharded cycles")
    emit({"phase": "mesh_host_loop", "config": "host-10k", "shards": host_shards,
          "pods_bound": len(binds["sharded"]),
          "sharded_cycles": sharded_cycles, "cycle_ms": cycle_ms["sharded"],
          "dense_cycle_ms": cycle_ms["dense"], "bindings_equal_dense": True})

    # the sidecar as the shipped manifest's --mesh-devices 4 builds it
    launches["sidecar_backlog"] = mesh_sidecar(
        torch, port, snap, pods_w, dense, "mesh_sidecar", (P.NODE_AXIS,),
        ["--mesh-devices", str(MESH_SHARDS)], spread)
    emit({"phase": "mesh_seconds", "seconds": time.perf_counter() - t0})
    return launches, flat


def run_mesh_2d(torch, port, snap, pods, learned_engine, flat: dict, spread: bool = False):
    """Phase 22: the (dcn, node) mesh of a slice spanning hosts on one card,
    gpu-10kx10k: make_mesh_multihost(MESH2D_HOSTS, MESH_SHARDS //
    MESH2D_HOSTS, device=cuda:0), ShardedEngine(node_axes=(dcn, node)).
    The fused auction backlog (N_WINDOWS windows) and the fused greedy
    backlog (MESH_GREEDY_WINDOWS), each bitwise the dense TorchEngine's and
    phase 21's 1-D 4-shard mesh's (`flat`), K1 MESH_SHARDS times a window
    and no other kernel (counted), warm, the median of 3 beside phase 21's
    dense and 1-D medians; MESH2D_RESIDENT_CYCLES resident delta cycles
    with bytes per shard; the learned auction window on the 2-D mesh
    bitwise the dense LearnedEngine's; the in-process sidecar of
    --mesh-devices 4 --mesh-hosts 2 (fused auction), its backlog reply
    bitwise the in-process dense call. Then sharded_train_step at
    NodeScorer()'s widths on a ("dp", "node") TRAIN_GRID mesh of the card
    against train_step from the same seeded state on phase 20's problem
    (one 1,024-pod window x 10,000 nodes): the loss within
    TRAIN_LOSS_RTOL, every parameter within TRAIN_PARAM_TOL after 1 and
    TRAIN_STEPS_CHECKED steps; both steps' ms (CUDA events, median of
    TRAIN_TIMED_STEPS) and peak device memory. With `spread` the meshes
    are make_mesh_multihost(MESH2D_HOSTS, MESH_SHARDS // MESH2D_HOSTS) and
    the training grid over the first cards, one shard a card. Returns the
    launches by run."""
    P, L = port["parallel"], port["learned"]
    t0 = time.perf_counter()
    dev = snap.allocatable.device
    axes = (P.DCN_AXIS, P.NODE_AXIS)
    mesh = P.make_mesh_multihost(MESH2D_HOSTS, MESH_SHARDS // MESH2D_HOSTS,
                                 device=None if spread else dev)
    se = P.ShardedEngine(mesh, node_axes=axes)
    if se.n_shards != MESH_SHARDS or mesh.axis_names != axes:
        fail(f"mesh-2d: {se.n_shards} shards over {mesh.axis_names}")
    dense = port["TorchEngine"]()
    window = type(pods)(*[f[:WINDOW] for f in pods])
    n_nodes = snap.allocatable.shape[0]
    launches = {}
    for name in ("k1_auction", "k1_greedy"):
        kw = MESH_CASES[name]
        n_windows = MESH_GREEDY_WINDOWS if kw["assigner"] == "greedy" else N_WINDOWS
        _, pods_w = backlog_windows(port, pods, n_windows)
        run = lambda: se.schedule_windows(snap, pods_w, **kw)  # noqa: E731
        got, ln = counted(torch, port, run)
        expect_launches(f"mesh-2d {name}", ln, {
            "masked_score": n_windows * MESH_SHARDS, "row_stats": 0, "auction_bid": 0,
            "greedy_scan": 0})
        check_equal(torch, f"mesh-2d {name} (vs dense)", got, flat[name]["dense"])
        check_equal(torch, f"mesh-2d {name} (vs the 1-D mesh)", got, flat[name]["out"])
        check_backlog(torch, f"mesh-2d {name}", got, n_windows, n_nodes, 0.5)
        launches[name] = ln
        runs, _ = wall_ms(torch, run)
        emit({"phase": f"mesh2d_{name}_schedule_windows", "config": "gpu-10kx10k",
              "mesh_shape": list(mesh.shape), "shards": MESH_SHARDS, "windows": n_windows,
              "window": WINDOW, "ms": statistics.median(runs), "ms_runs": runs,
              "flat_ms": flat[name]["ms"], "dense_ms": flat[name]["dense_ms"],
              "n_assigned": int(got.n_assigned), "launches": ln,
              "bitwise_dense": True, "bitwise_flat": True})

    kw = MESH_CASES["k1_auction"]
    resident = mesh_delta_cycles(torch, port, se, dense, snap, window, kw,
                                 np.random.default_rng(22), MESH2D_RESIDENT_CYCLES)
    for i, row in enumerate(resident["cycles"]):
        expect_launches(f"mesh-2d resident delta cycle {i}", row["launches"], {
            "masked_score": MESH_SHARDS, "row_stats": 0, "auction_bid": 0, "greedy_scan": 0})
    launches["resident"] = {k: sum(r["launches"][k] for r in resident["cycles"])
                            for k in port["fused"].launches}
    emit({"phase": "mesh2d_resident", "config": "gpu-10kx10k",
          "mesh_shape": list(mesh.shape), **resident})

    kw = dict(assigner="auction", normalizer="min_max")
    fn = L.make_sharded_learned_fn(learned_engine.params, mesh, model=learned_engine.model,
                                   node_axes=axes, **kw)
    row = warm_pair(torch, "mesh-2d learned auction window", lambda: fn(snap, window),
                    lambda: learned_engine.schedule_batch(snap, window, affinity_aware=False,
                                                          **kw))
    emit({"phase": "mesh2d_learned", "mesh_shape": list(mesh.shape), "bitwise_dense": True,
          "auction_window": row})

    _, pods_w = backlog_windows(port, pods)
    launches["sidecar_backlog"] = mesh_sidecar(
        torch, port, snap, pods_w, dense, "mesh2d_sidecar", axes,
        ["--mesh-devices", str(MESH_SHARDS), "--mesh-hosts", str(MESH2D_HOSTS)], spread)

    emit({"phase": "mesh2d_train", **mesh_train_step(torch, port, snap, window, spread)})
    emit({"phase": "mesh2d_seconds", "seconds": time.perf_counter() - t0})
    return launches


def mesh_train_step(torch, port, snap, window, spread: bool) -> dict:
    """sharded_train_step on a (dp, node) TRAIN_GRID mesh of the card (with
    `spread`, of the first cards) against train_step, two states from one
    seed (phase 22). The mesh step's peak memory is summed over the grid's
    cards."""
    P, L = port["parallel"], port["learned"]
    check_no_tf32(torch, "mesh-2d train step")
    dev = snap.allocatable.device
    n = TRAIN_GRID[0] * TRAIN_GRID[1]
    devices = [torch.device("cuda", k) for k in range(n)] if spread else [dev] * n
    grid = P.Mesh(devices, TRAIN_GRID, (P.DP_AXIS, P.NODE_AXIS))
    cards = sorted(set(devices), key=str)
    (d_state, d_model, d_tx), (m_state, m_model, m_tx) = (L.init_train_state(0),
                                                          L.init_train_state(0))
    n_params = sum(t.numel() for t in d_state.params.values())
    if n_params != 201_481:
        fail(f"mesh-2d train step: NodeScorer() has {n_params} parameters")
    pod_x, node_x = L.make_features(snap, window)
    teacher = port["compute_scores"](snap, window, "balanced_cpu_diskio")
    args = (pod_x, node_x, teacher, snap.node_mask, window.pod_mask)
    state = {"dense": d_state, "mesh": m_state}

    def dense_step():
        state["dense"], loss = L.train_step(state["dense"], d_model, d_tx, *args)
        return loss

    def mesh_step():
        state["mesh"], loss = L.sharded_train_step(state["mesh"], m_model, m_tx, grid, *args)
        return loss

    loss_err, param_err = [], {}
    for i in range(1, TRAIN_STEPS_CHECKED + 1):
        want, got = float(dense_step()), float(mesh_step())
        loss_err.append(abs(got - want) / abs(want))
        if not np.isfinite(got) or loss_err[-1] > TRAIN_LOSS_RTOL:
            fail(f"mesh-2d train step {i}: loss {got} against the dense {want}")
        if i in (1, TRAIN_STEPS_CHECKED):
            param_err[i] = max(max_abs_err(state["mesh"].params[k].detach(), t.detach())
                               for k, t in state["dense"].params.items())
            if not param_err[i] <= TRAIN_PARAM_TOL:
                fail(f"mesh-2d train step {i}: parameters differ by {param_err[i]}")
    if state["mesh"].step != TRAIN_STEPS_CHECKED:
        fail(f"mesh-2d train step: the state counts {state['mesh'].step} steps")
    out = {"config": "gpu-10kx10k", "pods": WINDOW, "nodes": snap.allocatable.shape[0],
           "grid": list(TRAIN_GRID), "cards": len(cards), "params": n_params,
           "loss_rel_err": loss_err, "param_max_abs_err": param_err}
    for name, step, on in (("dense", dense_step, [dev]), ("mesh", mesh_step, cards)):
        out[f"{name}_step_ms"] = cuda_ms(torch, step, n=TRAIN_TIMED_STEPS, warmup=1)
        for c in on:
            torch.cuda.synchronize(c)
            torch.cuda.reset_peak_memory_stats(c)
        base = sum(torch.cuda.memory_allocated(c) for c in on)
        step()
        for c in on:
            torch.cuda.synchronize(c)
        peak = sum(torch.cuda.max_memory_allocated(c) for c in on)
        out[f"{name}_peak_bytes"] = peak
        out[f"{name}_step_peak_bytes"] = peak - base
    return out


def run_mesh_cards(torch, port, snap, pods) -> None:
    """Phases 20-22 alone (--mesh-cards), each mesh over the first
    MESH_SHARDS cards."""
    if torch.cuda.device_count() < MESH_SHARDS:
        fail(f"--mesh-cards needs {MESH_SHARDS} cards, {torch.cuda.device_count()} visible")
    work = Path(__file__).resolve().parent / SMOKE_WORK
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    try:
        _, learned_engine = run_learned(torch, port, snap, pods, work)
        _, flat = run_mesh(torch, port, snap, pods, learned_engine, spread=True)
        run_mesh_2d(torch, port, snap, pods, learned_engine, flat, spread=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)


# phase 23: the port's bench. The engine rows and the suite's gpu config
# run at the reference's full sizes (bench.py's defaults: 10,000 nodes,
# 16,384 pods, windows of 512) with fewer timed calls; the host-loop
# block's sizes are cut so the phase stays near 150 s (each cut below,
# the bench's default beside it).
BENCH_REPS = 3                       # BENCH_REPS: 12
BENCH_LOOP_CUTS = {
    # 4,000 nodes. From 2,000 nodes on, the drift row's warm-up grows the
    # hostPort table once (a "port-churn" rebuild), which the reference
    # smoke test's assertions forbid; the reference's bench does the same
    # there (tests/test_torch_bench_rows.py::
    # test_torch_bench_drift_rebuilds_at_2000_nodes_e2e)
    "BENCH_LOOP_NODES": "1000",
    "BENCH_LOOP_PODS": "2048",       # 8,192 pods a backlog
    "BENCH_LOOP_SAMPLES": "3",       # >= 10 measured cycles a row
    # 100,000 nodes; not 10,000, whose scheduling_throughput_10000nodes
    # row would share the headline's name
    "BENCH_SHARDED_NODES": "20000",
    "BENCH_SHARDED_PODS": "8192",    # 50,000 pods
    "BENCH_DRIFT_ROUNDS": "6",       # 12 rounds
    "BENCH_SCENARIO_INTENSITY": "0.25",  # 1.0
}
BENCH_SUITE_CONFIG = "gpu-10kx10k"
# the kernels the bench's path runs: K1 (every fused row), K3 (every
# auction round of a selector-free window), K4 (the suite's greedy
# oracle). K2 runs only under normalizer="min_max", which no bench row
# asks for (the reference's rows pass "none", or schedule_windows'
# default "none"), so it launches 0 times here.
BENCH_KERNELS = ("masked_score", "auction_bid", "greedy_scan")


def _need(cond, what, row=None) -> None:
    if not cond:
        raise AssertionError(f"{what}: {row}" if row is not None else what)


def check_bench_rows(metrics: dict, *, nodes, loop_nodes: int, sharded_nodes: int,
                     mesh_devices: int) -> None:
    """The assertions tests/test_bench_smoke.py makes of the reference
    bench's rows, on the port's rows ({metric: row}) at the given knobs
    (BENCH_NODES, or None without the engine rows; BENCH_LOOP_NODES;
    BENCH_SHARDED_NODES); the mesh is `mesh_devices` shards, not 8.
    Raises AssertionError naming the first row that fails."""
    ln, sn = loop_nodes, sharded_nodes
    sn_thr = sn - sn % mesh_devices  # _sharded_throughput keeps it mesh-divisible
    want = [
        f"host_loop_{ln}nodes", f"host_loop_{ln}nodes_deep16w",
        f"host_loop_{ln}nodes_pipelined", f"host_loop_{ln}nodes_fused",
        f"host_loop_{ln}nodes_resident", f"host_loop_{ln}nodes_streaming",
        f"host_loop_{ln}nodes_idle_streaming", f"host_loop_{ln}nodes_streaming_drift",
        f"host_loop_{sn}nodes", f"host_loop_{sn}nodes_streaming",
        f"host_loop_{max(sharded_nodes // 10, 8)}nodes_sharded_ref",
        f"scheduling_throughput_{sn_thr}nodes",
        *(f"host_loop_{ln}nodes_replicas{n}" for n in (1, 2, 4)),
        f"host_loop_{ln}nodes_replicas1_shared", f"host_loop_{ln}nodes_replicas4_shared",
        f"host_loop_{ln}nodes_replicas", f"host_loop_{ln}nodes_replay",
        f"host_loop_{ln}nodes_shadow", f"host_loop_{ln}nodes_telemetry",
        f"host_loop_{ln}nodes_attribution", f"scenario_burst_{ln}nodes",
        f"scenario_gang_{ln}nodes", f"host_loop_{ln}nodes_chaos",
    ]
    if nodes is not None:
        want += [f"scheduling_throughput_{nodes}nodes{s}"
                 for s in ("", "_deployed_default", "_weighted_multi_scorer")]
    for name in want:
        _need(name in metrics, f"row {name} missing", sorted(metrics))
    if nodes is not None:
        for s in ("", "_deployed_default", "_weighted_multi_scorer"):
            row = metrics[f"scheduling_throughput_{nodes}nodes{s}"]
            _need(row["value"] > 0 and row["vs_baseline"] > 0, "engine row", row)
    h = f"host_loop_{ln}nodes"
    for name in (h, f"{h}_pipelined", f"{h}_resident"):
        _need(metrics[name]["pods_bound"] > 0 and metrics[name]["cycle_p50_ms"] > 0,
              name, metrics[name])
    pipe = metrics[f"{h}_pipelined"]
    _need("host_overlap_p50_ms" in pipe and "pipeline_flushes" in pipe, "pipelined", pipe)
    fus = metrics[f"{h}_fused"]
    _need(fus["pods_bound"] > 0 and fus["unfused_pods_per_sec"] > 0
          and "fused_engine_speedup" in fus and "fused_cycle_speedup" in fus
          and fus["fallback_cycles"] == 0, "fused", fus)
    res = metrics[f"{h}_resident"]
    _need(res["delta_uploads"] > 0 and res["fallback_cycles"] == 0
          and 0.0 < res["delta_hit_rate"] <= 1.0 and res["snapshot_upload_bytes"] > 0
          and res["delta_bytes_saved"] > 0, "resident", res)
    st = metrics[f"{h}_streaming"]
    _need(st["pods_bound"] > 0 and st["fallback_cycles"] == 0 and st["delta_uploads"] > 0
          and st["mirror_verify_failures"] == 0 and st["mirror_events_per_cycle"] > 0
          and st["mirror_full_rebuilds"] <= 2 and "streaming_stage_speedup" in st
          and st["baseline_pods_per_sec"] > 0 and st["cycle_slo_ms"] == 50.0
          and st["slo_breaches"] >= 0, "streaming", st)
    idle = metrics[f"{h}_idle_streaming"]
    _need(idle["idle_zero_row_deltas"] is True and idle["events_per_cycle"] == 0
          and idle["mirror_emit_idle_p50_ms"] >= 0 and idle["trigger_latency_p50_ms"] < 500,
          "idle_streaming", idle)
    drift = metrics[f"{h}_streaming_drift"]
    ext, rounds = drift["mirror_incremental_extensions"], drift["drift_rounds"]
    _need(drift["pods_bound"] > 0 and ext.get("selector", 0) >= rounds - 4
          and ext.get("port-remap", 0) >= rounds - 4 and drift["drift_rebuilds"] <= 4
          and drift["mirror_rebuild_reasons"].get("port-churn", 0) == 0
          and drift["mirror_verify_failures"] == 0 and drift["final_verify_ok"] is True,
          "streaming_drift", drift)
    for name in (f"host_loop_{sn}nodes", f"host_loop_{sn}nodes_streaming"):
        sha = metrics[name]
        _need(sha["pods_bound"] > 0 and sha["fallback_cycles"] == 0
              and sha["mesh_devices"] == mesh_devices and sha["sharded_cycles"] == sha["cycles"]
              and sha["delta_uploads"] > 0 and sha["shard_delta_bytes_per_cycle"] > 0,
              name, sha)
    sha = metrics[f"host_loop_{sn}nodes"]
    _need(sha["ref_shard_delta_bytes_per_cycle"] > 0 and sha["flat_bytes_ratio"] > 0,
          "sharded flat bytes", sha)
    _need(metrics[f"host_loop_{sn}nodes_streaming"]["mirror_verify_failures"] == 0,
          "sharded streaming", metrics[f"host_loop_{sn}nodes_streaming"])
    ref = metrics[f"host_loop_{max(sharded_nodes // 10, 8)}nodes_sharded_ref"]
    _need(ref["pods_bound"] > 0 and ref["fallback_cycles"] == 0, "sharded_ref", ref)
    thr = metrics[f"scheduling_throughput_{sn_thr}nodes"]
    _need(thr["mesh_devices"] == mesh_devices and thr["assigned"] > 0 and thr["value"] > 0,
          "sharded throughput", thr)
    for n in (1, 2, 4):
        row = metrics[f"{h}_replicas{n}"]
        _need(row["pods_bound"] > 0 and row["double_binds"] == 0
              and len(row["binds_per_replica"]) == n, f"replicas{n}", row)
    r4 = metrics[f"{h}_replicas4"]
    _need(len(set(r4["binds_per_replica"].values())) == 1, "replicas4 balance", r4)
    head = metrics[f"{h}_replicas"]
    _need(head["double_binds"] == 0 and head["pods_lost"] == 0
          and head["bind_conflicts"] == head["storm_overlap_pods"]
          and head["pods_discarded"] == head["storm_overlap_pods"]
          and head["requeue_latency_count"] == head["bind_conflicts"]
          and head["requeue_latency_mean_ms"] > 0
          and head["scaling_x_2"] > 0 and head["scaling_x_4"] > 0, "replicas", head)
    for n in (1, 4):
        row = metrics[f"{h}_replicas{n}_shared"]
        _need(row["pods_bound"] > 0 and row["double_binds"] == 0
              and sum(row["uploads"].values()) >= 1 and row["upload_bytes_vs_private"] < 1.0,
              f"replicas{n}_shared", row)
    s4 = metrics[f"{h}_replicas4_shared"]
    _need(s4["coalesced_dispatches"] > 0 and s4["dispatches_per_round"] < 4
          and "scaling_x_4" in s4, "replicas4_shared", s4)
    _need(head["shared_storm_double_binds"] == 0 and head["shared_storm_pods_lost"] == 0
          and head["shared_storm_bind_conflicts"] > 0
          and head["shared_storm_dispatches_per_tick"] < 2, "shared storm", head)
    rep = metrics[f"{h}_replay"]
    _need(rep["binding_diffs"] == 0 and rep["cycles_replayed"] > 0 and rep["pods_replayed"] > 0
          and rep["traced_pods_per_sec"] > 0 and "trace_overhead_pct" in rep
          and rep["trace_bytes"] > 0, "replay", rep)
    sh = metrics[f"{h}_shadow"]
    _need(sh["records_rescored"] > 0 and sh["bindings_changed"] == 0
          and sh["divergence_ratio"] == 0.0 and sh["shadow_pods_per_sec"] > 0
          and sh["breaker_state"] == "closed", "shadow", sh)
    tel = metrics[f"{h}_telemetry"]
    _need(tel["pods_bound"] > 0 and tel["spans_written"] > 0 and tel["span_bytes"] > 0
          and tel["spans_dropped"] == 0 and tel["metrics_scrapes"] > 0
          and "telemetry_overhead_pct" in tel, "telemetry", tel)
    att = metrics[f"{h}_attribution"]
    _need(att["cycles"] > 0 and att["cycle_p50_ms"] > 0
          and "engine_step" in att["attribution_pct"]
          and abs(sum(att["attribution_pct"].values()) - 100.0) < 0.5
          and att["stage_p50_ms"]["engine_step"] > 0, "attribution", att)
    for name in (f"scenario_burst_{ln}nodes", f"scenario_gang_{ln}nodes"):
        _need(metrics[name]["pods_bound"] > 0 and metrics[name]["fallback_cycles"] == 0,
              name, metrics[name])
    gang = metrics[f"scenario_gang_{ln}nodes"]
    _need(gang["gangs_admitted"] > 0 and 0.0 < gang["gang_admit_rate"] <= 1.0, "gang", gang)
    chaos = metrics[f"{h}_chaos"]
    _need(chaos["pods_bound"] > 0 and chaos["faults_injected"]
          and 0 < chaos["degraded_cycles"] < chaos["cycles"]
          and chaos["breaker_transitions"].get("open", 0) >= 1
          and chaos["breaker_transitions"].get("closed", 0) >= 1
          and chaos["breaker_state"] == "closed" and chaos["recovery_episodes"] > 0
          and chaos["unrecovered_episodes"] == 0 and chaos["recovery_latency_ms_p99"] > 0
          and chaos["recovered"] is True, "chaos", chaos)


def run_bench(torch, port, dev) -> dict:
    """Phase 23: the port's bench in this process, so the launch counts
    can be read. bench.main(["--device", "cuda"]) runs the default mode
    (the three engine rows at the reference's sizes with BENCH_REPS
    timed calls, the host-loop block at BENCH_LOOP_CUTS) with each
    engine row and each host-loop row counted on its own (the counts set
    to 0 just before the row, read just after); then one suite_rate over
    BENCH_SUITE_CONFIG (its greedy oracle is K4's launch on this path).
    Fails on an exit other than 0, any diag line but the backend line,
    a missing row, a row that fails check_bench_rows, and a first
    untimed call of an engine row or of the suite (its auction and its
    greedy oracle) that differs from the same call on the plain
    versions. Returns {row: launches}."""
    bench, engine = port["bench"], port["engine_module"]
    launches: dict = {}
    seconds: dict = {}
    first: dict = {}  # (row, assigner) -> the first call's (args, kw, out)
    engine_row, host_loop_rows = bench.engine_row, bench.host_loop_rows
    schedule_windows = engine.schedule_windows

    @contextlib.contextmanager
    def recording(row):
        """engine.schedule_windows, for the block, keeps each assigner's
        first call in `first` (the bench imports it at call time)."""
        def record(*a, **kw):
            out = schedule_windows(*a, **kw)
            first.setdefault((row, kw.get("assigner")), (a, kw, out))
            return out

        engine.schedule_windows = record
        try:
            yield
        finally:
            engine.schedule_windows = schedule_windows

    def counted_engine_row(suffix, *a, **kw):
        t0 = time.perf_counter()
        with recording(f"scheduling_throughput_{bench.N_NODES}nodes{suffix}"):
            row, counts = counted(torch, port, lambda: engine_row(suffix, *a, **kw))
        launches[row["metric"]] = counts
        seconds[row["metric"]] = time.perf_counter() - t0
        return row

    def counted_loop_rows(**kw):
        rows = host_loop_rows(**kw)
        while True:
            t0 = time.perf_counter()
            try:
                group, counts = counted(torch, port, lambda: next(rows))
            except StopIteration:
                return
            launches[group["metric"]] = counts
            seconds[group["metric"]] = time.perf_counter() - t0
            yield group

    saved = {k: os.environ.get(k) for k in BENCH_LOOP_CUTS}
    out = io.StringIO()
    try:
        os.environ.update(BENCH_LOOP_CUTS)
        bench.REPS = BENCH_REPS
        bench.engine_row, bench.host_loop_rows = counted_engine_row, counted_loop_rows
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = bench.main(["--device", "cuda"])
        main_s = time.perf_counter() - t0
    finally:
        bench.engine_row, bench.host_loop_rows = engine_row, host_loop_rows
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    lines = [json.loads(x) for x in out.getvalue().splitlines() if x.startswith("{")]
    if rc != 0:
        fail(f"bench exited {rc}: {lines[-3:]}")
    if not lines or lines[0].get("diag") != "backend" or lines[0].get("platform") != "gpu":
        fail(f"bench's first line is not the card's backend line: {lines[:1]}")
    diags = [x for x in lines[1:] if "diag" in x]
    if diags:
        fail(f"bench printed diag lines: {diags}")
    rows = {x["metric"]: x for x in lines[1:]}
    if len(rows) != len(lines) - 1:
        fail(f"bench printed {len(lines) - 1} rows under {len(rows)} names")
    headline = f"scheduling_throughput_{bench.N_NODES}nodes"
    if lines[-1].get("metric") != headline:
        fail(f"bench's last row is not {headline}: {lines[-1]}")
    try:
        check_bench_rows(rows, nodes=bench.N_NODES,
                         loop_nodes=int(BENCH_LOOP_CUTS["BENCH_LOOP_NODES"]),
                         sharded_nodes=int(BENCH_LOOP_CUTS["BENCH_SHARDED_NODES"]),
                         mesh_devices=port["parallel"].sharded_device_count())
    except AssertionError as e:
        fail(f"bench row: {e}")
    for name, row in rows.items():
        emit({"phase": "bench_row", "row": row, "seconds": seconds.get(name),
              "launches": launches.get(name)})
    emit({"phase": "bench_main", "rows": len(rows), "seconds": main_s,
          "reps": BENCH_REPS, "cuts": BENCH_LOOP_CUTS,
          "threads_after": threading.active_count()})
    # one suite config at full size
    t0 = time.perf_counter()
    with recording(f"suite/{BENCH_SUITE_CONFIG}"):
        suite, launches[f"suite/{BENCH_SUITE_CONFIG}"] = counted(
            torch, port, lambda: bench.suite_rate(BENCH_SUITE_CONFIG, device=dev)
        )
    emit({"phase": "bench_suite", "row": suite, "seconds": time.perf_counter() - t0,
          "launches": launches[f"suite/{BENCH_SUITE_CONFIG}"]})
    if suite["assigned"] <= 0 or suite["assigned_greedy"] <= 0:
        fail(f"bench suite row placed nothing: {suite}")
    # each engine row's first untimed call and the suite's first auction
    # and greedy call against the same call on the plain versions (the
    # plain runs launch no kernel and lie outside every count)
    want = {(f"scheduling_throughput_{bench.N_NODES}nodes{s}", "auction")
            for s in ("", "_deployed_default", "_weighted_multi_scorer")}
    want |= {(f"suite/{BENCH_SUITE_CONFIG}", a) for a in ("auction", "greedy")}
    if set(first) != want:
        fail(f"bench: first calls recorded {sorted(first)}, not {sorted(want)}")
    t0 = time.perf_counter()
    for (row, assigner), (a, kw, out) in sorted(first.items()):
        check_equal(torch, f"bench {row} {assigner} first call", out,
                    schedule_windows(*a, **kw, _plain=True))
    emit({"phase": "bench_first_calls", "equal_to_plain": sorted(f"{r} {a}" for r, a in first),
          "seconds": time.perf_counter() - t0})
    first.clear()
    total = {k: sum(c[k] for c in launches.values()) for k in port["fused"].launches}
    missing = [k for k in BENCH_KERNELS if total[k] == 0]
    if missing:
        fail(f"bench: kernels never launched: {missing} ({total})")
    emit({"phase": "bench_launches", "total": total})
    return launches


def load_port() -> dict:
    """The port's functions the phases call, by name (a CPU rehearsal
    passes its own dict); fails when the port is not importable or
    imports jax."""
    try:
        from kubernetes_scheduler_tpu_torch import TorchEngine, stack_windows
        from kubernetes_scheduler_tpu_torch import bench, parallel
        from kubernetes_scheduler_tpu_torch import engine as engine_module
        from kubernetes_scheduler_tpu_torch.bridge import server
        from kubernetes_scheduler_tpu_torch.bridge.client import RemoteEngine
        from kubernetes_scheduler_tpu_torch.bridge.server import make_server
        from kubernetes_scheduler_tpu_torch.cli import main as cli_main
        from kubernetes_scheduler_tpu_torch.device import reset_transfers, to_host, transfers
        from kubernetes_scheduler_tpu_torch.engine import (
            DOMAIN_TABLES,
            NORMALIZERS,
            POLICIES,
            UTIL_SERIES,
            SnapshotDelta,
            build_fused_layout,
            compute_free_capacity,
            compute_scores,
            compute_soft_scores,
            fused_score_operands,
            make_affinity_state,
            make_snapshot,
            preempt_on_host,
            schedule_batch,
            schedule_windows,
            snapshot_nbytes,
        )
        from kubernetes_scheduler_tpu_torch.host.observe import SHIPPED_SPANS
        from kubernetes_scheduler_tpu_torch.host.queue import namespace_partition
        from kubernetes_scheduler_tpu_torch.host.replica import ReplicaFleet
        from kubernetes_scheduler_tpu_torch.host.scheduler import RecordingEvictor, Scheduler
        from kubernetes_scheduler_tpu_torch.host.shadow import ShadowScheduler
        from kubernetes_scheduler_tpu_torch.host.types import Container, MatchExpression, Pod
        from kubernetes_scheduler_tpu_torch.kube.source import KubeBinder
        from kubernetes_scheduler_tpu_torch.models import learned
        from kubernetes_scheduler_tpu_torch.ops import _build, assign, fused
        from kubernetes_scheduler_tpu_torch.ops.assign import (
            NEG,
            auction_values,
            greedy_scan_operands,
        )
        from kubernetes_scheduler_tpu_torch.ops.score import alpha_beta
        from kubernetes_scheduler_tpu_torch.sim import (
            gen_cluster,
            gen_config,
            gen_host_cluster,
            gen_host_pods,
            gen_pods,
        )
        from kubernetes_scheduler_tpu_torch.sim.scenarios import (
            SCENARIOS,
            run,
            scenario_config,
        )
        from kubernetes_scheduler_tpu_torch.analysis import (
            contracts,
            kernel_budget,
            spmd_mutants,
        )
        from kubernetes_scheduler_tpu_torch.trace import analyze, inspect
        from kubernetes_scheduler_tpu_torch.trace.replay import (
            engine_kw_from_record,
            pod_batch_from_record,
            reconstruct_cycles,
            replay_journal,
        )
        from kubernetes_scheduler_tpu_torch.trace.spans import read_spans
        from kubernetes_scheduler_tpu_torch.utils.config import SchedulerConfig
        from kubernetes_scheduler_tpu_torch.utils.padding import pad_pod_batch
    except ImportError as e:
        fail(f"the port is not importable (run from the repository root): {e}")
    if "jax" in sys.modules:
        fail("jax was imported")
    port = dict(
        TorchEngine=TorchEngine, stack_windows=stack_windows, fused=fused,
        engine_module=engine_module,
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
        reset_transfers=reset_transfers, Scheduler=Scheduler,
        RecordingEvictor=RecordingEvictor, SchedulerConfig=SchedulerConfig,
        gen_host_cluster=gen_host_cluster, gen_host_pods=gen_host_pods, Pod=Pod,
        Container=Container, MatchExpression=MatchExpression,
        preempt_on_host=preempt_on_host, _build=_build, schedule_batch=schedule_batch,
        SHIPPED_SPANS=SHIPPED_SPANS, namespace_partition=namespace_partition,
        ReplicaFleet=ReplicaFleet, ShadowScheduler=ShadowScheduler, SCENARIOS=SCENARIOS,
        run_scenario=run, scenario_config=scenario_config, build_report=analyze.build_report,
        inspect=inspect, replay_journal=replay_journal, reconstruct_cycles=reconstruct_cycles,
        pod_batch_from_record=pod_batch_from_record,
        engine_kw_from_record=engine_kw_from_record, read_spans=read_spans,
        make_server=make_server, RemoteEngine=RemoteEngine, cli_main=cli_main,
        KubeBinder=KubeBinder, to_host=to_host, learned=learned, parallel=parallel,
        server=server, compute_scores=compute_scores,
        kernel_budget=kernel_budget, contracts=contracts, spmd_mutants=spmd_mutants,
        bench=bench, schedule_windows=schedule_windows,
    )
    return port


def run_kernel_resources(torch, port, n: int, r: int) -> None:
    """Phase 2b: the kernels' registers, shared memory and spills from a
    fresh nvcc build, held exactly against csrc/kernel_budget.json, and
    greedy_pass_kernel's dynamic shared memory at n nodes x r resources
    (the main path's) beside the card's opt-in limit. Fails on a reading
    it cannot parse, on nvcc missing, and on any difference."""
    kb = port["kernel_budget"]
    t0 = time.perf_counter()
    try:
        measured = kb.measure()
    except (RuntimeError, ValueError, OSError) as e:
        fail(f"kernel_resources: no ptxas reading: {e}")
    seconds = time.perf_counter() - t0
    budget = kb.load_budget()
    pass_static = max(
        row["static_smem_bytes"] for row in measured["kernels"]
        if row["kernel"].startswith("greedy_pass_kernel")
    )
    optin = int(torch.cuda.get_device_properties(0).shared_memory_per_block_optin)
    need = n * r * 4  # the free-capacity carry, float32 (launch_greedy_scan)
    problems = kb.compare(measured, budget)
    emit({
        "phase": "kernel_resources", "seconds": seconds,
        "nvcc": measured["nvcc"], "budget_nvcc": budget.get("nvcc"),
        "kernels": measured["kernels"],
        "greedy_pass_dynamic_smem": {
            "n": n, "r": r, "dynamic_bytes": need, "static_bytes": pass_static,
            "optin_bytes": optin, "in_shared_memory": need + pass_static <= optin,
        },
        "budget_matches": not problems,
    })
    if problems:
        fail("kernel_resources: " + "; ".join(problems))


def run_contracts(torch, port, device: str = "cuda") -> dict:
    """Phase 2c: layer 2 of the port's checker on the card. The dense
    contracts at the checker's GRID and at the main path's width, the
    sharded contracts on both meshes at GRID and at full width with 2
    windows (the sharded greedy is ~0.7 s a window on 4 shards; the
    option variants at GRID only), the collective call sites read here
    against the budget file written on the CPU, and the SPMD mutant
    harness. Launch counts are reset just before and read just after;
    fails on any violation (a budget that differs is one) and when K1,
    K2, K3 or K4 never launched."""
    contracts, fused = port["contracts"], port["fused"]
    t0 = time.perf_counter()
    fused.reset_launches()
    dense, sharded = [], []
    violations = contracts.check_contracts(
        device=device, grid=contracts.GRID + (contracts.FULL,), checked=dense)
    dense_launches = dict(fused.launches)
    violations += contracts.check_sharded_contracts(
        device=device, grid=contracts.GRID + (dict(contracts.FULL, w=2),), checked=sharded)
    launches = dict(fused.launches)
    contracts_s = time.perf_counter() - t0
    # check_sharded_contracts held each mesh's call sites, read here on the
    # card, to the budget file written on the CPU: a difference is a
    # collective-budget finding tagged with the mesh's name
    budget_equal = {
        name: not any(v.rule == contracts.BUDGET_RULE and v.message.startswith(f"[{name}]")
                      for v in violations)
        for name in contracts.meshes(device)
    }
    violations += port["spmd_mutants"].check_spmd_mutants(device)
    emit({
        "phase": "contracts", "device": device,
        "surfaces": sorted(set(contracts.CONTRACT_NAMES) | set(contracts.SHARDED_CONTRACT_NAMES)),
        "checks": len(dense) + len(sharded),
        "full_width_checks": sum(g["n"] == contracts.FULL["n"] for *_, g in dense + sharded),
        "violations": len(violations), "seconds": time.perf_counter() - t0,
        "contract_seconds": contracts_s,
        "launches": launches, "dense_launches": dense_launches,
        "budget_equal": budget_equal,
    })
    if violations:
        fail("contracts: " + "; ".join(v.format() for v in violations[:8]))
    missing = [name for name in REPLACES if launches[name] < 1]
    if missing:
        fail(f"contracts: {missing} never launched in the contracts phase")
    return launches


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent-tree", default=None,
                    help="a checkout of an earlier commit (e09185f or later): time its "
                         "K1, K2 and K4 beside this tree's")
    ap.add_argument("--mesh-cards", action="store_true",
                    help="run phases 20-22 alone with each mesh over the first "
                         f"{MESH_SHARDS} cards")
    ap.add_argument("--bench", action="store_true",
                    help="run phase 23 (the port's bench) alone")
    args = ap.parse_args()
    try:
        import torch
    except ImportError as e:
        fail(f"torch is not importable: {e}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this run needs a CUDA card")
    port = load_port()
    TorchEngine, _build = port["TorchEngine"], port["_build"]
    gen_cluster, gen_config, gen_pods = port["gen_cluster"], port["gen_config"], port["gen_pods"]

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
    lib_path, _log = _build.build()
    _build.load_library()
    print(f"build: {lib_path.name} in {time.perf_counter() - t0:.3f} s", flush=True)

    snap, pods = gen_config("gpu-10kx10k", seed=0, device=dev)
    if args.mesh_cards:
        run_mesh_cards(torch, port, snap, pods)
        emit({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}})
        return
    if args.bench:
        t0 = time.perf_counter()
        run_bench(torch, port, dev)
        emit({"phase": "bench_seconds", "seconds": time.perf_counter() - t0})
        emit({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}})
        return

    # ---- 2b. kernel resources against csrc/kernel_budget.json -----------
    n_nodes, n_res = snap.allocatable.shape
    run_kernel_resources(torch, port, int(n_nodes), int(n_res))

    # ---- 2c. the engine contracts and the collective budget on the card --
    contracts_launches = run_contracts(torch, port)

    # ---- 3. kernels against their plain versions ------------------------
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

    # ---- 13. the port's own host loop at 10,000 nodes ---------------------
    t0 = time.perf_counter()
    host = run_host_loop(torch, port)
    emit({"phase": "host_loop_seconds", "seconds": time.perf_counter() - t0})

    # ---- 14. preemption through the host loop ------------------------------
    t0 = time.perf_counter()
    preempt_inputs = run_host_preemption(torch, port)
    emit({"phase": "host_preemption_seconds", "seconds": time.perf_counter() - t0})

    # ---- 15-19. journal and replay, fleet and shadow, scenarios, the
    # sidecar, the live-cluster path ---------------------------------------
    work = Path(__file__).resolve().parent / SMOKE_WORK
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    server = None
    try:
        t0 = time.perf_counter()
        journal_launches, journal = run_journal(torch, port, work)
        emit({"phase": "journal_seconds", "seconds": time.perf_counter() - t0})
        t0 = time.perf_counter()
        fleet_launches = run_fleet_and_shadow(torch, port, journal)
        emit({"phase": "fleet_shadow_seconds", "seconds": time.perf_counter() - t0})
        t0 = time.perf_counter()
        scenario_launches = run_scenarios(torch, port, work)
        emit({"phase": "scenarios_seconds", "seconds": time.perf_counter() - t0})
        t0 = time.perf_counter()
        bridge_launches, server, address = run_bridge(torch, port, snap, pods, preempt_inputs)
        emit({"phase": "bridge_seconds", "seconds": time.perf_counter() - t0})
        t0 = time.perf_counter()
        live_launches = run_live_cluster(torch, port, work, address)
        emit({"phase": "live_cluster_seconds", "seconds": time.perf_counter() - t0})
        if server is not None:
            server.stop(grace=None)
            server = None

        # ---- 20. the learned scorer at full width ---------------------------
        learned_launches, learned_engine = run_learned(torch, port, snap, pods, work)

        # ---- 21. the node-sharded engine on one card ------------------------
        mesh_launches, flat = run_mesh(torch, port, snap, pods, learned_engine)

        # ---- 22. the (dcn, node) mesh and the dp x node training step -------
        mesh2d_launches = run_mesh_2d(torch, port, snap, pods, learned_engine, flat)
    finally:
        if server is not None:
            server.stop(grace=None)
        shutil.rmtree(work, ignore_errors=True)

    # ---- 23. the port's bench ------------------------------------------------
    t0 = time.perf_counter()
    bench_launches = run_bench(torch, port, dev)
    emit({"phase": "bench_seconds", "seconds": time.perf_counter() - t0})

    # ---- 24. the kernels line and the result ----------------------------
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
            "contracts_launches": contracts_launches[name],
            "multi_scorer_launches": {k: v[name] for k, v in multi.items()},
            "resident_launches": {path: {run: counts[name] for run, counts in runs.items()}
                                  for path, runs in resident.items()},
            "host_loop_launches": {run: [c[name] for c in cycles]
                                   for run, cycles in host.items()},
            "journal_launches": launches_of(journal_launches, name),
            "fleet_shadow_launches": launches_of(fleet_launches, name),
            "scenario_launches": launches_of(scenario_launches, name),
            "bridge_launches": launches_of(bridge_launches, name),
            "live_cluster_launches": launches_of(live_launches, name),
            "learned_launches": launches_of(learned_launches, name),
            "mesh_launches": launches_of(mesh_launches, name),
            "mesh_2d_launches": launches_of(mesh2d_launches, name),
            "bench_launches": launches_of(bench_launches, name),
        })
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}})


if __name__ == "__main__":
    main()
