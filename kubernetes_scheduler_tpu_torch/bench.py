"""Benchmark: batched scheduling throughput on the CUDA card against the
reference design (counterpart of the repo root's bench.py, which measures
the JAX package).

North-star metric (BASELINE.json): scheduling throughput at 10k nodes.
The reference publishes no numbers (BASELINE.md), so the denominator is a
faithful in-process emulation of its per-pod scheduling cycle: for every
pod, sequentially — recompute cluster utilization statistics, score every
node with the live BalancedCpuDiskIO formula, min-max normalize, pick the
best feasible node, decrement its capacity (what upstream kube-scheduler +
the yoda plugin compute per cycle, minus all of its network round-trips:
no 5.(N+1) Prometheus HTTP calls, no Redis — a strictly generous
baseline). The port schedules the same pods through the batched engine
in windows, carrying capacity between windows.

    python -m kubernetes_scheduler_tpu_torch.bench [--device cuda|cpu]
        [--suite | --loop | --perf-gate-spans DIR]

The same BENCH_* knobs, metric names, row keys and line order as the
reference's bench.py; the default mode ends with the headline
`scheduling_throughput_{N}nodes` row. Every mode runs on the CUDA card
unless --device cpu is passed; without a card the backend line reports
the failure and the run exits 1, measuring nothing. Each row's wall
seconds go to standard error.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

N_NODES = int(os.environ.get("BENCH_NODES", 10_000))
N_PODS = int(os.environ.get("BENCH_PODS", 16_384))
WINDOW = int(os.environ.get("BENCH_WINDOW", 512))
BASELINE_PODS = int(os.environ.get("BENCH_BASELINE_PODS", 64))
# back-to-back backlogs per measurement; suite_rate shares the knob
# (capped by its 65536-cell budget)
REPS = int(os.environ.get("BENCH_REPS", 12))
# the fused score + feasibility kernels (K1, K2; identical decisions)
FUSED = os.environ.get("BENCH_FUSED", "1") != "0"
# auction price step as a fraction of the unit score range (1.0 is also
# the shipped host default)
PRICE_FRAC = float(os.environ.get("BENCH_PRICE_FRAC", 1.0))
# the reference's PRODUCTION scoring: yoda at weight 2 beside the k8s
# 1.22 default shape scorers (example/config:25-27 +
# deploy/yoda-scheduler.yaml:21-47 disabling nothing)
MULTI_SCORER = (
    ("balanced_cpu_diskio", 2.0), ("least_allocated", 1.0),
    ("balanced_allocation", 1.0), ("image_locality", 1.0),
)
# where --suite writes its rows (never the root BENCH_SUITE.json: that
# file is the reference's record)
SUITE_OUT = "bench_suite_torch.json"


def baseline_rate(snapshot, pods) -> float:
    """Pods/sec of the sequential per-pod reference design (numpy), on
    host leaves (numpy arrays or CPU tensors).

    Measured in steady state: tiny configs repeat the whole pod set until
    the measurement covers ~100ms of work — a single 1-pod iteration
    would time interpreter warmup, not the design."""
    alloc = np.asarray(snapshot.allocatable)
    requested0 = np.asarray(snapshot.requested)
    disk_io = np.asarray(snapshot.disk_io)
    cpu_pct = np.asarray(snapshot.cpu_pct)
    req = np.asarray(pods.request)[:BASELINE_PODS]
    r_io = np.asarray(pods.r_io)[:BASELINE_PODS]

    reps = max(1, 512 // max(len(req), 1))
    t0 = time.perf_counter()
    for _ in range(reps):
        requested = requested0.copy()
        _baseline_pass(req, r_io, alloc, requested, disk_io, cpu_pct)
    dt = time.perf_counter() - t0
    return reps * len(req) / dt


def _baseline_pass(req, r_io, alloc, requested, disk_io, cpu_pct):
    for i in range(len(req)):
        # per-cycle statistics (algorithm.go:67-89 recomputes these per pod)
        u = disk_io / 50.0
        v = cpu_pct / 100.0
        u_avg = u.mean()
        _ = ((u - u_avg) ** 2).mean()
        # live policy (algorithm.go:99-119)
        rio = r_io[i] if r_io[i] > 0 else np.inf
        beta = 1.0 / (1.0 + req[i, 0] / rio)
        alpha = 1.0 - beta
        s = 10.0 - 10.0 * np.abs(alpha * v - beta * u)
        # normalize (scheduler.go:158-183)
        hi, lo = max(s.max(), 0.0), s.min()
        if hi == lo:
            lo -= 1.0
        s = (s - lo) * 100.0 / (hi - lo)
        # feasibility + bind (upstream NodeResourcesFit + binding cycle)
        fits = ((requested + req[i]) <= alloc).all(axis=1)
        s[~fits] = -np.inf
        j = int(np.argmax(s))
        if np.isfinite(s[j]):
            requested[j] += req[i]


def _upload(nt, device):
    """Every leaf of a SnapshotArrays / PodBatch (host arrays or CPU
    tensors) on `device`, each through device.to_device (counted, pinned
    copies to a card)."""
    from kubernetes_scheduler_tpu_torch.device import to_device

    return type(nt)(*[to_device(x, device) for x in nt])


def device_rate(
    snapshot, pods, *, price_frac: float = None, affinity_aware: bool = False,
    score_plugins: tuple = None, device=None,
) -> float:
    """Pods/sec of the batched engine (the reference's tpu_rate): the
    whole backlog as ONE call of engine.schedule_windows (a loop over
    capacity-carrying windows) on `device` (cuda unless given). The
    snapshot and the stacked, padded backlog upload once, through
    device.to_device; an untimed first call; then REPS calls timed by
    the host clock up to one read of the last call's n_assigned through
    device.to_host.

    "Pipelined" on the port: the reference enqueued REPS XLA programs
    back to back and synchronised once. Here each call is a Python loop
    of launches, and the auction reads its any-bid flag from the card
    every 8 rounds, so the host waits inside every call and consecutive
    calls do not overlap. The number is wall time either way."""
    from kubernetes_scheduler_tpu_torch.device import resolve_device, to_host
    from kubernetes_scheduler_tpu_torch.engine import schedule_windows, stack_windows
    from kubernetes_scheduler_tpu_torch.utils.padding import pad_pod_batch

    dev = resolve_device(device)
    n_padded = -(-N_PODS // WINDOW) * WINDOW
    snapshot = _upload(snapshot, dev)
    pods_w = _upload(stack_windows(pad_pod_batch(pods, n_padded), WINDOW), dev)

    kw = dict(assigner="auction", fused=FUSED, affinity_aware=affinity_aware,
              auction_price_frac=PRICE_FRAC if price_frac is None else price_frac)
    if score_plugins:
        # weighted multi-plugin combination (no fused kernel for it)
        kw.update(score_plugins=score_plugins, fused=False)
    out = schedule_windows(snapshot, pods_w, **kw)
    assigned = int(to_host(out.n_assigned))
    if assigned == 0:
        raise RuntimeError("benchmark scheduled zero pods")
    if assigned < 0.5 * N_PODS:
        raise RuntimeError(
            f"benchmark scheduled only {assigned}/{N_PODS} pods — "
            "assignment quality regression"
        )

    t0 = time.perf_counter()
    for _ in range(REPS):
        out = schedule_windows(snapshot, pods_w, **kw)
    # one read of the LAST backlog: the card runs its stream in order,
    # so the read's completion covers every call's work
    if int(to_host(out.n_assigned)) <= 0:
        raise RuntimeError("timed run scheduled zero pods")
    dt = time.perf_counter() - t0
    return REPS * N_PODS / dt


def engine_row(suffix: str, snapshot, pods, base: float, *, device=None) -> dict:
    """One of the default mode's three engine rows,
    scheduling_throughput_{N}nodes{suffix}: "_deployed_default" (the
    SchedulerConfig defaults: its price step, dynamic affinity on),
    "_weighted_multi_scorer" (MULTI_SCORER, affinity on) or "" (the
    throughput-first headline). `base` is baseline_rate's pods/s."""
    from kubernetes_scheduler_tpu_torch.utils.config import SchedulerConfig

    options = {
        "_deployed_default": dict(
            price_frac=SchedulerConfig().auction_price_frac,
            affinity_aware=True,
        ),
        "_weighted_multi_scorer": dict(
            affinity_aware=True, score_plugins=MULTI_SCORER
        ),
        "": {},
    }[suffix]
    rate = device_rate(snapshot, pods, device=device, **options)
    return {
        "metric": f"scheduling_throughput_{N_NODES}nodes{suffix}",
        "value": round(rate, 1),
        "unit": "pods/s",
        "vs_baseline": round(rate / base, 2),
    }


def native_rate(name: str, cfg: dict) -> dict:
    """Tiny configs through the host's adaptive dispatch target: the
    fully-native tiny-cycle loop (native/loop.cc — queue pop -> scalar
    cycle -> bind, many cycles per foreign call), which amortizes the
    ctypes dispatch across the whole cycle stream, as a resident native
    host process does. Raises when the native library cannot load: the
    bench never times a Python stand-in."""
    from kubernetes_scheduler_tpu_torch import native
    from kubernetes_scheduler_tpu_torch.sim import gen_config

    if not native.available():
        raise RuntimeError(
            "native_rate needs the native host library (make -C native)"
        )
    snapshot, pods = gen_config(name, seed=0, device="cpu")
    n_pods = cfg["n_pods"]
    req = np.asarray(pods.request)[:n_pods]
    r_io = np.asarray(pods.r_io)[:n_pods]
    free = (
        np.asarray(snapshot.allocatable) - np.asarray(snapshot.requested)
    )[: cfg["n_nodes"]].astype(np.float32)
    disk_io = np.asarray(snapshot.disk_io)[: cfg["n_nodes"]]
    cpu_pct = np.asarray(snapshot.cpu_pct)[: cfg["n_nodes"]]

    # decision check at the original scale (one window through the
    # plain scalar cycle — same decisions the loop makes per cycle)
    idx, _, _ = native.scalar_cycle(req, r_io, free, disk_io, cpu_pct)

    # throughput: a stream of `reps` arrivals of the SAME workload,
    # window-sized cycles, each cycle against steady-state capacity
    # (reset_free — snapshots are rebuilt between real cycles). M pod
    # rows are the workload tiled so handle lookup stays trivial.
    reps = max(1, 200_000 // max(n_pods, 1))
    m = reps * n_pods
    loop = native.NativeLoop(
        np.tile(req, (reps, 1)), np.tile(r_io, reps),
        np.zeros(m, np.int32), free, disk_io, cpu_pct,
        window=n_pods, reset_free=True,
    )
    loop.submit_all()
    t0 = time.perf_counter()
    bound, cycles = loop.run(reps)
    dt = time.perf_counter() - t0
    if cycles != reps or bound < reps * int((idx >= 0).sum()):
        raise RuntimeError(
            f"native loop anomaly: {bound} binds in {cycles}/{reps} cycles"
        )
    rate = reps * n_pods / dt
    base = baseline_rate(snapshot, pods)
    return {
        "config": name,
        "pods": n_pods,
        "nodes": cfg["n_nodes"],
        "assigner": "native-loop",
        "assigned": int((np.asarray(idx) >= 0).sum()),
        "pods_per_sec": round(rate, 1),
        "vs_baseline": round(rate / base, 2),
    }


def _mean_chosen_score(snapshot, pods_flat, idx_flat, policy) -> float:
    """Mean min-max-normalized policy score (0-100) of the assigned
    pods' chosen nodes — the in-data quality measure beside raw assigned
    counts. Not on the timed path; computed in pod CHUNKS on the
    snapshot's device because the card policy's score intermediates are
    [p, n, c, 6]. `pods_flat` is the host backlog, `idx_flat` host
    node indices."""
    import torch

    from kubernetes_scheduler_tpu_torch.device import to_host
    from kubernetes_scheduler_tpu_torch.engine import compute_scores
    from kubernetes_scheduler_tpu_torch.ops.normalize import min_max_normalize

    dev = snapshot.node_mask.device
    idx_all = np.asarray(idx_flat).reshape(-1)
    mask_all = np.asarray(pods_flat.pod_mask)
    p = mask_all.shape[0]
    chunk = 256
    total, count = 0.0, 0
    for lo in range(0, p, chunk):
        hi = min(lo + chunk, p)
        sub = _upload(type(pods_flat)(*[a[lo:hi] for a in pods_flat]), dev)
        raw = compute_scores(snapshot, sub, policy)
        norm = min_max_normalize(raw, snapshot.node_mask)
        idx = torch.from_numpy(idx_all[lo:hi]).to(dev)
        ok = (idx >= 0) & sub.pod_mask
        take = torch.take_along_dim(
            norm, torch.clamp(idx, 0, norm.shape[1] - 1).long()[:, None], dim=1
        )[:, 0]
        s, c = to_host(torch.where(ok, take, 0.0).sum(), ok.sum())
        total += float(s)
        count += int(c)
    return total / max(count, 1)


def suite_rate(name: str, *, device=None) -> dict:
    """One BASELINE.md config end-to-end: pods/s on the batch engine and
    the vs-baseline ratio, with the same windowed schedule_windows call
    as the headline metric, on `device` (cuda unless given). Configs
    below the host's adaptive-dispatch threshold run the C++ scalar path
    instead, as host.scheduler would."""
    from kubernetes_scheduler_tpu_torch.device import resolve_device, to_host
    from kubernetes_scheduler_tpu_torch.engine import schedule_windows, stack_windows
    from kubernetes_scheduler_tpu_torch.sim import gen_config
    from kubernetes_scheduler_tpu_torch.sim.cluster_gen import BENCH_CONFIGS
    from kubernetes_scheduler_tpu_torch.utils.padding import pad_pod_batch

    cfg = BENCH_CONFIGS[name]
    if (
        cfg["n_pods"] * cfg["n_nodes"] < (1 << 20)
        and not cfg.get("gpu")
        and not cfg.get("constraints")
    ):
        return native_rate(name, cfg)
    dev = resolve_device(device)
    snapshot_host, pods = gen_config(name, seed=0, device="cpu")
    n_pods = cfg["n_pods"]
    # windows: measured knees (PARITY.md) — constraint configs amortize the
    # per-round dynamic-affinity cost best at 1024; selector-free configs
    # converge in fewer rounds per window at 512
    window = min(1024 if cfg.get("constraints") else 512, max(8, n_pods))
    n_padded = -(-n_pods // window) * window
    # the auction enforces hard (anti)affinity exactly (dynamic round
    # masks + conflict eviction), so constraint configs use it too;
    # selector-free configs skip the dynamic machinery entirely
    assigner = "auction"
    policy = "card" if cfg.get("gpu") else "balanced_cpu_diskio"
    affinity_aware = bool(cfg.get("constraints"))
    fused = FUSED and not cfg.get("gpu")  # card policy has no fused kernel
    snapshot = _upload(snapshot_host, dev)
    pods_flat = pad_pod_batch(pods, n_padded)
    pods_w = _upload(stack_windows(pods_flat, window), dev)

    def run(which=assigner):
        return schedule_windows(
            snapshot, pods_w, assigner=which, fused=fused,
            policy=policy,
            affinity_aware=affinity_aware,
            auction_price_frac=PRICE_FRAC,
        )

    out = run()
    assigned = int(to_host(out.n_assigned))
    reps = max(1, min(REPS, 65_536 // n_pods))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = run()
    if int(to_host(out.n_assigned)) <= 0:
        raise RuntimeError("timed run scheduled zero pods")
    dt = time.perf_counter() - t0
    rate = reps * n_pods / dt
    base = baseline_rate(snapshot_host, pods)
    # quality oracle (untimed): greedy on the SAME matrices settles
    # whether an assigned-count shortfall is genuine infeasibility
    # (greedy strands them too) or auction quality loss, and the mean
    # chosen score compares placement quality in-data
    gout = run("greedy")
    g_assigned = int(to_host(gout.n_assigned))
    return {
        "config": name,
        "pods": n_pods,
        "nodes": cfg["n_nodes"],
        "assigner": assigner,
        "assigned": assigned,
        "pods_per_sec": round(rate, 1),
        "vs_baseline": round(rate / base, 2),
        "assigned_greedy": g_assigned,
        "auction_vs_greedy_assigned": round(assigned / max(g_assigned, 1), 4),
        "mean_score_auction": round(
            _mean_chosen_score(
                snapshot, pods_flat, to_host(out.node_idx), policy
            ), 2
        ),
        "mean_score_greedy": round(
            _mean_chosen_score(
                snapshot, pods_flat, to_host(gout.node_idx), policy
            ), 2
        ),
    }


# the deployed default max_windows_per_cycle the bare host_loop metric
# measures; the BENCH_LOOP_PODS override scales against the same anchor
DEFAULT_LOOP_WINDOWS = 8


def _pipelined_loop_rate(*, device=None) -> dict:
    """The pipelined host-loop metric (host_loop_*_pipelined): SAME total
    backlog as the default host_loop metric, but one window per cycle
    with pipeline_depth=1, so the drain runs 8 pipelined cycles whose
    host work overlaps the in-flight engine calls — before/after on the
    same snapshot (vs. the serial metric's strictly alternating loop)."""
    return loop_rate(
        n_pods=int(os.environ.get("BENCH_LOOP_PODS", 1024 * DEFAULT_LOOP_WINDOWS)),
        max_windows=1,
        pipeline_depth=1,
        force_device=True,
        metric_suffix="_pipelined",
        device=device,
    )


def _resident_loop_rate(*, device=None) -> dict:
    """The resident-state host-loop metric (host_loop_*_resident): the
    pipelined shape with config.resident_state on — after the first full
    upload per bucket shape the engine retains the snapshot on device
    and cycles ship SnapshotDeltas folded into it in place (the
    engine's row folds). Reported beside host_loop_* / host_loop_*_pipelined with
    the delta hit rate and the snapshot payload actually shipped, so the
    upload win is measurable in-data (the acceptance gate: >= 15% more
    pods/s or >= 20% lower cycle p50 than the serial metric, with
    fallback_cycles 0 and PARITY-pinned identical bindings)."""
    return loop_rate(
        n_pods=int(os.environ.get("BENCH_LOOP_PODS", 1024 * DEFAULT_LOOP_WINDOWS)),
        max_windows=1,
        pipeline_depth=1,
        force_device=True,
        resident=True,
        metric_suffix="_resident",
        device=device,
    )


def _streaming_loop_rate(*, device=None) -> dict:
    """The streaming-ingestion metric (host_loop_*_streaming): the
    resident pipelined drain with the event-sourced snapshot mirror ON
    over a metric-churn workload, measured BESIDE an identical
    mirror-off drain in the same round. Both drains emit spans, so the
    replacement is in-data per round: mirror_emit (+ event_apply) p50
    against the baseline's snapshot_build + delta_derive p50 — the
    >=5x acceptance comparison at real sizes (reported, not asserted,
    at smoke sizes where ~ms cycles drown in jitter)."""
    import shutil
    import tempfile

    from kubernetes_scheduler_tpu_torch.trace.analyze import build_report

    churn = int(os.environ.get("BENCH_CHURN_NODES", 64))
    n_pods = int(os.environ.get("BENCH_LOOP_PODS", 1024 * DEFAULT_LOOP_WINDOWS))
    kw = dict(
        n_pods=n_pods, max_windows=1, pipeline_depth=1, force_device=True,
        resident=True, churn_nodes=churn, device=device,
    )
    t_on = tempfile.mkdtemp(prefix="yoda-stream-on-")
    t_off = tempfile.mkdtemp(prefix="yoda-stream-off-")
    try:
        # baseline FIRST: the two drains share one process's warm caches
        # (the kernels' build, the allocator's pool), and whichever runs
        # first pays the first uses — the probe paying them keeps the
        # headline row's engine/cycle numbers clean
        base = loop_rate(
            metric_suffix="_streaming_off_probe", span_path=t_off, **kw
        )
        # the sub-50ms cycle gate rides the streaming drain with its
        # own alarm armed: the SLO watchdog counts breaches live while
        # the row reports the p50 the gate reads
        out = loop_rate(
            metric_suffix="_streaming", mirror=True, span_path=t_on,
            slo_ms=50.0, **kw
        )
        rep_on = build_report(t_on)
        rep_off = build_report(t_off)

        def p50(rep, stage):
            s = rep["stages"].get(stage)
            return float(s["p50_ms"]) if s else 0.0

        out["mirror_emit_p50_ms"] = p50(rep_on, "mirror_emit")
        out["event_apply_p50_ms"] = p50(rep_on, "event_apply")
        out["baseline_snapshot_build_p50_ms"] = p50(rep_off, "snapshot_build")
        out["baseline_delta_derive_p50_ms"] = p50(rep_off, "delta_derive")
        out["baseline_pods_per_sec"] = base["pods_per_sec"]
        out["baseline_cycle_p50_ms"] = base["cycle_p50_ms"]
        baseline_stages = (
            out["baseline_snapshot_build_p50_ms"]
            + out["baseline_delta_derive_p50_ms"]
        )
        # the acceptance ratio: the stage that REPLACED snapshot_build +
        # delta_derive against what it replaced (>= 5x at real sizes)
        out["mirror_emit_speedup"] = round(
            baseline_stages / max(out["mirror_emit_p50_ms"], 1e-6), 2
        )
        # the conservative composite: event_apply added too (it also
        # covers the advisor's own changed-node fetch, which the
        # baseline pays under state_fetch — so this UNDERSTATES)
        out["streaming_stage_speedup"] = round(
            baseline_stages
            / max(
                out["mirror_emit_p50_ms"] + out["event_apply_p50_ms"], 1e-6
            ),
            2,
        )
        return out
    finally:
        shutil.rmtree(t_on, ignore_errors=True)
        shutil.rmtree(t_off, ignore_errors=True)


def _idle_streaming_rate(*, device=None) -> dict:
    """The idle-cluster streaming metric (host_loop_*_idle_streaming):
    what a cycle costs when NOTHING happened — the mirror emits a
    zero-row delta from a clean dirty set (the pre-mirror loop paid the
    full O(nodes) rebuild + row diff on every idle tick), plus the
    event->wakeup latency of the cycle trigger (config.cycle_trigger=
    "event")."""
    import threading

    from kubernetes_scheduler_tpu_torch.engine import TorchEngine
    from kubernetes_scheduler_tpu_torch.host.scheduler import Scheduler
    from kubernetes_scheduler_tpu_torch.sim.host_gen import (
        gen_host_cluster,
        gen_host_pods,
    )
    from kubernetes_scheduler_tpu_torch.utils.config import SchedulerConfig

    n_nodes = int(os.environ.get("BENCH_LOOP_NODES", 4000))
    nodes, advisor = gen_host_cluster(n_nodes, seed=0)
    running: list = []
    sched = Scheduler(
        SchedulerConfig(
            batch_window=256, normalizer="none", adaptive_dispatch=False,
            min_device_work=1, snapshot_mirror=True, cycle_trigger="event",
        ),
        advisor=advisor,
        engine=TorchEngine(device=device),
        list_nodes=lambda: nodes,
        list_running_pods=lambda: running,
    )
    # warm: one small backlog seeds the mirror and warms the engine
    for pod in gen_host_pods(min(128, n_nodes), seed=1):
        sched.submit(pod)
    for _ in range(8):
        if len(sched.queue) == 0:
            break
        sched.run_cycle()
        for b in sched.binder.bindings[len(running):]:
            running.append(b.pod)
    reps = 20
    mir = sched.mirror
    prev, _, _ = mir.emit([], pending_all_plain=True, prev=None)
    emits = []
    zero_rows = True
    for _ in range(reps):
        t0 = time.perf_counter()
        snap, delta, _ = mir.emit([], pending_all_plain=True, prev=prev)
        emits.append(time.perf_counter() - t0)
        zero_rows &= delta is not None and bool(
            (np.asarray(delta.req_rows) >= n_nodes).all()
            and (np.asarray(delta.util_rows) >= n_nodes).all()
            and (np.asarray(delta.dom_rows) >= n_nodes).all()
        )
        prev = snap
    lats = []
    sched.trigger.wait(0)  # drain notifies latched during the warmup
    for _ in range(reps):
        holder = {}

        def poke():
            holder["t0"] = time.perf_counter()
            sched.trigger.notify()

        timer = threading.Timer(0.001, poke)
        timer.start()
        # a stray notify can wake the first wait before the timer fires
        # — keep waiting until the measured notify actually landed
        while "t0" not in holder:
            sched.trigger.wait(1.0)
        lats.append(time.perf_counter() - holder["t0"])
        timer.join()
    return {
        "metric": f"host_loop_{n_nodes}nodes_idle_streaming",
        "events_per_cycle": 0,
        "idle_zero_row_deltas": bool(zero_rows),
        "mirror_emit_idle_p50_ms": round(
            1e3 * float(np.percentile(emits, 50)), 4
        ),
        "trigger_latency_p50_ms": round(
            1e3 * float(np.percentile(lats, 50)), 4
        ),
        "trigger_latency_p99_ms": round(
            1e3 * float(np.percentile(lats, 99)), 4
        ),
    }


def _drift_streaming_rate(*, device=None) -> dict:
    """The layout-drift streaming metric (host_loop_*_streaming_drift):
    a mirror-on resident drain where EVERY backlog drifts the layout —
    one never-seen anti-affinity selector per round, plus a hostPort
    remap (the oldest port pod retires, a fresh port arrives, live
    count pinned at two). The pre-extension mirror flushed to a full
    rebuild on every such round; with the in-place extension paths
    (mirror_incremental_extensions_total{kind}) the recurring classes
    are absorbed and the only surviving rebuilds are power-of-two
    bucket/slot crossings — O(log drifts), ~0 per round post-warmup.
    The row ends with an on-demand bitwise verify() cross-check, so
    the absorbed rounds are proven equal to what a rebuild would have
    served."""
    from kubernetes_scheduler_tpu_torch.engine import TorchEngine
    from kubernetes_scheduler_tpu_torch.host.scheduler import Scheduler
    from kubernetes_scheduler_tpu_torch.host.types import Pod, PodAffinityTerm
    from kubernetes_scheduler_tpu_torch.sim.host_gen import (
        gen_host_cluster,
        gen_host_pods,
    )
    from kubernetes_scheduler_tpu_torch.utils.config import SchedulerConfig

    n_nodes = int(os.environ.get("BENCH_LOOP_NODES", 4000))
    rounds = int(os.environ.get("BENCH_DRIFT_ROUNDS", 12))
    backlog = max(32, min(256, n_nodes // 4))
    nodes, advisor = gen_host_cluster(n_nodes, seed=0, constraints=True)
    running: list = []
    sched = Scheduler(
        SchedulerConfig(
            batch_window=256, normalizer="none", adaptive_dispatch=False,
            min_device_work=1, snapshot_mirror=True, resident_state=True,
            pipeline_depth=1, max_windows_per_cycle=1,
        ),
        advisor=advisor,
        engine=TorchEngine(device=device),
        list_nodes=lambda: nodes,
        list_running_pods=lambda: running,
    )

    def drain():
        seen = len(sched.binder.bindings)
        for _ in range(64):
            if len(sched.queue) == 0 and sched._prefetched is None:
                break
            sched.run_cycle()
            for b in sched.binder.bindings[seen:]:
                running.append(b.pod)
            seen = len(sched.binder.bindings)

    # warmup: constraint traffic mints the steady-state selector
    # population (the generator's svc-app anti keys — enough to fill a
    # real power-of-two bucket), two port pods warm the two hostPort
    # slots the churn rounds then live inside, the mirror seeds, and
    # the first uses are paid
    port_live: list[str] = []
    for pod in gen_host_pods(max(backlog, 128), seed=1, constraints=True):
        sched.submit(pod)
    for name, pt in (("port-w0", 19998), ("port-w1", 19999)):
        sched.submit(Pod(name=name, namespace="bench", host_ports=[pt]))
        port_live.append(name)
    drain()
    mir = sched.mirror
    base_rebuilds = int(mir.ctr_rebuilds.total())
    bound0 = len(sched.binder.bindings)
    t0 = time.perf_counter()
    for k in range(rounds):
        if len(port_live) >= 2:
            # the oldest port pod terminates (informer DELETE): live
            # ports stay within the two allocated slots, so the fresh
            # port below is a same-width REMAP, never slot growth
            victim_name = port_live.pop(0)
            victim = next(
                (
                    p for p in running
                    if p.namespace == "bench" and p.name == victim_name
                ),
                None,
            )
            if victim is not None:
                running.remove(victim)
                mir.apply_pod_event("DELETED", victim)
        sched.submit(
            Pod(
                name=f"drift-{k}", namespace="bench",
                pod_affinity=[
                    PodAffinityTerm(
                        match_labels={"drift": str(k)},
                        topology_key="kubernetes.io/hostname",
                        anti=True,
                    )
                ],
            )
        )
        port_name = f"port-{k}"
        sched.submit(
            Pod(name=port_name, namespace="bench", host_ports=[20000 + k])
        )
        port_live.append(port_name)
        for pod in gen_host_pods(backlog, seed=100 + k):
            sched.submit(pod)
        drain()
    elapsed = time.perf_counter() - t0
    bound = len(sched.binder.bindings) - bound0
    ext = {key[0]: int(v) for key, v in mir.ctr_extensions._series.items()}
    reasons = {
        key[0]: int(n)
        for key, n in sorted(mir.ctr_rebuilds.breakdown().items())
    }
    return {
        "metric": f"host_loop_{n_nodes}nodes_streaming_drift",
        "drift_rounds": rounds,
        "pods_bound": bound,
        "pods_per_sec": round(bound / max(elapsed, 1e-9), 1),
        "mirror_incremental_extensions": ext,
        "mirror_full_rebuilds": int(mir.ctr_rebuilds.total()),
        "mirror_rebuild_reasons": reasons,
        # the headline: rebuilds actually paid across the drifting
        # rounds (bucket/slot crossings only — NOT one per round)
        "drift_rebuilds": int(mir.ctr_rebuilds.total()) - base_rebuilds,
        "mirror_verify_failures": int(
            mir.ctr_verify_failures._series.get((), 0)
        ),
        "final_verify_ok": bool(mir.verify()),
    }


def _fused_loop_rate(*, device=None) -> dict:
    """The fused-megakernel metric (host_loop_*_fused): the pipelined
    single-window drain with the fused kernels (K1, K2) explicitly ON,
    measured BESIDE an otherwise-identical unfused drain in the same
    round — so the fused/unfused engine delta (the sub-50ms-cycle
    tentpole's win) is visible in-data every round, not inferred from
    cross-round comparisons. The headline fields are the FUSED drain's;
    the unfused companion rides as unfused_* plus the p50 speedups."""
    n_pods = int(os.environ.get("BENCH_LOOP_PODS", 1024 * DEFAULT_LOOP_WINDOWS))
    kw = dict(
        n_pods=n_pods, max_windows=1, pipeline_depth=1, force_device=True,
        device=device,
    )
    out = loop_rate(metric_suffix="_fused", fused_kernel=True, **kw)
    unfused = loop_rate(
        metric_suffix="_unfused_probe", fused_kernel=False, **kw
    )
    out["unfused_pods_per_sec"] = unfused["pods_per_sec"]
    out["unfused_engine_p50_ms"] = unfused["engine_p50_ms"]
    out["unfused_cycle_p50_ms"] = unfused["cycle_p50_ms"]
    out["fused_engine_speedup"] = round(
        unfused["engine_p50_ms"] / max(out["engine_p50_ms"], 1e-9), 3
    )
    out["fused_cycle_speedup"] = round(
        unfused["cycle_p50_ms"] / max(out["cycle_p50_ms"], 1e-9), 3
    )
    return out


def _telemetry_loop_rate(
    pipelined: dict | None, *, device=None
) -> tuple[dict, dict]:
    """The full-telemetry metric (host_loop_*_telemetry): the pipelined
    drain with per-cycle spans ON (config.span_path -> Chrome-trace
    files) and a /metrics exporter being scraped concurrently — the
    everything-on production shape, measured BESIDE the telemetry-off
    pipelined baseline so the overhead is in-data. The acceptance gate
    (<5% drain-rate overhead with full telemetry on) reads
    telemetry_overhead_pct straight from the artifact; at smoke sizes
    the ratio is reported, not asserted (~ms cycles drown in jitter).

    Returns (telemetry metric, attribution metric): the drain's own
    span files are fed through trace/analyze.build_report before the
    tempdir is dropped, so host_loop_*_attribution — the per-stage
    cycle budget table, percentages summing to 100 by construction —
    rides every bench round beside the drain rate."""
    import shutil
    import tempfile

    n_nodes = int(os.environ.get("BENCH_LOOP_NODES", 4000))
    tmp = tempfile.mkdtemp(prefix="yoda-spans-bench-")
    try:
        out = loop_rate(
            n_pods=int(
                os.environ.get("BENCH_LOOP_PODS", 1024 * DEFAULT_LOOP_WINDOWS)
            ),
            max_windows=1,
            pipeline_depth=1,
            force_device=True,
            metric_suffix="_telemetry",
            span_path=tmp,
            scrape_metrics=True,
            device=device,
        )
        if pipelined and pipelined.get("pods_per_sec"):
            base = pipelined["pods_per_sec"]
            out["pipelined_pods_per_sec"] = base
            out["vs_pipelined"] = round(out["pods_per_sec"] / base, 4)
            out["telemetry_overhead_pct"] = round(
                100.0 * (1.0 - out["pods_per_sec"] / base), 2
            )
        from kubernetes_scheduler_tpu_torch.trace.analyze import build_report

        rep = build_report(tmp)
        attrib = {
            "metric": f"host_loop_{n_nodes}nodes_attribution",
            "cycles": rep["cycles"],
            "cycle_p50_ms": rep["cycle_ms"]["p50_ms"],
            "pods_per_sec": out["pods_per_sec"],
            # per-stage share of cycle wall time (+ "other" residual),
            # summing to ~100 — the budget table the sub-50ms-cycle
            # ROADMAP item reads to pick the next bottleneck
            "attribution_pct": rep["attribution_pct"],
            "stage_p50_ms": {
                name: s["p50_ms"] for name, s in rep["stages"].items()
            },
        }
        return out, attrib
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _replay_loop_rate(*, device=None) -> dict:
    """The flight-recorder metric (host_loop_*_replay): run the
    pipelined host-loop drain with the cycle recorder on (trace/), then
    REPLAY the captured journal through the engine and diff bindings
    bitwise — perf numbers from a captured workload instead of a fresh
    generator, plus in-data proof that recording survives the bench
    workload and that replay reproduces production decisions exactly
    (binding_diffs MUST be 0). traced_pods_per_sec sits beside the
    host_loop_*_pipelined metric so the recorder's overhead is readable
    from the artifact (<5% is the acceptance gate)."""
    import shutil
    import tempfile

    from kubernetes_scheduler_tpu_torch.trace.replay import replay_journal

    n_nodes = int(os.environ.get("BENCH_LOOP_NODES", 4000))
    tmp = tempfile.mkdtemp(prefix="yoda-trace-bench-")
    try:
        traced = loop_rate(
            n_pods=int(
                os.environ.get("BENCH_LOOP_PODS", 1024 * DEFAULT_LOOP_WINDOWS)
            ),
            max_windows=1,
            pipeline_depth=1,
            force_device=True,
            metric_suffix="_traced",
            trace_path=tmp,
            device=device,
        )
        rep = replay_journal(tmp, mode="serial", device=device)
        if rep.binding_diffs:
            raise RuntimeError(
                f"replay diverged from the recording: {rep.binding_diffs} "
                f"binding diffs over {rep.replayed} cycles"
            )
        return {
            "metric": f"host_loop_{n_nodes}nodes_replay",
            "cycles_replayed": rep.replayed,
            "cycles_skipped": rep.skipped,
            "binding_diffs": rep.binding_diffs,
            "pods_replayed": rep.pods_replayed,
            "pods_per_sec": round(rep.pods_replayed / max(rep.seconds, 1e-9), 1),
            # the recorder-on drain beside host_loop_*_pipelined = the
            # recorder's overhead, measured in-data
            "traced_pods_per_sec": traced["pods_per_sec"],
            "traced_cycle_p50_ms": traced["cycle_p50_ms"],
            "trace_record_seconds": traced["trace_record_seconds"],
            "trace_overhead_pct": traced["trace_overhead_pct"],
            "trace_bytes": traced["trace_bytes"],
        }
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _shadow_rescore_rate(*, device=None) -> dict:
    """The shadow-serving metric (host_loop_*_shadow): record a
    pipelined drain with the flight recorder on, then tail the journal
    through host/shadow.ShadowScheduler under an IDENTICAL candidate
    config. Two in-data proofs ride the rate: the decision diff MUST be
    zero (same config => same bindings, the rollout-gate null
    hypothesis), and shadow_pods_per_sec / latency_ratio say whether a
    colocated shadow can keep up with the primary it is auditioning
    against (keep-up ratio >= 1 means yes)."""
    import shutil
    import tempfile

    from kubernetes_scheduler_tpu_torch.host.shadow import ShadowScheduler
    from kubernetes_scheduler_tpu_torch.utils.config import SchedulerConfig

    n_nodes = int(os.environ.get("BENCH_LOOP_NODES", 4000))
    tmp = tempfile.mkdtemp(prefix="yoda-shadow-bench-")
    try:
        loop_rate(
            n_pods=int(
                os.environ.get("BENCH_LOOP_PODS", 1024 * DEFAULT_LOOP_WINDOWS)
            ),
            max_windows=1,
            pipeline_depth=1,
            force_device=True,
            metric_suffix="_shadow_recorded",
            trace_path=tmp,
            device=device,
        )
        shadow = ShadowScheduler(
            tmp,
            SchedulerConfig(
                batch_window=1024,
                normalizer="none",
                adaptive_dispatch=False,
                min_device_work=1,
            ),
            device=device,
        )
        t0 = time.perf_counter()
        summary = shadow.run()
        seconds = time.perf_counter() - t0
        shadow.close()
        if summary["bindings_changed"]:
            raise RuntimeError(
                "shadow diverged under an identical candidate config: "
                f"{summary['bindings_changed']} bindings over "
                f"{summary['records_applied']} records"
            )
        return {
            "metric": f"host_loop_{n_nodes}nodes_shadow",
            "records_rescored": summary["records_applied"],
            "bindings_changed": summary["bindings_changed"],
            "divergence_ratio": summary["divergence_ratio"],
            "pods_compared": summary["pods_compared"],
            "shadow_pods_per_sec": round(
                summary["pods_compared"] / max(seconds, 1e-9), 1
            ),
            # candidate engine wall time over the primary's recorded
            # engine time: < 1 means the shadow re-scores faster than
            # the primary produced the journal (it can tail live)
            "latency_ratio": round(summary["latency_ratio"], 3),
            "breaker_state": summary["breaker_state"],
        }
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _scenario_rate(name: str, short: str, *, device=None) -> dict:
    """Scenario-harness metrics (sim/scenarios): one adversarial traffic
    program driven end to end through the host loop at the bench scale,
    reported beside the pipelined host-loop baseline. The drain rate is
    NOT comparable to host_loop_* (scenario traffic arrives over virtual
    ticks, not as one pre-queued backlog) — it is the round-over-round
    anchor for the scenario itself; the gang metric adds the admit rate
    (admitted / (admitted + deferred)), the all-or-nothing health
    signal."""
    from kubernetes_scheduler_tpu_torch.sim import scenarios

    n_nodes = int(os.environ.get("BENCH_LOOP_NODES", 4000))
    intensity = float(os.environ.get("BENCH_SCENARIO_INTENSITY", "1.0"))
    summary = scenarios.run(
        name, n_nodes=n_nodes, intensity=intensity, seed=0, device=device
    )
    out = {
        "metric": f"scenario_{short}_{n_nodes}nodes",
        "scenario": name,
        "cycles": summary["cycles"],
        "pods_submitted": summary["pods_submitted"],
        "pods_bound": summary["pods_bound"],
        "pods_unschedulable": summary["pods_unschedulable"],
        "fallback_cycles": summary["fallback_cycles"],
        "pods_per_sec": summary["pods_per_sec"],
        "seconds": summary["seconds"],
    }
    admitted = summary["gangs_admitted"]
    deferred = summary["gangs_deferred"]
    if admitted or deferred:
        out.update(
            gangs_admitted=admitted,
            gangs_deferred=deferred,
            gang_pods_masked=summary["gang_pods_masked"],
            gang_admit_rate=round(
                admitted / max(admitted + deferred, 1), 4
            ),
        )
    return out


def _chaos_loop_rate(*, device=None) -> dict:
    """The chaos host-loop metric (host_loop_*_chaos): the SAME
    pipelined drain shape as host_loop_*_pipelined, under a
    deterministic RPC-flap FaultPlan (sim/faults.py) on the engine
    boundary — the clock is the CYCLE COUNTER, so the flap pattern is
    identical run over run. Reported beside the clean drain: the
    degraded-cycle rate, the circuit breaker's open/half-open/closed
    transition counts, and the recovery latency (wall time from a
    degradation episode's first degraded cycle back to every ladder
    rung at top with the breaker closed) p50/p99 over episodes. The
    plan quiesces with a recovery tail, so the row also asserts the
    run ENDS recovered — a chaos drain that stays degraded is a
    failure, not a number."""
    from kubernetes_scheduler_tpu_torch.engine import TorchEngine
    from kubernetes_scheduler_tpu_torch.host.scheduler import Scheduler
    from kubernetes_scheduler_tpu_torch.sim.faults import (
        FaultInjector,
        FaultPlan,
        FaultWindow,
        FaultyEngine,
    )
    from kubernetes_scheduler_tpu_torch.sim.host_gen import (
        gen_host_cluster,
        gen_host_pods,
    )
    from kubernetes_scheduler_tpu_torch.utils.config import SchedulerConfig

    n_nodes = int(os.environ.get("BENCH_LOOP_NODES", 4000))
    n_pods = int(
        os.environ.get("BENCH_LOOP_PODS", 1024 * DEFAULT_LOOP_WINDOWS)
    )
    # window sized for enough cycles that the flap pattern and the
    # recovery tail are both visible at any BENCH_* scale
    window = max(8, n_pods // 16)
    cycles_per_drain = -(-n_pods // window)
    samples = int(os.environ.get("BENCH_LOOP_SAMPLES", "0")) or 3
    measured = samples * cycles_per_drain
    # flap over the middle of the measured cycles; quiesce with a tail
    flap_start = max(2, measured // 4)
    flap_end = max(flap_start + 4, (2 * measured) // 3)
    # flap first (retry/fallback churn), then a solid outage long
    # enough to trip the breaker (threshold 2) so the open ->
    # half-open -> closed arc is in the transition counts every run
    outage_start = float(flap_end) + 2.0
    plan = FaultPlan((
        FaultWindow(
            boundary="engine", kind="flap",
            start=float(flap_start), end=float(flap_end), period=2,
        ),
        FaultWindow(
            boundary="engine", kind="error",
            start=outage_start, end=outage_start + 3.0,
        ),
    ))
    cycle_clock = [0.0]
    injector = FaultInjector(plan, clock=lambda: cycle_clock[0])
    nodes, advisor = gen_host_cluster(n_nodes, seed=0)
    running: list = []
    sched = Scheduler(
        SchedulerConfig(
            batch_window=window,
            max_windows_per_cycle=1,
            pipeline_depth=1,
            adaptive_dispatch=False,
            min_device_work=1,
            normalizer="none",
            breaker_failure_threshold=2,
            breaker_recovery_window_s=3.0,
        ),
        advisor=advisor,
        engine=FaultyEngine(TorchEngine(device=device), injector),
        list_nodes=lambda: nodes,
        list_running_pods=lambda: running,
        queue_clock=lambda: cycle_clock[0],
    )
    cycles = []
    episodes = []  # recovery latency (seconds) per degradation episode
    episode_t0 = None

    def drain(measure: bool):
        nonlocal episode_t0
        seen = len(sched.binder.bindings)
        for _ in range(64):
            if len(sched.queue) == 0 and sched._prefetched is None:
                break
            m = sched.run_cycle()
            if measure:
                cycle_clock[0] += 1.0
                cycles.append(m)
                recovered = (
                    sched.ladder.fully_recovered()
                    and sched.engine_breaker.state() == "closed"
                )
                if not recovered and episode_t0 is None:
                    episode_t0 = time.perf_counter()
                elif recovered and episode_t0 is not None:
                    episodes.append(time.perf_counter() - episode_t0)
                    episode_t0 = None
            for b in sched.binder.bindings[seen:]:
                running.append(b.pod)
            seen = len(sched.binder.bindings)

    for pod in gen_host_pods(n_pods, seed=1):
        sched.submit(pod)
    drain(measure=False)  # warmup: first uses, no injected clock ticks
    for seed in range(2, 2 + samples):
        for pod in gen_host_pods(n_pods, seed=seed):
            sched.submit(pod)
        drain(measure=True)
    # recovery tail: the sample drains already advanced the cycle
    # clock through BOTH fault windows (measured cycles span the plan
    # by construction), so these trailing drains idle-advance past the
    # plan's end and give the half-open probe + ladder climb traffic
    # to land on
    for tail_seed in (90, 91):
        cycle_clock[0] = max(cycle_clock[0], plan.last_end()) + 4.0
        for pod in gen_host_pods(window, seed=tail_seed):
            sched.submit(pod)
        drain(measure=True)
    # an episode still open at the end never recovered: count it
    # separately instead of poisoning the percentiles (float('inf')
    # would serialize as bare `Infinity` — invalid JSON on the one
    # line that reports the failure)
    unrecovered = int(episode_t0 is not None)
    bound = sum(c.pods_bound for c in cycles)
    lat = [c.cycle_seconds for c in cycles]
    degraded = sum(1 for c in cycles if c.degraded or c.used_fallback)
    rec_ms = sorted(1e3 * e for e in episodes)
    out = {
        "metric": f"host_loop_{n_nodes}nodes_chaos",
        "cycles": len(cycles),
        "pods_bound": bound,
        "pods_per_sec": round(bound / max(sum(lat), 1e-9), 1),
        "cycle_p50_ms": round(1e3 * float(np.percentile(lat, 50)), 2),
        "fallback_cycles": int(sum(c.used_fallback for c in cycles)),
        "degraded_cycles": degraded,
        "degraded_cycle_rate": round(degraded / max(len(cycles), 1), 4),
        "faults_injected": injector.summary(),
        "breaker_transitions": dict(
            sched.engine_breaker.transition_counts
        ),
        "breaker_state": sched.engine_breaker.state(),
        "recovery_episodes": len(episodes),
        "unrecovered_episodes": unrecovered,
        "recovery_latency_ms_p50": (
            round(float(np.percentile(rec_ms, 50)), 2) if rec_ms else 0.0
        ),
        "recovery_latency_ms_p99": (
            round(float(np.percentile(rec_ms, 99)), 2) if rec_ms else 0.0
        ),
        "recovered": (
            sched.ladder.fully_recovered()
            and sched.engine_breaker.state() == "closed"
        ),
    }
    return out


class _ChurnAdvisor:
    """Metric-churn wrapper over a StaticAdvisor: every fetch perturbs a
    FIXED-SIZE rotating slice of nodes' utilization series. The churn
    size is independent of the cluster size, so the resident-delta
    payload it induces (changed util rows) is too — the workload the
    flat-bytes gate measures: per-cycle host->device delta bytes must
    not grow with node count."""

    def __init__(self, base, node_names, churn_nodes: int, seed: int = 7):
        from kubernetes_scheduler_tpu_torch.host.advisor import NodeUtil

        self._NodeUtil = NodeUtil
        self._base = base
        self._names = list(node_names)
        self._k = min(churn_nodes, len(self._names))
        self._pos = 0
        self._rng = np.random.default_rng(seed)

    def fetch(self):
        utils = dict(self._base.fetch())
        self._changed = {}
        for i in range(self._k):
            name = self._names[(self._pos + i) % len(self._names)]
            u = utils[name]
            utils[name] = self._NodeUtil(
                cpu_pct=float(min(u.cpu_pct + self._rng.uniform(0.1, 2.0), 100.0)),
                mem_pct=u.mem_pct,
                disk_io=float(min(u.disk_io + self._rng.uniform(0.01, 0.5), 50.0)),
                net_up=u.net_up,
                net_down=u.net_down,
            )
            self._changed[name] = utils[name]
        self._pos = (self._pos + self._k) % max(len(self._names), 1)
        self._base.utils = utils  # churn accumulates across cycles
        return utils

    def fetch_changed(self):
        """The advisor-coalescing surface (host/mirror events): the
        churn advisor knows EXACTLY which nodes it perturbed, so the
        changed-node drain is O(churn) with no diff pass at all."""
        self.fetch()
        return dict(getattr(self, "_changed", {}))


def _mesh(device):
    """The sharded rows' mesh: sharded_device_count() shards, on the
    first that many cards (cuda) or all on `device` (e.g. the CPU)."""
    from kubernetes_scheduler_tpu_torch.device import resolve_device
    from kubernetes_scheduler_tpu_torch.parallel import make_mesh, sharded_device_count

    d = sharded_device_count()
    dev = resolve_device(device)
    return make_mesh(d) if dev.type == "cuda" else make_mesh(d, device=dev)


def _engine(config, device):
    """The engine a loop row's Scheduler runs on: the ShardedEngine over
    _mesh(device) for config.sharded_engine, else host.scheduler's
    default_engine on `device`."""
    from kubernetes_scheduler_tpu_torch.host.scheduler import default_engine
    from kubernetes_scheduler_tpu_torch.parallel import ShardedEngine

    if config.sharded_engine:
        return ShardedEngine(_mesh(device))
    return default_engine(config, device=device)


def loop_rate(
    *,
    n_pods: int | None = None,
    n_nodes: int | None = None,
    max_windows: int = DEFAULT_LOOP_WINDOWS,
    pipeline_depth: int = 0,
    force_device: bool = False,
    resident: bool = False,
    sharded: bool = False,
    churn_nodes: int = 0,
    metric_suffix: str = "",
    trace_path: str | None = None,
    span_path: str | None = None,
    scrape_metrics: bool = False,
    fused_kernel: bool | None = None,
    mirror: bool = False,
    slo_ms: float = 0.0,
    device=None,
) -> dict:
    """END-TO-END host loop at the north-star scale: queue pop -> snapshot
    build -> device program -> binds, through host.Scheduler on a simulated
    cluster (the BASELINE.md latency metric: per-cycle bind latency p50/p99
    including all host-side work, not just the device step).

    max_windows is SchedulerConfig.max_windows_per_cycle: how deep a
    pending backlog one cycle pops into a single device dispatch. The
    default (8) is the deployed default; the deep-backlog variant (16)
    amortizes the device round-trip over twice the pods — higher
    throughput, higher per-cycle latency, both reported honestly.

    pipeline_depth=1 measures the double-buffered host loop (one window
    per cycle, the engine call in flight while the host pops and
    prebuilds the next window) — the serialized-host-work recovery the
    host_loop_*_pipelined metric exists to capture.

    force_device pins the engine path (adaptive_dispatch off,
    min_device_work 1): at single-window shapes the adaptive model can
    legitimately route scalar (the C++ cycle beats a device round-trip
    below the crossover), which would measure the scalar path under a
    device-pipelining label — the overlap metric and the routing dial
    are separate questions.

    The Scheduler runs on `device` (cuda unless given): TorchEngine, or
    with sharded=True a ShardedEngine over _mesh(device)."""
    from kubernetes_scheduler_tpu_torch.host.scheduler import Scheduler
    from kubernetes_scheduler_tpu_torch.sim.host_gen import gen_host_cluster, gen_host_pods
    from kubernetes_scheduler_tpu_torch.utils.config import SchedulerConfig

    if n_nodes is None:
        n_nodes = int(os.environ.get("BENCH_LOOP_NODES", 4000))
    if n_pods is None:
        # BENCH_LOOP_PODS names the DEFAULT (8-window) backlog size; the
        # deep variant scales it so an override keeps the configurations
        # proportional (a flat override would quietly turn the "deep"
        # run into the default workload under a different label)
        n_pods = (
            int(os.environ.get("BENCH_LOOP_PODS", 1024 * DEFAULT_LOOP_WINDOWS))
            * max_windows
            // DEFAULT_LOOP_WINDOWS
        )
    # ONE scheduler, two backlogs: the first pays the first uses (the
    # kernels' build, the allocator's pool) and warms the steady-state caches a resident scheduler
    # accumulates (request-row/flag memos, the engine's uniform-leaf
    # device constants); the second — fresh pods, with the first
    # backlog's binds as the running set — is the measured steady state,
    # paying the real per-cycle costs (snapshot re-sum over every
    # running pod, cold pod-side caches for newly arrived pods).
    nodes, advisor = gen_host_cluster(n_nodes, seed=0)
    if churn_nodes:
        advisor = _ChurnAdvisor(
            advisor, [nd.name for nd in nodes], churn_nodes
        )
    running: list = []
    knobs = (
        {"adaptive_dispatch": False, "min_device_work": 1}
        if force_device
        else {}
    )
    if sharded:
        knobs["sharded_engine"] = True
    # streaming state ingestion: the event-sourced snapshot mirror
    # replaces the per-cycle rebuild; the churn advisor's fetch_changed
    # feeds utilization events and the scheduler self-applies its binds
    # as pod events. Pinned EXPLICITLY both ways: the config default is
    # mirror-on, but the non-mirror rows exist to measure the rebuild
    # loop the mirror is compared against
    knobs["snapshot_mirror"] = mirror
    if slo_ms:
        # the live SLO watchdog rides the measured drain: breaches are
        # counted (slo_breaches_total{path}) and reported beside the
        # percentile they gate — the <50ms claim with its own alarm on
        knobs["cycle_slo_ms"] = slo_ms
    if fused_kernel is not None:
        # the fused/unfused A-B knob (host_loop_*_fused): everything
        # else identical, only the feature gate moves
        from kubernetes_scheduler_tpu_torch.utils.config import FeatureGates

        knobs["feature_gates"] = FeatureGates(fused_kernel=fused_kernel)
    config = SchedulerConfig(
        batch_window=1024,
        normalizer="none",
        max_windows_per_cycle=max_windows,
        pipeline_depth=pipeline_depth,
        resident_state=resident,
        trace_path=trace_path,
        span_path=span_path,
        **knobs,
    )
    sched = Scheduler(
        config,
        advisor=advisor,
        engine=_engine(config, device),
        list_nodes=lambda: nodes,
        list_running_pods=lambda: running,
    )
    # full-telemetry shape: a live exporter being scraped mid-drain (the
    # /metrics contention is part of what the telemetry metric measures)
    exporter = None
    scrape_stop = None
    scrapes = [0]
    if scrape_metrics:
        import threading
        import urllib.request

        from kubernetes_scheduler_tpu_torch.host.observe import MetricsExporter

        exporter = MetricsExporter(sched)
        mport = exporter.serve(0, host="127.0.0.1")
        scrape_stop = threading.Event()

        def _scrape_loop():
            while not scrape_stop.is_set():
                try:
                    with urllib.request.urlopen(
                        f"http://127.0.0.1:{mport}/metrics", timeout=5
                    ) as r:
                        r.read()
                    scrapes[0] += 1
                except OSError:
                    pass  # a failed scrape is retried; the count says how many landed
                scrape_stop.wait(0.05)

        threading.Thread(target=_scrape_loop, daemon=True).start()

    def drain() -> tuple[list, float]:
        t0 = time.perf_counter()
        out = []
        seen = len(sched.binder.bindings)
        for _ in range(64):
            # a pipelined scheduler may hold a prefetched window outside
            # the queue — the drain is not done until it dispatched too
            if len(sched.queue) == 0 and sched._prefetched is None:
                break
            out.append(sched.run_cycle())
            # feed binds back as running pods, so later cycles pay the
            # real steady-state snapshot cost and capacity accrues
            for b in sched.binder.bindings[seen:]:
                running.append(b.pod)
            seen = len(sched.binder.bindings)
        return out, time.perf_counter() - t0

    for pod in gen_host_pods(n_pods, seed=1):
        sched.submit(pod)
    drain()  # warmup backlog (first uses; populates `running`)
    # recorder time spent on the warmup drain must not count against
    # the measured cycles' overhead ratio
    trace_warmup_s = (
        sched.recorder.seconds_spent if sched.recorder is not None else 0.0
    )
    cycles = []
    # enough measured backlogs for a STABLE p50/p99: the single-dispatch
    # shapes (serial 8-window, deep16w) drain one cycle per backlog, so
    # the old fixed 3 samples left 3-cycle percentiles — meaningless
    # order statistics the sub-50ms gate cannot be judged on. Target
    # >= 10 cycles (BENCH_LOOP_SAMPLES overrides), floor 3 samples.
    window_cap = 1024 * max(1, max_windows)
    cycles_per_drain = max(1, -(-n_pods // min(max(n_pods, 1), window_cap)))
    samples = int(os.environ.get("BENCH_LOOP_SAMPLES", "0")) or max(
        3, -(-10 // cycles_per_drain)
    )
    for seed in range(2, 2 + samples):
        for pod in gen_host_pods(n_pods, seed=seed):
            sched.submit(pod)
        got, _ = drain()
        cycles.extend(got)
    if scrape_stop is not None:
        scrape_stop.set()
    if exporter is not None:
        exporter.close()
    if sched.recorder is not None:
        sched.recorder.close()
    if sched.spans is not None:
        sched.spans.close()
    bound = sum(c.pods_bound for c in cycles)
    lat = [c.cycle_seconds for c in cycles]
    eng = [c.engine_seconds for c in cycles]
    overlap = [c.host_overlap_seconds for c in cycles]
    p50 = float(np.percentile(lat, 50))
    rates = [
        c.pods_bound / c.cycle_seconds
        for c in cycles
        if c.cycle_seconds > 0
    ]
    out = {
        "metric": f"host_loop_{n_nodes}nodes{metric_suffix}",
        "cycles": len(cycles),
        "pods_bound": bound,
        # HEADLINE = aggregate throughput (all binds / all cycle time),
        # the same definition as BASELINE.md's rates — comparable across
        # rounds. The p50 companion is the per-cycle median, robust to
        # outlier cycles but NOT comparable to an aggregate baseline.
        "pods_per_sec": round(bound / max(sum(lat), 1e-9), 1),
        "pods_per_sec_p50": round(float(np.percentile(rates, 50)), 1),
        "cycle_p50_ms": round(1e3 * p50, 2),
        "cycle_p99_ms": round(1e3 * float(np.percentile(lat, 99)), 2),
        # engine dispatch to the result's read (device.to_host)
        "engine_p50_ms": round(1e3 * float(np.percentile(eng, 50)), 2),
        "fallback_cycles": int(sum(c.used_fallback for c in cycles)),
        # pipelined-loop observability (zeros on the serial metrics):
        # host work hidden under in-flight engine calls, and speculative
        # discards — the acceptance gate is cycle_p50 approaching
        # engine_p50 with flushes staying ~0 on a churn-free drain
        "host_overlap_p50_ms": round(
            1e3 * float(np.percentile(overlap, 50)), 2
        ),
        "pipeline_flushes": int(sum(c.pipeline_flushes for c in cycles)),
    }
    if slo_ms:
        out["cycle_slo_ms"] = slo_ms
        out["slo_breaches"] = int(sched.slo_breaches)
    if sched.recorder is not None:
        # the recorder's own wall time vs the drain's cycle time — the
        # direct <5%-overhead evidence (recording runs AFTER each
        # cycle's bookkeeping, so cycle_seconds cannot show it)
        spent = sched.recorder.seconds_spent - trace_warmup_s
        out["trace_record_seconds"] = round(spent, 4)
        out["trace_overhead_pct"] = round(
            100.0 * spent / max(sum(lat), 1e-9), 2
        )
        out["trace_bytes"] = sched.recorder.bytes_written
    if sched.spans is not None:
        out["spans_written"] = sched.spans.spans_written
        out["span_bytes"] = sched.spans.bytes_written
        out["spans_dropped"] = sched.spans.spans_dropped
    if scrape_metrics:
        out["metrics_scrapes"] = scrapes[0]
    if resident:
        # resident-state observability: delta hit rate and the snapshot
        # payload actually shipped. snapshot_upload_bytes is the full
        # per-cycle payload MINUS what the deltas avoided — measured
        # against the same cycles, so the win is in-data, not inferred.
        from kubernetes_scheduler_tpu_torch.engine import snapshot_nbytes

        deltas = int(sum(c.delta_uploads for c in cycles))
        fulls = int(sum(c.full_uploads for c in cycles))
        saved = int(sum(c.delta_bytes_saved for c in cycles))
        snap_bytes = snapshot_nbytes(
            sched.builder.build_snapshot(
                nodes, sched.advisor.fetch(), running, ephemeral=True
            )
        )
        out.update(
            delta_uploads=deltas,
            full_uploads=fulls,
            delta_hit_rate=round(deltas / max(deltas + fulls, 1), 4),
            delta_bytes_saved=saved,
            snapshot_upload_bytes=(deltas + fulls) * snap_bytes - saved,
        )
    if mirror and sched.mirror is not None:
        # streaming-ingestion observability: events the mirror applied
        # (by kind), flush-to-full rebuilds, and verify outcomes —
        # events_per_cycle is the O(events) claim's in-data evidence
        ev = {k[0]: int(v) for k, v in sched.mirror.ctr_events._series.items()}
        out["mirror_events"] = ev
        out["mirror_events_per_cycle"] = round(
            sum(ev.values()) / max(len(cycles), 1), 2
        )
        out["mirror_full_rebuilds"] = int(sched.mirror.ctr_rebuilds.total())
        out["mirror_rebuild_reasons"] = {
            key[0]: int(n)
            for key, n in sorted(sched.mirror.ctr_rebuilds.breakdown().items())
        }
        out["mirror_verify_failures"] = int(
            sched.mirror.ctr_verify_failures._series.get((), 0)
        )
    if sharded:
        # mesh-sharded observability: the per-cycle routed delta payload
        # (summed over shards — the total host->device bytes a delta
        # cycle ships) and its worst single shard. The flat-bytes gate
        # compares shard_delta_bytes_per_cycle across node scales.
        delta_cycles = [c for c in cycles if c.shard_delta_bytes]
        per_cycle = [float(sum(c.shard_delta_bytes)) for c in delta_cycles]
        out["mesh_devices"] = int(sched.engine.n_shards)
        out["sharded_cycles"] = int(sum(c.sharded_cycles for c in cycles))
        out["shard_delta_bytes_per_cycle"] = (
            round(float(np.mean(per_cycle)), 1) if per_cycle else 0.0
        )
        out["shard_delta_bytes_max_shard"] = (
            int(max(max(c.shard_delta_bytes) for c in delta_cycles))
            if delta_cycles
            else 0
        )
    return out


def _sharded_loop_rate(*, device=None) -> list[dict]:
    """The 100k-node mesh-sharded host loop (host_loop_100000nodes):
    config.sharded_engine + resident_state on a metric-churn workload
    (a fixed-size rotating slice of nodes changes utilization every
    fetch — the workload whose resident deltas must stay FLAT as the
    cluster grows). Emits the 100k row plus a reference row at a tenth
    the nodes; the 100k row carries flat_bytes_ratio = its per-cycle
    routed delta payload over the reference's — the gate is <= 2x
    (asserted at compressed scale in tests/test_bench_smoke.py; at
    real scale the ratio rides the artifact)."""
    n_nodes = int(os.environ.get("BENCH_SHARDED_NODES", 100_000))
    n_pods = int(
        os.environ.get("BENCH_LOOP_PODS", 1024 * DEFAULT_LOOP_WINDOWS)
    )
    churn = int(os.environ.get("BENCH_CHURN_NODES", 256))
    kw = dict(
        n_pods=n_pods, max_windows=1, pipeline_depth=1, force_device=True,
        resident=True, sharded=True, churn_nodes=churn, device=device,
    )
    ref = loop_rate(
        n_nodes=max(n_nodes // 10, 8), metric_suffix="_sharded_ref", **kw
    )
    out = loop_rate(n_nodes=n_nodes, **kw)
    out["ref_shard_delta_bytes_per_cycle"] = ref[
        "shard_delta_bytes_per_cycle"
    ]
    if ref["shard_delta_bytes_per_cycle"]:
        out["flat_bytes_ratio"] = round(
            out["shard_delta_bytes_per_cycle"]
            / ref["shard_delta_bytes_per_cycle"],
            3,
        )
    # the combined scale row: streaming ingestion AND the mesh-sharded
    # resident engine on the same drain — the mirror's O(events) emits
    # feed shard-routed deltas, so the 100k-node cycle pays neither the
    # full host rebuild nor the full upload
    stream = loop_rate(
        n_nodes=n_nodes, metric_suffix="_streaming", mirror=True, **kw
    )
    return [ref, out, stream]


def _replica_loop_rate(*, device=None) -> list[dict]:
    """Replicated scheduler fleet over the partitioned queue
    (host_loop_*nodes_replicas): 1 vs 2 vs 4 FULL Schedulers, each
    draining its crc32(namespace) partition against the shared
    first-bind-wins BindTable (host/replica.py — the checked
    `replica-bind` protocol).

    Scaling phase: each fleet drains the SAME namespaced backlog
    sequentially (ReplicaFleet.run_sequential); the reported aggregate
    is total_bound / max(per-replica busy seconds) — N single-host
    processes run their partitions in true parallel, one GIL cannot, so
    the max-busy quotient is the honest deployment-topology number. The
    per-cycle dispatch shape is held CONSTANT across fleet sizes
    (max_windows_per_cycle tuned so every replica pops full windows):
    scaling then measures the partitioned drain's parallelism, not
    dispatch-shape effects.

    Conflict phase: the deterministic 2-replica storm — the pipelined
    prefetch slot holds replica 0's overlap window popped-but-unbound
    across the round replica 1 binds its copies, so replica 0's bind
    loses the CAS (bind_lose: requeue + 409-drop) and its next pop
    retires the requeued copy via drop_bound. Every loser resolves,
    zero double binds, requeue latency in-data."""
    from kubernetes_scheduler_tpu_torch.host.queue import namespace_partition
    from kubernetes_scheduler_tpu_torch.host.replica import ReplicaFleet
    from kubernetes_scheduler_tpu_torch.host.types import Container, Pod
    from kubernetes_scheduler_tpu_torch.sim.host_gen import (
        gen_host_cluster,
        gen_host_pods,
    )
    from kubernetes_scheduler_tpu_torch.utils.config import SchedulerConfig

    n_nodes = int(os.environ.get("BENCH_LOOP_NODES", 4000))
    n_pods = int(os.environ.get("BENCH_REPLICA_PODS", 0)) or int(
        os.environ.get("BENCH_LOOP_PODS", 1024 * DEFAULT_LOOP_WINDOWS)
    )
    samples = int(os.environ.get("BENCH_LOOP_SAMPLES", "0")) or 3
    fleet_sizes = (1, 2, 4)
    # window sizing: the LARGEST fleet must still pop full dispatches,
    # so cap the per-cycle dispatch at (backlog / max_replicas) windows
    # — at the default 8192-pod backlog that is 2 windows/cycle: r=1
    # runs 4 cycles, r=2 runs 2/replica, r=4 runs 1/replica, all the
    # same dispatch shape
    max_windows = max(1, min(DEFAULT_LOOP_WINDOWS,
                             n_pods // (max(fleet_sizes) * 1024)))
    # one namespace per crc32 % 4 residue: round-robin over these four
    # is exactly balanced at every fleet size (residues alternate mod 2,
    # so the mod-2 split inherits the balance)
    by_res: dict = {}
    i = 0
    while len(by_res) < 4:
        ns = f"tenant-{i}"
        by_res.setdefault(namespace_partition(ns, 4), ns)
        i += 1
    tenants = [by_res[r] for r in range(4)]

    nodes, advisor = gen_host_cluster(n_nodes, seed=0)
    rows: list = []
    base_rate = None
    double_binds = 0
    for n_replicas in fleet_sizes:
        running: list = []
        fleet = ReplicaFleet(
            SchedulerConfig(
                batch_window=1024,
                normalizer="none",
                max_windows_per_cycle=max_windows,
                adaptive_dispatch=False,
                min_device_work=1,
            ),
            n_replicas=n_replicas,
            advisor_factory=lambda i: advisor,
            list_nodes=lambda: nodes,
            list_running_pods=lambda: running,
            device=device,
        )
        cursors = [0] * n_replicas

        def absorb():
            # feed binds back as running pods (per-scheduler cursors:
            # fleet.bindings concatenates, so a flat cursor would skew)
            for k, sched in enumerate(fleet.schedulers):
                bs = sched.binder.bindings
                running.extend(b.pod for b in bs[cursors[k]:])
                cursors[k] = len(bs)

        def backlog(seed_):
            # per-seed unique names: the bind table keys on
            # namespace/name, and a re-run of "pod-0" would be fenced
            # off as already-bound
            for j, pod in enumerate(gen_host_pods(n_pods, seed=seed_)):
                pod.name = f"{pod.name}-s{seed_}"
                pod.namespace = tenants[j % 4]
                fleet.submit(pod)

        backlog(1)
        fleet.run_sequential()  # warmup: first uses; populates `running`
        absorb()
        bound0 = fleet.evidence()["total_binds"]
        agg_s = 0.0
        busy = [0.0] * n_replicas
        for s in range(2, 2 + samples):
            backlog(s)
            ev = fleet.run_sequential()
            absorb()
            agg_s += ev["aggregate_drain_seconds"]
            busy = [a + b for a, b in zip(busy, ev["replica_busy_seconds"])]
        ev = fleet.evidence()
        bound = ev["total_binds"] - bound0
        rate = bound / max(agg_s, 1e-9)
        if base_rate is None:
            base_rate = rate
        double_binds = max(double_binds, ev["double_binds"])
        rows.append({
            "metric": f"host_loop_{n_nodes}nodes_replicas{n_replicas}",
            "replicas": n_replicas,
            "pods_bound": bound,
            "aggregate_pods_per_sec": round(rate, 1),
            "scaling_x": round(rate / max(base_rate, 1e-9), 2),
            "aggregate_drain_seconds": round(agg_s, 3),
            "replica_busy_seconds": [round(b, 3) for b in busy],
            "binds_per_replica": ev["binds_per_replica"],
            "double_binds": ev["double_binds"],
        })

    # -- shared-engine fleet (ONE resident sidecar, coalesced dispatch) --
    # Same backlog/accounting model as the private rows — N single-host
    # processes drain their partitions in true parallel, so the quotient
    # is max per-replica busy seconds — with one refinement: the fused
    # coalesced execute is ONE device invocation serving every
    # participant, so its wall time is apportioned evenly across the
    # requests it carried (each replica's private-engine alternative
    # would have paid a whole dispatch alone; sharing it IS the win this
    # row measures). Host-side dispatch/complete work stays charged to
    # the replica that did it.
    from kubernetes_scheduler_tpu_torch.engine import snapshot_nbytes

    shared_rows: list = []
    shared_base = None
    for n_replicas in (1, 4):
        running_s: list = []
        fleet = ReplicaFleet(
            SchedulerConfig(
                batch_window=1024,
                normalizer="none",
                max_windows_per_cycle=max_windows,
                adaptive_dispatch=False,
                min_device_work=1,
                pipeline_depth=1,
                shared_engine=True,
            ),
            n_replicas=n_replicas,
            advisor_factory=lambda i: advisor,
            list_nodes=lambda: nodes,
            list_running_pods=lambda: running_s,
            device=device,
        )
        pool = fleet.engine_pool
        cursors_s = [0] * n_replicas

        def absorb_s():
            for k, sched in enumerate(fleet.schedulers):
                bs = sched.binder.bindings
                running_s.extend(b.pod for b in bs[cursors_s[k]:])
                cursors_s[k] = len(bs)

        def backlog_s(seed_):
            for j, pod in enumerate(gen_host_pods(n_pods, seed=seed_)):
                pod.name = f"{pod.name}-s{seed_}"
                pod.namespace = tenants[j % 4]
                fleet.submit(pod)

        round_walls: list = []
        round_bound: list = []
        rounds = [0]

        def drain_s(measure: bool):
            for _ in range(256):
                live = [
                    (k, s) for k, s in enumerate(fleet.schedulers)
                    if len(s.queue) or s._prefetched is not None
                ]
                if not live:
                    break
                rounds[0] += measure
                bound_before = sum(
                    len(s.binder.bindings) for s in fleet.schedulers
                )
                exec0 = pool.execute_seconds
                charge = {}
                handles = []
                for k, s in live:
                    t0 = time.perf_counter()
                    handles.append((k, s.run_cycle_split()))
                    charge[k] = time.perf_counter() - t0
                t_complete = {}
                for k, h in handles:
                    t0 = time.perf_counter()
                    h.complete()
                    t_complete[k] = time.perf_counter() - t0
                dev = pool.execute_seconds - exec0
                if measure:
                    # the fused execute landed inside ONE leader's
                    # complete(): strip it there, then charge every
                    # participant an even share of the shared dispatch
                    lead = max(t_complete, key=t_complete.get)
                    t_complete[lead] = max(t_complete[lead] - dev, 0.0)
                    share = dev / max(len(handles), 1)
                    for k, _ in handles:
                        charge[k] += t_complete[k] + share
                    round_walls.append(max(charge.values()))
                    round_bound.append(
                        sum(len(s.binder.bindings) for s in fleet.schedulers)
                        - bound_before
                    )
                absorb_s()

        backlog_s(1)
        drain_s(False)  # warmup: first uses; populates `running_s`
        # second warmup backlog: the first round's replica snapshots are
        # identical (zero-delta elements); once the mirrors diverge the
        # fleet's elements carry real deltas, whose first folds must not
        # land measured
        backlog_s(99)
        drain_s(False)
        bound0 = fleet.evidence()["total_binds"]
        st0 = pool.stats()
        for s in range(2, 2 + samples):
            backlog_s(s)
            drain_s(True)
        ev = fleet.evidence()
        st = pool.stats()
        bound = ev["total_binds"] - bound0
        # rate from the MEDIAN round (same reasoning as the host-loop
        # p50 companions): delta row buckets occasionally cross a
        # power-of-two during measured rounds, and that round's one-time
        # reallocation is a cache event, not the steady-state cost the
        # scaling gate compares
        wall_p50 = float(np.percentile(round_walls, 50))
        bound_p50 = float(np.percentile(round_bound, 50))
        rate = bound_p50 / max(wall_p50, 1e-9)
        if shared_base is None:
            shared_base = rate
        dispatches = st["device_dispatches"] - st0["device_dispatches"]
        shared_bytes = sum(st["upload_bytes"].values()) - sum(
            st0["upload_bytes"].values()
        )
        # what the SAME measured traffic costs with private engines: one
        # full snapshot upload per replica-dispatch (the non-resident
        # fleet rows above device_put the whole snapshot every cycle)
        s0 = fleet.schedulers[0]
        snap_bytes = snapshot_nbytes(
            s0.builder.build_snapshot(
                nodes, s0.advisor.fetch(), running_s, ephemeral=True
            )
        )
        # one dispatch per live replica-round under private engines
        private_bytes = rounds[0] * n_replicas * snap_bytes
        row = {
            "metric": f"host_loop_{n_nodes}nodes_replicas{n_replicas}_shared",
            "replicas": n_replicas,
            "pods_bound": bound,
            "aggregate_pods_per_sec": round(rate, 1),
            "scaling_x": round(rate / max(shared_base, 1e-9), 2),
            "round_wall_p50_ms": round(1e3 * wall_p50, 2),
            "rounds": rounds[0],
            "device_dispatches": dispatches,
            "dispatches_per_round": round(dispatches / max(rounds[0], 1), 2),
            "coalesced_dispatches": st["coalesced_dispatches"]
            - st0["coalesced_dispatches"],
            "uploads": {
                k: st["uploads"][k] - st0["uploads"][k]
                for k in ("full", "delta", "dedup")
            },
            # per-fleet bytes actually shipped vs what N private engines
            # ship for the same traffic — the <= ~1/N dedupe gate
            "snapshot_upload_bytes": shared_bytes,
            "private_engine_upload_bytes": private_bytes,
            "upload_bytes_vs_private": round(
                shared_bytes / max(private_bytes, 1), 4
            ),
            "double_binds": ev["double_binds"],
        }
        if n_replicas == 4:
            row["scaling_x_4"] = row["scaling_x"]
        shared_rows.append(row)

    # -- conflict storm (deterministic; evidence for the headline row) --
    ns0 = next(
        f"tenant-{i}" for i in range(64)
        if namespace_partition(f"tenant-{i}", 2) == 0
    )
    storm_running: list = []
    storm = ReplicaFleet(
        SchedulerConfig(
            batch_window=32,
            normalizer="none",
            max_windows_per_cycle=1,
            pipeline_depth=1,
            adaptive_dispatch=False,
            min_device_work=1,
        ),
        n_replicas=2,
        advisor_factory=lambda i: advisor,
        list_nodes=lambda: nodes,
        list_running_pods=lambda: storm_running,
        device=device,
    )

    def _storm_pod(name, prio):
        return Pod(
            name=name,
            namespace=ns0,
            labels={"scv/priority": str(prio)},
            containers=[Container(
                requests={"cpu": 100.0, "memory": float(2**28)}
            )],
        )

    n_overlap = 8
    for j in range(32):  # filler: replica 0 binds these first...
        storm.submit(_storm_pod(f"filler-{j}", 10))
    for j in range(n_overlap):  # ...while PREFETCHING the overlap window
        storm.submit_overlap(_storm_pod(f"overlap-{j}", 5))
    for _ in range(64):  # round-robin cycles (the scenario runner's drain)
        progressed = False
        active = False
        for sched in storm.schedulers:
            if len(sched.queue) == 0 and sched._prefetched is None:
                continue
            active = True
            m = sched.run_cycle()
            if m.pods_bound > 0 or m.pods_dropped > 0:
                progressed = True
        if not active or not progressed:
            break
    for sched in storm.schedulers:
        sched.drain_pipeline()
    sev = storm.evidence()

    # -- shared-engine storm: the same deterministic conflict program
    # through ONE pooled engine — under contention the fleet must still
    # resolve every loser (no pod lost, no double bind) while the pool
    # coalesces the per-tick dispatches below one-per-replica
    storm2_running: list = []
    storm2 = ReplicaFleet(
        SchedulerConfig(
            batch_window=32,
            normalizer="none",
            max_windows_per_cycle=1,
            pipeline_depth=1,
            adaptive_dispatch=False,
            min_device_work=1,
            shared_engine=True,
        ),
        n_replicas=2,
        advisor_factory=lambda i: advisor,
        list_nodes=lambda: nodes,
        list_running_pods=lambda: storm2_running,
        device=device,
    )
    for j in range(32):
        storm2.submit(_storm_pod(f"filler-{j}", 10))
    for j in range(n_overlap):
        storm2.submit_overlap(_storm_pod(f"overlap-{j}", 5))
    storm_ticks = 0
    for _ in range(64):
        live = [
            s for s in storm2.schedulers
            if len(s.queue) or s._prefetched is not None
        ]
        if not live:
            break
        storm_ticks += 1
        handles = [s.run_cycle_split() for s in live]
        progressed = False
        for h in handles:
            m = h.complete()
            progressed |= m.pods_bound > 0 or m.pods_dropped > 0
        if not progressed:
            break
    for sched in storm2.schedulers:
        sched.drain_pipeline()
    sev2 = storm2.evidence()
    st2 = storm2.engine_pool.stats()

    head = {
        "metric": f"host_loop_{n_nodes}nodes_replicas",
        # HEADLINE = aggregate-throughput scaling at 2 replicas with
        # zero double binds (the acceptance gate reads scaling_x_2 and
        # double_binds off this row)
        "scaling_x_2": rows[1]["scaling_x"],
        "scaling_x_4": rows[2]["scaling_x"],
        "aggregate_pods_per_sec": {
            str(r["replicas"]): r["aggregate_pods_per_sec"] for r in rows
        },
        "double_binds": max(double_binds, sev["double_binds"]),
        # storm accounting: 32 filler + 8 overlap must bind exactly
        # once each — every overlap loser resolved, never a lost pod
        "storm_overlap_pods": n_overlap,
        "bind_conflicts": sev["bind_conflicts_total"],
        "conflict_rate": round(
            sev["bind_conflicts_total"] / n_overlap, 2
        ),
        "pods_discarded": sev["pods_discarded"],
        "pods_lost": 32 + n_overlap - sev["total_binds"],
        "requeue_latency_count": sev["requeue_latency_count"],
        "requeue_latency_mean_ms": round(
            1e3 * sev["requeue_latency_mean_s"], 2
        ),
        "requeue_latency_max_ms": round(
            1e3 * sev["requeue_latency_max_s"], 2
        ),
        # shared-engine storm: contention semantics intact (no pod lost,
        # no double bind, every loser resolved) while the pool coalesces
        # below one dispatch per replica per tick — the <N gate
        "shared_storm_double_binds": sev2["double_binds"],
        "shared_storm_pods_lost": 32 + n_overlap - sev2["total_binds"],
        "shared_storm_bind_conflicts": sev2["bind_conflicts_total"],
        "shared_storm_ticks": storm_ticks,
        "shared_storm_device_dispatches": st2["device_dispatches"],
        "shared_storm_dispatches_per_tick": round(
            st2["device_dispatches"] / max(storm_ticks, 1), 2
        ),
        "shared_storm_coalesced_dispatches": st2["coalesced_dispatches"],
    }
    return rows + shared_rows + [head]


def _sharded_throughput(*, device=None) -> dict:
    """The 100k-node engine headline (scheduling_throughput_100000nodes):
    the whole 50k-pod backlog as ONE call of the mesh-sharded windows
    program (make_sharded_windows_fn — the node axis sharded over
    _mesh(device), capacity/affinity carries threaded between windows
    on each shard), measured like device_rate. The ROADMAP's "millions
    of users" scale step: 100k nodes x 50k pending pods in one
    device-resident assignment problem."""
    from kubernetes_scheduler_tpu_torch.device import to_host
    from kubernetes_scheduler_tpu_torch.engine import stack_windows
    from kubernetes_scheduler_tpu_torch.parallel import (
        make_sharded_windows_fn,
        shard_snapshot,
    )
    from kubernetes_scheduler_tpu_torch.sim import gen_cluster, gen_pods
    from kubernetes_scheduler_tpu_torch.utils.padding import pad_pod_batch

    n_nodes = int(os.environ.get("BENCH_SHARDED_NODES", 100_000))
    n_pods = int(os.environ.get("BENCH_SHARDED_PODS", 50_000))
    window = min(WINDOW, max(8, n_pods))
    mesh = _mesh(device)
    d = mesh.size
    n_nodes -= n_nodes % d  # keep the node axis mesh-divisible
    snapshot = gen_cluster(n_nodes, seed=0, device="cpu")
    pods = gen_pods(n_pods, seed=1, device="cpu")
    n_padded = -(-n_pods // window) * window
    # every shard's rows upload once, to its device; the backlog once,
    # to the lead device (the program replicates it per call)
    shards = shard_snapshot(snapshot, mesh)
    pods_w = _upload(
        stack_windows(pad_pod_batch(pods, n_padded), window), mesh.devices[0]
    )
    fn = make_sharded_windows_fn(
        mesh, assigner="auction", normalizer="none", fused=FUSED,
        auction_price_frac=PRICE_FRAC,
    )
    out = fn(shards, pods_w)
    assigned = int(to_host(out.n_assigned))
    if assigned == 0:
        raise RuntimeError("sharded benchmark scheduled zero pods")
    t0 = time.perf_counter()
    for _ in range(REPS):
        out = fn(shards, pods_w)
    if int(to_host(out.n_assigned)) <= 0:
        raise RuntimeError("timed sharded run scheduled zero pods")
    dt = time.perf_counter() - t0
    rate = REPS * n_pods / dt
    return {
        "metric": f"scheduling_throughput_{n_nodes}nodes",
        "value": round(rate, 1),
        "unit": "pods/s",
        "mesh_devices": d,
        "pods": n_pods,
        "assigned": assigned,
    }


def host_loop_rows(*, device=None):
    """The host-loop block's rows, in the reference's order: --loop
    prints them alone, the default mode between its first and second
    engine rows."""
    yield loop_rate(device=device)
    yield loop_rate(max_windows=16, metric_suffix="_deep16w", device=device)
    # the double-buffered loop beside the serial one
    pipe = _pipelined_loop_rate(device=device)
    yield pipe
    # fused kernels vs the composed device step on the same drain shape
    yield _fused_loop_rate(device=device)
    # device-resident cluster state with epoch-validated delta uploads
    yield _resident_loop_rate(device=device)
    # streaming state ingestion: the event-sourced mirror drain beside
    # an identical rebuild drain, the idle-cluster and layout-drift rows
    yield _streaming_loop_rate(device=device)
    yield _idle_streaming_rate(device=device)
    yield _drift_streaming_rate(device=device)
    # the mesh-sharded resident loop at the 100k-node scale (with the
    # flat-bytes reference) and the sharded engine headline
    yield from _sharded_loop_rate(device=device)
    yield _sharded_throughput(device=device)
    # the replicated scheduler fleet: 1 vs 2 vs 4 Schedulers over the
    # partitioned queue + first-bind-wins table, the shared-engine
    # fleets, and the deterministic conflict-storm row
    yield from _replica_loop_rate(device=device)
    # flight recorder on, then replay-from-trace (binding_diffs = 0)
    yield _replay_loop_rate(device=device)
    # shadow serving over the same journal shape (divergence 0)
    yield _shadow_rescore_rate(device=device)
    # full telemetry on beside the pipelined baseline, and the per-stage
    # cycle budget table over the same drain's spans
    yield from _telemetry_loop_rate(pipe, device=device)
    # the scenario harness: burst arrivals and the gang-heavy mix
    yield _scenario_rate("burst", "burst", device=device)
    yield _scenario_rate("gang-mix", "gang", device=device)
    # the same drain shape under a deterministic engine RPC-flap plan
    yield _chaos_loop_rate(device=device)


def perf_gate_rows(out_dir: str, *, device=None):
    """--perf-gate-spans: three telemetry-shaped drains writing spans into
    ONE directory, which `spans diff` then gates against the committed
    kubernetes_scheduler_tpu_torch/BENCH_SPAN_BASELINE.json — a
    regression in any stage fails loudly, per stage, with numbers
    attached."""
    n_pods = int(os.environ.get("BENCH_LOOP_PODS", 1024 * DEFAULT_LOOP_WINDOWS))
    churn = int(os.environ.get("BENCH_CHURN_NODES", 64))
    kw = dict(
        n_pods=n_pods, max_windows=1, pipeline_depth=1, force_device=True,
        span_path=out_dir, device=device,
    )
    yield loop_rate(metric_suffix="_perfgate", **kw)
    # the mesh-sharded resident drain: the baseline covers the sharded
    # path's stage costs too
    yield loop_rate(
        n_nodes=int(os.environ.get("BENCH_SHARDED_NODES", 4000)),
        resident=True, sharded=True, churn_nodes=churn,
        metric_suffix="_perfgate_sharded", **kw,
    )
    # the streaming-ingestion drain adds the mirror stages (event_apply,
    # mirror_emit)
    yield loop_rate(
        resident=True, mirror=True, churn_nodes=churn,
        metric_suffix="_perfgate_streaming", **kw,
    )


_PROBE_SRC = (
    "import torch\n"
    "n = torch.cuda.device_count() if torch.cuda.is_available() else 0\n"
    "print(n)\n"
)
PROBE_TIMEOUT_S = 240


def _card() -> str | None:
    """The card's name and power limit as nvidia-smi prints them, or
    None when nvidia-smi does not answer."""
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.SubprocessError):
        return None
    lines = smi.stdout.strip().splitlines()
    return lines[0] if smi.returncode == 0 and lines else None


def _diag(**fields) -> None:
    print(json.dumps(fields), flush=True)


def backend_diag(device) -> bool:
    """Probe torch.cuda in a SUBPROCESS with a deadline, printing one
    diagnostic JSON line BEFORE any metric, so a red bench is
    attributable from its output alone (the reference's _backend_diag:
    a wedged CUDA runtime hangs the probe, not the bench). One clean retry
    (fresh subprocess) covers transient init flakes.

    On success: {"diag": "backend", "platform": "gpu" | "cpu" (what
    the bench runs on), "device_count": N (visible cards), "attempt": k},
    on a card with its name and power limit ("card"). Returns False
    after a backend_probe_timeout / backend_init_failed line when no
    probe answered, or when `device` is a card and the probe found none:
    the bench never measures the CPU under a card's metric name."""
    on_card = str(device).startswith("cuda")
    for attempt in (1, 2):
        try:
            probe = subprocess.run(
                [sys.executable, "-c", _PROBE_SRC],
                capture_output=True, text=True, timeout=PROBE_TIMEOUT_S,
            )
        except subprocess.TimeoutExpired:
            _diag(diag="backend_probe_timeout", attempt=attempt,
                  timeout_s=PROBE_TIMEOUT_S)
            continue
        if probe.returncode == 0 and probe.stdout.strip():
            count = int(probe.stdout.split()[-1])
            if on_card and count == 0:
                # a missing card is an answer, not a flake: no retry
                _diag(diag="backend_init_failed", attempt=attempt, rc=0,
                      platform="cpu", device_count=0,
                      error="no CUDA device (torch.cuda.is_available() is "
                      "false); pass --device cpu to run the plain PyTorch "
                      "path on the CPU")
                return False
            line = {"diag": "backend", "platform": "gpu" if on_card else "cpu",
                    "device_count": count, "attempt": attempt}
            if on_card:
                line["card"] = _card()
            _diag(**line)
            return True
        _diag(diag="backend_init_failed", attempt=attempt, rc=probe.returncode,
              error=(probe.stderr or "")[-300:])
        time.sleep(5)
    return False


def _emit(row: dict, since: float) -> float:
    """Print one row as a JSON line, and its wall seconds since `since`
    (the previous row) on standard error; returns the time now."""
    print(json.dumps(row), flush=True)
    now = time.perf_counter()
    print(f"bench: {row.get('metric', row.get('config'))} "
          f"{now - since:.3f} s", file=sys.stderr, flush=True)
    return now


def main(argv=None) -> int:
    import traceback

    ap = argparse.ArgumentParser(
        prog="python -m kubernetes_scheduler_tpu_torch.bench",
        description="The port's throughput benchmark (the reference's "
        "bench.py): the engine rows by default, the suite, the host loop, "
        "or the perf gate's span drains.",
    )
    ap.add_argument("--device", default="cuda",
                    help="torch device to measure (default cuda; cpu runs "
                    "the plain PyTorch path)")
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--suite", action="store_true",
                      help=f"the BASELINE.md configs, written to {SUITE_OUT}")
    mode.add_argument("--loop", action="store_true",
                      help="the host-loop rows alone")
    mode.add_argument("--perf-gate-spans", metavar="DIR",
                      help="three span-writing drains into DIR for `spans diff`")
    args = ap.parse_args(argv)
    device = args.device
    if not backend_diag(device):
        return 1
    t = time.perf_counter()
    if args.perf_gate_spans:
        for row in perf_gate_rows(args.perf_gate_spans, device=device):
            t = _emit(row, t)
        return 0
    if args.loop:
        for row in host_loop_rows(device=device):
            t = _emit(row, t)
        return 0
    if args.suite:
        from kubernetes_scheduler_tpu_torch.sim.cluster_gen import BENCH_CONFIGS

        results = []
        for name in BENCH_CONFIGS:
            t0 = time.perf_counter()
            results.append(suite_rate(name, device=device))
            print(f"bench: {name} {time.perf_counter() - t0:.3f} s",
                  file=sys.stderr, flush=True)
        with open(SUITE_OUT, "w") as f:
            json.dump(results, f, indent=2)
        for r in results:
            print(json.dumps(r), flush=True)
        return 0

    from kubernetes_scheduler_tpu_torch.sim import gen_cluster, gen_pods

    # images=True adds the ImageLocality signal for the weighted-combination
    # measurement; the yoda-only calls never read those leaves
    snapshot = gen_cluster(N_NODES, seed=0, images=True, device="cpu")
    pods = gen_pods(N_PODS, seed=1, images=True, device="cpu")
    base = baseline_rate(snapshot, pods)
    # the deployed-default configuration measured BESIDE the
    # throughput-first headline; emitted first, the headline LAST
    t = _emit(engine_row("_deployed_default", snapshot, pods, base,
                         device=device), t)
    # the END-TO-END host loop recorded beside the engine rows; a failure
    # must not cost the engine rows, and ends the run non-zero
    failed = False
    try:
        for row in host_loop_rows(device=device):
            t = _emit(row, t)
    except Exception as e:  # noqa: BLE001 - reported, then exit 1
        traceback.print_exc()
        _diag(diag="host_loop_failed", error=str(e)[-200:])
        failed = True
    t = _emit(engine_row("_weighted_multi_scorer", snapshot, pods, base,
                         device=device), t)
    _emit(engine_row("", snapshot, pods, base, device=device), t)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
