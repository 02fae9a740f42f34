"""Run one cell of the benchmark once and print its result line.

    python3 -m schedbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout that holds BENCHMARK.json. The cell names
a configuration (schedbench/configs/<name>.json) and a traffic mix
(schedbench/traffic/<name>.json); each metric is read by
schedbench/metrics/<name>.py. With --trace 0 the result carries the cell's
end-to-end metrics, with --trace 1 its per-layer metrics, read from
torch.profiler, the program's spans and its CycleMetrics. Either way the
run ends with the reference's check (schedbench/reference.py): each
compared number beside its limit, as the last lines on standard error and
under `check` as the last key of the result line, the last line on
standard output.

The run needs a CUDA card: without one, or with fewer than the cell asks
for, it exits 2 and prints no result. It exits 3 and prints no result when
jax, jaxlib, flax or the JAX package is loaded once the window has closed.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import inspect
import json
import os
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

START = time.perf_counter()

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "kubernetes_scheduler_tpu")


def since_process_start() -> float:
    """Seconds from this process's start to now (Linux /proc), measured
    so that the interpreter's own start counts as set-up."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - START


PRE_START = since_process_start() - (time.perf_counter() - START)


def cache_dirs(root: Path) -> None:
    """Every build and kernel cache inside the checkout, at fixed paths:
    the program's nvcc library goes to kubernetes_scheduler_tpu_torch/_build
    and the native host library to native/build by the program's own rule."""
    cache = root / ".schedbench_cache"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    # keep any library that would load JAX by itself from doing so
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list   # metric entries of BENCHMARK.json this cell reports
    per_layer: list


def load_cell(name: str, root: Path) -> Cell:
    """The cell `name` of root/BENCHMARK.json, with its configuration and
    traffic files and the metrics it reports."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise SystemExit(f"schedbench: no workload {name!r} in BENCHMARK.json")
    w = work[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((root / conf["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text())

    def mine(metrics: list) -> list:
        return [m for m in metrics if "workloads" not in m or name in m["workloads"]]

    return Cell(name, int(w["chips"]), config, traffic,
                mine(bench["end_to_end"]), mine(bench["per_layer"]))


def reader(metric: str):
    """schedbench/metrics/<metric>.py's read()."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"schedbench.metrics.{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclass
class RunView:
    """What the metric readers see."""

    rec: object
    setup_s: float
    trace: object = None
    launches: dict = field(default_factory=dict)


def record_launches(fused) -> dict:
    """Wrap K1's and K3's launch sites (ops.fused.masked_score and
    auction_bid) to keep each CUDA launch's shapes; K3 keeps its `active`
    mask, whose count is read once the window has closed."""
    log = {"masked_score": [], "auction_bid": []}
    ms, ab = fused.masked_score, fused.auction_bid
    ms_sig, ab_sig = inspect.signature(ms), inspect.signature(ab)

    def masked_score(*a, **k):
        b = ms_sig.bind(*a, **k).arguments
        if b["u"].is_cuda and not b.get("_plain", False):
            req, aff = b["pod_request"], b.get("aff_pod")
            log["masked_score"].append((
                req.shape[0], b["u"].shape[0], req.shape[1],
                0 if aff is None else aff.shape[0] // 4,
                b.get("other") is not None, b.get("stats") is not None,
            ))
        return ms(*a, **k)

    def auction_bid(*a, **k):
        b = ab_sig.bind(*a, **k).arguments
        if b["sj"].is_cuda and not b.get("_plain", False):
            sj = b["sj"]
            log["auction_bid"].append((sj.shape[0], sj.shape[1], b["req"].shape[1], b["active"]))
        return ab(*a, **k)

    fused.masked_score, fused.auction_bid = masked_score, auction_bid
    log["_restore"] = lambda: (setattr(fused, "masked_score", ms),
                               setattr(fused, "auction_bid", ab))
    return log


def resolve_launches(log: dict, torch) -> dict:
    """K3's active masks turned into counts, after the window."""
    k3 = log.get("auction_bid", [])
    counts = torch.stack([a.sum() for *_, a in k3]).tolist() if k3 else []
    return {
        "masked_score": list(log.get("masked_score", [])),
        "auction_bid": [(p, n, r, int(c)) for (p, n, r, _), c in zip(k3, counts)],
    }


def forbidden_modules() -> list:
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, *, device,
             torch, log=print, after_setup=None, control: bool = False) -> dict:
    """One run: set-up, the window, the metrics and the check. Returns the
    result object; raises SystemExit(3) when JAX was loaded. `after_setup`,
    when given, is called with the CellRun before the window (the tests
    break the timed path there). With `control`, the result also holds
    the control's numbers and verdict under `control` (schedbench.control;
    the benchmark's own runs never run it)."""
    from schedbench import reference
    from schedbench.loop import CellRun
    from schedbench.profile import Tracer

    span_path = None
    if trace:
        span_path = os.path.join(os.environ.get("TMPDIR") or str(Path.home()), "schedbench_spans")
        _clear(span_path)
    run = CellRun(cell.config, cell.traffic, seed, device=device, span_path=span_path)
    log(f"schedbench: effective config {json.dumps(run.rec.effective_config, sort_keys=True)}",
        file=sys.stderr)
    run.setup(seconds)
    if after_setup is not None:
        after_setup(run)
    on_card = torch.device(device).type == "cuda"
    launches, spans, tracer = {}, [], None
    if trace:
        from kubernetes_scheduler_tpu_torch.ops import fused

        launches = record_launches(fused)
        if run.sched.spans is not None:
            flush = run.sched.spans.flush

            def keep(ss, **kw):
                spans.extend((n, t0, t1) for n, t0, t1, _ in ss.spans)
                return flush(ss, **kw)

            run.sched.spans.flush = keep
        if on_card:
            tracer = Tracer(torch)
            tracer.start()
    t_first = time.perf_counter()
    run.window(seconds)
    window_stages = [st for st in run.rec.stages if st[1] >= t_first]
    dev_trace = tracer.stop(spans + window_stages) if tracer is not None else None
    if trace:
        launches["_restore"]()
        launches = resolve_launches(launches, torch)
    found = forbidden_modules()
    if found:
        print(f"schedbench: loaded after the window: {', '.join(found)}", file=sys.stderr)
        raise SystemExit(3)
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    view = RunView(rec=run.rec, setup_s=PRE_START + t_first - START, trace=dev_trace,
                   launches=launches)
    wanted = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in wanted:
        value = reader(m["name"])(view)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    rec = run.rec
    _report(rec, view, log)
    run.close()
    del run
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    lim = reference.limits(cell.config)
    values = reference.check(rec, device)
    correct, shown = reference.verdict(values, lim)
    window = rec.window()
    out = {
        "correct": correct,
        "attempted": rec.window_submitted,
        "failed": sum(c.metrics.pods_unschedulable + c.metrics.pods_dropped for c in window),
        "metrics": metrics,
        "device": {
            "platform": "gpu" if on_card else "cpu",
            "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
            "count": cell.chips,
            "memory_peak_bytes": int(peak),
        },
    }
    if dev_trace is not None:
        out["device"]["busy_s"] = dev_trace.busy_s()
        out["device"]["window_s"] = dev_trace.window_s()
        ops = sorted(dev_trace.by_name().items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(dev_trace.idle_gaps().items(), key=lambda kv: -kv[1])[:10]
        out["breakdown"] = {"device_ops": [[k[:120], v] for k, v in ops],
                            "idle_gaps": [[k, v] for k, v in gaps]}
    if control:
        c_correct, c_shown = reference.verdict(reference.control_check(rec, device), lim)
        out["control"] = {"correct": c_correct, "check": c_shown}
    rec.k1 = None
    out["check"] = shown
    return out


def _report(rec, view, log) -> None:
    """Earlier lines on standard error: cycle paths, the pods the pool
    lacked, and the host stages' totals."""
    from schedbench.metrics._shared import stage_seconds

    window = rec.window()
    scalar = sum(1 for c in window if c.metrics.used_fallback)
    stage_s = stage_seconds(rec)
    log(f"schedbench: window cycles {len(window)} device {len(window) - scalar} "
        f"scalar {scalar} pods_bound {sum(c.metrics.pods_bound for c in window)} "
        f"seconds {rec.window_t1 - rec.window_t0} "
        f"cycle_s {sum(c.metrics.cycle_seconds for c in window)} "
        f"engine_s {sum(c.metrics.engine_seconds for c in window)} "
        f"harness_s {json.dumps(stage_s, sort_keys=True)} "
        f"pool_short {rec.pool_short} queued_at_end {rec.queued_at_end}", file=sys.stderr)
    if view.trace is not None:
        stages: dict = {}
        for name, t0, t1 in view.trace.spans:
            stages[name] = stages.get(name, 0.0) + (t1 - t0)
        log(f"schedbench: host stages {json.dumps(stages, sort_keys=True)}", file=sys.stderr)


def _clear(path: str) -> None:
    import shutil

    shutil.rmtree(path, ignore_errors=True)
    os.makedirs(path, exist_ok=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m schedbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = Path.cwd()
    cache_dirs(root)
    cell = load_cell(args.workload, root)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"schedbench: needs {cell.chips} CUDA card(s); "
              f"available={torch.cuda.is_available()} count={torch.cuda.device_count()}",
              file=sys.stderr)
        return 2
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                   device=torch.device("cuda", 0), torch=torch)
    for name, v in out["check"].items():
        print(f"check {name} {v['value']} limit {v['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
