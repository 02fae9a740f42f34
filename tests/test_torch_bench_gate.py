"""The port's span perf gate: `bench --perf-gate-spans DIR` (three
span-writing drains into one directory) and `spans diff` against the
committed kubernetes_scheduler_tpu_torch/BENCH_SPAN_BASELINE.json, at the
knobs and thresholds of the reference's `make perf-gate`
(Makefile:410-423), on the CPU."""

import json
import os
import subprocess
import sys

from kubernetes_scheduler_tpu_torch import bench
from kubernetes_scheduler_tpu_torch.cli import main as cli_main
from kubernetes_scheduler_tpu_torch.trace.analyze import build_report, perturb_spans

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASELINE = os.path.join(REPO, "kubernetes_scheduler_tpu_torch", "BENCH_SPAN_BASELINE.json")
GATE_ENV = {
    "BENCH_LOOP_NODES": "32", "BENCH_LOOP_PODS": "64",
    "BENCH_SHARDED_NODES": "64", "BENCH_CHURN_NODES": "8",
}
THRESHOLDS = [
    "--threshold-pct", "100", "--min-ms", "20",
    "--stage-threshold", "engine_step=150",
    "--stage-threshold", "snapshot_build=150",
    "--stage-threshold", "cycle=150",
]


def lines(text: str) -> list:
    return [json.loads(x) for x in text.splitlines() if x.startswith("{")]


def test_torch_perf_gate_spans_and_diff(monkeypatch, capsys, tmp_path):
    """Every drain writes spans; the run's own report diffs clean against
    it; a 20x engine_step trips the gate (exit 1, naming the stage); the
    committed baseline covers every stage the run writes."""
    for k, v in GATE_ENV.items():
        monkeypatch.setenv(k, v)
    spans = str(tmp_path / "spans")
    assert bench.main(["--device", "cpu", "--perf-gate-spans", spans]) == 0
    out = lines(capsys.readouterr().out)
    assert out[0]["diag"] == "backend" and out[0]["platform"] == "cpu"
    rows = {r["metric"]: r for r in out[1:]}
    assert list(rows) == [
        "host_loop_32nodes_perfgate", "host_loop_64nodes_perfgate_sharded",
        "host_loop_32nodes_perfgate_streaming",
    ]
    for row in rows.values():
        assert row["spans_written"] > 0 and row["spans_dropped"] == 0, row
    report = build_report(spans)
    base = tmp_path / "self.json"
    base.write_text(json.dumps(report))
    assert cli_main(["spans", "diff", str(base), spans, *THRESHOLDS]) == 0
    assert json.loads(capsys.readouterr().out)["clean"] is True
    slow = str(tmp_path / "slow")
    assert perturb_spans(spans, slow, stage="engine_step", factor=20.0) > 0
    assert cli_main(["spans", "diff", str(base), slow, *THRESHOLDS]) == 1
    tripped = json.loads(capsys.readouterr().out)
    assert "engine_step" in tripped["regressions"], tripped
    committed = json.load(open(BASELINE))
    assert set(report["stages"]) <= set(committed["stages"])
    assert committed["cycles"] == report["cycles"]


def test_torch_perf_gate_e2e(tmp_path):
    """The gate as a user runs it: a fresh --perf-gate-spans run in its
    own process, diffed against the committed baseline with the
    reference's thresholds: exit 0."""
    env = {**os.environ, **GATE_ENV}
    spans = str(tmp_path / "spans")
    run = subprocess.run(
        [sys.executable, "-m", "kubernetes_scheduler_tpu_torch.bench",
         "--device", "cpu", "--perf-gate-spans", spans],
        capture_output=True, text=True, timeout=600, cwd=REPO, env=env,
    )
    assert run.returncode == 0, run.stderr[-2000:]
    gate = subprocess.run(
        [sys.executable, "-m", "kubernetes_scheduler_tpu_torch", "spans", "diff",
         BASELINE, spans, *THRESHOLDS],
        capture_output=True, text=True, timeout=300, cwd=REPO,
    )
    assert gate.returncode == 0, gate.stdout[-2000:] + gate.stderr[-1000:]
    assert json.loads(gate.stdout)["clean"] is True
