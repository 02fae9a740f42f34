"""The port's bench (kubernetes_scheduler_tpu_torch/bench.py) against the
reference's (the repo root's bench.py), in process on the CPU, with the
reference's module-level knobs set by monkeypatch (nothing in bench.py
changes for this).

- `_baseline_pass`, the vs_baseline denominator, is the same numpy
  arithmetic: bitwise on the same seeded snapshot.
- suite_rate on a tiny gpu and a tiny constraints config (added to both
  packages' BENCH_CONFIGS) and on deployment-50 (the native loop): the
  same keys, `assigned` and `assigned_greedy` equal, `mean_score_*`
  within 0.01 (the rows round to 2 decimals; the port's per-cell scores
  differ from the reference's only by the CPU's FMA contraction, ~1 ulp
  of 10).
- the default mode's three engine rows: the same metric names, keys and
  order as the reference's main() at the smoke knobs.
- --suite writes its own file and leaves the root BENCH_SUITE.json as it
  was.
- a slow-marked twin of tests/test_bench_smoke.py::test_bench_smoke_e2e:
  the port's whole default mode and --loop on --device cpu, every row
  held to chip_smoke.check_bench_rows (the reference smoke test's
  assertions; the mesh size is sharded_device_count(), not 8)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import bench as ref_bench
import chip_smoke
from kubernetes_scheduler_tpu.sim import cluster_gen as ref_cluster_gen
from kubernetes_scheduler_tpu_torch import bench
from kubernetes_scheduler_tpu_torch.parallel import sharded_device_count
from kubernetes_scheduler_tpu_torch.sim import cluster_gen

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# tests/test_bench_smoke.py's knobs
SMOKE_ENV = {
    "BENCH_NODES": "64",
    "BENCH_PODS": "128",
    "BENCH_WINDOW": "32",
    "BENCH_REPS": "2",
    "BENCH_BASELINE_PODS": "8",
    "BENCH_LOOP_NODES": "32",
    "BENCH_LOOP_PODS": "64",
    "BENCH_LOOP_SAMPLES": "3",
    "BENCH_SHARDED_NODES": "256",
    "BENCH_SHARDED_PODS": "96",
    "BENCH_CHURN_NODES": "8",
}
# the knobs both modules read when they are imported
MODULE_KNOBS = {
    "N_NODES": "BENCH_NODES", "N_PODS": "BENCH_PODS", "WINDOW": "BENCH_WINDOW",
    "REPS": "BENCH_REPS", "BASELINE_PODS": "BENCH_BASELINE_PODS",
}
TINY_CONFIGS = {
    "gpu-tiny": dict(n_pods=96, n_nodes=40, gpu=True),
    "constraints-tiny": dict(n_pods=96, n_nodes=48, constraints=True),
}


def smoke_knobs(monkeypatch, env=SMOKE_ENV):
    """Both benches at `env`'s knobs: the call-time ones in the
    environment, the import-time ones on both modules."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    for attr, key in MODULE_KNOBS.items():
        if key in env:
            monkeypatch.setattr(ref_bench, attr, int(env[key]))
            monkeypatch.setattr(bench, attr, int(env[key]))


def json_lines(text: str) -> list:
    return [json.loads(x) for x in text.splitlines() if x.startswith("{")]


@pytest.mark.parametrize("seed,n_nodes,n_pods", [(0, 64, 16), (1, 300, 64), (2, 9, 40)])
def test_torch_bench_baseline_pass_bitwise(seed, n_nodes, n_pods):
    """The per-pod emulation of the reference scheduler: the capacity it
    leaves behind, bitwise, with zero r_io (the beta = 1 limit) and
    pods that fit nowhere among the inputs."""
    rng = np.random.default_rng(seed)
    alloc = rng.choice([4000, 8000], (n_nodes, 3)).astype(np.float32)
    requested = (alloc * rng.uniform(0.0, 0.9, (n_nodes, 3))).astype(np.float32)
    disk_io = rng.uniform(0, 50, n_nodes).astype(np.float32)
    cpu_pct = rng.uniform(0, 100, n_nodes).astype(np.float32)
    req = rng.choice([100, 500, 2000, 9000], (n_pods, 3)).astype(np.float32)
    r_io = np.where(rng.random(n_pods) < 0.3, 0.0, rng.uniform(1, 20, n_pods)).astype(np.float32)
    got, want = requested.copy(), requested.copy()
    bench._baseline_pass(req, r_io, alloc, got, disk_io, cpu_pct)
    ref_bench._baseline_pass(req, r_io, alloc, want, disk_io, cpu_pct)
    assert got.tobytes() == want.tobytes()
    assert not np.array_equal(got, requested)  # pods were placed


@pytest.fixture
def tiny_suite(monkeypatch):
    """TINY_CONFIGS added to both packages' BENCH_CONFIGS, REPS 1."""
    monkeypatch.setattr(ref_cluster_gen, "BENCH_CONFIGS",
                        {**ref_cluster_gen.BENCH_CONFIGS, **TINY_CONFIGS})
    monkeypatch.setattr(cluster_gen, "BENCH_CONFIGS",
                        {**cluster_gen.BENCH_CONFIGS, **TINY_CONFIGS})
    monkeypatch.setattr(ref_bench, "REPS", 1)
    monkeypatch.setattr(bench, "REPS", 1)


@pytest.mark.parametrize("name", ["gpu-tiny", "constraints-tiny", "deployment-50"])
def test_torch_bench_suite_rows_match_reference(tiny_suite, name):
    got = bench.suite_rate(name, device="cpu")
    want = ref_bench.suite_rate(name)
    assert list(got) == list(want)
    for key in ("config", "pods", "nodes", "assigner", "assigned"):
        assert got[key] == want[key], key
    # the ratio rounds to 2 decimals: on a loaded CPU the port's rate can
    # fall below 1/200 of the numpy baseline's, and the ratio reads 0.0
    assert got["pods_per_sec"] > 0 and isinstance(got["vs_baseline"], float)
    assert got["vs_baseline"] >= 0
    if name == "deployment-50":
        assert got["assigner"] == "native-loop"
        return
    assert got["assigned"] > 0
    # these configs have no near-tie flip: the greedy oracle places the
    # same pods as the reference's
    assert got["assigned_greedy"] == want["assigned_greedy"]
    assert got["auction_vs_greedy_assigned"] == want["auction_vs_greedy_assigned"]
    for key in ("mean_score_auction", "mean_score_greedy"):
        assert abs(got[key] - want[key]) <= 0.01, (key, got[key], want[key])


def test_torch_bench_engine_rows_match_reference(monkeypatch, capsys):
    """The default mode's engine rows at the smoke knobs, the host-loop
    block failing at once in both benches (each then prints
    host_loop_failed and still prints the engine rows; the port exits 1)."""
    smoke_knobs(monkeypatch)

    def boom(*a, **kw):
        raise RuntimeError("host loop not run here")

    monkeypatch.setattr(ref_bench, "_backend_diag", lambda: None)
    monkeypatch.setattr(ref_bench, "loop_rate", boom)
    monkeypatch.setattr(sys, "argv", ["bench.py"])
    ref_bench.main()
    want = json_lines(capsys.readouterr().out)
    monkeypatch.setattr(bench, "backend_diag", lambda device: True)
    monkeypatch.setattr(bench, "host_loop_rows", boom)
    assert bench.main(["--device", "cpu"]) == 1
    got = json_lines(capsys.readouterr().out)
    assert [r.get("metric", r.get("diag")) for r in got] == [
        r.get("metric", r.get("diag")) for r in want
    ]
    assert [list(r) for r in got] == [list(r) for r in want]
    assert got[1]["diag"] == "host_loop_failed"
    assert got[-1]["metric"] == "scheduling_throughput_64nodes"
    assert all(r["value"] > 0 for r in got if "metric" in r)


def test_torch_bench_suite_keeps_reference_record(monkeypatch, capsys):
    """--suite writes bench.SUITE_OUT in the working directory and leaves
    the root BENCH_SUITE.json byte for byte as it was."""
    monkeypatch.setattr(cluster_gen, "BENCH_CONFIGS", dict(TINY_CONFIGS))
    monkeypatch.setattr(bench, "REPS", 1)
    monkeypatch.chdir(REPO)
    record = os.path.join(REPO, "BENCH_SUITE.json")
    out = os.path.join(REPO, bench.SUITE_OUT)
    before = open(record, "rb").read()
    prior = open(out, "rb").read() if os.path.exists(out) else None
    try:
        assert bench.main(["--device", "cpu", "--suite"]) == 0
        rows = json.load(open(out))
    finally:
        if prior is None:
            if os.path.exists(out):
                os.remove(out)
        else:
            open(out, "wb").write(prior)
    assert open(record, "rb").read() == before
    assert [r["config"] for r in rows] == list(TINY_CONFIGS)
    printed = json_lines(capsys.readouterr().out)
    assert printed[0]["diag"] == "backend" and printed[1:] == rows


def test_torch_bench_smoke_e2e():
    """The port's whole default mode, then --loop, on --device cpu at the
    reference smoke test's knobs: exit 0, no failed diag, every row the
    reference smoke test asserts (chip_smoke.check_bench_rows), the
    headline last."""
    env = {**os.environ, **SMOKE_ENV}
    rows = {}
    for mode in ([], ["--loop"]):
        proc = subprocess.run(
            [sys.executable, "-m", "kubernetes_scheduler_tpu_torch.bench",
             "--device", "cpu", *mode],
            capture_output=True, text=True, timeout=900, cwd=REPO, env=env,
        )
        assert proc.returncode == 0, proc.stderr[-2000:] + proc.stdout[-500:]
        records = json_lines(proc.stdout)
        assert records[0]["diag"] == "backend", records[0]
        assert not any("diag" in r for r in records[1:]), records
        if not mode:
            assert records[-1]["metric"] == "scheduling_throughput_64nodes"
        rows[tuple(mode)] = {r["metric"]: r for r in records[1:]}
    assert set(rows[("--loop",)]) <= set(rows[()])
    chip_smoke.check_bench_rows(
        rows[()], nodes=64, loop_nodes=32, sharded_nodes=256,
        mesh_devices=sharded_device_count(),
    )
    chip_smoke.check_bench_rows(
        rows[("--loop",)], nodes=None, loop_nodes=32, sharded_nodes=256,
        mesh_devices=sharded_device_count(),
    )
