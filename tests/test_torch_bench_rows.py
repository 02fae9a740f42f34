"""Every row function of the port's bench against the reference's, in
process on the CPU at tests/test_bench_smoke.py's knobs: the same metric
names, in the same order, with the same keys. The port runs on
--device cpu; its mesh is sharded_device_count() shards (1 here), the
reference's its 8 virtual devices, so `mesh_devices` differs in value,
never in key."""

import pytest

import bench as ref_bench
from kubernetes_scheduler_tpu_torch import bench
from tests.test_torch_bench import smoke_knobs

# id -> (row function name, positional arguments); the ids keep the
# conftest's slow substrings out (fused, sharded, ...)
ROWS = {
    "loop": ("loop_rate", ()),
    "pipelined": ("_pipelined_loop_rate", ()),
    "k1k2_ab": ("_fused_loop_rate", ()),
    "resident": ("_resident_loop_rate", ()),
    "streaming": ("_streaming_loop_rate", ()),
    "idle": ("_idle_streaming_rate", ()),
    "drift": ("_drift_streaming_rate", ()),
    "mesh_loop": ("_sharded_loop_rate", ()),
    "mesh_throughput": ("_sharded_throughput", ()),
    "replicas": ("_replica_loop_rate", ()),
    "replay": ("_replay_loop_rate", ()),
    "shadow": ("_shadow_rescore_rate", ()),
    "telemetry": ("_telemetry_loop_rate", (None,)),
    "burst": ("_scenario_rate", ("burst", "burst")),
    "gang": ("_scenario_rate", ("gang-mix", "gang")),
    "chaos": ("_chaos_loop_rate", ()),
}


def rows_of(out) -> list:
    if isinstance(out, dict):
        return [out]
    return list(out)


@pytest.mark.parametrize("row", sorted(ROWS))
def test_torch_bench_row_keys_match_reference(monkeypatch, row):
    smoke_knobs(monkeypatch)
    name, args = ROWS[row]
    want = rows_of(getattr(ref_bench, name)(*args))
    got = rows_of(getattr(bench, name)(*args, device="cpu"))
    assert [r["metric"] for r in got] == [r["metric"] for r in want]
    for g, w in zip(got, want):
        assert list(g) == list(w), g["metric"]


def test_torch_bench_deep_row_keys_match_reference(monkeypatch):
    """loop_rate's deep16w row (16 windows a cycle, the backlog scaled
    from BENCH_LOOP_PODS as the reference scales it)."""
    smoke_knobs(monkeypatch)
    kw = dict(max_windows=16, metric_suffix="_deep16w")
    want = ref_bench.loop_rate(**kw)
    got = bench.loop_rate(**kw, device="cpu")
    assert got["metric"] == want["metric"] == "host_loop_32nodes_deep16w"
    assert list(got) == list(want)
    assert got["pods_bound"] == want["pods_bound"] > 0


def test_torch_bench_host_loop_block_order(monkeypatch):
    """host_loop_rows yields the reference's host-loop block in the
    reference's order (its --loop mode and the default mode's block),
    each row function called once with the device."""
    calls = []

    def fake(name):
        def f(*args, device=None, **kw):
            assert device == "cpu"
            calls.append(name)
            suffix = kw.get("metric_suffix", "")
            rows = [{"metric": f"{name}{suffix}"}]
            if name in ("_sharded_loop_rate", "_replica_loop_rate", "_telemetry_loop_rate"):
                rows.append({"metric": f"{name}#2"})
                return rows if name != "_telemetry_loop_rate" else tuple(rows)
            return rows[0]
        return f

    for name in {n for n, _ in ROWS.values()}:
        monkeypatch.setattr(bench, name, fake(name))
    got = [r["metric"] for r in bench.host_loop_rows(device="cpu")]
    assert got == [
        "loop_rate", "loop_rate_deep16w", "_pipelined_loop_rate", "_fused_loop_rate",
        "_resident_loop_rate", "_streaming_loop_rate", "_idle_streaming_rate",
        "_drift_streaming_rate", "_sharded_loop_rate", "_sharded_loop_rate#2",
        "_sharded_throughput", "_replica_loop_rate", "_replica_loop_rate#2",
        "_replay_loop_rate", "_shadow_rescore_rate", "_telemetry_loop_rate",
        "_telemetry_loop_rate#2", "_scenario_rate", "_scenario_rate", "_chaos_loop_rate",
    ]


def test_torch_bench_drift_rebuilds_at_2000_nodes_e2e(monkeypatch):
    """From 2,000 loop nodes the drift row's warm-up grows the hostPort
    table once: one "port-churn" rebuild, which the reference smoke
    test's assertions forbid (so chip_smoke's phase 23 runs the host-loop
    block at 1,000 nodes). The reference's row does the same: every
    count equal, the rate aside."""
    monkeypatch.setenv("BENCH_LOOP_NODES", "2000")
    monkeypatch.setenv("BENCH_DRIFT_ROUNDS", "12")
    want = ref_bench._drift_streaming_rate()
    got = bench._drift_streaming_rate(device="cpu")
    assert want["mirror_rebuild_reasons"].get("port-churn") == 1, want
    assert {k: v for k, v in got.items() if k != "pods_per_sec"} == {
        k: v for k, v in want.items() if k != "pods_per_sec"
    }
