"""The port's flight recorder, spans and journal replay
(kubernetes_scheduler_tpu_torch/trace/) against the JAX reference's, on
the CPU.

First the port's copies of the reference's journal unit cases
(tests/test_trace.py): every field kind round-trips, a truncated or
corrupt tail recovers, a schema-version skew is refused, rotation and the
disk budget keep the journal replayable, a torn write strands nothing,
seq resumes across a restart, and `diff` pairs by seq after a head prune.

Then the journal-replay gate across the two packages, on ~64 nodes with
a window of 32: the reference's Scheduler records and the port's
replay_journal on TorchEngine(device="cpu") replays in all four modes
with zero binding diffs; the port's Scheduler records and the
reference's replay_journal replays with zero diffs; the port's
inspect.diff of the two journals of one drain shows no decision
difference. Both sides run the fused min-max route (the reference's
engine answers supports_fused_min_max() as TorchEngine does) and one
virtual queue clock (tests/test_torch_host.py's drain). The two
committed reference journals under tests/torch_fixtures/ replay through
both packages.

Test names and parametrize ids avoid the substrings tests/conftest.py
marks slow."""

import os
import shutil

import numpy as np
import pytest

from kubernetes_scheduler_tpu.trace import inspect as ref_inspect
from kubernetes_scheduler_tpu.trace import recorder as ref_recorder
from kubernetes_scheduler_tpu.trace import replay as ref_replay
from kubernetes_scheduler_tpu_torch import TorchEngine
from kubernetes_scheduler_tpu_torch.host.observe import PORT_SPANS, SHIPPED_SPANS
from kubernetes_scheduler_tpu_torch.host.scheduler import Scheduler
from kubernetes_scheduler_tpu_torch.sim.host_gen import gen_host_cluster, gen_host_pods
from kubernetes_scheduler_tpu_torch.trace import analyze as tanalyze
from kubernetes_scheduler_tpu_torch.trace import inspect as tinspect
from kubernetes_scheduler_tpu_torch.trace import schema as tschema
from kubernetes_scheduler_tpu_torch.trace.recorder import (
    CycleRecorder,
    JournalWriter,
    TraceError,
    TraceVersionError,
    decode_record,
    encode_record,
    journal_files,
    read_journal,
)
from kubernetes_scheduler_tpu_torch.trace.replay import (
    pod_batch_from_record,
    replay_journal,
)
from kubernetes_scheduler_tpu_torch.trace.spans import read_spans
from kubernetes_scheduler_tpu_torch.utils.config import SchedulerConfig
from tests.test_torch_host import SIDES, FusedMinMaxLocalEngine, built, drain

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_fixtures")
MODES = [("serial", False), ("pipelined", False), ("serial", True), ("pipelined", True)]


def cpu_replay(path, **kw):
    return replay_journal(str(path), engine=TorchEngine(device="cpu"), **kw)


def make_cfg(**kw):
    """tests/test_pipeline.make_cfg for the port's config: the engine path
    pinned and no mid-drain requeue re-entry."""
    kw.setdefault("batch_window", 32)
    kw.setdefault("max_windows_per_cycle", 1)
    kw.setdefault("min_device_work", 1)
    kw.setdefault("adaptive_dispatch", False)
    kw.setdefault("initial_backoff_seconds", 3600.0)
    kw.setdefault("max_backoff_seconds", 3600.0)
    return SchedulerConfig(**kw)


def record_workload(trace_path, *, constraints=False, n_nodes=24, n_pods=60, **cfg_kw):
    """The port's Scheduler on TorchEngine(device="cpu") drains a sim
    backlog with the recorder on; returns (bindings, scheduler)."""
    nodes, advisor = gen_host_cluster(n_nodes, seed=0, constraints=constraints)
    running: list = []
    cfg_kw.setdefault("batch_window", 16)
    sched = Scheduler(
        make_cfg(trace_path=str(trace_path), **cfg_kw), advisor=advisor,
        list_nodes=lambda: nodes, list_running_pods=lambda: running,
        engine=TorchEngine(device="cpu"),
    )
    for pod in gen_host_pods(n_pods, seed=1, constraints=constraints):
        sched.submit(pod)
    seen = 0
    for _ in range(64):
        if len(sched.queue) == 0 and sched._prefetched is None:
            break
        sched.run_cycle()
        for b in sched.binder.bindings[seen:]:
            running.append(b.pod)
        seen = len(sched.binder.bindings)
    sched.recorder.close()
    return [(b.pod.namespace, b.pod.name, b.node_name) for b in sched.binder.bindings], sched


# ---- record encoding ------------------------------------------------------


def test_torch_trace_roundtrip_every_kind():
    rec = {
        "seq": 7,                                            # u64
        "path": "device",                                    # str
        "wall_time": 123.25,                                 # f64
        "metrics": {"pods_bound": 3, "used_fallback": False},  # json
        "pod_keys": [["default", "a"]],
        "assign": {"node_idx": np.array([2, -1], np.int32)},  # tensors
    }
    kinds = {tschema.FIELD_BY_NAME[k].kind for k in rec}
    assert kinds == set(tschema.KINDS)
    got = decode_record(encode_record(rec))
    assert got["seq"] == 7 and got["path"] == "device"
    assert got["wall_time"] == 123.25
    assert got["metrics"] == rec["metrics"]
    assert got["pod_keys"] == [["default", "a"]]
    np.testing.assert_array_equal(got["assign"]["node_idx"], [2, -1])


def test_torch_trace_schema_is_the_reference_schema():
    assert tschema.MAGIC == ref_recorder.MAGIC == b"YTRJ"
    assert tschema.SCHEMA_VERSION == ref_recorder.SCHEMA_VERSION == 1
    from kubernetes_scheduler_tpu.trace import schema as ref_schema

    assert [tuple(f) for f in tschema.JOURNAL_FIELDS] == [
        tuple(f) for f in ref_schema.JOURNAL_FIELDS]
    assert tschema.KINDS == ref_schema.KINDS
    assert tschema.TENSOR_DTYPES == ref_schema.TENSOR_DTYPES
    tschema.check_engine_coverage()


@pytest.mark.parametrize("kind", ["plain", "constraints"])
def test_torch_trace_payload_bytes_equal_reference(kind):
    """The same record dict (the port's builder leaves, a delta, cycle
    options) encodes to the same bytes in both packages, and each
    package decodes the other's payload to the same record."""
    from kubernetes_scheduler_tpu_torch.host import snapshot as port_snap
    from kubernetes_scheduler_tpu_torch.trace.recorder import _jsonable_kw, _tensor_items

    s0, s1, batch, _ = built("port", kind == "constraints")
    delta = port_snap.snapshot_delta(s0, s1, max_byte_frac=1.0)
    assert delta is not None
    kw = {"policy": "balanced_cpu_diskio", "assigner": "auction", "fused": True,
          "score_plugins": (("balanced_cpu_diskio", 2.0), ("least_allocated", 1.0))}
    rec = {
        "seq": 3, "path": "device", "wall_time": 1.5,
        "metrics": {"pods_bound": 4}, "engine_kw": _jsonable_kw(kw),
        "snapshot": _tensor_items(s0), "delta": _tensor_items(delta),
        "pods": _tensor_items(batch),
        "assign": {"node_idx": np.arange(batch.request.shape[0], dtype=np.int32)},
    }
    mine = encode_record(rec)
    theirs = ref_recorder.encode_record(rec)
    assert mine == theirs
    for a, b in ((decode_record(theirs), rec), (ref_recorder.decode_record(mine), rec)):
        for group in ("snapshot", "delta", "pods"):
            names = [name for name, _ in b[group]]
            assert list(a[group]) == names
            for name, arr in b[group]:
                got = a[group][name]
                assert got.dtype == arr.dtype and got.shape == arr.shape, name
                assert got.tobytes() == np.ascontiguousarray(arr).tobytes(), name
        assert a["engine_kw"] == rec["engine_kw"]


def test_torch_trace_dtype_pin_rejected_never_raises(tmp_path):
    """A leaf whose dtype drifted from the schema pin is REJECTED (the
    record drops and counts); a CPU tensor leaf records as its
    numpy view; the recorder never raises into the scheduling loop."""
    import torch

    s0, _, batch, _ = built("port", False)
    rec = CycleRecorder(str(tmp_path / "j"))
    bad = batch._replace(request=np.asarray(batch.request, np.float64))
    rec.record_cycle(path="device", metrics={}, snapshot=s0, pods=bad,
                     node_idx=np.zeros(2, np.int32))
    assert rec.records_dropped == 1 and rec.cycles_recorded == 0
    cpu = batch._replace(request=torch.from_numpy(np.asarray(batch.request)))
    rec.record_cycle(path="device", metrics={}, snapshot=s0, pods=cpu,
                     node_idx=np.zeros(2, np.int32))
    assert rec.cycles_recorded == 1 and rec.records_dropped == 1
    rec.close()
    (got,) = list(read_journal(str(tmp_path / "j")))
    np.testing.assert_array_equal(got["pods"]["request"], batch.request)


# ---- journal robustness ---------------------------------------------------


def _recorded_journal(tmp_path):
    path = tmp_path / "journal"
    binds, _ = record_workload(path)
    files = journal_files(str(path))
    assert len(files) == 1 and binds
    return str(path), files[0]


def test_torch_trace_truncated_tail_recovers(tmp_path):
    path, fp = _recorded_journal(tmp_path)
    whole = list(read_journal(path))
    assert len(whole) >= 2
    size = os.path.getsize(fp)
    with open(fp, "r+b") as f:
        f.truncate(size - 37)
    got = list(read_journal(path))
    assert [r["seq"] for r in got] == [r["seq"] for r in whole[:-1]]


def test_torch_trace_corrupt_tail_recovers(tmp_path):
    path, fp = _recorded_journal(tmp_path)
    whole = list(read_journal(path))
    with open(fp, "r+b") as f:
        f.seek(os.path.getsize(fp) - 5)
        b = f.read(1)
        f.seek(-1, 1)
        f.write(bytes([b[0] ^ 0xFF]))
    got = list(read_journal(path))
    assert len(got) == len(whole) - 1
    rep = cpu_replay(path)
    assert rep.binding_diffs == 0 and rep.replayed == len(got)


def test_torch_trace_version_skew_rejected(tmp_path):
    path, fp = _recorded_journal(tmp_path)
    with open(fp, "r+b") as f:
        f.seek(4)
        f.write((99).to_bytes(2, "little"))
    with pytest.raises(TraceVersionError, match="schema version 99"):
        list(read_journal(path))
    with pytest.raises(ref_recorder.TraceVersionError, match="schema version 99"):
        list(ref_recorder.read_journal(path))


def test_torch_trace_rotation_keeps_files_replayable(tmp_path):
    path = tmp_path / "journal"
    record_workload(path, n_pods=90, resident_state=True, pipeline_depth=1,
                    trace_file_bytes=16_000, trace_max_bytes=10 << 20)
    files = journal_files(str(path))
    assert len(files) >= 2, files
    for fp in files:
        sub = tmp_path / ("one_" + os.path.basename(fp))
        sub.mkdir()
        os.link(fp, sub / os.path.basename(fp))
        first = next((r for r in read_journal(str(sub))
                      if r.get("path") in ("device", "backlog")), None)
        if first is not None:
            assert "snapshot" in first
    rep = cpu_replay(path)
    assert rep.binding_diffs == 0 and rep.replayed >= 2
    assert ref_replay.replay_journal(str(path)).binding_diffs == 0


def test_torch_trace_torn_write_never_strands_later_records(tmp_path):
    from unittest import mock

    w = JournalWriter(str(tmp_path / "j"))
    w.append(encode_record({"seq": 0, "path": "scalar"}))
    real_write = w._f.write
    calls = {"n": 0}

    def bad_write(b):
        calls["n"] += 1
        if calls["n"] == 1:
            real_write(b[:3])
            raise OSError(28, "No space left on device")
        return real_write(b)

    with mock.patch.object(w._f, "write", side_effect=bad_write):
        with mock.patch.object(w._f, "truncate", side_effect=OSError(28, "")):
            with pytest.raises(OSError):
                w.append(encode_record({"seq": 1, "path": "scalar"}))
    assert w._torn
    w.append(encode_record({"seq": 2, "path": "scalar"}))
    w.close()
    assert [r["seq"] for r in read_journal(str(tmp_path / "j"))] == [0, 2]


def test_torch_trace_disk_budget_drops_oldest(tmp_path):
    path = tmp_path / "journal"
    record_workload(path, n_pods=120, trace_file_bytes=12_000, trace_max_bytes=30_000)
    files = journal_files(str(path))
    assert sum(os.path.getsize(fp) for fp in files) <= 30_000 + 16_000
    assert os.path.basename(files[0]) != "journal-00000000.ytrj"
    assert cpu_replay(path).binding_diffs == 0


def test_torch_trace_seq_resumes_across_restart(tmp_path):
    path = tmp_path / "journal"
    record_workload(path, n_pods=60)
    first = [r["seq"] for r in read_journal(str(path))]
    record_workload(path, n_pods=60)
    seqs = [r["seq"] for r in read_journal(str(path))]
    assert len(seqs) == len(set(seqs)) and seqs == sorted(seqs) and len(seqs) > len(first)
    out = str(tmp_path / "replayed")
    assert cpu_replay(path, record_path=out).binding_diffs == 0
    report = tinspect.diff(str(path), out)
    assert report["differences"] == 0 and report["records_compared"] == len(seqs)
    assert report["extra_records_a"] == 0 and report["extra_records_b"] == 0


def test_torch_trace_diff_pairs_by_seq_after_head_prune(tmp_path):
    path = tmp_path / "journal"
    record_workload(path, n_pods=90, resident_state=True, pipeline_depth=1,
                    trace_file_bytes=16_000, trace_max_bytes=10 << 20)
    files = journal_files(str(path))
    assert len(files) >= 2
    pruned = tmp_path / "pruned"
    pruned.mkdir()
    for fp in files[1:]:
        shutil.copy(fp, pruned / os.path.basename(fp))
    report = tinspect.diff(str(path), str(pruned))
    assert report["differences"] == 0 and report["extra_records_a"] >= 1
    assert report["extra_records_b"] == 0 and report["records_compared"] >= 1
    out = tmp_path / "pruned_replayed"
    assert cpu_replay(pruned, record_path=str(out)).binding_diffs == 0
    r2 = tinspect.diff(str(pruned), str(out))
    assert r2["differences"] == 0
    assert r2["extra_records_a"] == 0 and r2["extra_records_b"] == 0


def test_torch_trace_diff_ignores_bind_outcomes(tmp_path):
    idx = np.array([0, 1], np.int32)
    for name, bindings in (("a", [("default", "p0", "n0"), ("default", "p1", "n1")]),
                           ("b", [("default", "p0", "n0")])):
        rec = CycleRecorder(str(tmp_path / name))
        rec.record_cycle(path="scalar", metrics={},
                         pod_keys=[("default", "p0"), ("default", "p1")],
                         bindings=bindings, node_idx=idx)
        rec.close()
    assert tinspect.diff(str(tmp_path / "a"), str(tmp_path / "b"))["differences"] == 0


def test_torch_trace_stats_and_modes_on_own_journal(tmp_path):
    """A constraint workload recorded by the port replays with zero
    diffs in every mode, and two recorded replays diff to zero."""
    path = tmp_path / "journal"
    binds, sched = record_workload(path, constraints=True, n_pods=90)
    st = tinspect.stats(str(path))
    assert st == ref_inspect.stats(str(path))
    assert st["by_path"].get("device", 0) >= 2 and binds
    assert st["peak_selector_slots"] == sched.builder._selector_slots() >= 2
    for mode, resident in MODES:
        rep = cpu_replay(path, mode=mode, resident=resident)
        assert rep.binding_diffs == 0, (mode, resident, rep.to_dict())
        assert rep.replayed == st["by_path"]["device"]
        assert rep.pods_replayed == rep.pods_recorded
    out_a, out_b = str(tmp_path / "ra"), str(tmp_path / "rb")
    cpu_replay(path, record_path=out_a)
    cpu_replay(path, mode="pipelined", record_path=out_b)
    report = tinspect.diff(out_a, out_b)
    assert report["differences"] == 0 and report["extra_records_a"] == 0
    assert tinspect.diff(str(path), out_a)["differences"] == 0


def test_torch_trace_backfills_pre_gang_pod_tensors():
    _, _, batch, _ = built("port", False)
    tensors = {name: np.asarray(a) for name, a in zip(type(batch)._fields, batch)}
    del tensors["gang_id"], tensors["gang_size"]
    out = pod_batch_from_record(tensors)
    n = batch.request.shape[0]
    assert np.array_equal(np.asarray(out.gang_id), np.full(n, -1, np.int32))
    assert np.array_equal(np.asarray(out.gang_size), np.zeros(n, np.int32))
    del tensors["priority"]
    with pytest.raises(TraceError, match="drift"):
        pod_batch_from_record(tensors)


# ---- spans ------------------------------------------------------------------


def test_torch_trace_spans_feed_the_report(tmp_path):
    """The port's Scheduler with span_path writes one span set a cycle,
    every stage shipped, each set cross-linked to its journal seq; the
    report's attribution sums to 100; a replay re-emits one cycle span a
    record; the registry is the reference's plus the port-only names."""
    from kubernetes_scheduler_tpu.host.observe import SHIPPED_SPANS as REF_SPANS

    assert set(REF_SPANS) <= set(SHIPPED_SPANS)
    assert set(SHIPPED_SPANS) - set(REF_SPANS) == set(PORT_SPANS)
    spans = str(tmp_path / "spans")
    _, sched = record_workload(tmp_path / "journal", n_pods=60, span_path=spans,
                               resident_state=True, pipeline_depth=1)
    sched.spans.close()
    assert sched.spans.spans_dropped == 0 and sched.recorder.records_dropped == 0
    events = [e for e in read_spans(spans) if e.get("ph") == "X"]
    assert {e["name"] for e in events} <= set(SHIPPED_SPANS)
    seqs = {r["seq"] for r in read_journal(str(tmp_path / "journal"))}
    cycle_seqs = {e["args"]["seq"] for e in events if e["name"] == "cycle"}
    assert cycle_seqs == seqs
    report = tanalyze.build_report(spans)
    assert report["cycles"] == len(seqs)
    assert abs(sum(report["attribution_pct"].values()) - 100.0) < 0.5
    assert "engine_step" in report["attribution_pct"]
    rspans = str(tmp_path / "replay-spans")
    cpu_replay(tmp_path / "journal", span_path=rspans)
    replay_cycles = [e for e in read_spans(rspans) if e["name"] == "cycle"]
    assert sorted(e["args"]["seq"] for e in replay_cycles) == sorted(seqs)


# ---- the journal-replay gate across the two packages -----------------------


DEVICE = dict(batch_window=32, adaptive_dispatch=False, min_device_work=1)
CROSS_CASES = {
    f"{a}-{shape}{'-resident' if res else ''}": {
        "assigner": "greedy" if a == "k4" else "auction",
        "resident_state": res,
        **({"max_windows_per_cycle": 4} if shape == "mw4"
           else {"max_windows_per_cycle": 1, "pipeline_depth": 1}),
    }
    for a in ("k3", "k4") for shape in ("mw4", "mw1-depth1") for res in (False, True)
}


def _device_records(path) -> int:
    by = ref_inspect.stats(str(path))["by_path"]
    return by.get("device", 0) + by.get("backlog", 0)


@pytest.mark.parametrize("case", list(CROSS_CASES))
def test_torch_trace_cross_package_replay(tmp_path, case):
    cfg = {**DEVICE, **CROSS_CASES[case]}
    jr, jp = str(tmp_path / "ref"), str(tmp_path / "port")
    want, _, ref = drain("ref", {**cfg, "trace_path": jr})
    got, _, port = drain("port", {**cfg, "trace_path": jp})
    ref.recorder.close()
    port.recorder.close()
    assert got == want and len(got) > 96
    n_dev = _device_records(jr)
    assert n_dev == _device_records(jp) >= 2
    # the reference's journal through the port, every mode
    for mode, resident in MODES:
        rep = cpu_replay(jr, mode=mode, resident=resident)
        assert rep.binding_diffs == 0, (mode, resident, rep.to_dict())
        assert rep.replayed == n_dev and rep.pods_replayed == rep.pods_recorded
    # the port's journal through the reference
    rep = ref_replay.replay_journal(jp, engine=FusedMinMaxLocalEngine(),
                                    resident=cfg["resident_state"])
    assert rep.binding_diffs == 0 and rep.replayed == n_dev, rep.to_dict()
    report = tinspect.diff(jr, jp)
    assert report["differences"] == 0, report
    assert report["extra_records_a"] == report["extra_records_b"] == 0
    assert report["records_compared"] == ref.recorder.cycles_recorded


def test_torch_trace_scalar_cycles_skipped_both_ways(tmp_path):
    """A run with the engine path gated off records decision-only scalar
    records: each package's replay of the other's journal skips them."""
    paths = {}
    for side in ("ref", "port"):
        gates = SIDES[side][2].FeatureGates(tpu_batch_score=False)
        paths[side] = str(tmp_path / side)
        binds, _, sched = drain(
            side, {**DEVICE, "feature_gates": gates, "trace_path": paths[side]},
            backlogs=1, n_pods=48,
        )
        sched.recorder.close()
        assert binds
    rep = cpu_replay(paths["ref"])
    assert rep.replayed == 0 and rep.skipped >= 1 and rep.binding_diffs == 0
    rep = ref_replay.replay_journal(paths["port"])
    assert rep.replayed == 0 and rep.skipped >= 1 and rep.binding_diffs == 0
    assert tinspect.diff(paths["ref"], paths["port"])["differences"] == 0


@pytest.mark.parametrize("assigner", ["k3", "k4"])
def test_torch_trace_committed_reference_journals_replay(assigner):
    """The committed journals (tests/torch_fixtures/make_journals.py: the
    reference on the CPU, 1,000 nodes, two 1,024-pod cycles, the second a
    delta record) replay through the reference and through the port's
    CPU path with zero diffs, so a stale fixture fails here first."""
    path = os.path.join(FIXTURES, "ref-auction" if assigner == "k3" else "ref-greedy")
    st = tinspect.stats(path)
    assert st["by_path"] == {"device": 2} and st["delta_records"] == 1
    assert st["pods_bound"] == 2048
    kw = next(read_journal(path))["engine_kw"]
    assert kw["fused"] and kw["normalizer"] == "min_max"
    assert kw["assigner"] == ("auction" if assigner == "k3" else "greedy")
    rep = ref_replay.replay_journal(path)
    assert rep.binding_diffs == 0 and rep.replayed == 2
    for mode, resident in (("serial", False), ("pipelined", True)):
        rep = cpu_replay(path, mode=mode, resident=resident)
        assert rep.binding_diffs == 0 and rep.replayed == 2, rep.to_dict()
        assert rep.pods_replayed == 2048
