"""Deterministic journal replay: re-execute recorded cycles and diff
bindings bitwise against what production decided.

The replayer works at the engine boundary — the recorded PodBatch and
the reconstructed SnapshotArrays are bit-exact copies of what the live
cycle dispatched, so replaying them through ANY engine mode combination
(Local/Remote x serial/pipelined x full/resident) must reproduce the
recorded node_idx exactly; that is precisely the set of guarantees
PARITY.md pins, and this module is what turns those pins from promises
into a tool you can run against a production journal.

Snapshot reconstruction: records carry either the full snapshot or the
SnapshotDelta the cycle actually shipped; deltas fold into the previous
device record's snapshot with engine.apply_snapshot_delta_np, which is
bitwise the full build by construction. Resident-mode replay re-derives
its OWN deltas (host.snapshot.snapshot_delta against the previously
uploaded snapshot), so the replayed engine exercises the same delta
machinery the live host did rather than trusting the recorded bytes.

The port's copy of kubernetes_scheduler_tpu/trace/replay.py: the default
engine is TorchEngine (on cuda unless the caller passes `device=` or an
engine), and every replayed result comes back through device.to_host,
one read per result. The journal format is the reference's, so either
package replays the other's journals.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

from kubernetes_scheduler_tpu_torch.device import to_host
from kubernetes_scheduler_tpu_torch.engine import (
    PodBatch,
    SnapshotArrays,
    SnapshotDelta,
    apply_snapshot_delta_np,
    stack_windows,
)
from kubernetes_scheduler_tpu_torch.trace.recorder import TraceError, read_journal

MODES = ("serial", "pipelined")


@dataclass
class CycleDiff:
    seq: int
    mismatches: int
    detail: str = ""


@dataclass
class ReplayReport:
    cycles: int = 0
    replayed: int = 0
    skipped: int = 0            # scalar/mixed cycles (no engine dispatch)
    pods_recorded: int = 0      # assignments in the journal
    pods_replayed: int = 0      # assignments the replay produced
    seconds: float = 0.0
    diffs: list = field(default_factory=list)

    @property
    def binding_diffs(self) -> int:
        return sum(d.mismatches for d in self.diffs)

    def to_dict(self) -> dict:
        return {
            "cycles": self.cycles,
            "replayed": self.replayed,
            "skipped": self.skipped,
            "pods_recorded": self.pods_recorded,
            "pods_replayed": self.pods_replayed,
            "seconds": round(self.seconds, 3),
            "binding_diffs": self.binding_diffs,
            "diff_cycles": [
                {"seq": d.seq, "mismatches": d.mismatches, "detail": d.detail}
                for d in self.diffs
            ],
        }


def pod_batch_from_record(tensors: dict) -> PodBatch:
    """PodBatch from a record's `pods` tensors, backfilling leaves added
    to the struct AFTER the journal was written (schema tags are
    append-only, so old records simply lack them). Only leaves with a
    semantically-neutral default may be backfilled — currently the gang
    fields (gang_id=-1 / gang_size=0 is exactly "no gangs", and the gang
    mask is bitwise the identity then); any other absence is drift."""
    missing = set(PodBatch._fields) - set(tensors)
    if missing - {"gang_id", "gang_size"}:
        raise TraceError(
            f"record's pods tensors lack {sorted(missing)} and no neutral "
            "default exists — journal/struct drift"
        )
    if missing:
        tensors = dict(tensors)
        shape = np.asarray(tensors["request"]).shape[:-1]
        if "gang_id" in missing:
            tensors["gang_id"] = np.full(shape, -1, np.int32)
        if "gang_size" in missing:
            tensors["gang_size"] = np.zeros(shape, np.int32)
    return PodBatch(**tensors)


def engine_kw_from_record(rec: dict) -> dict:
    """The cycle options as the engine call expects them (JSON round-
    trips tuples to lists; score_plugins is a tuple of tuples again, as
    the host loop passes it)."""
    kw = dict(rec.get("engine_kw") or {})
    sp = kw.get("score_plugins")
    if sp is not None:
        kw["score_plugins"] = tuple((n, float(w)) for n, w in sp)
    return kw


def bindings_from_idx(pod_keys, node_names, idx) -> list:
    """(namespace, name, node_name) triples for assigned window rows —
    the human-facing form of a node_idx vector."""
    out = []
    for i, key in enumerate(pod_keys):
        j = int(idx[i]) if i < len(idx) else -1
        if 0 <= j < len(node_names):
            out.append((key[0], key[1], node_names[j]))
    return out


def reconstruct_cycles(path: str):
    """Yield (record, full SnapshotArrays | None) across the journal,
    folding recorded deltas into the previous device snapshot. A delta
    with no predecessor means a broken chain (hand-truncated journal) —
    fail loudly rather than replay against garbage."""
    prev: SnapshotArrays | None = None
    for rec in read_journal(path):
        snapshot = None
        if "snapshot" in rec:
            snapshot = SnapshotArrays(**rec["snapshot"])
        elif "delta" in rec:
            if prev is None:
                raise TraceError(
                    f"record seq={rec.get('seq')} carries a delta but no "
                    "prior snapshot anchors it (journal head missing?)"
                )
            snapshot = apply_snapshot_delta_np(
                prev, SnapshotDelta(**rec["delta"])
            )
        if snapshot is not None:
            prev = snapshot
        yield rec, snapshot


def _dispatch(engine, snapshot, pods, kw, *, mode, resident, state) -> np.ndarray:
    """One replayed engine call -> flat node_idx. `state` carries the
    resident replay bookkeeping (previously uploaded snapshot + epoch)."""
    if resident:
        from kubernetes_scheduler_tpu_torch.host.snapshot import snapshot_delta

        delta = None
        if state.get("prev") is not None:
            delta = snapshot_delta(state["prev"], snapshot)
        epoch = state.get("epoch", 0) + 1
        submit = (
            getattr(engine, "schedule_resident_async", None)
            if mode == "pipelined"
            else None
        )
        if submit is not None:
            res = submit(snapshot, pods, delta=delta, epoch=epoch, **kw).result()
        else:
            res = engine.schedule_resident(
                snapshot, pods, delta=delta, epoch=epoch, **kw
            )
        state["prev"] = snapshot
        state["epoch"] = epoch
        return to_host(res.node_idx)
    submit = (
        getattr(engine, "schedule_batch_async", None)
        if mode == "pipelined"
        else None
    )
    if submit is not None:
        return to_host(submit(snapshot, pods, **kw).result().node_idx)
    return to_host(engine.schedule_batch(snapshot, pods, **kw).node_idx)


def _dispatch_windows(
    engine, snapshot, pods, kw, bw: int, *, resident, state
) -> np.ndarray:
    windows = stack_windows(pods, bw)
    if resident and hasattr(engine, "schedule_windows_resident"):
        from kubernetes_scheduler_tpu_torch.host.snapshot import snapshot_delta

        delta = None
        if state.get("prev") is not None:
            delta = snapshot_delta(state["prev"], snapshot)
        epoch = state.get("epoch", 0) + 1
        res = engine.schedule_windows_resident(
            snapshot, windows, delta=delta, epoch=epoch, **kw
        )
        state["prev"] = snapshot
        state["epoch"] = epoch
    else:
        res = engine.schedule_windows(snapshot, windows, **kw)
    return to_host(res.node_idx).reshape(-1)


def replay_journal(
    path: str,
    *,
    engine=None,
    mode: str = "serial",
    resident: bool = False,
    limit: int | None = None,
    record_path: str | None = None,
    span_path: str | None = None,
    device=None,
) -> ReplayReport:
    """Re-execute a journal and diff every replayed cycle's node_idx
    bitwise against the recording. `engine` defaults to a fresh
    TorchEngine on `device` (cuda unless given; it raises without
    CUDA). mode="pipelined" drives the async dispatch surface;
    resident=True drives the delta-upload surface with re-derived
    deltas. record_path re-records the replayed cycles as a new journal
    (same inputs, the REPLAYED decisions), so `trace diff` can compare
    two replays record-for-record.

    span_path turns the replay into a POST-HOC attribution run: every
    journal record re-emits a span set (observe.SpanRecorder, process
    "replay") — `reconstruct` (journal decode + delta fold),
    `engine_step` (the replayed dispatch, resident delta re-derivation
    included), and one `cycle` span per record, each carrying the
    SOURCE record's flight-recorder seq. A journal captured with
    telemetry off becomes a Perfetto-loadable timeline after the fact,
    and the same journal replayed through different engine/loop
    combinations becomes a deterministic A/B measurement harness
    (`spans report`/`spans diff` over the per-variant directories)."""
    if mode not in MODES:
        raise ValueError(f"unknown replay mode {mode!r}; expected {MODES}")
    if engine is None:
        from kubernetes_scheduler_tpu_torch.engine import TorchEngine

        engine = TorchEngine(device=device)
    out_rec = None
    if record_path is not None:
        from kubernetes_scheduler_tpu_torch.trace.recorder import CycleRecorder

        # effectively unbounded budget: the replayed journal carries one
        # FULL snapshot per device record (deltas are an online-recording
        # optimization), so the production default budget could silently
        # drop its head — and a `trace diff` against the original must
        # see every record the operator asked to re-record
        out_rec = CycleRecorder(
            record_path, file_bytes=256 << 20, max_bytes=1 << 60
        )
    spans = None
    if span_path is not None:
        from kubernetes_scheduler_tpu_torch.host.observe import SpanRecorder

        spans = SpanRecorder(span_path, process="replay")
    report = ReplayReport()
    state: dict = {}
    t0 = time.perf_counter()
    it = reconstruct_cycles(path)
    try:
        while True:
            if limit is not None and report.cycles >= limit:
                break
            t_cycle = time.perf_counter()
            # the reconstruction cost (journal decode + delta fold)
            # lives inside the generator's next() — timed around it so
            # the replay timeline attributes it as its own stage
            try:
                rec, snapshot = next(it)
            except StopIteration:
                break
            ss = spans.begin() if spans is not None else None
            if ss is not None:
                ss.add("reconstruct", t_cycle, time.perf_counter())
            report.cycles += 1
            recorded_idx = np.asarray(
                (rec.get("assign") or {}).get("node_idx", np.zeros(0, np.int32))
            )
            report.pods_recorded += int((recorded_idx >= 0).sum())
            pod_keys = rec.get("pod_keys") or []
            node_names = rec.get("node_names") or []
            if (
                snapshot is None
                or "pods" not in rec
                or rec.get("path") not in ("device", "backlog")
            ):
                report.skipped += 1
                if out_rec is not None:
                    out_rec.record_cycle(
                        path=rec.get("path", "scalar"),
                        metrics=rec.get("metrics") or {},
                        node_names=node_names or None,
                        pod_keys=pod_keys or None,
                        bindings=rec.get("bindings"),
                        node_idx=recorded_idx if recorded_idx.size else None,
                        seq=rec.get("seq"),
                    )
                if ss is not None:
                    # skipped cycles still own a timeline slot: the
                    # span count must match the journal's cycle count,
                    # and a scalar cycle's absence would read as a gap
                    ss.add(
                        "cycle", t_cycle, time.perf_counter(),
                        path=rec.get("path", "scalar"), replayed=False,
                    )
                    spans.flush(ss, seq=rec.get("seq"))
                continue
            pods = pod_batch_from_record(rec["pods"])
            kw = engine_kw_from_record(rec)
            t_eng = time.perf_counter()
            if rec["path"] == "backlog":
                bw = int(rec.get("batch_window") or 0)
                if bw <= 0:
                    raise TraceError(
                        f"backlog record seq={rec.get('seq')} lacks "
                        "batch_window"
                    )
                idx = _dispatch_windows(
                    engine, snapshot, pods, kw, bw,
                    resident=resident, state=state,
                )
            else:
                idx = _dispatch(
                    engine, snapshot, pods, kw,
                    mode=mode, resident=resident, state=state,
                )
            if ss is not None:
                ss.add(
                    "engine_step", t_eng, time.perf_counter(),
                    backlog=rec["path"] == "backlog", resident=resident,
                )
            n_real = len(pod_keys) if pod_keys else recorded_idx.shape[0]
            replay_idx = np.asarray(idx).reshape(-1)[:n_real].astype(np.int32)
            report.replayed += 1
            report.pods_replayed += int((replay_idx >= 0).sum())
            want = recorded_idx[:n_real]
            if want.shape != replay_idx.shape or not np.array_equal(
                want, replay_idx
            ):
                bad = (
                    int((want != replay_idx).sum())
                    if want.shape == replay_idx.shape
                    else n_real
                )
                rows = (
                    np.flatnonzero(want != replay_idx)[:5].tolist()
                    if want.shape == replay_idx.shape
                    else []
                )
                report.diffs.append(
                    CycleDiff(
                        seq=int(rec.get("seq", report.cycles - 1)),
                        mismatches=bad,
                        detail=f"first differing rows: {rows}",
                    )
                )
            if out_rec is not None:
                out_rec.record_cycle(
                    path=rec["path"],
                    metrics={"pods_bound": int((replay_idx >= 0).sum())},
                    node_names=node_names or None,
                    pod_keys=pod_keys or None,
                    bindings=bindings_from_idx(
                        pod_keys, node_names, replay_idx
                    ),
                    snapshot=snapshot,
                    pods=pods,
                    engine_kw=kw,
                    node_idx=replay_idx,
                    batch_window=int(rec.get("batch_window") or 0),
                    fingerprint=rec.get("fingerprint"),
                    seq=rec.get("seq"),
                )
            if ss is not None:
                ss.add(
                    "cycle", t_cycle, time.perf_counter(),
                    path=rec["path"], replayed=True,
                )
                spans.flush(ss, seq=rec.get("seq"))
    finally:
        if out_rec is not None:
            out_rec.close()
        if spans is not None:
            spans.close()
    report.seconds = time.perf_counter() - t0
    return report
