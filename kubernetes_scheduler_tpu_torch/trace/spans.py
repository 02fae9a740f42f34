"""Span telemetry files: rotating Chrome-trace-event JSON + the merge.

Writers emit the Chrome trace "JSON Array Format": every file opens
with ``[`` and holds one complete ("ph": "X") event object per line,
comma-terminated. The closing ``]`` is deliberately absent — the format
specifies it as optional precisely so a crashed writer's file stays
loadable — which gives span files the same crash-consistency contract
as the flight-recorder journal (trace/recorder.py): a torn tail costs
at most the last line, and every file loads independently in Perfetto
(ui.perfetto.dev) or chrome://tracing.

Rotation rides the same machinery as the journal: numbered files under
one directory, a per-file size bound, and a whole-directory disk budget
enforced by `recorder.enforce_disk_budget` (oldest files dropped).

Host and sidecar each write their own span directory; `merge_spans`
joins them on the `args.trace_id` every event carries (the host's
monotonically-assigned cycle id, propagated to the sidecar over gRPC
metadata) into one timeline. Timestamps are epoch microseconds on both
sides, so same-machine processes need no clock alignment and
cross-machine skew shows up honestly instead of being hidden.
"""

from __future__ import annotations

import json
import logging
import os
import threading

from kubernetes_scheduler_tpu_torch.trace.recorder import enforce_disk_budget

log = logging.getLogger("yoda_tpu.trace.spans")

_FILE_PATTERN = "spans-%08d.trace.json"


def span_files(path: str) -> list[str]:
    """The span directory's data files, oldest first."""
    if not os.path.isdir(path):
        return []
    return [
        os.path.join(path, n)
        for n in sorted(os.listdir(path))
        if n.startswith("spans-") and n.endswith(".trace.json")
    ]


class SpanWriter:
    """Rotating, disk-budgeted Chrome-trace-event file writer.

    `append` takes fully-formed event dicts; encoding cost is paid by
    the caller's completion stage, never a dispatch path. Each fresh
    file opens with a process_name metadata event so a merged timeline
    labels the host and sidecar tracks."""

    def __init__(
        self,
        path: str,
        *,
        file_bytes: int = 32 << 20,
        max_bytes: int = 128 << 20,
        process_name: str = "host",
    ):
        self.path = path
        self.file_bytes = int(file_bytes)
        self.max_bytes = int(max_bytes)
        self.process_name = process_name
        self.pid = os.getpid()
        os.makedirs(path, exist_ok=True)
        existing = span_files(path)
        self._next_index = len(existing) and (
            int(os.path.basename(existing[-1])[6:14]) + 1
        )
        self._f = None
        self._file_size = 0
        # the sidecar serves more than one worker thread; appends must
        # never interleave two events on one line
        self._lock = threading.Lock()
        self.events_written = 0
        self.bytes_written = 0
        # EAGER first file: a configured span directory always holds at
        # least the process_name metadata track, so "files exist but no
        # events joined" is distinguishable from "spans were never
        # configured" — the signal `spans merge` uses to flag broken
        # trace-id propagation instead of silently tolerating it
        self._open_next()

    def _open_next(self) -> None:
        if self._f is not None:
            self._f.close()
        fp = os.path.join(self.path, _FILE_PATTERN % self._next_index)
        self._next_index += 1
        # called only from append, which holds self._lock
        self._f = open(fp, "w", encoding="utf-8")
        meta = json.dumps(
            {
                "ph": "M",
                "name": "process_name",
                "pid": self.pid,
                "tid": 0,
                "args": {"name": self.process_name},
            },
            separators=(",", ":"),
        )
        head = "[\n" + meta + ",\n"
        self._f.write(head)
        # called only from append, which holds self._lock
        self._file_size = len(head)
        enforce_disk_budget(
            span_files(self.path), self.max_bytes, keep=self._f.name
        )

    def append(self, events: list[dict]) -> None:
        """Append events (one JSON object per line). Rotates when the
        current file would exceed file_bytes."""
        if not events:
            return
        lines = [
            json.dumps(ev, separators=(",", ":")) + ",\n" for ev in events
        ]
        blob = "".join(lines)
        with self._lock:
            if self._f is None or self._file_size + len(blob) > self.file_bytes:
                self._open_next()
            self._f.write(blob)
            self._f.flush()
            self._file_size += len(blob)
            self.bytes_written += len(blob)
            self.events_written += len(events)

    def close(self) -> None:
        with self._lock:
            if self._f is not None:
                self._f.close()
                self._f = None


def read_span_file(fp: str) -> list[dict]:
    """Decode one span file, tolerant of a torn tail: unparseable lines
    end the file at the last good event (the crash contract)."""
    out: list[dict] = []
    with open(fp, encoding="utf-8") as f:
        first = f.readline()
        if not first.startswith("["):
            log.warning("spans: %s is not a span file; skipping", fp)
            return out
        for line in f:
            line = line.strip().rstrip(",").rstrip("]").strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError:
                log.warning(
                    "spans: %s torn line; recovered to last good event", fp
                )
                break
    return out


def read_spans(path: str) -> list[dict]:
    """Every event across the directory's span files, oldest first."""
    out: list[dict] = []
    for fp in span_files(path):
        out.extend(read_span_file(fp))
    return out


def _trace_ids(events: list[dict]) -> set:
    return {
        ev["args"]["trace_id"]
        for ev in events
        if ev.get("ph") == "X" and "trace_id" in ev.get("args", {})
    }


def merge_spans(host_path: str, sidecar_path: str, out_path: str) -> dict:
    """Join host and sidecar span files on trace id into ONE Chrome
    trace (JSON Object Format — a plain `{"traceEvents": [...]}` that
    Perfetto loads directly). Every event rides through; the report
    counts the trace ids seen on each side and the ids present on BOTH
    (the join — zero joined ids on non-empty inputs means the metadata
    propagation is broken, and callers should fail loudly)."""
    host_files = len(span_files(host_path))
    sidecar_files = len(span_files(sidecar_path))
    host_events = read_spans(host_path)
    sidecar_events = read_spans(sidecar_path)
    host_ids = _trace_ids(host_events)
    sidecar_ids = _trace_ids(sidecar_events)
    joined = host_ids & sidecar_ids
    merged = host_events + sidecar_events
    merged.sort(key=lambda ev: ev.get("ts", 0))
    with open(out_path, "w", encoding="utf-8") as f:
        json.dump(
            {
                "traceEvents": merged,
                "otherData": {
                    "joined_trace_ids": len(joined),
                    "host_trace_ids": len(host_ids),
                    "sidecar_trace_ids": len(sidecar_ids),
                },
            },
            f,
        )
    return {
        "host_events": len(host_events),
        "sidecar_events": len(sidecar_events),
        "host_files": host_files,
        "sidecar_files": sidecar_files,
        "host_trace_ids": len(host_ids),
        "sidecar_trace_ids": len(sidecar_ids),
        "joined_trace_ids": len(joined),
        "merged_events": len(merged),
        "out": out_path,
    }
