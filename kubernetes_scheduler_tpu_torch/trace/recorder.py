"""Cycle flight recorder: append-only journal of scheduling cycles.

Journal layout (trace/schema.py is the field contract):

    file     := MAGIC "YTRJ" + u16 schema version + record*
    record   := u32 payload_len + u32 crc32(payload) + payload
    payload  := field*
    field    := u16 tag + u8 kind + value

Every record is length-prefixed and CRC-guarded, so a crash mid-write
(power cut, SIGKILL, full disk) costs at most the tail record: readers
stop a file at the first short or CRC-failing frame and keep everything
before it — the flight-recorder property. Journals rotate across
numbered files under one directory with a bounded total disk budget
(oldest files dropped); each file opens with a FULL snapshot record, so
a journal whose head was rotated away still replays.

The recorder sits OFF the device-dispatch critical path: the scheduler
appends from the cycle's completion stage (host/scheduler._finish_cycle),
after the engine result was forced and the binds applied, and the write
itself is a buffered memcpy — no device sync, no RPC, no lock shared
with the dispatch path.
"""

from __future__ import annotations

import json
import logging
import os
import struct
import time
import zlib

import numpy as np

from kubernetes_scheduler_tpu_torch.trace.schema import (
    FIELD_BY_NAME,
    FIELD_BY_TAG,
    KIND_F64,
    KIND_JSON,
    KIND_STR,
    KIND_TENSORS,
    KIND_U64,
    KINDS,
    MAGIC,
    SCHEMA_VERSION,
    TENSOR_DTYPES,
)

log = logging.getLogger("yoda_tpu.trace")

_HEADER = struct.Struct("<4sH")     # magic + version
_FRAME = struct.Struct("<II")       # payload_len + crc32
_FIELD = struct.Struct("<HB")       # tag + kind
_U32 = struct.Struct("<I")
_U64 = struct.Struct("<Q")
_F64 = struct.Struct("<d")
_FILE_PATTERN = "journal-%08d.ytrj"


class TraceError(RuntimeError):
    """Malformed journal content (beyond a recoverable truncated tail)."""


class TraceVersionError(TraceError):
    """The journal speaks a schema version this reader does not."""


# ---- record encoding -------------------------------------------------------


# dtype object -> canonical name (dtype.name walks numpy internals —
# ~0.4 ms/record over ~60 leaves without this)
_DTYPE_NAMES: dict = {}


def _put_tensor(out: list, field_name: str, name: str, arr) -> None:
    a = np.asarray(arr)
    want = TENSOR_DTYPES.get(f"{field_name}.{name}")
    if want is None:
        raise TraceError(
            f"tensor {field_name}.{name} has no pinned dtype in "
            "trace/schema.py — journals cannot carry unclassified leaves"
        )
    have = _DTYPE_NAMES.get(a.dtype)
    if have is None:
        have = "bool" if a.dtype == np.bool_ else a.dtype.name
        _DTYPE_NAMES[a.dtype] = have
    if have != want:
        raise TraceError(
            f"tensor {field_name}.{name} is {have}, schema pins {want} "
            "(never silently cast: replay parity is bitwise)"
        )
    a = np.ascontiguousarray(a)
    nb = name.encode()
    db = want.encode()
    out.append(
        struct.pack(
            f"<H{len(nb)}sB{len(db)}sB", len(nb), nb, len(db), db, a.ndim
        )
    )
    for d in a.shape:
        out.append(_U32.pack(d))
    out.append(_U32.pack(a.nbytes))
    # zero-copy view — the one copy happens in the payload join (the
    # builders' arrays are not mutated between dispatch and record)
    out.append(a.data.cast("B"))


def encode_record(rec: dict, extra: list | None = None) -> bytes:
    """dict (schema field name -> value) -> one framed record payload.
    Unknown names fail loudly — the schema table is the contract.
    `extra` carries pre-encoded field blobs (the recorder's cached
    node_names field) appended verbatim; field order is immaterial to
    the decoder."""
    out: list[bytes] = list(extra or ())
    for name, value in rec.items():
        f = FIELD_BY_NAME.get(name)
        if f is None:
            raise TraceError(f"unknown journal field {name!r}")
        kind = KINDS[f.kind]
        out.append(_FIELD.pack(f.tag, kind))
        if kind == KIND_U64:
            out.append(_U64.pack(int(value)))
        elif kind == KIND_F64:
            out.append(_F64.pack(float(value)))
        elif kind == KIND_STR:
            b = str(value).encode()
            out.append(_U32.pack(len(b)))
            out.append(b)
        elif kind == KIND_JSON:
            b = json.dumps(value, separators=(",", ":")).encode()
            out.append(_U32.pack(len(b)))
            out.append(b)
        else:  # KIND_TENSORS
            items = value.items() if isinstance(value, dict) else value
            items = list(items)
            out.append(struct.pack("<H", len(items)))
            for tname, arr in items:
                _put_tensor(out, name, tname, arr)
    return b"".join(out)


def decode_record(payload: bytes) -> dict:
    """Inverse of encode_record; unknown tags are skipped (forward
    compatibility — new fields under fresh tags must not break old
    readers), malformed framing raises TraceError."""
    rec: dict = {}
    view = memoryview(payload)
    pos = 0
    end = len(payload)

    def need(n: int):
        nonlocal pos
        if pos + n > end:
            raise TraceError("record payload truncated mid-field")
        chunk = view[pos : pos + n]
        pos += n
        return chunk

    while pos < end:
        tag, kind = _FIELD.unpack(need(_FIELD.size))
        if kind == KIND_U64:
            value = _U64.unpack(need(8))[0]
        elif kind == KIND_F64:
            value = _F64.unpack(need(8))[0]
        elif kind in (KIND_STR, KIND_JSON):
            (ln,) = _U32.unpack(need(4))
            raw = bytes(need(ln))
            value = raw.decode() if kind == KIND_STR else json.loads(raw)
        elif kind == KIND_TENSORS:
            (count,) = struct.unpack("<H", need(2))
            tensors = {}
            for _ in range(count):
                (nlen,) = struct.unpack("<H", need(2))
                tname = bytes(need(nlen)).decode()
                (dlen,) = struct.unpack("<B", need(1))
                dtype = bytes(need(dlen)).decode()
                (ndim,) = struct.unpack("<B", need(1))
                shape = tuple(
                    _U32.unpack(need(4))[0] for _ in range(ndim)
                )
                (nbytes,) = _U32.unpack(need(4))
                raw = need(nbytes)
                np_dtype = np.bool_ if dtype == "bool" else np.dtype(dtype)
                arr = np.frombuffer(raw, np_dtype)
                expect = 1
                for d in shape:
                    expect *= d
                if arr.size != expect:
                    raise TraceError(
                        f"tensor {tname}: {arr.size} elements for shape "
                        f"{shape}"
                    )
                tensors[tname] = arr.reshape(shape)
            value = tensors
        else:
            raise TraceError(f"unknown field kind {kind}")
        f = FIELD_BY_TAG.get(tag)
        if f is not None:
            rec[f.name] = value
    return rec


# ---- journal files ---------------------------------------------------------


def journal_files(path: str) -> list[str]:
    """The journal's data files under `path`, oldest first."""
    if not os.path.isdir(path):
        return []
    return [
        os.path.join(path, n)
        for n in sorted(os.listdir(path))
        if n.startswith("journal-") and n.endswith(".ytrj")
    ]


def enforce_disk_budget(
    files: list[str], max_bytes: int, *, keep: str | None = None
) -> None:
    """Drop the OLDEST of `files` (given oldest first) until the total
    size fits `max_bytes`; `keep` (the file being written) is never
    dropped. Shared by the journal writer and the span writer
    (trace/spans.py) — one disk-budget policy for every telemetry
    artifact the scheduler rotates."""
    total = 0
    sizes = {}
    for fp in files:
        try:
            sizes[fp] = os.path.getsize(fp)
        except OSError:
            sizes[fp] = 0
        total += sizes[fp]
    for fp in files:
        if total <= max_bytes or fp == keep:
            break
        total -= sizes[fp]
        try:
            os.remove(fp)
            log.info("trace: dropped %s (disk budget)", fp)
        except OSError:
            log.warning("trace: could not drop %s", fp, exc_info=True)


def read_journal_file(fp: str, *, strict_version: bool = True):
    """Yield decoded records from ONE journal file, with truncated-tail
    recovery: a short final frame, a failing CRC, or a payload cut
    mid-field ends the file at the last good record — the crash-
    consistency contract. A schema-version mismatch raises
    TraceVersionError (clear error, never a guessed parse)."""
    with open(fp, "rb") as f:
        head = f.read(_HEADER.size)
        if len(head) < _HEADER.size:
            log.warning("trace: %s too short for a header; skipping", fp)
            return
        magic, version = _HEADER.unpack(head)
        if magic != MAGIC:
            raise TraceError(f"{fp}: not a journal file (bad magic)")
        if version != SCHEMA_VERSION:
            if strict_version:
                raise TraceVersionError(
                    f"{fp}: journal schema version {version}, this "
                    f"reader speaks {SCHEMA_VERSION} — re-record or "
                    "replay with a matching build"
                )
            log.warning("trace: %s version %d skipped", fp, version)
            return
        while True:
            frame = f.read(_FRAME.size)
            if len(frame) < _FRAME.size:
                if frame:
                    log.warning(
                        "trace: %s truncated frame header; recovered "
                        "to last good record", fp,
                    )
                break
            ln, crc = _FRAME.unpack(frame)
            payload = f.read(ln)
            if len(payload) < ln:
                log.warning(
                    "trace: %s truncated record payload; recovered "
                    "to last good record", fp,
                )
                break
            if zlib.crc32(payload) & 0xFFFFFFFF != crc:
                log.warning(
                    "trace: %s CRC mismatch; recovered to last good "
                    "record", fp,
                )
                break
            try:
                yield decode_record(payload)
            except TraceError:
                log.warning(
                    "trace: %s undecodable record; recovered to last "
                    "good record", fp,
                )
                break


def read_journal(path: str, *, strict_version: bool = True):
    """Yield decoded records across every journal file, oldest first."""
    for fp in journal_files(path):
        yield from read_journal_file(fp, strict_version=strict_version)


class JournalTailer:
    """Incremental reader over a journal that is STILL BEING WRITTEN.

    read_journal assumes a closed file set: it treats the first short or
    CRC-failing frame as end-of-file, which is exactly right post-mortem
    and exactly wrong mid-flight — a tail that is short because the
    writer's buffered append has not landed yet must be re-polled, not
    abandoned. The tailer keeps, per file, the byte offset after the
    last GOOD frame and distinguishes the three tail states a live
    journal can be in:

    - short/garbled tail on the NEWEST file: bytes may still be
      arriving (or the writer truncated a torn frame and will overwrite
      them) — hold position and retry next poll. A tail that was short
      and then decoded counts a truncated-tail-then-grew recovery.
    - short/garbled tail on a file with a SUCCESSOR: the writer only
      appends to the newest file, so that tail is final torn garbage
      (the ENOSPC poison path) — skip it and follow the rotation.
    - rotation: the next numbered file opens with a full snapshot
      record (CycleRecorder re-anchors the delta chain on every
      rotation), so following a boundary never strands the consumer's
      reconstruction.

    `resume_seq` filters records at or below an already-applied seq —
    the restart contract for a shadow consumer: re-open the tailer at
    its last applied seq and the delta chain re-anchors at the next
    full-snapshot record. The tailer never writes; it shares nothing
    with the writer but the directory."""

    def __init__(
        self,
        path: str,
        *,
        resume_seq: int | None = None,
        strict_version: bool = True,
    ):
        self.path = path
        self.strict_version = strict_version
        self.last_seq = None if resume_seq is None else int(resume_seq)
        self._file: str | None = None
        self._offset = 0            # byte offset after the last good frame
        self._short_tail = False    # last poll stopped mid-frame at _offset
        self._skip_file = False     # version-skipped file (non-strict mode)
        self.rotations_followed = 0
        self.truncations_recovered = 0
        self.dead_tails_skipped = 0
        self.records_yielded = 0
        self.records_filtered = 0   # skipped by the resume_seq watermark

    def stats(self) -> dict:
        return {
            "file": self._file,
            "offset": self._offset,
            "last_seq": self.last_seq,
            "records_yielded": self.records_yielded,
            "records_filtered": self.records_filtered,
            "rotations_followed": self.rotations_followed,
            "truncations_recovered": self.truncations_recovered,
            "dead_tails_skipped": self.dead_tails_skipped,
        }

    def poll(self, *, max_records: int | None = None) -> list[dict]:
        """Decode every record that became readable since the last poll
        (bounded by `max_records`); empty when the writer has not
        progressed. Never blocks, never raises on a recoverable tail —
        only on bad magic or (strict) schema-version mismatch."""
        out: list[dict] = []
        while True:
            files = journal_files(self.path)
            if not files:
                return out
            if self._file is None:
                self._enter(files[0], first=True)
            elif self._file not in files:
                # the file we were reading was dropped by the disk
                # budget — resume at the oldest survivor newer than it
                base = os.path.basename(self._file)
                newer = [
                    f for f in files if os.path.basename(f) > base
                ]
                if not newer:
                    return out
                self._enter(newer[0])
            self._drain(out, max_records)
            if max_records is not None and len(out) >= max_records:
                return out
            # current file exhausted: follow the rotation only when a
            # successor exists — the writer appends solely to the
            # newest file, so an older file's tail is final
            files = journal_files(self.path)
            try:
                i = files.index(self._file)
            except ValueError:
                continue  # dropped between listings; re-resolve
            if i + 1 >= len(files):
                return out
            if self._short_tail:
                log.warning(
                    "trace: %s rotated away with a torn tail; skipping "
                    "to %s", self._file, files[i + 1],
                )
                self.dead_tails_skipped += 1
            self._enter(files[i + 1])

    def _enter(self, fp: str, *, first: bool = False) -> None:
        self._file = fp
        self._offset = 0
        self._short_tail = False
        self._skip_file = False
        if not first:
            self.rotations_followed += 1

    def _drain(self, out: list, max_records: int | None) -> None:
        """Decode frames from the current file starting at _offset."""
        if self._skip_file:
            return
        try:
            f = open(self._file, "rb")
        except OSError:
            return
        with f:
            if self._offset == 0:
                head = f.read(_HEADER.size)
                if len(head) < _HEADER.size:
                    return  # header still being written; retry next poll
                magic, version = _HEADER.unpack(head)
                if magic != MAGIC:
                    raise TraceError(
                        f"{self._file}: not a journal file (bad magic)"
                    )
                if version != SCHEMA_VERSION:
                    if self.strict_version:
                        raise TraceVersionError(
                            f"{self._file}: journal schema version "
                            f"{version}, this reader speaks "
                            f"{SCHEMA_VERSION}"
                        )
                    log.warning(
                        "trace: %s version %d skipped", self._file, version
                    )
                    self._skip_file = True
                    return
                self._offset = _HEADER.size
            else:
                f.seek(self._offset)
            while max_records is None or len(out) < max_records:
                frame = f.read(_FRAME.size)
                if len(frame) < _FRAME.size:
                    self._short_tail = self._short_tail or bool(frame)
                    return
                ln, crc = _FRAME.unpack(frame)
                payload = f.read(ln)
                if len(payload) < ln:
                    self._short_tail = True
                    return
                if zlib.crc32(payload) & 0xFFFFFFFF != crc:
                    # a torn frame the writer may truncate and overwrite
                    # — hold position; rotation supersedes if it never
                    # heals
                    self._short_tail = True
                    return
                try:
                    rec = decode_record(payload)
                except TraceError:
                    self._short_tail = True
                    return
                if self._short_tail:
                    # the bytes we previously stopped on completed
                    self.truncations_recovered += 1
                    self._short_tail = False
                self._offset += _FRAME.size + ln
                seq = rec.get("seq")
                if (
                    seq is not None
                    and self.last_seq is not None
                    and int(seq) <= self.last_seq
                ):
                    self.records_filtered += 1
                    continue
                if seq is not None:
                    self.last_seq = int(seq)
                self.records_yielded += 1
                out.append(rec)


def last_journal_seq(path: str) -> int | None:
    """The highest `seq` in the journal, or None when empty — scanned
    newest file backwards so a restarting recorder's startup cost is
    one file, not the whole journal."""
    for fp in reversed(journal_files(path)):
        last = None
        try:
            for rec in read_journal_file(fp):
                if "seq" in rec:
                    last = int(rec["seq"])
        except TraceError:
            continue
        if last is not None:
            return last
    return None


class JournalWriter:
    """Rotating, disk-budgeted journal writer.

    `file_bytes` bounds one file; `max_bytes` bounds the whole journal
    directory — exceeding it drops the OLDEST file(s). rotated() flips
    True whenever a rotation (or drop) happened since the last
    full-snapshot record, so the recorder can re-anchor the delta chain:
    every file must open with a full snapshot or it cannot replay after
    its predecessors are gone."""

    def __init__(
        self,
        path: str,
        *,
        file_bytes: int = 32 << 20,
        max_bytes: int = 256 << 20,
    ):
        self.path = path
        self.file_bytes = int(file_bytes)
        self.max_bytes = int(max_bytes)
        os.makedirs(path, exist_ok=True)
        existing = journal_files(path)
        self._next_index = len(existing) and (
            int(os.path.basename(existing[-1])[8:16]) + 1
        )
        self._f = None
        self._file_size = 0
        # a failed write may have left a torn frame we could not
        # truncate away: the file is poisoned (readers would stop at the
        # torn frame and lose everything after it), so the next append
        # must rotate to a fresh file
        self._torn = False
        self.bytes_written = 0
        self.records_written = 0

    def _open_next(self) -> None:
        if self._f is not None:
            self._f.close()
        fp = os.path.join(self.path, _FILE_PATTERN % self._next_index)
        self._next_index += 1
        self._f = open(fp, "wb")
        self._f.write(_HEADER.pack(MAGIC, SCHEMA_VERSION))
        self._file_size = _HEADER.size
        self._torn = False
        self._enforce_budget()

    def _enforce_budget(self) -> None:
        # never drop the file being written
        enforce_disk_budget(
            journal_files(self.path),
            self.max_bytes,
            keep=self._f.name if self._f is not None else None,
        )

    def needs_rotation(self, payload_len: int) -> bool:
        return (
            self._f is None
            or self._file_size + _FRAME.size + payload_len > self.file_bytes
        )

    def append(self, payload: bytes, *, rotate: bool = False) -> None:
        if rotate or self._f is None or self._torn:
            self._open_next()
        frame = _FRAME.pack(len(payload), zlib.crc32(payload) & 0xFFFFFFFF)
        pos = self._file_size
        try:
            self._f.write(frame)
            self._f.write(payload)
            self._f.flush()
        except OSError:
            # a partial frame may be on disk (ENOSPC mid-payload):
            # readers stop a file at the first bad frame, so good
            # records appended after it would be unreachable. Truncate
            # the torn bytes away; if even that fails, poison the file
            # so the next append rotates instead of appending past them.
            try:
                self._f.seek(pos)
                self._f.truncate()
            except OSError:
                self._torn = True
            raise
        self._file_size += len(frame) + len(payload)
        self.bytes_written += len(frame) + len(payload)
        self.records_written += 1

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None


# ---- the scheduler-facing recorder ----------------------------------------


class CycleRecorder:
    """One length-prefixed, CRC-guarded record per scheduling cycle.

    Owns the full-vs-delta choice: a cycle that shipped a SnapshotDelta
    is recorded as that delta ONLY while the chain is anchored — the
    previous device-path record lives in the same file (every file opens
    with a full snapshot so rotation never strands a delta against a
    dropped predecessor). The full host build is always available at
    record time, so re-anchoring costs bytes, never information."""

    def __init__(
        self,
        path: str,
        *,
        file_bytes: int = 32 << 20,
        max_bytes: int = 256 << 20,
    ):
        from kubernetes_scheduler_tpu_torch.trace.schema import check_engine_coverage

        # fail loudly HERE (the write path) on engine-struct drift; the
        # read-only journal tooling stays engine/torch-free
        check_engine_coverage()
        self._writer = JournalWriter(
            path, file_bytes=file_bytes, max_bytes=max_bytes
        )
        self.path = path
        self.cycles_recorded = 0
        self.records_dropped = 0
        # cumulative encode+write wall time: the recorder's cost is kept
        # OUT of CycleMetrics.cycle_seconds (it runs after the cycle's
        # bookkeeping), so this is the number the <5%-overhead bench
        # gate reads directly
        self.seconds_spent = 0.0
        # seq RESUMES across restarts into the same directory (the way
        # JournalWriter resumes file numbering): a seq reset to 0 would
        # break `trace diff`'s merge-by-seq pairing on any journal that
        # spans a scheduler restart
        last = last_journal_seq(path)
        self._seq = 0 if last is None else last + 1
        # is there a reconstructible device-path snapshot earlier in the
        # CURRENT file for a delta record to chain from?
        self._chain_anchored = False
        # IDENTITY of the last device record's full snapshot: a delta is
        # recorded only when its base IS that object — a non-resident
        # dispatch in between (ephemeral build, engine fallback) moves
        # the reader's reconstruction off the delta's base, and applying
        # the delta there would reconstruct garbage silently
        self._last_snapshot_obj = None

    @property
    def bytes_written(self) -> int:
        return self._writer.bytes_written

    def record_cycle(
        self,
        *,
        path: str,
        metrics,
        node_names: list[str] | None = None,
        pod_keys: list | None = None,
        bindings: list | None = None,
        snapshot=None,
        delta=None,
        delta_base=None,
        pods=None,
        engine_kw: dict | None = None,
        node_idx=None,
        resident_epoch: int = 0,
        delta_sent: bool = False,
        batch_window: int = 0,
        fingerprint: dict | None = None,
        seq: int | None = None,
    ) -> None:
        """Append one cycle. Never raises into the scheduling loop — an
        encode/IO failure logs, counts a drop, and de-anchors the chain
        (the next delta record re-anchors with a full snapshot).

        `seq` overrides the recorder's own counter — the replayer
        re-records each cycle under its SOURCE record's seq, so a
        replay of a head-pruned journal still pairs with the original
        in `trace diff`'s merge-by-seq."""
        t0 = time.perf_counter()
        try:
            self._record(
                path=path, metrics=metrics, node_names=node_names,
                pod_keys=pod_keys, bindings=bindings, snapshot=snapshot,
                delta=delta, delta_base=delta_base, pods=pods,
                engine_kw=engine_kw,
                node_idx=node_idx, resident_epoch=resident_epoch,
                delta_sent=delta_sent, batch_window=batch_window,
                fingerprint=fingerprint, seq=seq,
            )
        except Exception:
            log.exception("trace: cycle record failed; dropping record")
            self.records_dropped += 1
            self._chain_anchored = False
            self._last_snapshot_obj = None
        finally:
            self.seconds_spent += time.perf_counter() - t0

    def _record(
        self, *, path, metrics, node_names, pod_keys, bindings, snapshot,
        delta, delta_base, pods, engine_kw, node_idx, resident_epoch,
        delta_sent, batch_window, fingerprint, seq=None,
    ) -> None:
        import dataclasses

        if seq is not None:
            self._seq = int(seq)
        rec: dict = {
            "seq": self._seq,
            "path": path,
            "wall_time": time.time(),
            "metrics": (
                dataclasses.asdict(metrics)
                if dataclasses.is_dataclass(metrics)
                else dict(metrics or {})
            ),
        }
        if fingerprint is not None:
            rec["fingerprint"] = fingerprint
        extra = []
        if node_names is not None:
            # the node-name list is identical cycle after cycle on a
            # quiet cluster; re-encoding 4k names cost ~1 ms/record, the
            # equality probe costs ~0.1 ms
            extra.append(self._names_field(node_names))
        if pod_keys is not None:
            rec["pod_keys"] = [list(k) for k in pod_keys]
        if bindings is not None:
            rec["bindings"] = [list(b) for b in bindings]
        if engine_kw is not None:
            rec["engine_kw"] = _jsonable_kw(engine_kw)
        rec["resident_epoch"] = int(resident_epoch)
        rec["delta_sent"] = int(bool(delta_sent))
        if batch_window:
            rec["batch_window"] = int(batch_window)
        device_record = pods is not None and (
            snapshot is not None or delta is not None
        )
        use_delta = (
            delta is not None
            and device_record
            and self._chain_anchored
            # the chain rule: the reader reconstructs by folding this
            # delta into the PREVIOUS device record's snapshot, so the
            # delta's base must BE that snapshot (object identity — a
            # non-resident dispatch in between breaks it)
            and delta_base is not None
            and delta_base is self._last_snapshot_obj
        )
        if device_record:
            if use_delta:
                rec["delta"] = _tensor_items(delta)
            else:
                if snapshot is None:
                    raise TraceError(
                        "delta record with no anchor and no full snapshot"
                    )
                rec["snapshot"] = _tensor_items(snapshot)
            rec["pods"] = _tensor_items(pods)
        if node_idx is not None:
            rec["assign"] = {
                "node_idx": np.asarray(node_idx, np.int32).reshape(-1)
            }
        payload = encode_record(rec, extra)
        rotate = self._writer.needs_rotation(len(payload))
        if rotate and use_delta:
            # a fresh file must open with a full snapshot: re-encode this
            # record as the full build (always in hand at record time)
            if snapshot is None:
                raise TraceError("rotation needs a full snapshot to anchor")
            del rec["delta"]
            rec["snapshot"] = _tensor_items(snapshot)
            use_delta = False
            payload = encode_record(rec, extra)
        self._writer.append(payload, rotate=rotate)
        if rotate:
            self._chain_anchored = False
        if device_record:
            # a delta record extends the chain; a full record anchors it
            self._chain_anchored = True
            self._last_snapshot_obj = snapshot
        self._seq += 1
        self.cycles_recorded += 1

    def _names_field(self, node_names) -> bytes:
        """The node_names field pre-encoded, cached by list equality."""
        names = list(node_names)
        c = self.__dict__.get("_names_cache")
        if c is not None and c[0] == names:
            return c[1]
        f = FIELD_BY_NAME["node_names"]
        b = json.dumps(names, separators=(",", ":")).encode()
        blob = _FIELD.pack(f.tag, KIND_JSON) + _U32.pack(len(b)) + b
        self.__dict__["_names_cache"] = (names, blob)
        return blob

    def stats(self) -> dict:
        return {
            "cycles_recorded": self.cycles_recorded,
            "trace_bytes": self.bytes_written,
            "records_dropped": self.records_dropped,
        }

    def close(self) -> None:
        self._writer.close()


def _tensor_items(nt) -> list:
    """(name, host ndarray) pairs of a NamedTuple of arrays. Leaves must
    already be host numpy (the builders' output) or CPU tensors; a CUDA
    tensor raises here (the record is dropped and counted), since a read
    from the card does not belong on the record path."""
    return [(name, np.asarray(a)) for name, a in zip(type(nt)._fields, nt)]


def _jsonable_kw(kw: dict) -> dict:
    out = dict(kw)
    sp = out.get("score_plugins")
    if sp is not None:
        out["score_plugins"] = [[n, float(w)] for n, w in sp]
    return out
