"""Journal inspection: dump / stats / diff (the `trace` CLI's backends).

These read journals without touching an engine (importing this module
never pulls in torch) — safe to run against a production trace on a
laptop. `diff` pairs two journals' records by seq and compares their
DECISION content (path, window identity, node_idx), which is what "two
identical replays report zero differences" means: metrics, timestamps,
and bind-time outcomes (a live binder's 404/409 drops ride `bindings`)
legitimately differ between runs and are never part of the comparison.
"""

from __future__ import annotations

import numpy as np

from kubernetes_scheduler_tpu_torch.trace.recorder import journal_files, read_journal


def record_summary(rec: dict) -> dict:
    """One journal record as a compact JSON-able summary (tensor payloads
    reduced to shapes)."""
    assign = (rec.get("assign") or {}).get("node_idx")
    out = {
        "seq": rec.get("seq"),
        "path": rec.get("path"),
        "pods_in": len(rec.get("pod_keys") or []),
        "bound": len(rec.get("bindings") or []),
        "assigned": int((np.asarray(assign) >= 0).sum())
        if assign is not None
        else None,
        "resident_epoch": rec.get("resident_epoch", 0),
        "delta_sent": bool(rec.get("delta_sent", 0)),
        "carries": (
            "delta" if "delta" in rec
            else "snapshot" if "snapshot" in rec
            else "none"
        ),
    }
    snap = rec.get("snapshot") or rec.get("delta")
    if snap:
        out["tensor_bytes"] = int(
            sum(a.nbytes for a in snap.values())
            + sum(a.nbytes for a in (rec.get("pods") or {}).values())
        )
    if rec.get("batch_window"):
        out["batch_window"] = rec["batch_window"]
    return out


def dump(path: str, *, limit: int | None = None):
    """Yield per-record summaries, oldest first."""
    for i, rec in enumerate(read_journal(path)):
        if limit is not None and i >= limit:
            return
        yield record_summary(rec)


def stats(path: str) -> dict:
    """Whole-journal aggregates: what a pilot reads before a replay."""
    import os

    files = journal_files(path)
    by_path: dict[str, int] = {}
    records = 0
    bound = 0
    assigned = 0
    delta_records = 0
    full_records = 0
    peak_sel = 0
    first_seq = last_seq = None
    for rec in read_journal(path):
        records += 1
        by_path[rec.get("path", "?")] = by_path.get(rec.get("path", "?"), 0) + 1
        bound += len(rec.get("bindings") or [])
        a = (rec.get("assign") or {}).get("node_idx")
        if a is not None:
            assigned += int((np.asarray(a) >= 0).sum())
        if "delta" in rec:
            delta_records += 1
            dv = rec["delta"].get("dom_vals")
            if dv is not None and np.asarray(dv).ndim == 3:
                peak_sel = max(peak_sel, int(np.asarray(dv).shape[1]))
        elif "snapshot" in rec:
            full_records += 1
            dc = rec["snapshot"].get("domain_counts")
            if dc is not None and np.asarray(dc).ndim == 2:
                peak_sel = max(peak_sel, int(np.asarray(dc).shape[1]))
        if first_seq is None:
            first_seq = rec.get("seq")
        last_seq = rec.get("seq")
    return {
        "files": len(files),
        "bytes": sum(os.path.getsize(fp) for fp in files),
        "records": records,
        "by_path": by_path,
        "first_seq": first_seq,
        "last_seq": last_seq,
        "pods_bound": bound,
        "pods_assigned": assigned,
        "snapshot_records": full_records,
        "delta_records": delta_records,
        # the selector-table width the run peaked at (the snapshot's
        # domain tables are sized to the power-of-two selector bucket):
        # feed this to config.mirror_initial_selectors on a warm restart
        # so the restarted mirror skips the early bucket-crossing
        # rebuilds the original run already paid for
        "peak_selector_slots": peak_sel,
    }


def _compare_decisions(ra: dict, rb: dict) -> list:
    """The DECISION identity of a cycle record: path, window pod
    identity, and the engine's node_idx. Bindings are deliberately NOT
    compared — they record bind-time outcomes (a live binder's 404/409
    drops), which are environment, not decisions: a recorded production
    journal and its replay legitimately differ there while agreeing on
    every assignment."""
    problems = []
    if ra.get("path") != rb.get("path"):
        problems.append(f"path {ra.get('path')!r} != {rb.get('path')!r}")
    if (ra.get("pod_keys") or []) != (rb.get("pod_keys") or []):
        problems.append("window pod identity differs")
    ia = np.asarray((ra.get("assign") or {}).get("node_idx", ()))
    ib = np.asarray((rb.get("assign") or {}).get("node_idx", ()))
    if ia.shape != ib.shape or not np.array_equal(ia, ib):
        n = (
            int((ia != ib).sum())
            if ia.shape == ib.shape
            else max(ia.size, ib.size)
        )
        problems.append(f"node_idx differs on {n} rows")
    return problems


def diff(path_a: str, path_b: str, *, limit: int | None = None) -> dict:
    """Record-by-record decision diff of two journals. Zero differences
    means the two runs decided identically — the acceptance check for
    replaying the same journal twice.

    Records pair by `seq` (a two-pointer merge — seq is monotonic
    within a run), so a journal whose head was rotated or pruned away
    diffs against the surviving overlap instead of misaligning every
    record positionally; records only one side has count as extra, not
    as differences. Records without seq fall back to positional
    pairing."""
    it_a = read_journal(path_a)
    it_b = read_journal(path_b)
    compared = 0
    differing = []
    extra_a = extra_b = 0
    truncated = False
    ra = next(it_a, None)
    rb = next(it_b, None)
    while ra is not None and rb is not None:
        if limit is not None and compared >= limit:
            # a limited diff is NOT a verdict on the uncompared tail —
            # flag it, so "differences: 0" cannot be mistaken for
            # "the journals agree" (cmd_trace never passes a limit)
            truncated = True
            ra = rb = None
            break
        sa, sb = ra.get("seq"), rb.get("seq")
        if sa is not None and sb is not None and sa != sb:
            if sa < sb:
                extra_a += 1
                ra = next(it_a, None)
            else:
                extra_b += 1
                rb = next(it_b, None)
            continue
        compared += 1
        problems = _compare_decisions(ra, rb)
        if problems:
            differing.append({"seq": sa, "problems": problems})
        ra = next(it_a, None)
        rb = next(it_b, None)
    if ra is not None:
        extra_a += 1 + sum(1 for _ in it_a)
    if rb is not None:
        extra_b += 1 + sum(1 for _ in it_b)
    return {
        "records_compared": compared,
        "differences": len(differing),
        "differing": differing[:32],
        "extra_records_a": extra_a,
        "extra_records_b": extra_b,
        "truncated": truncated,
    }
