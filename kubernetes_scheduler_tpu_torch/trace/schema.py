"""Journal record schema: the wire contract of the cycle flight recorder.

The port's copy of kubernetes_scheduler_tpu/trace/schema.py: MAGIC,
SCHEMA_VERSION, every tag, kind and pinned dtype are the same, so a
journal written by either package reads in the other. One declarative
table, so the record layout has an explicit identity instead of being
implied by whatever the encoder happens to write: field tags must
be unique and stable (a tag is wire identity — renumbering breaks every
journal on disk), and every tensor leaf must pin its dtype (a dtype
drift would make "bitwise replay parity" silently meaningless).

Versioning: SCHEMA_VERSION rides every journal file's header. Readers
reject a version they do not speak with a clear error (never a best-
effort parse of an unknown layout); ADDING fields under fresh tags is
backward-compatible — old records simply lack them and decode to the
field's absence — so the version only moves on layout-breaking changes.
"""

from __future__ import annotations

from typing import NamedTuple

# file header: magic + u16 schema version (little-endian)
MAGIC = b"YTRJ"
SCHEMA_VERSION = 1

# field kinds (u8 on the wire)
KIND_U64 = 0
KIND_F64 = 1
KIND_STR = 2
KIND_JSON = 3
KIND_TENSORS = 4

KINDS = {
    "u64": KIND_U64,
    "f64": KIND_F64,
    "str": KIND_STR,
    "json": KIND_JSON,
    "tensors": KIND_TENSORS,
}


class Field(NamedTuple):
    tag: int    # wire identity; append-only, never renumbered or reused
    name: str
    kind: str   # one of KINDS


# One record per scheduling cycle. Tags are APPEND-ONLY: a retired field
# keeps its tag reserved (readers skip unknown tags), exactly like proto
# field numbers.
JOURNAL_FIELDS = (
    Field(1, "seq", "u64"),             # cycle sequence within the run
    Field(2, "path", "str"),            # device | backlog | scalar | mixed
    Field(3, "wall_time", "f64"),       # recorder wall clock (epoch s)
    Field(4, "fingerprint", "json"),    # config + layout identity summary
    Field(5, "engine_kw", "json"),      # the exact engine cycle options
    Field(6, "node_names", "json"),     # snapshot row -> node name
    Field(7, "pod_keys", "json"),       # batch row -> [namespace, name]
    Field(8, "bindings", "json"),       # [[namespace, name, node_name]]
    Field(9, "metrics", "json"),        # CycleMetrics as a dict
    Field(10, "resident_epoch", "u64"),
    Field(11, "delta_sent", "u64"),     # 1 = the cycle shipped a delta
    Field(12, "batch_window", "u64"),   # backlog records: window stride
    Field(13, "snapshot", "tensors"),   # full SnapshotArrays leaves
    Field(14, "delta", "tensors"),      # SnapshotDelta leaves (delta recs)
    Field(15, "pods", "tensors"),       # PodBatch leaves
    Field(16, "assign", "tensors"),     # node_idx over the real window
)

FIELD_BY_NAME = {f.name: f for f in JOURNAL_FIELDS}
FIELD_BY_TAG = {f.tag: f for f in JOURNAL_FIELDS}

# Pinned dtypes for every tensor leaf a record may carry, keyed
# "<field>.<leaf>". The recorder REJECTS an array whose dtype disagrees
# (never silently casts): replay parity is bitwise, so an upstream dtype
# drift must fail at record time, not surface as a mysterious diff.
TENSOR_DTYPES = {
    # SnapshotArrays
    "snapshot.allocatable": "float32",
    "snapshot.requested": "float32",
    "snapshot.disk_io": "float32",
    "snapshot.cpu_pct": "float32",
    "snapshot.mem_pct": "float32",
    "snapshot.net_up": "float32",
    "snapshot.net_down": "float32",
    "snapshot.node_mask": "bool",
    "snapshot.cards": "float32",
    "snapshot.card_mask": "bool",
    "snapshot.card_healthy": "bool",
    "snapshot.taints": "int32",
    "snapshot.taint_mask": "bool",
    "snapshot.node_labels": "int32",
    "snapshot.node_label_mask": "bool",
    "snapshot.domain_counts": "float32",
    "snapshot.domain_id": "int32",
    "snapshot.avoid_counts": "float32",
    "snapshot.pref_attract": "float32",
    "snapshot.pref_avoid": "float32",
    "snapshot.image_scaled": "float32",
    # SnapshotDelta
    "delta.req_rows": "int32",
    "delta.req_vals": "float32",
    "delta.util_rows": "int32",
    "delta.util_vals": "float32",
    "delta.dom_rows": "int32",
    "delta.dom_vals": "float32",
    "delta.node_mask": "bool",
    # PodBatch
    "pods.request": "float32",
    "pods.r_io": "float32",
    "pods.priority": "int32",
    "pods.pod_mask": "bool",
    "pods.want_number": "int32",
    "pods.want_memory": "float32",
    "pods.want_clock": "float32",
    "pods.tolerations": "int32",
    "pods.tol_mask": "bool",
    "pods.na_key": "int32",
    "pods.na_op": "int32",
    "pods.na_vals": "int32",
    "pods.na_val_mask": "bool",
    "pods.na_mask": "bool",
    "pods.na_term": "int32",
    "pods.affinity_sel": "int32",
    "pods.anti_affinity_sel": "int32",
    "pods.pod_matches": "bool",
    "pods.pna_key": "int32",
    "pods.pna_op": "int32",
    "pods.pna_vals": "int32",
    "pods.pna_val_mask": "bool",
    "pods.pna_mask": "bool",
    "pods.pna_weight": "float32",
    "pods.pna_term": "int32",
    "pods.pref_affinity_sel": "int32",
    "pods.pref_affinity_weight": "float32",
    "pods.pref_anti_sel": "int32",
    "pods.pref_anti_weight": "float32",
    "pods.target_node": "int32",
    "pods.spread_sel": "int32",
    "pods.spread_max": "int32",
    "pods.soft_spread_sel": "int32",
    "pods.image_ids": "int32",
    "pods.n_containers": "int32",
    # gang co-scheduling (ops/gang.py): window-local gang slot + size
    "pods.gang_id": "int32",
    "pods.gang_size": "int32",
    # replay comparison target: the engine's node_idx over the real
    # (unpadded) window rows — "bitwise binding parity" reduces to an
    # array_equal on this
    "assign.node_idx": "int32",
}


def _leaves(prefix: str) -> set:
    return {
        k.split(".", 1)[1] for k in TENSOR_DTYPES if k.startswith(prefix + ".")
    }


_engine_coverage_checked = False


def check_engine_coverage() -> None:
    """Every engine-struct leaf MUST carry a pinned dtype: a leaf added
    to SnapshotArrays/PodBatch/SnapshotDelta without a schema entry
    would be silently dropped from records — replay would re-execute
    with a default-valued leaf and the parity guarantee would be a lie.
    Same stance as host/snapshot.py's delta-leaf classification assert.

    Called lazily from the WRITE/replay paths (CycleRecorder, replay),
    never at import: the read-only inspection path (`trace dump/stats/
    diff`) must stay engine-free — importing engine imports torch,
    which a laptop reading a production journal need not have."""
    global _engine_coverage_checked
    if _engine_coverage_checked:
        return
    from kubernetes_scheduler_tpu_torch.engine import (
        PodBatch,
        SnapshotArrays,
        SnapshotDelta,
    )

    for prefix, cls in (
        ("snapshot", SnapshotArrays),
        ("delta", SnapshotDelta),
        ("pods", PodBatch),
    ):
        have, want = _leaves(prefix), set(cls._fields)
        assert have == want, (
            f"trace schema drift for {prefix!r}: TENSOR_DTYPES covers "
            f"{sorted(have ^ want)} differently than {cls.__name__} — pin "
            "the new leaf's dtype (or retire the stale entry) before "
            "journals can be trusted"
        )
    _engine_coverage_checked = True


def _check_tables() -> None:
    """Import-time sanity on the tables themselves (engine-free)."""
    assert len({f.tag for f in JOURNAL_FIELDS}) == len(JOURNAL_FIELDS), (
        "duplicate journal field tag"
    )
    assert len(FIELD_BY_NAME) == len(JOURNAL_FIELDS), (
        "duplicate journal field name"
    )
    assert all(f.kind in KINDS for f in JOURNAL_FIELDS)


_check_tables()
