"""spmd-collective: the replication discipline of the per-shard lists
of the node-sharded engine — psum double-counts, unbound axis names,
redundant gathers of replicated lists, gather_cat's dim misuse, and one
shard's value returned as the global answer.

Thin registry shim: the replication-lattice abstract interpreter that
powers the family lives in analysis/spmd.py (it rides the shared
parse-once ModuleIndex the way the lockset family rides the dataflow
core). Scope is the sharded engine's surface — parallel/ — plus, in
fixture mode, whatever files the caller passed."""

from __future__ import annotations

from kubernetes_scheduler_tpu_torch.analysis import spmd
from kubernetes_scheduler_tpu_torch.analysis.core import Context, Violation

RULE = spmd.RULE

SCOPE = ("kubernetes_scheduler_tpu_torch/parallel/*.py",)


def check(ctx: Context) -> list[Violation]:
    return spmd.check_files(ctx, ctx.scoped(SCOPE))
