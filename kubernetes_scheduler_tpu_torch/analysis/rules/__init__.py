"""Rule registry: name -> check(ctx) -> list[Violation].

Fifteen families. Ten are the JAX package's, copied with their scopes
repointed at this package: lock-discipline, timeout-hygiene,
metric-hygiene, span-hygiene, sim-determinism, wire-schema and
capability-completeness check one file (or the bridge against its
.proto) at a time; lockset-race rides the interprocedural dataflow core
(analysis/dataflow.py), and thread-race and determinism-taint ride the
declared thread model (analysis/threads.py). Four are twins of JAX
families in torch and CUDA terms: host-sync (device barriers and
per-element reads in the cycle path), host-transfer (implicit
device-to-host syncs on tensors in the hot path), dtype-shape (float64
in the engine) and cuda-kernel (the twin of pallas-vmem: the CUDA
sources' launch bounds, host callbacks, accumulators, static shared
memory, the ctypes table and the kernel budget file). The fifteenth,
spmd-collective, twins the reference's family of that name over the
sharded engine's per-shard lists (analysis/spmd.py): double-counting
psums, unbound axis names, redundant gathers, gather_cat's dim misuse,
and one shard's value returned as the global answer.
The README's "Static analysis of the port" table must name exactly this
registry (checked both ways by the `docs-drift` runner check).
"""

from kubernetes_scheduler_tpu_torch.analysis.rules import (
    capability_completeness,
    cuda_kernel,
    determinism_taint,
    dtype_shape,
    host_sync,
    host_transfer,
    lock_discipline,
    lockset_race,
    metric_hygiene,
    sim_determinism,
    span_hygiene,
    spmd_collective,
    thread_race,
    timeout_hygiene,
    wire_schema,
)

RULES = {
    host_sync.RULE: host_sync.check,
    lock_discipline.RULE: lock_discipline.check,
    wire_schema.RULE: wire_schema.check,
    dtype_shape.RULE: dtype_shape.check,
    timeout_hygiene.RULE: timeout_hygiene.check,
    cuda_kernel.RULE: cuda_kernel.check,
    metric_hygiene.RULE: metric_hygiene.check,
    sim_determinism.RULE: sim_determinism.check,
    span_hygiene.RULE: span_hygiene.check,
    host_transfer.RULE: host_transfer.check,
    lockset_race.RULE: lockset_race.check,
    capability_completeness.RULE: capability_completeness.check,
    spmd_collective.RULE: spmd_collective.check,
    thread_race.RULE: thread_race.check,
    determinism_taint.RULE: determinism_taint.check,
}
