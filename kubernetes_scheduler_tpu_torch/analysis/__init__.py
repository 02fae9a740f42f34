"""graftlint for the PyTorch/CUDA package: repo-native static analysis.

The counterpart of kubernetes_scheduler_tpu/analysis, in its three
layers.

Layer 1: fifteen AST and text rule families over this package's own
source, on the parse-once dataflow core (analysis/dataflow.py) and the
declared thread model (analysis/threads.py). Ten are the JAX package's
families copied with their scopes repointed here (lock-discipline,
timeout-hygiene, metric-hygiene, span-hygiene, sim-determinism,
wire-schema, capability-completeness, lockset-race, thread-race,
determinism-taint); five are twins in torch and CUDA terms:

  host-sync        device barriers and per-element reads in the cycle path
  host-transfer    implicit device-to-host syncs on tensors in the hot path
  dtype-shape      float64 in the engine
  cuda-kernel      the CUDA sources: launch bounds, host callbacks, f32
                   accumulators, static shared memory, the ctypes table
                   and the kernel budget file (csrc/kernel_budget.json,
                   read from ptxas on the card by analysis/kernel_budget.py)
  spmd-collective  the replication lattice over the sharded engine's
                   per-shard lists (analysis/spmd.py)

Layer 2: engine contracts (analysis/contracts.py): every engine entry
point and kernel wrapper called on the device asked for (cuda by
default), its output's shapes and dtypes diffed against a declared
spec; the sharded surfaces on a 4-shard and a 2 x 2 mesh against the
dense specs; the collective budget (analysis/COLLECTIVE_BUDGET.json:
distinct call sites of each parallel/mesh.py collective a surface
reaches); the seeded SPMD mutants (analysis/spmd_mutants.py) and thread
mutants (analysis/thread_mutants.py).

Layer 3: protocol models (analysis/model/): the JAX package's declared
session/epoch/capability, gang-queue, pipeline-slot, replica-bind and
degradation-ladder state machines, exhaustively model-checked, every
transition anchored on this package's code.

Nothing here imports jax or the JAX package; torch is imported only
inside layer 2's functions, so layers 1 and 3 read source text alone.

Run:  python -m kubernetes_scheduler_tpu_torch.analysis [--device cpu]

A genuine-but-intended site is waived inline with a justification:

  x = t.item()  # graftlint: disable=host-sync -- one read per cycle

and in a CUDA source with `// graftlint: disable=cuda-kernel -- <reason>`.
A waiver without the `-- reason` clause is itself a violation; a waiver
above a decorator covers the whole def, one on a multi-line statement
covers the statement. CI artifacts: `--format json|sarif`,
`--json-artifact`, and the package's analysis/LINT_BASELINE.json
suppression file (stale or unexplained entries fail lint).
"""

from kubernetes_scheduler_tpu_torch.analysis.core import (  # noqa: F401
    Context,
    Violation,
    run_lint,
)
