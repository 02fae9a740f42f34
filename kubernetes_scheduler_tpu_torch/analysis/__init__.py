"""graftlint for the PyTorch/CUDA package: repo-native static analysis.

The counterpart of kubernetes_scheduler_tpu/analysis, layer 1: fourteen
AST and text rule families over this package's own source, on the
parse-once dataflow core (analysis/dataflow.py) and the declared thread
model (analysis/threads.py). Ten are the JAX package's families copied
with their scopes repointed here (lock-discipline, timeout-hygiene,
metric-hygiene, span-hygiene, sim-determinism, wire-schema,
capability-completeness, lockset-race, thread-race,
determinism-taint); four are twins in torch and CUDA terms:

  host-sync       device barriers and per-element reads in the cycle path
  host-transfer   implicit device-to-host syncs on tensors in the hot path
  dtype-shape     float64 in the engine
  cuda-kernel     the CUDA sources: launch bounds, host callbacks, f32
                  accumulators, static shared memory, the ctypes table
                  and the kernel budget file (csrc/kernel_budget.json,
                  read from ptxas on the card by analysis/kernel_budget.py)

The engine-contract layer and the protocol models of the JAX package
have no counterpart yet. Nothing here imports torch, jax or the JAX
package: the checker reads source text only.

Run:  python -m kubernetes_scheduler_tpu_torch.analysis

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
