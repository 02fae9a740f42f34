"""graftmodel: explicit-state bounded model checking of the
session/epoch/capability protocol, run as part of lint (layer 3 of the
port's checker: the JAX package's analysis/model, its anchors bound to
this package's bridge and host code).

The invariants that keep the resident-state bridge correct used to live
in prose ("latched like the field cache and INVALIDATED TOGETHER with
it", bridge/client.py) — and were violated once (the
mid-stream-downgrade bug). This package makes them CHECKED artifacts:

- `checker` — the engine: a deterministic explicit-state explorer over
  declared protocol state machines, with sleep-set partial-order
  reduction, state/time budgets, and counterexamples rendered as
  readable event schedules;
- `protocols` — the models: the RemoteEngine client session (wire
  field cache + capability latches + resident epoch under
  failure/restart/version-skew), the sidecar's session-keyed state,
  the queue's restore_window/gang-deferral semantics (front- and
  back-restoring variants), the pipelined driver's in-flight slot,
  and a 2-replica model of the PROPOSED cross-replica bind-conflict
  protocol (ROADMAP's horizontal scale-out item, de-risked before it
  is written);
- `anchors` — the drift layer: every model transition is bound to the
  real code site it abstracts via the shared ModuleIndex/call-graph
  (the way contracts.py binds output specs by calling the engine), so the
  model FAILS LINT when the code moves out from under it;
- `mutants` — the teeth: seeded reintroductions of known protocol bug
  classes (invalidate-without-the-field-cache — the mid-stream-downgrade class;
  delta-across-layout-churn; restore-to-the-back on the Python queue;
  unfenced cross-replica binds) that the checker must each catch.

`python -m kubernetes_scheduler_tpu_torch.analysis.model` is the CLI;
a full-repo graftlint run folds the whole layer in as pseudo-rule
`protocol-model`.
"""

from kubernetes_scheduler_tpu_torch.analysis.model.checker import (  # noqa: F401
    CheckResult,
    Convergence,
    Invariant,
    ProtocolModel,
    Transition,
    check_model,
)
