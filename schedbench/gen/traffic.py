"""The traffic mixes' one generator. A mix is a data file under
schedbench/traffic/ whose `kind` picks one of the kinds below; every other
key is a parameter of that kind.

- closed_backlog: before each cycle the pending queue is refilled to
  `backlog_pods` (a scale-up drained as fast as the scheduler can). The
  pods the window creates are built in set-up, `pool_pods_per_s` for each
  second of the window on top of one backlog, so the window times only
  the program's submit of each.
- preemption_backlog: preemptors over a running set of its own priority
  (the configuration's init_pod, placed by set-up), for a configuration
  with scheduler.preemption: true and for no other. Before each
  cycle the pending pods of the `pod` template are refilled to
  `backlog_pods`; after it the program's victims are killed, and the
  oldest bound pods of the `pod` template beyond `held_pods` are deleted,
  as completions, so their room goes back to the running set. With
  `recreate_victims`, each killed victim comes back as a new pending pod
  of init_pod in the next refill (its ReplicaSet). The pool is built as
  closed_backlog's, once for each template; the re-created pods come
  from init_pod's, and either pool's shortfall counts in pool_short.

Each kind's side of the cluster is one class of loop.TRAFFIC_KINDS.
"""

from __future__ import annotations

import math

KINDS = ("closed_backlog", "preemption_backlog")
NEED = {
    "closed_backlog": ("backlog_pods", "pool_pods_per_s"),
    "preemption_backlog": ("backlog_pods", "pool_pods_per_s", "held_pods", "recreate_victims"),
}


def check(traffic: dict) -> None:
    kind = traffic.get("kind")
    if kind not in KINDS:
        raise ValueError(f"traffic kind {kind!r} is not one of {KINDS}")
    missing = [k for k in NEED[kind] if k not in traffic]
    if missing:
        raise ValueError(f"traffic of kind {kind} lacks {missing}")


def refill_count(traffic: dict, pending: int) -> int:
    """Pods to create so that `pending` reaches the backlog (for
    preemption_backlog, `pending` counts the pod template's pods alone)."""
    return max(int(traffic["backlog_pods"]) - int(pending), 0)


def pool_size(traffic: dict, seconds: float) -> int:
    """Pods built ahead of a window of `seconds` (of each template, for
    preemption_backlog)."""
    return int(traffic["backlog_pods"]) + math.ceil(float(traffic["pool_pods_per_s"]) * seconds)
