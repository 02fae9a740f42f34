"""The traffic mixes' one generator. A mix is a data file under
schedbench/traffic/ whose `kind` picks one of the kinds below; every other
key is a parameter of that kind.

- closed_backlog: before each cycle the pending queue is refilled to
  `backlog_pods` (a scale-up drained as fast as the scheduler can). The
  pods the window creates are built in set-up, `pool_pods_per_s` for each
  second of the window on top of one backlog, so the window times only
  the program's submit of each.
"""

from __future__ import annotations

import math

KINDS = ("closed_backlog",)


def check(traffic: dict) -> None:
    kind = traffic.get("kind")
    if kind not in KINDS:
        raise ValueError(f"traffic kind {kind!r} is not one of {KINDS}")
    need = {"closed_backlog": ("backlog_pods", "pool_pods_per_s")}[kind]
    missing = [k for k in need if k not in traffic]
    if missing:
        raise ValueError(f"traffic of kind {kind} lacks {missing}")


def refill_count(traffic: dict, pending: int) -> int:
    """closed_backlog: pods to create so that `pending` reaches the backlog."""
    return max(int(traffic["backlog_pods"]) - int(pending), 0)


def pool_size(traffic: dict, seconds: float) -> int:
    """Pods built ahead of a window of `seconds`."""
    return int(traffic["backlog_pods"]) + math.ceil(float(traffic["pool_pods_per_s"]) * seconds)
