"""Host <-> engine-sidecar gRPC bridge (SURVEY.md §7 step 3).

One RPC per scheduling cycle: ScheduleBatch(matrices) -> bindings.
Replaces the reference's per-score network chatter (5·(N+1) Prometheus
HTTP calls + O(N) Redis round-trips per pod, SURVEY.md §3.2) with a
single dense transfer.

The port's copy of kubernetes_scheduler_tpu/bridge: the same
schedule.proto (byte for byte, package yodatpu), so a host speaking it to
the JAX sidecar gets the same bindings from this one, whose engine is
TorchEngine on the card.
"""

from kubernetes_scheduler_tpu_torch.bridge.client import (
    EngineUnavailable,
    LocalEngine,
    RemoteEngine,
)
from kubernetes_scheduler_tpu_torch.bridge.server import make_server
