"""Meshes and the node-sharded scheduling engine (counterpart of
kubernetes_scheduler_tpu/parallel).

The parallelism of a batch scheduler is the node axis (10k+) and the
pending-pod axis: nodes split into shards, pods stay replicated, and the
per-cycle reductions (utilization statistics, score bounds, the global
argmax of assignment) become collectives over the shards. The engine is
single-controller: one process drives every shard, and a mesh may place
several shards on one device. make_mesh_multihost is the reference's
mesh across hosts: a 2-D (dcn, node) grid of this process's devices, the
node axis sharded over both in row-major order.
"""

from kubernetes_scheduler_tpu_torch.parallel.engine import (
    ShardedEngine,
    make_sharded_schedule_fn,
    make_sharded_windows_fn,
    shard_snapshot,
    sharded_device_count,
    stack_shard_deltas,
)
from kubernetes_scheduler_tpu_torch.parallel.mesh import (
    DCN_AXIS,
    DP_AXIS,
    NODE_AXIS,
    Mesh,
    make_mesh,
    make_mesh_multihost,
)

__all__ = [
    "DCN_AXIS",
    "DP_AXIS",
    "NODE_AXIS",
    "Mesh",
    "ShardedEngine",
    "make_mesh",
    "make_mesh_multihost",
    "make_sharded_schedule_fn",
    "make_sharded_windows_fn",
    "shard_snapshot",
    "sharded_device_count",
    "stack_shard_deltas",
]
