"""spmd-collective violating fixture: every check of the family fires.

A miniature node-sharded scoring pipeline over the port's per-shard
lists with the five bug classes seeded: a psum of a replicated list
(double count), a reduction on an axis name no mesh declares, a gather
of a replicated list, a mesh axis name passed as gather_cat's `dim`, and
one shard's value returned (and stored in a result field) as the global
answer. Never imported, only parsed."""

from typing import NamedTuple

import torch

from kubernetes_scheduler_tpu_torch.parallel.engine import shard_snapshot
from kubernetes_scheduler_tpu_torch.parallel.mesh import (
    Mesh,
    all_gather,
    broadcast,
    gather_cat,
    pmax,
    psum,
)

NODE_AXIS = "node"


class PickResult(NamedTuple):
    node: torch.Tensor


def make_mesh(device):
    return Mesh([device] * 4, (4,), (NODE_AXIS,))


def bad_stats(snapshot, w, mesh):
    shards = shard_snapshot(snapshot, mesh)
    xs = [s.cpu_pct for s in shards]
    total = psum([x.sum() for x in xs], mesh, NODE_AXIS)
    ws = broadcast(w, mesh)
    # VIOLATION (replicated-psum): every shard holds the same w, so the
    # sum counts it D times
    wsum = psum([v.sum() for v in ws], mesh)
    # VIOLATION (unbound-axis): "nodez" is declared by no mesh
    hi = pmax([x.max() for x in xs], mesh, "nodez")
    # VIOLATION (replicated-gather): total is already on every shard
    stacked = all_gather(total, mesh)
    # VIOLATION (gather-axis-misuse): dim is a tensor dimension, an int
    cols = gather_cat(xs, mesh, dim=NODE_AXIS)
    return total[0] + wsum[0] + hi[0] + stacked[0].sum() + cols.sum()


def local_max_as_global(snapshot, mesh):
    shards = shard_snapshot(snapshot, mesh)
    his = [s.cpu_pct.max() for s in shards]
    # VIOLATION (shard-as-global, sharded): shard 0's local maximum
    # ships as the global one
    return his[0] * 1.0


def offset_as_global(snapshot, mesh):
    shards = shard_snapshot(snapshot, mesh)
    n_local = shards[0].cpu_pct.shape[0]
    picks = [s.cpu_pct.argmax() + k * n_local for k, s in enumerate(shards)]
    # VIOLATION (shard-as-global, varying): shard 0's pick in global
    # columns stored in the result without an election
    return PickResult(node=picks[0])
