"""spmd-collective clean fixture: the violating fixture's pipeline done
right — sums over sharded lists only, declared axis names, gathers of
per-shard values, gather_cat along a tensor dimension, and global
answers joined or reduced from every shard. Never imported, only parsed."""

from typing import NamedTuple

import torch

from kubernetes_scheduler_tpu_torch.parallel.engine import shard_snapshot
from kubernetes_scheduler_tpu_torch.parallel.mesh import (
    Mesh,
    broadcast,
    gather_cat,
    pmax,
    psum,
    reduce_lead,
    to_lead,
)

NODE_AXIS = "node"


class PickResult(NamedTuple):
    node: torch.Tensor


def make_mesh(device):
    return Mesh([device] * 4, (4,), (NODE_AXIS,))


def good_stats(snapshot, w, mesh):
    shards = shard_snapshot(snapshot, mesh)
    xs = [s.cpu_pct for s in shards]
    total = psum([x.sum() for x in xs], mesh, NODE_AXIS)
    # the replicated weight is used as it is
    ws = broadcast(w, mesh)
    scaled = [x * v.sum() for x, v in zip(xs, ws)]
    hi = pmax([x.max() for x in scaled], mesh, NODE_AXIS)
    cols = gather_cat(scaled, mesh, dim=0)
    return total[0] + hi[0] + cols.sum()


def global_max(snapshot, mesh):
    shards = shard_snapshot(snapshot, mesh)
    return reduce_lead(torch.maximum, [s.cpu_pct.max() for s in shards], mesh)


def elected_pick(snapshot, mesh):
    shards = shard_snapshot(snapshot, mesh)
    n_local = shards[0].cpu_pct.shape[0]
    vals = torch.stack(to_lead([s.cpu_pct.max() for s in shards], mesh))
    picks = torch.cat(to_lead(
        [(s.cpu_pct.argmax() + k * n_local).view(1) for k, s in enumerate(shards)], mesh))
    return PickResult(node=picks[torch.argmax(vals)])
