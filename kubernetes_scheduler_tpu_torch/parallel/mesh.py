"""Device meshes and their collectives (counterpart of
kubernetes_scheduler_tpu/parallel/mesh.py).

One logical axis, `node`: the cluster-node dimension is split into
contiguous shards, one per mesh device. The sharded engine is
single-controller, as the reference's is: one process holds every shard
and calls one engine object, so a mesh here is an ordered list of torch
devices, and a collective is a function over the per-shard tensors: each
shard's value moves to the lead device, the reduction runs there in shard
order, and the result is copied back to every shard without blocking the
host. Nothing is read to the host.

A mesh may name one device several times: one card (or the CPU) then
holds several shards, the counterpart of the reference's virtual CPU
devices. Copies between shards on one device are no-ops.
"""

from __future__ import annotations

import functools

import torch

from kubernetes_scheduler_tpu_torch.device import resolve_device

NODE_AXIS = "node"


class Mesh:
    """An ordered list of torch devices, one per node shard: shard k holds
    nodes [k * n_local, (k + 1) * n_local)."""

    def __init__(self, devices):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def lead(self) -> torch.device:
        """The device collectives reduce on and results are returned on."""
        return self.devices[0]

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]})"


def make_mesh(n_devices: int | None = None, *, device=None) -> Mesh:
    """A 1-D mesh over NODE_AXIS. Without `device`: the first `n_devices` visible CUDA
    devices (default all), RuntimeError without CUDA or when fewer are
    visible. With `device` (e.g. "cpu" or "cuda:0"): that one device
    `n_devices` times (default 1), several shards on one device."""
    if device is None:
        resolve_device("cuda")
        have = torch.cuda.device_count()
        n = have if n_devices is None else int(n_devices)
        if not 1 <= n <= have:
            raise RuntimeError(
                f"make_mesh({n}) needs {n} CUDA devices, {have} visible; pass "
                "device= to put several shards on one device"
            )
        return Mesh([torch.device("cuda", i) for i in range(n)])
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return Mesh([dev] * (1 if n_devices is None else int(n_devices)))


def broadcast(x: torch.Tensor, mesh: Mesh) -> list:
    """[x on every shard's device]: the same tensor where the device is
    x's own, a non-blocking copy elsewhere."""
    return [x.to(d, non_blocking=True) for d in mesh.devices]


def to_lead(xs, mesh: Mesh) -> list:
    return [x.to(mesh.lead, non_blocking=True) for x in xs]


def _reduce(op, xs, mesh: Mesh) -> list:
    return broadcast(functools.reduce(op, to_lead(xs, mesh)), mesh)


def psum(xs, mesh: Mesh) -> list:
    """The shards' values summed in shard order, on every shard."""
    return _reduce(torch.add, xs, mesh)


def pmax(xs, mesh: Mesh) -> list:
    return _reduce(torch.maximum, xs, mesh)


def pmin(xs, mesh: Mesh) -> list:
    return _reduce(torch.minimum, xs, mesh)


def all_gather(xs, mesh: Mesh) -> list:
    """[D, ...] stack of the shards' values in shard order, on every shard."""
    return broadcast(torch.stack(to_lead(xs, mesh)), mesh)


def gather_cat(xs, mesh: Mesh, dim: int = 0) -> torch.Tensor:
    """The shards' values concatenated along `dim` on the lead device: the
    dense array, so a reduction over it is bitwise the dense reduction."""
    return torch.cat(to_lead(xs, mesh), dim=dim)
