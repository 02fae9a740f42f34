"""Device meshes and their collectives (counterpart of
kubernetes_scheduler_tpu/parallel/mesh.py).

A mesh is a grid of torch devices with named axes: one axis, `node`, by
default (make_mesh), or (`dcn`, `node`) for the reference's slice spanning
hosts (make_mesh_multihost). The sharded engine is single-controller, as
the reference's is: one process holds every shard and calls one engine
object, so a collective is a function over the per-shard tensors. Shard k
is the mesh's k-th device in row-major order, the node order of the
reference's PartitionSpec((outer, inner)), so a (2, 2) mesh and a 1-D mesh
over the same four devices hold the same node blocks.

A collective reduces over every axis of the mesh: each shard's value moves
to the lead device, the reduction runs there in shard order, and the
result is copied back to every shard without blocking the host. Nothing is
read to the host. psum and pmax may instead name some of the axes, as
jax.lax.psum(x, axis_name) does: over `node` alone on a (dp, node) mesh
each dp row reduces apart, on its first device, in shard order.

A mesh may name one device several times: one card (or the CPU) then
holds several shards, the counterpart of the reference's virtual CPU
devices. Copies between shards on one device are no-ops.

set_observer installs a callable told of every collective called from
outside this module, with its call site (the collective budget of
analysis/contracts.py); with none installed a collective pays one
`is None` check.
"""

from __future__ import annotations

import functools
import math
import sys

import numpy as np
import torch

from kubernetes_scheduler_tpu_torch.device import resolve_device

NODE_AXIS = "node"
# the outer axis of the reference's mesh across hosts
DCN_AXIS = "dcn"
# the pod (data-parallel) axis of the learned scorer's training mesh
DP_AXIS = "dp"


class Mesh:
    """Torch devices on a grid of named axes, listed in row-major order:
    `shape` (default (len(devices),)) and `axis_names` (default
    (NODE_AXIS,)). A node-sharded program over the mesh gives shard k the
    nodes [k * n_local, (k + 1) * n_local)."""

    def __init__(self, devices, shape=None, axis_names=None):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.shape = (len(self.devices),) if shape is None else tuple(int(s) for s in shape)
        self.axis_names = (NODE_AXIS,) if axis_names is None else tuple(axis_names)
        if (math.prod(self.shape) != len(self.devices)
                or len(self.shape) != len(self.axis_names)
                or len(set(self.axis_names)) != len(self.axis_names)):
            raise ValueError(
                f"{len(self.devices)} devices do not fill the shape {self.shape} with "
                f"distinct axes {self.axis_names}"
            )

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def lead(self) -> torch.device:
        """The device collectives reduce on and results are returned on."""
        return self.devices[0]

    def axes(self, names) -> tuple:
        """`names` (one axis name or a tuple) as a tuple, ValueError naming
        any axis the mesh lacks."""
        names = names if isinstance(names, tuple) else (names,)
        missing = [a for a in names if a not in self.axis_names]
        if missing:
            raise ValueError(f"mesh {self.axis_names} lacks axes {missing}")
        return names

    def blocks(self, names=None) -> list:
        """The shard indices of each group a reduction over the axes
        `names` (default every axis) runs within, in shard order: one group
        of every shard for every axis, else one group per index of the
        other axes."""
        if names is None:
            return [list(range(self.size))]
        named = [self.axis_names.index(a) for a in self.axes(names)]
        rest = [i for i in range(len(self.shape)) if i not in named]
        grid = np.arange(self.size).reshape(self.shape).transpose(rest + sorted(named))
        return grid.reshape(-1, math.prod(self.shape[i] for i in named)).tolist()

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]}, shape={self.shape}, axes={self.axis_names})"


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
    return Mesh([_one_device(device)] * (1 if n_devices is None else int(n_devices)))


def make_mesh_multihost(n_hosts: int, devices_per_host: int | None = None, *,
                        device=None) -> Mesh:
    """A 2-D (hosts, devices per host) mesh over (DCN_AXIS, NODE_AXIS), the
    reference's mesh for a slice spanning hosts; the node axis shards over
    both (ShardedEngine(mesh, node_axes=(DCN_AXIS, NODE_AXIS))). The port
    is single-controller, so the grid is of the devices this process sees.
    Without `device`: the first n_hosts x devices_per_host visible CUDA
    devices (devices_per_host default: visible // n_hosts), ValueError
    when fewer are visible, RuntimeError without CUDA. With `device`: that
    one device n_hosts x devices_per_host times (devices_per_host
    required)."""
    if device is None:
        resolve_device("cuda")
        have = torch.cuda.device_count()
        if devices_per_host is None:
            devices_per_host = have // n_hosts
        need = n_hosts * devices_per_host
        if have < need:
            raise ValueError(f"need {need} devices, have {have}")
        devices = [torch.device("cuda", i) for i in range(need)]
    else:
        if devices_per_host is None:
            raise ValueError("make_mesh_multihost(device=...) needs devices_per_host")
        devices = [_one_device(device)] * (n_hosts * devices_per_host)
    return Mesh(devices, (n_hosts, devices_per_host), (DCN_AXIS, NODE_AXIS))


def _one_device(device) -> torch.device:
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


# ---- collectives ----------------------------------------------------------------

# None, or observer(kind, filename, lineno), told of each collective at its
# call site outside this module (set_observer)
_observer = None


def set_observer(observer):
    """Install `observer(kind, filename, lineno)` (None removes it) and
    return the one it replaces. It is told of each collective whose
    caller lies outside this module, so a collective that another one
    calls (to_lead inside all_gather, gather_cat and reduce_lead) is not
    told twice."""
    global _observer
    previous, _observer = _observer, observer
    return previous


def _observe(kind: str) -> None:
    # frame 0 is this function, frame 1 the collective, frame 2 its caller
    caller = sys._getframe(2)
    if caller.f_code.co_filename != __file__:
        _observer(kind, caller.f_code.co_filename, caller.f_lineno)


def broadcast(x: torch.Tensor, mesh: Mesh) -> list:
    """[x on every shard's device]: the same tensor where the device is
    x's own, a non-blocking copy elsewhere."""
    if _observer is not None:
        _observe("broadcast")
    return [x.to(d, non_blocking=True) for d in mesh.devices]


def to_lead(xs, mesh: Mesh) -> list:
    if _observer is not None:
        _observe("to_lead")
    return [x.to(mesh.lead, non_blocking=True) for x in xs]


def reduce_lead(op, xs, mesh: Mesh) -> torch.Tensor:
    """op over every shard's value, in shard order, on the lead device."""
    if _observer is not None:
        _observe("reduce_lead")
    return functools.reduce(op, to_lead(xs, mesh))


def _reduce(op, xs, mesh: Mesh, axes=None) -> list:
    out = [None] * mesh.size
    for group in mesh.blocks(axes):
        first = mesh.devices[group[0]]
        y = functools.reduce(op, [xs[i].to(first, non_blocking=True) for i in group])
        for i in group:
            out[i] = y.to(mesh.devices[i], non_blocking=True)
    return out


def psum(xs, mesh: Mesh, axes=None) -> list:
    """The shards' values summed in shard order over `axes` (default
    every axis), on every shard."""
    if _observer is not None:
        _observe("psum")
    return _reduce(torch.add, xs, mesh, axes)


def pmax(xs, mesh: Mesh, axes=None) -> list:
    if _observer is not None:
        _observe("pmax")
    return _reduce(torch.maximum, xs, mesh, axes)


def pmin(xs, mesh: Mesh) -> list:
    if _observer is not None:
        _observe("pmin")
    return _reduce(torch.minimum, xs, mesh)


def all_gather(xs, mesh: Mesh) -> list:
    """[D, ...] stack of the shards' values in shard order, on every shard."""
    if _observer is not None:
        _observe("all_gather")
    return broadcast(torch.stack(to_lead(xs, mesh)), mesh)


def gather_cat(xs, mesh: Mesh, dim: int = 0) -> torch.Tensor:
    """The shards' values concatenated along `dim` on the lead device: the
    dense array, so a reduction over it is bitwise the dense reduction."""
    if _observer is not None:
        _observe("gather_cat")
    return torch.cat(to_lead(xs, mesh), dim=dim)
