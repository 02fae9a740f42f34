"""Device resolution for the port's entry points.

Every entry point takes `device=`. With no argument it runs on the CUDA
card and raises when there is none: the port never falls back to the CPU
on its own. Tests and CPU callers pass `device="cpu"` explicitly.
Host data reaches the card through `to_device`, which counts the bytes;
results come back through `to_host`, one explicit read per result.
"""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The torch.device an entry point runs on: `cuda` by default.

    Raises RuntimeError when CUDA is asked for (explicitly or by default)
    and this process has no usable CUDA device."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain PyTorch path on the CPU"
        )
    return dev


# host-to-device copies made through to_device since the last
# reset_transfers() (chip_smoke.py reads them per cycle)
transfers = {"h2d_bytes": 0, "h2d_copies": 0, "d2h_reads": 0}


def reset_transfers() -> None:
    for name in transfers:
        transfers[name] = 0


def to_device(a, device: torch.device) -> torch.Tensor:
    """A private tensor on `device` with the values of host array `a` (a
    numpy array or a CPU tensor; the caller may reuse it afterwards). To
    a CUDA device the copy goes through pinned host memory without
    blocking the host (PyTorch's pinned allocator keeps the buffer until
    the copy has run), and counts in `transfers`: every upload of the
    port's host data passes here."""
    if isinstance(a, np.ndarray) and not a.flags.writeable:
        # a view of a decoded journal's bytes: torch wants a writable
        # buffer, so copy (the builders' arrays never take this branch)
        a = np.array(a)
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(a))
    if device.type != "cuda":
        return t.to(device).clone()
    transfers["h2d_bytes"] += t.numel() * t.element_size()
    transfers["h2d_copies"] += 1
    return t.pin_memory().to(device, non_blocking=True)


def to_host(*leaves):
    """numpy copies of result leaves (tensors on any device, or host
    arrays), as one explicit device-to-host read: the host loop's only
    wait on the card for an engine result. One leaf gives one array,
    several a tuple. A read that touches a CUDA tensor counts in
    `transfers["d2h_reads"]`."""
    out = []
    cuda = False
    for x in leaves:
        if isinstance(x, torch.Tensor):
            cuda = cuda or x.device.type == "cuda"
            out.append(x.detach().cpu().numpy())
        else:
            out.append(np.asarray(x))
    if cuda:
        transfers["d2h_reads"] += 1
    return out[0] if len(out) == 1 else tuple(out)
