"""Device resolution for the port's entry points.

Every entry point takes `device=`. With no argument it runs on the CUDA
card and raises when there is none: the port never falls back to the CPU
on its own. Tests and CPU callers pass `device="cpu"` explicitly.
"""

from __future__ import annotations

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
