"""Lint fixture: host-transfer clean patterns (never imported)."""

import numpy as np
import torch


def shapes(x: torch.Tensor):
    n = x.shape[0]
    if n > 4 and x.size(1) > 2 and x.dim() == 2:
        return int(x.numel())
    return n


def identity(x, prior=None):
    y = torch.zeros(3)
    if prior is None:
        prior = y
    return prior


def fixed_shape_mask(x: torch.Tensor):
    return torch.where(x > 0, x, torch.zeros_like(x))


def host_values(rows):
    arr = np.asarray(rows)
    if arr.any():
        return float(arr.sum())
    return 0.0


def not_a_tensor(leaf):
    if isinstance(leaf, torch.Tensor):
        return leaf * 2
    return np.asarray(leaf)


def flag(x: torch.Tensor) -> bool:
    # graftlint: disable=host-transfer -- fixture: the one read, by contract
    return bool(x.any())


def caller(x: torch.Tensor):
    need = flag(x)
    if need:
        return x
    return None
