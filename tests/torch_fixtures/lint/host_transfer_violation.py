"""Lint fixture: implicit device-to-host syncs on tensors (never
imported)."""

import numpy as np
import torch


def scalar_read(x):
    total = torch.sum(x)
    return total.item()


def convert(x: torch.Tensor):
    m = x.max()
    return float(m)


def copy(x: torch.Tensor):
    return np.asarray(x)


def branch(scores: torch.Tensor):
    best = scores.amax(1)
    if (best > 0).any():
        return best
    return None


def bare_branch(x):
    flag = torch.any(x > 0)
    while flag:
        flag = torch.any(x > 1)
    return flag


def mask_index(x: torch.Tensor):
    keep = x > 0
    return x[keep]


def inline_mask(x: torch.Tensor):
    return x[x > 0]


def data_shapes(x: torch.Tensor):
    idx = x.nonzero()
    vals = torch.unique(x)
    sel = torch.masked_select(x, x > 0)
    return idx, vals, sel


def host_move(x: torch.Tensor):
    return x.to("cpu"), x.tolist()


def narrowed(leaf):
    if isinstance(leaf, torch.Tensor):
        return leaf.cpu()
    return leaf


def helper() -> torch.Tensor:
    return torch.zeros(3)


def through_helper():
    t = helper()
    return int(t)
