"""Lint fixture: float32 engine code (never imported)."""

import numpy as np
import torch


def f32(x):
    return x.to(torch.float32)


def ctor(n):
    return torch.zeros(n, dtype=torch.float32)


def host_table(n):
    return np.zeros(n, dtype=np.float32)


def cast(a):
    return a.astype("float32")


def waived(x):
    # graftlint: disable=dtype-shape -- fixture: a reference comparison in float64
    return x.double()
