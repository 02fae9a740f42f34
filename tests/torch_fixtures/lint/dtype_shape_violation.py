"""Lint fixture: float64 in engine code (never imported)."""

import numpy as np
import torch


def promote(x):
    return x.to(torch.float64)


def double(x):
    return x.double()


def ctor(n):
    return torch.zeros(n, dtype=torch.double)


def host_table(n):
    return np.zeros(n, dtype=float)


def cast(a):
    return a.astype("float64")
