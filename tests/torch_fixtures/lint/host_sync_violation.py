"""Lint fixture: host-sync violations in torch terms (never imported)."""

import numpy as np
import torch


def barrier(x):
    y = x * 2
    torch.cuda.synchronize()
    return y


def event_wait(stream):
    ev = torch.cuda.Event()
    ev.record(stream)
    ev.synchronize()


def per_element(scores):
    out = []
    for i in range(scores.shape[0]):
        out.append(scores[i].item())
    return out


def per_row_copy(rows):
    return [r.cpu() for r in rows]


def per_row_list(rows):
    total = []
    while rows:
        total.extend(rows.pop().tolist())
    return total


def per_row_numpy(rows):
    return {k: v.numpy() for k, v in rows.items()}


def asarray_in_loop(leaves):
    return [np.asarray(x) for x in leaves]
