"""Lint fixture: host-sync clean patterns (never imported)."""

import numpy as np
import torch


def bulk_read(scores):
    # one bulk read, then a loop over host values
    host = scores.cpu().numpy()
    return [float(v) for v in host]


def hoisted_iterable(scores):
    # the loop's source is evaluated once: the recommended hoist
    return [v * 2 for v in scores.tolist()]


def bulk_asarray(leaves):
    stacked = np.asarray(torch.stack(leaves).cpu())
    return [row.sum() for row in stacked]


def host_numpy_waived(leaves):
    # graftlint: disable=host-sync -- leaves are host numpy by construction
    return [np.asarray(x) for x in leaves]
