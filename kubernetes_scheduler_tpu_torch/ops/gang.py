"""Gang co-scheduling, all-or-nothing pod groups (counterpart of
kubernetes_scheduler_tpu/ops/gang.py: `gang_mask_assign`, `decode_masked`
and the host's numpy mirror `mask_partial_gangs_np`).

A gang whose assigned-member count falls short of its declared size has
every assigned member's placement rescinded before the result leaves the
engine. Rescinded entries are encoded GANG_MASKED_BASE - node_idx (<= -2)
so the would-have node stays decodable; -1 stays "no node found".
"""

from __future__ import annotations

import numpy as np
import torch

GANG_MASKED_BASE = -2


def decode_masked(idx):
    """The node a masked (<= -2) entry would have been assigned to. Works
    on numpy arrays and tensors alike (pure arithmetic; its own inverse)."""
    return GANG_MASKED_BASE - idx


def gang_mask_assign(
    gang_id: torch.Tensor,
    gang_size: torch.Tensor,
    pod_mask: torch.Tensor,
    node_idx: torch.Tensor,
    request: torch.Tensor,
    free_after: torch.Tensor,
    n_assigned: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(node_idx', free_after', n_assigned'): members of incomplete gangs
    are rescinded (sentinel-encoded), their requests handed back to
    free_after, and n_assigned recounted. Every step is a select, so a
    gang-free window passes through bit-identical, with no host sync."""
    p = node_idx.shape[0]
    n = free_after.shape[0]
    has = (gang_id >= 0) & pod_mask
    assigned = node_idx >= 0
    # assigned members per gang slot; pad slot p absorbs non-members
    slot = torch.where(has & assigned, torch.clamp(gang_id, 0, p - 1), p).long()
    cnt = torch.zeros(p + 1, dtype=torch.int32, device=node_idx.device)
    cnt.index_add_(0, slot, torch.ones(p, dtype=torch.int32, device=node_idx.device))
    complete = cnt[torch.clamp(gang_id, 0, max(p - 1, 0)).long()] >= gang_size
    mask_out = has & assigned & ~complete
    new_idx = torch.where(mask_out, GANG_MASKED_BASE - node_idx, node_idx)
    any_masked = mask_out.any()
    # capacity give-back; row n collects (and drops) the untouched pods
    rows = torch.where(mask_out, node_idx, n).long()
    freed = torch.zeros(n + 1, free_after.shape[1], dtype=free_after.dtype,
                        device=free_after.device)
    freed.index_add_(0, rows, torch.where(mask_out[:, None], request, 0.0))
    free_after = torch.where(any_masked, free_after + freed[:n], free_after)
    n_assigned = torch.where(
        any_masked,
        ((new_idx >= 0) & pod_mask).sum().to(torch.int32),
        n_assigned,
    )
    return new_idx, free_after, n_assigned


def mask_partial_gangs_np(gang_id, gang_size, node_idx):
    """Host (numpy) mirror of the all-or-nothing rule, the unconditional
    backstop in host.scheduler._resolve_gangs: against a gang-capable
    engine it is the identity (gang_mask_assign already rescinded the
    placements), against a gang-blind one it gives the same masked vector
    the engine would have, bitwise. Returns (node_idx', newly_masked)."""
    idx = np.asarray(node_idx).copy()
    gid = np.asarray(gang_id)
    gsz = np.asarray(gang_size)
    n = min(idx.shape[0], gid.shape[0])
    newly = 0
    for g in np.unique(gid[:n]):
        if g < 0:
            continue
        rows = np.flatnonzero(gid[:n] == g)
        got = idx[rows]
        cnt = int((got >= 0).sum())
        # per-lane size check, exactly like gang_mask_assign's
        # `cnt[gang] >= gang_size` select: members declaring inconsistent
        # sizes mask lane-wise, so the mirror stays bitwise on any input
        bad = rows[(got >= 0) & (cnt < gsz[rows])]
        idx[bad] = GANG_MASKED_BASE - idx[bad]
        newly += int(bad.size)
    return idx, newly
