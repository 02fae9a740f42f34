"""Taint/toleration, node-affinity and nodeName masks (counterpart of
kubernetes_scheduler_tpu/ops/constraints.py, the filters on the fused path).

Encoding (the host interns strings to int32 ids; -1 is "absent"):

- taints[n, T, 3]: (key_id, value_id, effect), effect in {1=NoSchedule,
  2=PreferNoSchedule, 3=NoExecute}; taint_mask[n, T].
- tolerations[p, L, 4]: (key_id, value_id, op, effect); op in {0=Exists,
  1=Equal}; key_id -1 with Exists tolerates everything; effect 0 = all
  effects; tol_mask[p, L].
- node labels: node_labels[n, Ln, 2] (key_id, value_id), node_label_mask.
- node-affinity expressions: (key_id, op, values[V]) with op in {0=In,
  1=NotIn, 2=Exists, 3=DoesNotExist}, grouped into OR'd terms by id.
"""

from __future__ import annotations

import torch

# taint effects
NO_SCHEDULE = 1
PREFER_NO_SCHEDULE = 2
NO_EXECUTE = 3
# toleration operators
TOL_EXISTS = 0
TOL_EQUAL = 1
# node-affinity expression operators
OP_IN = 0
OP_NOT_IN = 1
OP_EXISTS = 2
OP_NOT_EXISTS = 3


def _taints_tolerated(
    taints: torch.Tensor, tolerations: torch.Tensor, tol_mask: torch.Tensor
) -> torch.Tensor:
    """[p, n, T] bool: taint t of node n is tolerated by some toleration
    of pod p (upstream v1.Toleration.ToleratesTaint)."""
    t_key = taints[..., 0][None, :, :, None]       # [1, n, T, 1]
    t_val = taints[..., 1][None, :, :, None]
    t_eff = taints[..., 2][None, :, :, None]
    o_key = tolerations[..., 0][:, None, None, :]  # [p, 1, 1, L]
    o_val = tolerations[..., 1][:, None, None, :]
    o_op = tolerations[..., 2][:, None, None, :]
    o_eff = tolerations[..., 3][:, None, None, :]

    wildcard_key = (o_key == -1) & (o_op == TOL_EXISTS)
    key_ok = wildcard_key | (
        (o_key == t_key) & ((o_op == TOL_EXISTS) | (o_val == t_val))
    )
    eff_ok = (o_eff == 0) | (o_eff == t_eff)
    matches = key_ok & eff_ok & tol_mask[:, None, None, :]  # [p, n, T, L]
    return matches.any(-1)


def taint_toleration_fit(
    taints: torch.Tensor,
    taint_mask: torch.Tensor,
    tolerations: torch.Tensor,
    tol_mask: torch.Tensor,
) -> torch.Tensor:
    """F[p, n]: no untolerated NoSchedule/NoExecute taint (PreferNoSchedule
    never filters)."""
    tolerated = _taints_tolerated(taints, tolerations, tol_mask)
    effect = taints[..., 2]
    hard = taint_mask[None, :, :] & (
        (effect == NO_SCHEDULE) | (effect == NO_EXECUTE)
    )[None, :, :]
    return ~(hard & ~tolerated).any(-1)


def _expressions_satisfied(
    node_labels: torch.Tensor,
    node_label_mask: torch.Tensor,
    expr_key: torch.Tensor,
    expr_op: torch.Tensor,
    expr_vals: torch.Tensor,
    expr_val_mask: torch.Tensor,
) -> torch.Tensor:
    """[p, E, n] bool: the node satisfies each matchExpression (padding is
    the caller's to mask)."""
    n_key = node_labels[..., 0]  # [n, Ln]
    n_val = node_labels[..., 1]
    key_eq = (
        n_key[None, None, :, :] == expr_key[:, :, None, None]
    ) & node_label_mask[None, None, :, :]                      # [p, E, n, Ln]
    has_key = key_eq.any(-1)                                   # [p, E, n]
    val_in_set = (
        n_val[None, None, :, :, None] == expr_vals[:, :, None, None, :]
    ) & expr_val_mask[:, :, None, None, :]                     # [p, E, n, Ln, V]
    key_val_match = (key_eq[..., None] & val_in_set).any(-1).any(-1)

    op = expr_op[:, :, None]
    return torch.where(
        op == OP_IN,
        key_val_match,
        torch.where(
            op == OP_NOT_IN,
            ~key_val_match,
            torch.where(op == OP_EXISTS, has_key, ~has_key),
        ),
    )


def node_affinity_fit(
    node_labels: torch.Tensor,
    node_label_mask: torch.Tensor,
    expr_key: torch.Tensor,
    expr_op: torch.Tensor,
    expr_vals: torch.Tensor,
    expr_val_mask: torch.Tensor,
    expr_mask: torch.Tensor,
    expr_term: torch.Tensor,
) -> torch.Tensor:
    """F[p, n]: required node affinity with upstream OR-of-ANDs
    nodeSelectorTerms semantics: a node passes if it satisfies every
    expression of some term; a pod with no expressions passes everywhere.
    expr_term [p, E] holds OR-group ids in [0, E)."""
    ok = _expressions_satisfied(
        node_labels, node_label_mask, expr_key, expr_op, expr_vals, expr_val_mask
    )
    e = expr_key.shape[1]
    groups = torch.arange(e, device=expr_term.device)
    member = (expr_term[:, :, None] == groups) & expr_mask[:, :, None]  # [p, E, G]
    fail = expr_mask[:, :, None] & ~ok                                  # [p, E, n]
    group_fail = (
        torch.einsum("peg,pen->pgn", member.float(), fail.float()) > 0
    )                                                                   # [p, G, n]
    group_has = member.any(1)                                           # [p, G]
    term_ok = group_has[:, :, None] & ~group_fail
    no_terms = ~group_has.any(1)
    return term_ok.any(1) | no_terms[:, None]


def node_name_fit(target_node: torch.Tensor, n: int) -> torch.Tensor:
    """F[p, n] for spec.nodeName pinning: -1 unpinned (every node ok), an
    index pins to that node, a value >= n matches nothing."""
    cols = torch.arange(n, device=target_node.device)[None, :]
    return (target_node[:, None] < 0) | (cols == target_node[:, None])
