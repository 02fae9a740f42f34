"""Constraint families (counterpart of kubernetes_scheduler_tpu/ops/constraints.py):
the hard masks (taints, node affinity, nodeName, and the count-based
inter-pod (anti)affinity and topology spread against pre-window counts)
and the soft score terms (PreferNoSchedule taints, preferred node and
inter-pod (anti)affinity), which score and never filter.

Encoding (the host interns strings to int32 ids; -1 is "absent"):

- taints[n, T, 3]: (key_id, value_id, effect), effect in {1=NoSchedule,
  2=PreferNoSchedule, 3=NoExecute}; taint_mask[n, T].
- tolerations[p, L, 4]: (key_id, value_id, op, effect); op in {0=Exists,
  1=Equal}; key_id -1 with Exists tolerates everything; effect 0 = all
  effects; tol_mask[p, L].
- node labels: node_labels[n, Ln, 2] (key_id, value_id), node_label_mask.
- node-affinity expressions: (key_id, op, values[V]) with op in {0=In,
  1=NotIn, 2=Exists, 3=DoesNotExist}, grouped into OR'd terms by id.
- inter-pod (anti)affinity: domain_counts[n, s] = running pods matching
  selector s in node n's topology domain; pods carry selector ids
  (-1 padded).
"""

from __future__ import annotations

import torch

from kubernetes_scheduler_tpu_torch.ops.assign import spread_ok_batched

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


def _term_groups(ok, expr_mask, expr_term):
    """(member [p, E, G], group_fail [p, G, n], group_has [p, G]): the
    expressions of each OR-group / preferred term (ids in [0, E)), whether
    some expression of the group fails on each node (one batched
    contraction of 0/1 values, exact), and whether the group exists."""
    e = expr_term.shape[1]
    groups = torch.arange(e, device=expr_term.device)
    member = (expr_term[:, :, None] == groups) & expr_mask[:, :, None]  # [p, E, G]
    fail = expr_mask[:, :, None] & ~ok                                  # [p, E, n]
    group_fail = (
        torch.einsum("peg,pen->pgn", member.float(), fail.float()) > 0
    )
    return member, group_fail, member.any(1)


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
    _, group_fail, group_has = _term_groups(ok, expr_mask, expr_term)
    term_ok = group_has[:, :, None] & ~group_fail
    no_terms = ~group_has.any(1)
    return term_ok.any(1) | no_terms[:, None]


def node_affinity_preference(
    node_labels: torch.Tensor,
    node_label_mask: torch.Tensor,
    expr_key: torch.Tensor,
    expr_op: torch.Tensor,
    expr_vals: torch.Tensor,
    expr_val_mask: torch.Tensor,
    expr_mask: torch.Tensor,
    expr_weight: torch.Tensor,
    expr_term: torch.Tensor | None = None,
) -> torch.Tensor:
    """[p, n] float32 preferred node-affinity score (upstream NodeAffinity
    scoring): each preferred term, an AND-list of the expressions sharing
    a group id in expr_term [p, E], adds its weight once where every one
    of its expressions holds. Weights are per term (the largest of the
    group's, as in the reference); expr_term None makes each expression
    its own term."""
    ok = _expressions_satisfied(
        node_labels, node_label_mask, expr_key, expr_op, expr_vals, expr_val_mask
    )
    weight = expr_weight.to(torch.float32)
    if expr_term is None:
        w = torch.where(expr_mask, weight, 0.0)                          # [p, E]
        return (ok * w[:, :, None]).sum(1)
    member, group_fail, group_has = _term_groups(ok, expr_mask, expr_term)
    group_w = torch.where(member, weight[:, :, None], 0.0).amax(1)      # [p, G]
    sat = group_has[:, :, None] & ~group_fail
    return (sat * group_w[:, :, None]).sum(1)


def prefer_no_schedule_penalty(
    taints: torch.Tensor,
    taint_mask: torch.Tensor,
    tolerations: torch.Tensor,
    tol_mask: torch.Tensor,
) -> torch.Tensor:
    """[p, n] float32 count of untolerated PreferNoSchedule taints
    (upstream TaintToleration scoring); callers subtract a weighted
    multiple. Never filters."""
    tolerated = _taints_tolerated(taints, tolerations, tol_mask)
    soft = taint_mask[None, :, :] & (taints[..., 2] == PREFER_NO_SCHEDULE)[None, :, :]
    return (soft & ~tolerated).sum(-1).to(torch.float32)


def pod_affinity_preference(
    domain_counts: torch.Tensor,
    pref_affinity_sel: torch.Tensor,
    pref_affinity_weight: torch.Tensor,
    pref_anti_sel: torch.Tensor,
    pref_anti_weight: torch.Tensor,
) -> torch.Tensor:
    """[p, n] float32 preferred inter-pod (anti)affinity (upstream
    InterPodAffinity scoring): +weight for each preferred selector with a
    match in the node's topology domain, -weight for each preferred anti
    selector with one. Selector ids are -1 padded; an id outside [0, S)
    adds nothing (a stale preference never makes a pod unschedulable,
    unlike pod_affinity_fit)."""
    s = domain_counts.shape[1]

    def term(sel, weight, sign):
        ok = (sel >= 0) & (sel < s)                                     # [p, K]
        idx = torch.clamp(sel, 0, max(s - 1, 0)).long()
        present = domain_counts[:, idx] > 0                             # [n, p, K]
        w = torch.where(ok, weight.to(torch.float32), 0.0)
        return sign * (present * w[None, :, :]).sum(-1).T               # [p, n]

    return term(pref_affinity_sel, pref_affinity_weight, 1.0) + term(
        pref_anti_sel, pref_anti_weight, -1.0
    )


def pod_affinity_fit(
    domain_counts: torch.Tensor,
    affinity_sel: torch.Tensor,
    anti_affinity_sel: torch.Tensor,
) -> torch.Tensor:
    """F[p, n] from pre-window topology-domain match counts [n, S]: every
    selector of affinity_sel [p, K] has a match in the node's domain and
    none of anti_affinity_sel [p, K] has one (-1 padded). A selector id
    >= S (a pod batch built against another snapshot's selector table)
    is unsatisfiable: the pod is infeasible everywhere."""
    s = domain_counts.shape[1]
    aff = torch.clamp(affinity_sel, 0, max(s - 1, 0)).long()
    aff_ok = (domain_counts[:, aff] > 0) | (affinity_sel[None, :, :] < 0)     # [n, p, K]
    anti = torch.clamp(anti_affinity_sel, 0, max(s - 1, 0)).long()
    anti_ok = (domain_counts[:, anti] == 0) | (anti_affinity_sel[None, :, :] < 0)
    valid = ~((affinity_sel >= s).any(-1) | (anti_affinity_sel >= s).any(-1))
    return (aff_ok & anti_ok).all(-1).T & valid[:, None]


def topology_spread_fit(
    domain_counts: torch.Tensor,
    node_mask: torch.Tensor,
    spread_sel: torch.Tensor,
    spread_max: torch.Tensor,
) -> torch.Tensor:
    """F[p, n]: hard topologySpreadConstraints (upstream PodTopologySpread,
    DoNotSchedule): count + 1 - min over schedulable domains <= maxSkew
    for every constraint; out-of-range selector ids are unsatisfiable.
    The same function as the assigners' live-count form."""
    return spread_ok_batched(domain_counts, node_mask, spread_sel, spread_max)


def node_name_fit(target_node: torch.Tensor, n: int) -> torch.Tensor:
    """F[p, n] for spec.nodeName pinning: -1 unpinned (every node ok), an
    index pins to that node, a value >= n matches nothing."""
    cols = torch.arange(n, device=target_node.device)[None, :]
    return (target_node[:, None] < 0) | (cols == target_node[:, None])
