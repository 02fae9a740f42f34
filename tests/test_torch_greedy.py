"""The port's greedy assigner (kubernetes_scheduler_tpu_torch/ops/assign.py
`greedy_assign`, kernel K4 `greedy_scan` in ops/fused.py) against the JAX
reference, on identical numpy inputs made from a seed.

Everything here is held bitwise: picks, node_idx and free_after. The
inputs are score matrices handed to both packages as they are, so no
score rounding differs between the two sides. On CPU tensors K4's wrapper
runs its plain version, which the CUDA kernel must equal bitwise on the
card (chip_smoke.py holds them).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from kubernetes_scheduler_tpu.ops import assign as rassign
from kubernetes_scheduler_tpu.ops.pallas_fused import fused_greedy_scan
from kubernetes_scheduler_tpu_torch.ops import assign, fused

SHAPES = [(17, 130, 3), (64, 256, 5), (128, 128, 1), (129, 127, 7), (3, 8, 2), (40, 1100, 3)]


def T(x):
    return torch.from_numpy(np.array(x))


def bits(x):
    return np.asarray(x).view(np.uint32)


def greedy_problem(p, n, r, seed):
    """The cases of tests/test_pallas.py's greedy-scan pin: exact ties
    between columns and between whole rows, an all-infeasible pod, zero
    requests, masked pods, and capacity that runs out."""
    rng = np.random.default_rng(seed)
    scores = rng.uniform(0, 10, (p, n)).astype(np.float32)
    scores[:, n // 2] = scores[:, n // 3]
    scores[p // 2] = scores[p // 3]
    feasible = rng.uniform(size=(p, n)) < 0.7
    feasible[-1] = False
    req = rng.uniform(0, 4, (p, r)).astype(np.float32)
    req[rng.uniform(size=(p, r)) < 0.3] = 0.0
    free = rng.uniform(1, 6, (n, r)).astype(np.float32)
    prio = rng.integers(-3, 3, p).astype(np.int32)
    mask = rng.uniform(size=p) < 0.9
    return scores, feasible, req, free, prio, mask


@pytest.mark.parametrize("p,n,r", SHAPES, ids=[f"p{p}-n{n}-r{r}" for p, n, r in SHAPES])
def test_torch_greedy_scan_plain_matches_reference(p, n, r):
    scores, feasible, req, free, prio, mask = greedy_problem(p, n, r, seed=p * 31 + n + r)
    order = np.asarray(rassign._priority_order(jnp.asarray(prio), jnp.asarray(mask)))
    sj = np.where(feasible & mask[:, None], scores, np.float32(rassign.NEG))[order]
    req_o = req[order]
    want_picks, want_free = fused_greedy_scan(
        jnp.asarray(sj), jnp.asarray(req_o), jnp.asarray(free), interpret=True
    )
    before = dict(fused.launches)
    picks, free_after = fused.greedy_scan(T(sj), T(req_o), T(free))
    assert fused.launches == before  # CPU tensors never launch a kernel
    assert picks.dtype == torch.int32 and free_after.dtype == torch.float32
    np.testing.assert_array_equal(picks.numpy(), np.asarray(want_picks))
    np.testing.assert_array_equal(bits(free_after.numpy()), bits(want_free))
    assert (picks.numpy() >= 0).any() and (picks.numpy() == -1).any()


@pytest.mark.parametrize("p,n,r", SHAPES, ids=[f"p{p}-n{n}-r{r}" for p, n, r in SHAPES])
def test_torch_greedy_assign_matches_reference(p, n, r):
    args = greedy_problem(p, n, r, seed=p + 7 * n + r)
    want = rassign.greedy_assign(*[jnp.asarray(a) for a in args], greedy_kernel=False)
    got = assign.greedy_assign(*[T(a) for a in args])
    np.testing.assert_array_equal(got.node_idx.numpy(), np.asarray(want.node_idx))
    np.testing.assert_array_equal(bits(got.free_after.numpy()), bits(want.free_after))
    assert int(got.n_assigned) == int(want.n_assigned)
    # the masked pods and the all-infeasible pod stay unassigned
    assert (got.node_idx.numpy()[~args[5]] == -1).all()
    assert got.node_idx.numpy()[-1] == -1


def test_torch_greedy_capacity_sequencing():
    """One-slot nodes admit exactly one pod each, in priority order, the
    capacity decremented between pods."""
    p, n = 6, 4
    scores = np.tile(np.array([4.0, 3.0, 2.0, 1.0], np.float32), (p, 1))
    args = (scores, np.ones((p, n), bool), np.ones((p, 1), np.float32),
            np.ones((n, 1), np.float32), np.array([0, 5, 3, 1, 2, 4], np.int32),
            np.ones(p, bool))
    want = rassign.greedy_assign(*[jnp.asarray(a) for a in args], greedy_kernel=False)
    got = assign.greedy_assign(*[T(a) for a in args])
    np.testing.assert_array_equal(got.node_idx.numpy(), np.asarray(want.node_idx))
    # priorities 5, 4, 3, 2 take nodes 0..3 in order; 1 and 0 find none
    np.testing.assert_array_equal(got.node_idx.numpy(), [-1, 0, 2, -1, 3, 1])
    assert int(got.n_assigned) == 4
    np.testing.assert_array_equal(got.free_after.numpy(), np.zeros((n, 1), np.float32))


def test_torch_greedy_scan_zero_requests_on_oversubscribed_nodes():
    """An unrequested resource never excludes a node, even where that
    resource is already oversubscribed (negative free capacity)."""
    rng = np.random.default_rng(11)
    p, n, r = 24, 50, 4
    sj = rng.uniform(0, 1, (p, n)).astype(np.float32)
    req = rng.integers(1, 3, (p, r)).astype(np.float32)
    req[:, 3] = 0.0
    free = rng.integers(0, 4, (n, r)).astype(np.float32)
    free[:, 3] = -2.0
    want_p, want_f = fused_greedy_scan(jnp.asarray(sj), jnp.asarray(req), jnp.asarray(free),
                                       interpret=True)
    picks, free_after = fused.greedy_scan(T(sj), T(req), T(free))
    np.testing.assert_array_equal(picks.numpy(), np.asarray(want_p))
    np.testing.assert_array_equal(bits(free_after.numpy()), bits(want_f))
    assert (picks.numpy() >= 0).sum() > p // 2
    assert (free_after.numpy()[:, :3] >= 0).all()


def affinity_problem(p, n, s, seed, *, k=2):
    """Random scores and capacity with an AffinityState whose domains are
    shared by groups of nodes (a different grouping per selector),
    per-node replicated base match and avoider counts, required and
    forbidden selectors (some stale ids >= S), pods matching selectors,
    hard spread constraints with planted maxSkew, and masked nodes."""
    rng = np.random.default_rng(seed)
    scores = rng.uniform(0, 10, (p, n)).astype(np.float32)
    scores[:, n // 2] = scores[:, n // 4]                 # exact ties
    feasible = rng.uniform(size=(p, n)) < 0.85
    req = rng.integers(0, 3, (p, 2)).astype(np.float32)
    free = rng.integers(1, 5, (n, 2)).astype(np.float32)
    prio = rng.integers(0, 4, p).astype(np.int32)
    mask = rng.uniform(size=p) < 0.9
    node_mask = rng.uniform(size=n) < 0.9
    group = rng.integers(1, 6, s)                         # nodes per domain, per selector
    dom = (np.arange(n)[:, None] // group[None, :]) * group[None, :]
    dom = dom.astype(np.int32)                            # representative = first member
    per_dom = lambda prob, hi: (rng.uniform(size=(n, s)) < prob) * rng.integers(1, hi, (n, s))  # noqa: E731
    base = per_dom(0.3, 3).astype(np.float32)
    avoid = per_dom(0.08, 2).astype(np.float32)
    cols = np.arange(s)[None, :]
    sel = lambda prob, hi: np.where(rng.uniform(size=(p, k)) < prob,  # noqa: E731
                                    rng.integers(0, hi, (p, k)), -1).astype(np.int32)
    anti = sel(0.2, s)
    spread_sel = sel(0.25, s)
    spread_sel[0, 0] = s + 1                              # a stale id: infeasible everywhere
    state = dict(
        domain_counts=base[dom, cols],                    # every member holds its domain's total
        domain_id=dom,
        pod_matches=rng.uniform(size=(p, s)) < 0.3,
        affinity_sel=sel(0.15, s + 1),                    # id s is stale
        anti_affinity_sel=anti,
        avoid_counts=avoid[dom, cols],
        pod_has_anti=np.asarray(rassign.pod_has_anti_onehot(jnp.asarray(anti), s)),
        spread_sel=spread_sel,
        spread_max=rng.integers(0, 3, (p, k)).astype(np.int32),
        node_mask=node_mask,
    )
    return (scores, feasible, req, free, prio, mask), state


def as_states(state):
    return (
        rassign.AffinityState(**{k: jnp.asarray(v) for k, v in state.items()}),
        assign.AffinityState(**{k: T(v) for k, v in state.items()}),
    )


def test_torch_affinity_row_helpers_match_reference():
    (scores, *_), state = affinity_problem(30, 45, 5, seed=21, k=3)
    ra, ta = as_states(state)
    rng = np.random.default_rng(22)
    # in-window tables in the representative-row layout
    added = (rng.uniform(size=(45, 5)) < 0.2).astype(np.float32) * 2
    added_avoid = (rng.uniform(size=(45, 5)) < 0.1).astype(np.float32)
    for i in range(30):
        want = rassign._affinity_row_ok(ra, jnp.asarray(added), jnp.asarray(added_avoid), i)
        got = assign._affinity_row_ok(ta, T(added), T(added_avoid), i)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=str(i))
        choice = int(rng.integers(0, 45))
        for found in (True, False):
            w_a, w_v = rassign._affinity_update(
                ra, jnp.asarray(added), jnp.asarray(added_avoid), i,
                jnp.asarray(choice), jnp.asarray(found))
            g_a, g_v = assign._affinity_update(
                ta, T(added), T(added_avoid), i, torch.tensor([choice]), torch.tensor(found))
            np.testing.assert_array_equal(g_a.numpy(), np.asarray(w_a))
            np.testing.assert_array_equal(g_v.numpy(), np.asarray(w_v))
    cnt = state["domain_counts"]
    for i in range(30):
        a, t = state["affinity_sel"][i], state["anti_affinity_sel"][i]
        np.testing.assert_array_equal(
            assign.affinity_ok_from_counts(T(cnt), T(a), T(t)).numpy(),
            np.asarray(rassign.affinity_ok_from_counts(jnp.asarray(cnt), jnp.asarray(a),
                                                       jnp.asarray(t))))
        ss, sm = state["spread_sel"][i], state["spread_max"][i]
        np.testing.assert_array_equal(
            assign.spread_ok_from_counts(T(cnt), T(state["node_mask"]), T(ss), T(sm)).numpy(),
            np.asarray(rassign.spread_ok_from_counts(
                jnp.asarray(cnt), jnp.asarray(state["node_mask"]), jnp.asarray(ss),
                jnp.asarray(sm))))
        m = state["pod_matches"][i]
        np.testing.assert_array_equal(
            assign.anti_reverse_ok(T(state["avoid_counts"]), T(m)).numpy(),
            np.asarray(rassign.anti_reverse_ok(jnp.asarray(state["avoid_counts"]),
                                               jnp.asarray(m))))


@pytest.mark.parametrize("p,n,s,seed", [(30, 40, 4, 1), (48, 25, 6, 2), (64, 90, 3, 3)])
def test_torch_greedy_affinity_matches_reference(p, n, s, seed):
    args, state = affinity_problem(p, n, s, seed)
    ra, ta = as_states(state)
    want = rassign.greedy_assign(*[jnp.asarray(a) for a in args], affinity=ra,
                                 greedy_kernel=False)
    before = dict(fused.launches)
    got = assign.greedy_assign(*[T(a) for a in args], affinity=ta)
    assert fused.launches == before
    np.testing.assert_array_equal(got.node_idx.numpy(), np.asarray(want.node_idx))
    np.testing.assert_array_equal(bits(got.free_after.numpy()), bits(want.free_after))
    assert int(got.n_assigned) == int(want.n_assigned)
    # the constraints bind: without them the same pods land elsewhere
    free_run = assign.greedy_assign(*[T(a) for a in args])
    assert not torch.equal(free_run.node_idx, got.node_idx)
    assert got.node_idx.numpy()[0] == -1                 # the stale spread id


def test_torch_greedy_nan_scores_match_reference():
    """A NaN in one node's disk IO makes min-max turn every score NaN; the
    reference's XLA scan body still places every pod (a NaN cell is
    feasible and jnp.argmax ranks it highest), and so must the port."""
    from kubernetes_scheduler_tpu import engine as ref
    from kubernetes_scheduler_tpu.sim import gen_cluster as ref_cluster
    from kubernetes_scheduler_tpu.sim import gen_pods as ref_pods
    from kubernetes_scheduler_tpu_torch import engine
    from kubernetes_scheduler_tpu_torch.convert import from_reference

    rs = ref_cluster(40, seed=1, constraints=True)
    rp = ref_pods(24, seed=2, constraints=True)
    assert bool(np.asarray(rs.node_mask)[3])
    disk_io = np.array(rs.disk_io)
    disk_io[3] = np.nan
    rs = rs._replace(disk_io=jnp.asarray(disk_io))
    kw = dict(fused=False, normalizer="min_max", assigner="greedy", affinity_aware=False)
    want = ref.schedule_batch(rs, rp, **kw)
    got = engine.schedule_batch(from_reference(rs, device="cpu"),
                                from_reference(rp, device="cpu"), **kw)
    assert int(want.n_assigned) == 24 and int(got.n_assigned) == 24
    np.testing.assert_array_equal(got.node_idx.numpy(), np.asarray(want.node_idx))
    np.testing.assert_array_equal(bits(got.free_after.numpy()), bits(want.free_after))


def test_torch_greedy_scan_plain_first_nan_wins():
    """K4's order on one row: a NaN ranks above +inf and every number, the
    first NaN above later ones; a NaN cell without capacity is passed
    over, and a NaN at or below NEG/2 never is one (NaN is not <= NEG/2)."""
    nan, inf, neg = np.nan, np.inf, assign.NEG
    sj = np.array([
        [1.0, nan, inf, nan, 2.0],   # the first NaN, over +inf and a later NaN
        [inf, nan, 3.0, nan, neg],   # column 1 is taken: the next NaN
        [neg, neg, neg, nan, 5.0],   # its NaN column has no room: 5.0
        [neg, neg, neg, neg, neg],   # nothing qualifies
    ], np.float32)
    req = np.ones((4, 1), np.float32)
    free = np.array([[1.0], [1.0], [1.0], [1.0], [1.0]], np.float32)
    picks, free_after = fused.greedy_scan_plain(T(sj), T(req), T(free))
    np.testing.assert_array_equal(picks.numpy(), [1, 3, 4, -1])
    np.testing.assert_array_equal(free_after.numpy()[:, 0], [1.0, 0.0, 1.0, 0.0, 0.0])
    want = rassign.greedy_assign(
        jnp.asarray(sj), jnp.asarray(~(sj <= np.float32(neg * 0.5))), jnp.asarray(req),
        jnp.asarray(free), jnp.zeros(4, jnp.int32), jnp.ones(4, bool), greedy_kernel=False)
    np.testing.assert_array_equal(picks.numpy(), np.asarray(want.node_idx))
    np.testing.assert_array_equal(bits(free_after.numpy()), bits(want.free_after))
