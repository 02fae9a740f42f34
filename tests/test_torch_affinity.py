"""In-window inter-pod (anti)affinity in the port's auction
(kubernetes_scheduler_tpu_torch/ops/assign.py, `auction_assign` with an
AffinityState) against the JAX reference, on identical numpy inputs.

The bid mask, the same-round eviction, the count fold and whole runs are
held bitwise, in the dense and in the scatter forms of both element
budgets (DENSE_EVICT_BUDGET, DENSE_FOLD_BUDGET), which the tests patch on
both sides. Counts are small integers in float32, so every sum is exact
in any order.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from kubernetes_scheduler_tpu.ops import assign as rassign
from kubernetes_scheduler_tpu_torch.ops import assign, fused
from tests.test_torch_greedy import T, affinity_problem, as_states, bits

BUDGETS = {"dense": None, "scatter": 0}


def patch_budgets(monkeypatch, evict, fold):
    for mod in (rassign, assign):
        if BUDGETS[evict] is not None:
            monkeypatch.setattr(mod, "DENSE_EVICT_BUDGET", BUDGETS[evict])
        if BUDGETS[fold] is not None:
            monkeypatch.setattr(mod, "DENSE_FOLD_BUDGET", BUDGETS[fold])


def expanded_tables(state, seed):
    """Random in-window tables in the per-node expanded layout (every
    member of a domain holds the domain's total)."""
    rng = np.random.default_rng(seed)
    n, s = state["domain_counts"].shape
    cols = np.arange(s)[None, :]
    rep = lambda prob: (rng.uniform(size=(n, s)) < prob).astype(np.float32)  # noqa: E731
    return rep(0.2)[state["domain_id"], cols], rep(0.1)[state["domain_id"], cols]


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_torch_affinity_round_mask_matches_reference(seed):
    _, state = affinity_problem(40, 60, 5, seed=seed, k=3)
    ra, ta = as_states(state)
    added, added_avoid = expanded_tables(state, seed)
    want = rassign._affinity_round_mask(ra, jnp.asarray(added), jnp.asarray(added_avoid))
    got = assign._affinity_round_mask(ta, T(added), T(added_avoid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0 < got.numpy().mean() < 1
    cnt = state["domain_counts"] + added
    np.testing.assert_array_equal(
        assign.spread_ok_batched(T(cnt), T(state["node_mask"]), T(state["spread_sel"]),
                                 T(state["spread_max"])).numpy(),
        np.asarray(rassign.spread_ok_batched(
            jnp.asarray(cnt), jnp.asarray(state["node_mask"]),
            jnp.asarray(state["spread_sel"]), jnp.asarray(state["spread_max"]))))
    np.testing.assert_array_equal(
        assign.anti_reverse_bad(T(state["pod_matches"]), T(state["avoid_counts"])).numpy(),
        np.asarray(rassign.anti_reverse_bad(jnp.asarray(state["pod_matches"]),
                                            jnp.asarray(state["avoid_counts"]))))


@pytest.mark.parametrize("evict", sorted(BUDGETS))
def test_torch_affinity_eviction_matches_reference(monkeypatch, evict):
    """Same-round conflicts among many admitted pods on few domains."""
    patch_budgets(monkeypatch, evict, "dense")
    _, state = affinity_problem(60, 30, 4, seed=9)
    state["pod_matches"] = np.random.default_rng(10).uniform(size=(60, 4)) < 0.6
    ra, ta = as_states(state)
    added, _ = expanded_tables(state, 9)
    rng = np.random.default_rng(11)
    bid = rng.integers(0, 30, 60).astype(np.int32)
    admitted = rng.uniform(size=60) < 0.8
    by_prio = rassign._priority_order(jnp.asarray(rng.integers(0, 3, 60)), jnp.ones(60, bool))
    rank = np.zeros(60, np.int32)
    rank[np.asarray(by_prio)] = np.arange(60)
    prio_key = (60 - rank).astype(np.int32)
    want = rassign._evict_round_conflicts(ra, jnp.asarray(admitted), jnp.asarray(bid),
                                          jnp.asarray(prio_key), jnp.asarray(added))
    got = assign._evict_round_conflicts(ta, T(admitted), T(bid), T(prio_key), T(added))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0 < got.numpy().sum() < admitted.sum()  # some conflicts, some survivors


@pytest.mark.parametrize(
    "evict,fold", [(e, f) for e in sorted(BUDGETS) for f in sorted(BUDGETS)],
    ids=[f"evict-{e}-fold-{f}" for e in sorted(BUDGETS) for f in sorted(BUDGETS)],
)
def test_torch_affinity_bid_rounds_match_reference(monkeypatch, evict, fold):
    patch_budgets(monkeypatch, evict, fold)
    forms, expands = [], []
    real_sum, real_expand = assign._domain_sum, assign._expand
    monkeypatch.setattr(assign, "_domain_sum", lambda samef, *a: (
        forms.append(samef is None), real_sum(samef, *a))[1])
    monkeypatch.setattr(assign, "_expand", lambda *a: (
        expands.append(1), real_expand(*a))[1])
    for seed in (4, 5):
        args, state = affinity_problem(48, 36, 5, seed=seed)
        ra, ta = as_states(state)
        want = rassign.auction_assign(*[jnp.asarray(a) for a in args], rounds=64,
                                      affinity=ra, bid_kernel=False)
        before = dict(fused.launches)
        got = assign.auction_assign(*[T(a) for a in args], rounds=64, affinity=ta)
        assert fused.launches == before
        np.testing.assert_array_equal(got.node_idx.numpy(), np.asarray(want.node_idx))
        np.testing.assert_array_equal(bits(got.free_after.numpy()), bits(want.free_after))
        assert int(got.n_assigned) == int(want.n_assigned) > 0
    # the budgets picked the forms (only the scatter fold expands tables)
    assert set(forms) == {evict == "scatter"}
    assert bool(expands) == (fold == "scatter")


def test_torch_affinity_bid_fold_forms_agree(monkeypatch):
    """The dense [p, n, S] fold and the representative-row scatter fold
    give the same tables exactly."""
    _, state = affinity_problem(50, 40, 6, seed=12)
    _, ta = as_states(state)
    added, added_avoid = expanded_tables(state, 12)
    rng = np.random.default_rng(13)
    admitted, bid = T(rng.uniform(size=50) < 0.7), T(rng.integers(0, 40, 50).astype(np.int32))
    dense = assign._fold_round(ta, admitted, bid, T(added), T(added_avoid))
    monkeypatch.setattr(assign, "DENSE_FOLD_BUDGET", 0)
    scatter = assign._fold_round(ta, admitted, bid, T(added), T(added_avoid))
    for d, s in zip(dense, scatter):
        np.testing.assert_array_equal(bits(d.numpy()), bits(s.numpy()))
    assert (dense[0].numpy() > added).any()


def test_torch_affinity_bid_stop_between_checks(monkeypatch):
    """A run whose first no-bid round is not a multiple of CHECK_EVERY:
    the port reads the any-bid flag only every CHECK_EVERY rounds, and the
    extra no-op rounds leave the result bit-identical to the reference's
    stop at the first no-bid round."""
    p, n, s = 6, 8, 2
    dom = (np.repeat([0, 4], 4)[:, None] * np.ones((1, s))).astype(np.int32)
    matches = np.zeros((p, s), bool)
    matches[:, 0] = True
    state = dict(
        domain_counts=np.zeros((n, s), np.float32), domain_id=dom, pod_matches=matches,
        affinity_sel=np.full((p, 1), -1, np.int32),
        anti_affinity_sel=np.zeros((p, 1), np.int32),       # spread pods: one per domain
        avoid_counts=np.zeros((n, s), np.float32),
        pod_has_anti=matches.copy(),
        spread_sel=np.full((p, 1), -1, np.int32), spread_max=np.ones((p, 1), np.int32),
        node_mask=np.ones(n, bool),
    )
    ra, ta = as_states(state)
    scores = np.tile(np.linspace(10, 1, n, dtype=np.float32), (p, 1))
    args = (scores, np.ones((p, n), bool), np.ones((p, 3), np.float32),
            np.full((n, 3), 100.0, np.float32), np.arange(p, dtype=np.int32), np.ones(p, bool))
    any_bid = []
    real = assign._segmented_admission
    monkeypatch.setattr(assign, "_segmented_admission", lambda bid, has, *a: (
        any_bid.append(bool(has.any())), real(bid, has, *a))[1])
    got = assign.auction_assign(*[T(a) for a in args], affinity=ta)
    want = rassign.auction_assign(*[jnp.asarray(a) for a in args], affinity=ra)
    first_idle = any_bid.index(False) + 1                    # 1-based round
    assert first_idle % assign.CHECK_EVERY != 0
    assert len(any_bid) == assign.CHECK_EVERY                # broke at the first read
    assert not any(any_bid[first_idle - 1:])                 # every later round idle
    np.testing.assert_array_equal(got.node_idx.numpy(), np.asarray(want.node_idx))
    np.testing.assert_array_equal(bits(got.free_after.numpy()), bits(want.free_after))
    stopped = assign.auction_assign(*[T(a) for a in args], affinity=ta, rounds=first_idle)
    assert torch.equal(stopped.node_idx, got.node_idx)
    assert torch.equal(stopped.free_after, got.free_after)
    placed = got.node_idx.numpy()
    assert sorted(np.where(placed >= 0)[0]) == [4, 5]        # top priorities, one per domain
    assert {int(j) // 4 for j in placed[placed >= 0]} == {0, 1}
