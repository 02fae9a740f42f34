"""The port's constraint families and soft scores against the JAX package:
the hard count-based masks (pod_affinity_fit, topology_spread_fit,
engine.compute_feasibility), the soft terms (prefer_no_schedule_penalty,
node_affinity_preference, pod_affinity_preference,
engine.compute_soft_scores) and soft=True through schedule_batch and
schedule_windows on the kernel path and the composed path.

The soft terms come from chip_smoke.soft_terms, the seeded generator the
card run uses. Masks are exact. The soft term is exact too: every part
is a sum of integer weights and integer count differences, exact in
float32 in any order. Cycle scores and decisions are held as in
tests/test_torch_policies.py.
"""

import numpy as np
import pytest

from chip_smoke import soft_terms
from kubernetes_scheduler_tpu import engine as ref
from kubernetes_scheduler_tpu.ops import constraints as rcons
from kubernetes_scheduler_tpu_torch import engine
from kubernetes_scheduler_tpu_torch.ops import constraints
from kubernetes_scheduler_tpu_torch.sim import gen_cluster, gen_pods
from tests.test_torch_policies import ASSIGNER_IDS, T, assert_cycle, to_reference


@pytest.fixture(scope="module")
def problem():
    """(reference snapshot, pods, port snapshot, pods): a 300-node
    constraints cluster and 96 pods with soft terms."""
    ts, tp = soft_terms(
        gen_cluster(300, seed=3, constraints=True, device="cpu"),
        gen_pods(96, seed=4, constraints=True, device="cpu"), seed=7,
    )
    return to_reference(ts), to_reference(tp), ts, tp


def test_torch_soft_terms_cover_every_family(problem):
    _, _, ts, tp = problem
    p = tp.request.shape[0]
    soft_taints = ts.taint_mask[:, -1] & (ts.taints[:, -1, 2] == constraints.PREFER_NO_SCHEDULE)
    assert 0 < int(soft_taints.sum()) < ts.taint_mask.shape[0]
    assert 0 < int(tp.pna_mask[:, 0].sum()) < p
    assert bool((tp.pna_mask[:, 1] & (tp.pna_term[:, 1] == 0)).any())   # an AND term
    assert bool((tp.pna_mask[:, 1] & (tp.pna_term[:, 1] == 1)).any())   # a second term
    for f in (tp.pref_affinity_sel, tp.pref_anti_sel, tp.soft_spread_sel):
        assert 0 < int((f >= 0).sum()) < p
    assert bool((ts.pref_attract > 0).any()) and bool((ts.pref_avoid > 0).any())


def test_torch_prefer_no_schedule_penalty_matches_reference(problem):
    rs, rp, ts, tp = problem
    want = rcons.prefer_no_schedule_penalty(rs.taints, rs.taint_mask, rp.tolerations,
                                            rp.tol_mask)
    got = constraints.prefer_no_schedule_penalty(ts.taints, ts.taint_mask, tp.tolerations,
                                                 tp.tol_mask)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0 < (np.asarray(want) > 0).mean() < 1


@pytest.mark.parametrize("grouped", [True, False], ids=["terms", "expressions"])
def test_torch_node_affinity_preference_matches_reference(problem, grouped):
    rs, rp, ts, tp = problem
    names = ("pna_key", "pna_op", "pna_vals", "pna_val_mask", "pna_mask", "pna_weight")
    term_r, term_t = (rp.pna_term, tp.pna_term) if grouped else (None, None)
    want = rcons.node_affinity_preference(rs.node_labels, rs.node_label_mask,
                                          *[getattr(rp, k) for k in names], term_r)
    got = constraints.node_affinity_preference(ts.node_labels, ts.node_label_mask,
                                               *[getattr(tp, k) for k in names], term_t)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0 < (np.asarray(want) > 0).mean() < 1


def test_torch_pod_affinity_preference_matches_reference(problem):
    rs, rp, ts, tp = problem
    s = rs.domain_counts.shape[1]
    aff, anti = np.asarray(rp.pref_affinity_sel).copy(), np.asarray(rp.pref_anti_sel).copy()
    aff[:3], anti[3:6] = s, s + 4         # stale ids: they add nothing
    args_r = (rs.domain_counts, aff, rp.pref_affinity_weight, anti, rp.pref_anti_weight)
    args_t = (ts.domain_counts, T(aff), tp.pref_affinity_weight, T(anti), tp.pref_anti_weight)
    want = np.asarray(rcons.pod_affinity_preference(*args_r))
    got = constraints.pod_affinity_preference(*args_t).numpy()
    np.testing.assert_array_equal(got, want)
    assert (want[:6] == 0).all() and (want > 0).any() and (want < 0).any()


def _hard_selectors(rs, rp, seed):
    """Pod-side hard selectors over the snapshot's S selectors: required,
    forbidden and spread ids with a few stale ones (id >= S)."""
    rng = np.random.default_rng(seed)
    p, s = rp.request.shape[0], rs.domain_counts.shape[1]

    def ids(share, k):
        return np.where(rng.random((p, k)) < share, rng.integers(0, s, (p, k)), -1).astype(np.int32)

    aff, anti, spread = ids(0.3, 2), ids(0.3, 2), ids(0.3, 2)
    aff[0, 0], anti[1, 1], spread[2, 0] = s, s + 1, s + 2
    return aff, anti, spread, rng.integers(0, 3, (p, 2)).astype(np.int32)


def test_torch_pod_affinity_and_spread_fit_match_reference(problem):
    rs, rp, ts, tp = problem
    aff, anti, spread, smax = _hard_selectors(rs, rp, 8)
    want = np.asarray(rcons.pod_affinity_fit(rs.domain_counts, aff, anti))
    got = constraints.pod_affinity_fit(ts.domain_counts, T(aff), T(anti)).numpy()
    np.testing.assert_array_equal(got, want)
    assert not want[:2].any() and 0 < want.mean() < 1
    node_mask = np.asarray(rs.node_mask).copy()
    node_mask[::7] = False
    want = np.asarray(rcons.topology_spread_fit(rs.domain_counts, node_mask, spread, smax))
    got = constraints.topology_spread_fit(ts.domain_counts, T(node_mask), T(spread),
                                          T(smax)).numpy()
    np.testing.assert_array_equal(got, want)
    assert not want[2].any() and 0 < want.mean() < 1


@pytest.mark.parametrize("include", [True, False], ids=["static-affinity", "live-affinity"])
def test_torch_compute_feasibility_matches_reference(problem, include):
    rs, rp, ts, tp = problem
    aff, anti, spread, smax = _hard_selectors(rs, rp, 9)
    rp = rp._replace(affinity_sel=aff, anti_affinity_sel=anti, spread_sel=spread,
                     spread_max=smax)
    tp = tp._replace(affinity_sel=T(aff), anti_affinity_sel=T(anti), spread_sel=T(spread),
                     spread_max=T(smax))
    want = np.asarray(ref.compute_feasibility(rs, rp, include_pod_affinity=include))
    got = engine.compute_feasibility(ts, tp, include_pod_affinity=include).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < want.mean() < 1


@pytest.mark.parametrize("dmin", ["local", "given"])
def test_torch_compute_soft_scores_matches_reference(problem, dmin):
    rs, rp, ts, tp = problem
    kw_r = kw_t = {}
    if dmin == "given":   # a caller's global minimum, below the local one
        d = np.asarray(ref.local_spread_dmin(rs)) - np.float32(1.0)
        kw_r, kw_t = dict(spread_dmin=d, taint_penalty_weight=3.0), dict(
            spread_dmin=T(d), taint_penalty_weight=3.0)
    want = np.asarray(ref.compute_soft_scores(rs, rp, **kw_r))
    got = engine.compute_soft_scores(ts, tp, **kw_t).numpy()
    np.testing.assert_array_equal(got, want)
    assert (want > 0).any() and (want < 0).any()


SOFT = [(True, "greedy", True), (True, "auction", True),
        (False, "greedy", False), (False, "auction", False)]


@pytest.mark.parametrize(
    "kernel,assigner,affinity_aware", SOFT,
    ids=[f"{'kernel' if k else 'composed'}-{ASSIGNER_IDS[a]}" for k, a, _ in SOFT],
)
def test_torch_soft_cycle_matches_reference(problem, kernel, assigner, affinity_aware):
    rs, rp, ts, tp = problem
    kw = dict(assigner=assigner, normalizer="min_max", fused=kernel,
              affinity_aware=affinity_aware, soft=True)
    want = ref.schedule_batch(rs, rp, **kw)
    got = engine.TorchEngine(device="cpu").schedule_batch(ts, tp, **kw)
    assert_cycle(got, want, ts, tp, rp, kw)
    # the term is live: it moves some pods
    plain = engine.schedule_batch(ts, tp, **dict(kw, soft=False))
    assert int((plain.node_idx != got.node_idx).sum()) > 0


def test_torch_soft_backlog_matches_reference(problem):
    rs, rp, ts, tp = problem
    kw = dict(assigner="auction", normalizer="min_max", fused=True, affinity_aware=True,
              soft=True)
    want = ref.schedule_windows(rs, ref.stack_windows(rp, 32), **kw)
    got = engine.schedule_windows(ts, engine.stack_windows(tp, 32), **kw)
    assert int(got.n_assigned) > 0
    np.testing.assert_array_equal(got.node_idx.numpy(), np.asarray(want.node_idx))
    assert int(got.n_assigned) == int(want.n_assigned)
    np.testing.assert_array_equal(got.free_after.numpy().view(np.uint32),
                                  np.asarray(want.free_after).view(np.uint32))
