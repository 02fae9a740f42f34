"""The port's scoring surface against the JAX package: the policies of
ops/score.py and ops/collect.py, the normalizers of ops/normalize.py, and
engine.compute_scores / normalize_scores / schedule_batch /
schedule_windows on the unfused path with every policy and normalizer,
on a generated cluster with GPU cards, constraints and images.

Tolerance, set from the float32 rounding of each expression
(chip_smoke.score_tolerance, which the card run holds the card to the
CPU with). Masks and decisions are exact. A score is a short chain of
float32 operations; XLA on the CPU contracts products and sums into FMAs
and may sum in another order, so the two sides may round each operation
differently:

- raw scores agree within 8 ulp of their scale (the largest |score| over
  valid nodes);
- balanced_diskio rescales its statistic Mj inside the policy, and the
  min-max normalizer rescales the raw row: an error d in the values and
  in the row's bounds becomes at most 4 d * 100 / (highest - lowest),
  plus 8 ulp of 100 for the rescale's own rounding;
- softmax: rtol 1e-6 on identical logits (exp and the sum differ in the
  last bits); logits that differ by up to d add a relative exp(2 d) - 1.
  Probabilities under the smallest normal float32 are 0 on both sides
  (XLA flushes subnormals), so atol is twice that number.

Greedy has no tie jitter: a differing greedy decision is accepted only as
the near-tie flip of tests/test_torch_engine_affinity.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import (
    SCORE_ULPS,
    normalized_tolerance,
    raw_score_tolerance,
    score_tolerance,
)
from kubernetes_scheduler_tpu import engine as ref
from kubernetes_scheduler_tpu.ops import collect as rcollect
from kubernetes_scheduler_tpu.ops import feasibility as rfeas
from kubernetes_scheduler_tpu.ops import normalize as rnorm
from kubernetes_scheduler_tpu.ops import score as rscore
from kubernetes_scheduler_tpu.ops import stats as rstats
from kubernetes_scheduler_tpu.sim import gen_cluster as ref_cluster
from kubernetes_scheduler_tpu.sim import gen_pods as ref_pods
from kubernetes_scheduler_tpu_torch import engine
from kubernetes_scheduler_tpu_torch.ops import collect, feasibility, normalize, score, stats
from kubernetes_scheduler_tpu_torch.sim import gen_cluster, gen_pods
from tests.test_torch_engine_affinity import _assert_batch

ULP100 = float(np.spacing(np.float32(100.0)))
F32_TINY = float(np.finfo(np.float32).tiny)
FEATURES = dict(gpu=True, constraints=True, images=True)
ASSIGNER_IDS = {"greedy": "scan", "auction": "bid"}


def T(x):
    return torch.from_numpy(np.array(x))


def N(x):
    return np.asarray(x, dtype=np.float64) if np.asarray(x).dtype.kind == "f" else np.asarray(x)


def to_reference(nt):
    """The reference's NamedTuple of the same name for a port one."""
    cls = ref.SnapshotArrays if type(nt).__name__ == "SnapshotArrays" else ref.PodBatch
    return cls(*[np.asarray(f.cpu().numpy()) for f in nt])


def ulp_of(x) -> float:
    """One ulp of float32 at the largest |x|."""
    return float(np.spacing(np.float32(np.abs(np.asarray(x)).max())))


def assert_close(got, want, tol, what=""):
    diff = np.abs(N(got) - N(want))
    bound = np.broadcast_to(tol, diff.shape)
    assert (diff <= bound).all(), (what, float(diff.max()), float((diff - bound).max()))


@pytest.fixture(scope="module")
def problem():
    """(reference snapshot, pods, port snapshot, pods) of a 300-node
    cluster with cards, constraints and images, and 96 pods."""
    return (
        ref_cluster(300, seed=3, **FEATURES), ref_pods(96, seed=4, **FEATURES),
        gen_cluster(300, seed=3, device="cpu", **FEATURES),
        gen_pods(96, seed=4, device="cpu", **FEATURES),
    )


# ---- normalizers ----------------------------------------------------------


@pytest.mark.parametrize("case", ["integer-parity", "bounds", "max-score-10"])
def test_torch_min_max_normalize_options_match_reference(case):
    rng = np.random.default_rng(11)
    scores = rng.uniform(-3, 60, (9, 50)).astype(np.float32)
    scores[2] = 4.0                       # highest == lowest guard
    mask = rng.uniform(size=50) > 0.2
    kw_ref, kw = {}, {}
    if case == "integer-parity":
        kw_ref = kw = dict(integer_parity=True)
    elif case == "bounds":
        hi = rng.uniform(40, 70, (9, 1)).astype(np.float32)
        lo = rng.uniform(-5, 5, (9, 1)).astype(np.float32)
        kw_ref = dict(bounds=(jnp.asarray(hi), jnp.asarray(lo)))
        kw = dict(bounds=(T(hi), T(lo)))
    else:
        kw_ref = kw = dict(max_node_score=10.0)
    want = rnorm.min_max_normalize(jnp.asarray(scores), jnp.asarray(mask), **kw_ref)
    got = normalize.min_max_normalize(T(scores), T(mask), **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("temperature", [1.0, 0.25])
def test_torch_softmax_normalize_matches_reference(temperature):
    rng = np.random.default_rng(12)
    scores = rng.uniform(0, 100, (8, 300)).astype(np.float32)
    scores[3] = rng.uniform(0, 1e4, 300)   # most probabilities underflow
    mask = rng.uniform(size=300) > 0.2
    for m in (mask, np.zeros(300, bool)):  # the second: every node masked
        want = rnorm.softmax_normalize(jnp.asarray(scores), jnp.asarray(m),
                                       temperature=temperature)
        got = normalize.softmax_normalize(T(scores), T(m), temperature=temperature)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=2 * F32_TINY)
        assert ((got.numpy() == 0) == (np.asarray(want) == 0)).all()
    np.testing.assert_array_equal(got.numpy(), np.full((8, 300), 1 / 300, np.float32))


@pytest.mark.parametrize("normalizer", sorted(engine.NORMALIZERS))
def test_torch_normalize_scores_matches_reference(problem, normalizer):
    rs, rp, ts, tp = problem
    raw = np.asarray(ref.compute_scores(rs, rp, "least_allocated"))
    raw = raw * np.float32(0.37) + np.float32(2.5)   # a row range that is not [0, 100]
    want = ref.normalize_scores(jnp.asarray(raw), rs.node_mask, normalizer)
    got = engine.normalize_scores(T(raw), ts.node_mask, normalizer)
    tol = normalized_tolerance(normalizer, 0.0, raw, want, rs.node_mask)
    assert_close(got.numpy(), want, tol, normalizer)
    with pytest.raises(ValueError, match="normalizer"):
        engine.normalize_scores(T(raw), ts.node_mask, "zscore")


# ---- policies -------------------------------------------------------------


def test_torch_balanced_diskio_and_free_capacity_match_reference(problem):
    rs, rp, ts, tp = problem
    r_st = rstats.utilization_stats(rs.disk_io, rs.cpu_pct, rs.node_mask)
    t_st = stats.utilization_stats(ts.disk_io, ts.cpu_pct, ts.node_mask)
    m_want = rscore.balanced_diskio_m(r_st, rs.disk_io, rp.r_io)
    m_got = score.balanced_diskio_m(t_st, ts.disk_io, tp.r_io)
    valid = np.asarray(rs.node_mask)
    assert_close(m_got.numpy(), m_want, SCORE_ULPS * ulp_of(N(m_want)[:, valid]), "Mj")
    # the bounds and the rescale on the same Mj: exact, sentinel seeds included
    m = np.asarray(m_want)
    for shift in (0.0, -2.0e6):   # every Mj below 0: M_max stays at its seed 0
        hi_w, lo_w = rscore.balanced_diskio_local_bounds(jnp.asarray(m + shift), rs.node_mask)
        hi_g, lo_g = score.balanced_diskio_local_bounds(T(m + shift), ts.node_mask)
        np.testing.assert_array_equal(hi_g.numpy(), np.asarray(hi_w))
        np.testing.assert_array_equal(lo_g.numpy(), np.asarray(lo_w))
        np.testing.assert_array_equal(
            score.balanced_diskio_from_m(T(m + shift), hi_g, lo_g).numpy(),
            np.asarray(rscore.balanced_diskio_from_m(jnp.asarray(m + shift), hi_w, lo_w)))
    assert (np.asarray(hi_w) == 0).all()
    want = rscore.balanced_diskio(r_st, rs.disk_io, rp.r_io, rs.node_mask)
    got = score.balanced_diskio(t_st, ts.disk_io, tp.r_io, ts.node_mask)
    assert_close(got.numpy(), want, raw_score_tolerance(ts, tp, "balanced_diskio"), "policy")

    for kw in ({}, dict(disk_io_weight=3.0, cpu_weight=0.5, memory_weight=7.0)):
        want = rscore.free_capacity(rs.cpu_pct, rs.mem_pct, rs.disk_io, **kw)
        got = score.free_capacity(ts.cpu_pct, ts.mem_pct, ts.disk_io, **kw)
        assert_close(got.numpy(), want, SCORE_ULPS * ulp_of(want), kw)


@pytest.mark.parametrize("clock_bug", [False, True], ids=["clock", "clock-bug"])
@pytest.mark.parametrize("integer_parity", [False, True], ids=["float", "integer"])
def test_torch_card_policy_matches_reference(problem, clock_bug, integer_parity):
    rs, rp, ts, tp = problem
    args = [getattr(rs, k) for k in ("cards", "card_mask", "card_healthy")] + [
        getattr(rp, k) for k in ("want_number", "want_memory", "want_clock")]
    fits_w, per_w = rfeas.card_fit(*args)
    fits_g, per_g = feasibility.card_fit(*[T(np.asarray(a)) for a in args])
    sel_w, sel_g = per_w & fits_w[:, :, None], per_g & fits_g[:, :, None]
    np.testing.assert_array_equal(
        collect.local_max_card_values(ts.cards, sel_g).numpy(),
        np.asarray(rcollect.local_max_card_values(rs.cards, sel_w)))
    max_w = rcollect.collect_max_card_values(rs.cards, sel_w)
    max_g = collect.collect_max_card_values(ts.cards, sel_g)
    np.testing.assert_array_equal(max_g.numpy(), np.asarray(max_w))
    assert (max_g.numpy() >= 1).all()
    kw = dict(reference_clock_bug=clock_bug, integer_parity=integer_parity)
    want = rscore.card_score(rs.cards, rs.card_mask, per_w, max_w, **kw)
    got = score.card_score(ts.cards, ts.card_mask, per_g, max_g, **kw)
    assert_close(got.numpy(), want, SCORE_ULPS * ulp_of(want), kw)
    assert np.asarray(want).max() > 0


def test_torch_default_scorers_match_reference(problem):
    rs, rp, ts, tp = problem
    assert score.IMAGE_MIN_THRESHOLD == rscore.IMAGE_MIN_THRESHOLD
    assert score.IMAGE_MAX_THRESHOLD == rscore.IMAGE_MAX_THRESHOLD
    req = np.asarray(rp.request).copy()
    req[:8] *= 40.0                       # pods that overflow most nodes: the 0 branches
    for name in ("least_allocated", "balanced_allocation"):
        for kw in ({}, dict(resource_cols=(0, 2))):
            want = getattr(rscore, name)(rs.allocatable, rs.requested, req, **kw)
            got = getattr(score, name)(ts.allocatable, ts.requested, T(req), **kw)
            assert_close(got.numpy(), want, SCORE_ULPS * ulp_of(want), (name, kw))
            assert 0 < (np.asarray(want) > 0).mean() < 1
    want = rscore.image_locality(rs.image_scaled, rp.image_ids, rp.n_containers)
    got = score.image_locality(ts.image_scaled, tp.image_ids, tp.n_containers)
    assert_close(got.numpy(), want, SCORE_ULPS * ulp_of(want), "image_locality")
    assert 0 < (np.asarray(want) > 0).mean() < 1


@pytest.mark.parametrize("policy", engine.POLICIES)
def test_torch_compute_scores_matches_reference(problem, policy):
    rs, rp, ts, tp = problem
    want = ref.compute_scores(rs, rp, policy)
    got = engine.compute_scores(ts, tp, policy)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert_close(got.numpy(), want, raw_score_tolerance(ts, tp, policy), policy)
    with pytest.raises(ValueError, match="unknown policy"):
        engine.compute_scores(ts, tp, "most_allocated")


# ---- the unfused cycle and backlog ----------------------------------------


def assert_cycle(got, want, ts, tp, rp, kw):
    """Masks exact, scores within score_tolerance on feasible cells,
    decisions equal (greedy: or a near-tie flip)."""
    feas = np.asarray(want.feasible)
    tol = score_tolerance(ts, tp, want.scores, feas, kw)
    assert_close(got.scores.numpy()[feas], np.asarray(want.scores)[feas], tol[feas], kw)
    _assert_batch(got, want, rp, kw["assigner"], kw)


# every policy once, the two assigners in turn
UNFUSED = [(p, ("greedy", "auction")[i % 2]) for i, p in enumerate(engine.POLICIES)]


@pytest.mark.parametrize("policy,assigner", UNFUSED,
                         ids=[f"{p}-{ASSIGNER_IDS[a]}" for p, a in UNFUSED])
def test_torch_unfused_cycle_matches_reference(problem, policy, assigner):
    rs, rp, ts, tp = problem
    kw = dict(policy=policy, assigner=assigner, normalizer="min_max", fused=False,
              affinity_aware=False)
    want = ref.schedule_batch(rs, rp, **kw)
    got = engine.TorchEngine(device="cpu").schedule_batch(ts, tp, **kw)
    assert int(got.n_assigned) > 0
    np.testing.assert_array_equal(got.raw_scores.numpy().shape, np.shape(want.raw_scores))
    assert_cycle(got, want, ts, tp, rp, kw)


SOFTMAX = [(p, a) for p in ("balanced_cpu_diskio", "least_allocated")
           for a in ("greedy", "auction")]


@pytest.mark.parametrize("policy,assigner", SOFTMAX,
                         ids=[f"{p}-{ASSIGNER_IDS[a]}" for p, a in SOFTMAX])
def test_torch_softmax_cycle_matches_reference(problem, policy, assigner):
    rs, rp, ts, tp = problem
    kw = dict(policy=policy, assigner=assigner, normalizer="softmax", fused=False,
              affinity_aware=False)
    want = ref.schedule_batch(rs, rp, **kw)
    got = engine.schedule_batch(ts, tp, **kw)
    assert int(got.n_assigned) > 0
    assert_cycle(got, want, ts, tp, rp, kw)


@pytest.mark.parametrize("assigner,policy,normalizer",
                         [("greedy", "card", "softmax"), ("auction", "balanced_diskio", "none")],
                         ids=["scan", "bid"])
def test_torch_unfused_backlog_matches_reference(problem, assigner, policy, normalizer):
    rs, rp, ts, tp = problem
    kw = dict(policy=policy, assigner=assigner, normalizer=normalizer, fused=False,
              affinity_aware=False)
    want = ref.schedule_windows(rs, ref.stack_windows(rp, 32), **kw)
    got = engine.schedule_windows(ts, engine.stack_windows(tp, 32), **kw)
    assert int(got.n_assigned) > 0
    np.testing.assert_array_equal(got.node_idx.numpy(), np.asarray(want.node_idx))
    assert int(got.n_assigned) == int(want.n_assigned)
    np.testing.assert_array_equal(got.free_after.numpy().view(np.uint32),
                                  np.asarray(want.free_after).view(np.uint32))
