"""The port's kernel wrappers (kubernetes_scheduler_tpu_torch/ops/fused.py)
against the reference's Pallas kernels run in interpret mode.

On CPU tensors each wrapper runs its plain PyTorch version, which the
CUDA kernel must equal bitwise on the card (chip_smoke.py holds them).
Inputs are made with numpy from a seed and fed to both sides, at sizes
that cross the reference's TILE_P=256 / TILE_N=1024 tile edges.

Score tolerance: masks must match exactly, scores within 4 ulp of their
scale. XLA on the CPU contracts alpha*v - beta*u and 10 - 10*load into
FMAs; the port rounds every product (as the CUDA kernel does), so raw
scores differ by up to an ulp of MAX_RAW_SCORE, and the min-max epilogue
scales that difference by 100 / (highest - lowest).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from kubernetes_scheduler_tpu.ops import pallas_fused as ref
from kubernetes_scheduler_tpu.ops.assign import NEG as REF_NEG
from kubernetes_scheduler_tpu_torch.ops import fused
from kubernetes_scheduler_tpu_torch.ops.assign import NEG
from kubernetes_scheduler_tpu_torch.ops.score import alpha_beta

ULP10 = float(np.spacing(np.float32(10.0)))
ULP100 = float(np.spacing(np.float32(100.0)))


def make_problem(p, n, r, n_sel, seed):
    """Random K1 inputs with pinned pods, masked pod rows and node
    columns, unrequested resources, missing diskIO annotations and
    count-based selector rows."""
    rng = np.random.default_rng(seed)
    alloc = rng.uniform(10, 100, (n, r)).astype(np.float32)
    reqd = (alloc * rng.uniform(0, 1, (n, r))).astype(np.float32)
    disk_io = rng.uniform(0, 50, n).astype(np.float32)
    cpu = rng.uniform(0, 100, n).astype(np.float32)
    req = rng.uniform(0, 40, (p, r)).astype(np.float32)
    req[rng.uniform(size=(p, r)) < 0.3] = 0.0        # unrequested resources
    r_cpu = req[:, 0] * 10
    r_io = rng.uniform(0, 30, p).astype(np.float32)
    r_io[rng.uniform(size=p) < 0.25] = 0.0           # no diskIO annotation
    node_mask = rng.uniform(size=n) > 0.1
    node_mask[: n // 9] = False                      # masked node columns
    pod_mask = rng.uniform(size=p) > 0.1
    pod_mask[-2:] = False                            # masked pod rows
    target = np.full(p, -1, np.int32)
    pinned = rng.uniform(size=p) < 0.1
    target[pinned] = rng.integers(0, n + 3, pinned.sum())  # some out of range
    other = (rng.uniform(size=(p, n)) < 0.8).astype(np.float32)
    hot = lambda k, prob: (rng.uniform(size=(k * n_sel, p)) < prob)  # noqa: E731
    thresh = np.where(
        rng.uniform(size=(n_sel, p)) < 0.3,
        rng.integers(0, 3, (n_sel, p)).astype(np.float32),
        np.finfo(np.float32).max,
    ).astype(np.float32)
    aff_pod = np.concatenate(
        [hot(1, 0.05), hot(1, 0.05), hot(1, 0.1)], axis=0
    ).astype(np.float32)
    aff_pod = np.concatenate([aff_pod, thresh], axis=0)
    aff_node = np.concatenate(
        [
            (rng.uniform(size=(n_sel, n)) < 0.7),
            (rng.uniform(size=(n_sel, n)) < 0.05),
            rng.integers(0, 4, (n_sel, n)),
        ],
        axis=0,
    ).astype(np.float32)
    return dict(
        u=disk_io / np.float32(50.0), v=cpu / np.float32(100.0),
        node_mask=node_mask, alloc=alloc, reqd=reqd, r_cpu=r_cpu, r_io=r_io,
        pod_request=req, pod_mask=pod_mask, target_node=target, other=other,
        aff_pod=aff_pod, aff_node=aff_node,
    )


def score_tolerance(stats):
    """Per-row [p, 1] bound on |port - reference| for feasible cells."""
    if stats is None:
        return 4 * ULP10
    span = (stats[0] - stats[1]).numpy().astype(np.float64)[:, None]
    return 4 * ULP10 * 100.0 / span + 4 * ULP100


def assert_scores_match(got, want, tol):
    feas_got, feas_want = got > NEG * 0.5, want > REF_NEG * 0.5
    np.testing.assert_array_equal(feas_got, feas_want)
    assert (got[~feas_want] == np.float32(NEG)).all()
    diff = np.abs(got.astype(np.float64) - want)
    assert (diff <= np.broadcast_to(tol, diff.shape))[feas_want].all(), diff.max()


K1_CASES = [
    (37, 300, 3, norm, with_other, n_sel)
    for norm in ("none", "min_max")
    for with_other in (False, True)
    for n_sel in (1, 8)
] + [(257, 1025, 5, "min_max", True, 8), (257, 1025, 5, "none", False, 1)]


@pytest.mark.parametrize(
    "p,n,r,normalizer,with_other,n_sel", K1_CASES,
    ids=[f"p{c[0]}-n{c[1]}-r{c[2]}-{c[3]}-other{int(c[4])}-S{c[5]}" for c in K1_CASES],
)
def test_torch_megakernel_plain_matches_reference(p, n, r, normalizer, with_other, n_sel):
    prob = make_problem(p, n, r, n_sel, seed=p * 7 + n + n_sel)
    if not with_other:
        prob.pop("other")
    want = np.asarray(
        ref.fused_masked_score(
            *[jnp.asarray(prob[k]) for k in (
                "u", "v", "node_mask", "alloc", "reqd", "r_cpu", "r_io",
                "pod_request", "pod_mask")],
            target_node=jnp.asarray(prob["target_node"]),
            other=jnp.asarray(prob["other"]) if with_other else None,
            aff_pod=jnp.asarray(prob["aff_pod"]),
            aff_node=jnp.asarray(prob["aff_node"]),
            normalizer=normalizer,
            interpret=True,
        )
    )
    t = {k: torch.from_numpy(np.array(v)) for k, v in prob.items()}
    before = dict(fused.launches)
    got = fused.fused_masked_score(**t, normalizer=normalizer).numpy()
    assert fused.launches == before  # CPU tensors never launch a kernel
    stats = None
    if normalizer == "min_max":
        alpha, beta = alpha_beta(t["r_cpu"], t["r_io"])
        stats = fused.fused_score_row_stats(alpha, beta, t["u"], t["v"], t["node_mask"])
    assert got.shape == (p, n)
    assert_scores_match(got, want, score_tolerance(stats))
    # the all-masked rows and columns are NEG everywhere
    assert (got[~prob["pod_mask"]] == np.float32(NEG)).all()
    assert (got[:, ~prob["node_mask"]] == np.float32(NEG)).all()


ROW_STATS_CASES = [(37, 300, None), (257, 1025, None), (37, 300, "valid"),
                   (257, 1025, "masked")]


@pytest.mark.parametrize(
    "p,n,nan_at", ROW_STATS_CASES,
    ids=["37-300", "257-1025", "37-300-nan-on-valid-nodes", "257-1025-nan-on-a-masked-node"],
)
def test_torch_row_stats_plain_matches_reference(p, n, nan_at):
    """NaN in u on node-masked nodes makes every row's bounds NaN, in the
    reference and the port alike; on a masked-out node it changes nothing."""
    prob = make_problem(p, n, 3, 1, seed=p + n)
    prob["node_mask"][n // 2:] = False
    if nan_at == "valid":
        prob["u"][[n // 9, n // 3]] = np.nan
    elif nan_at == "masked":
        prob["u"][n - 1] = np.nan
    t = {k: torch.from_numpy(np.array(v)) for k, v in prob.items()}
    alpha, beta = alpha_beta(t["r_cpu"], t["r_io"])
    target = np.full(p, -1.0, np.float32)
    pod_sc = ref._pad_axis(
        jnp.stack([jnp.asarray(alpha.numpy()), jnp.asarray(beta.numpy()),
                   jnp.asarray(prob["pod_mask"], jnp.float32), jnp.asarray(target)]),
        1, ref.TILE_P,
    )
    node_ft, _, _ = ref.prep_node_operands(
        jnp.asarray(prob["u"]), jnp.asarray(prob["v"]),
        jnp.asarray(prob["node_mask"]), jnp.asarray(prob["alloc"]),
        jnp.asarray(prob["reqd"]),
    )
    want = np.asarray(
        ref.fused_score_row_stats(pod_sc, node_ft, interpret=True)
    )[:, :p]
    got = fused.fused_score_row_stats(alpha, beta, t["u"], t["v"], t["node_mask"])
    assert got.shape == (2, p)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=4 * ULP10)
    assert np.isnan(got.numpy()).all() == (nan_at == "valid")
    assert np.isnan(want).all() == (nan_at == "valid")
    if nan_at != "valid":
        assert not np.isnan(got.numpy()).any() and not np.isnan(want).any()
    if nan_at == "masked":  # identical rows to the same problem without it
        prob["u"][n - 1] = 0.5
        clean = fused.fused_score_row_stats(
            alpha, beta, torch.from_numpy(prob["u"]), t["v"], t["node_mask"])
        np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                      clean.numpy().view(np.uint32))


def bid_problem(p, n, r, seed):
    """K3 inputs with planted ties inside one 1024-column tile and across
    tiles, rows with no feasible cell, inactive pods and zero requests."""
    rng = np.random.default_rng(seed)
    sj = (rng.uniform(0, 1, (p, n)) + rng.uniform(0, 0.01, (p, n))).astype(np.float32)
    sj[rng.uniform(size=(p, n)) < 0.3] = np.float32(NEG)
    price = rng.integers(0, 3, n).astype(np.float32)
    tie_cols = [5, min(700, n - 1), n - 1]           # n > 1024: last is in tile 2
    price[tie_cols] = 0.0
    for i in range(0, p, 2):
        sj[i, tie_cols] = np.float32(7.0)            # exact three-way tie
    sj[3::11] = np.float32(NEG)                      # rows with no feasible cell
    active = rng.uniform(size=p) < 0.85
    req = rng.uniform(0, 4, (p, r)).astype(np.float32)
    req[rng.uniform(size=(p, r)) < 0.3] = 0.0
    free = rng.uniform(1, 6, (n, r)).astype(np.float32)
    free[tie_cols] = 10.0                            # the ties are biddable
    return sj, price, active, req, free


@pytest.mark.parametrize("p,n,r", [(37, 300, 3), (257, 1025, 5)])
def test_torch_bid_head_plain_matches_reference(p, n, r):
    sj, price, active, req, free = bid_problem(p, n, r, seed=p + n)
    want_bid, want_has = ref.fused_auction_bid(
        ref._pad2(jnp.asarray(sj), ref.TILE_P, ref.TILE_N, value=REF_NEG),
        jnp.asarray(price), jnp.asarray(active),
        ref._pad_axis(jnp.asarray(req).T, 1, ref.TILE_P),
        jnp.asarray(free), p=p, interpret=True,
    )
    before = dict(fused.launches)
    bid, has = fused.auction_bid(*[torch.from_numpy(x) for x in (sj, price, active, req, free)])
    assert fused.launches == before
    assert bid.dtype == torch.int32 and has.dtype == torch.bool
    np.testing.assert_array_equal(bid.numpy(), np.asarray(want_bid))
    np.testing.assert_array_equal(has.numpy(), np.asarray(want_has))
    ties = np.arange(0, p, 2)
    live = active[ties] & (np.arange(p)[ties] % 11 != 3)
    assert (bid.numpy()[ties][live] == 5).all()      # the first of the tie
