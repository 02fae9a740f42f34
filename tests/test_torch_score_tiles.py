"""The decompositions of K1 `masked_score` and K2 `row_stats`
(kubernetes_scheduler_tpu_torch/csrc/fused.cu) held on the CPU.

The CUDA kernels cannot run here, so the models below follow them step by
step in PyTorch:

- K2 (`split_row_stats`): a block's threads each take every T-th group
  of four consecutive nodes, keep per pod the NaN-propagating (min, max) of the
  load |alpha * v - beta * u| over their node-masked nodes, and the
  block folds the T partials; 10 - 10 * x is applied once to the folded
  min and max (the score is non-increasing in the load). A pod with no
  node-masked node gets (-F32_MAX, F32_MAX).
- K1 (`tile_masked_score`): blocks of `cols` columns by `group` pods;
  NodeResourcesFit taken once per block, resource by resource, as the
  kernel's word of fit bits (bit 4g + c: pod g fits column c); the
  selector rows folded into per-column and per-pod words of bits, the
  word test (req & ~pres) | (anti & pres) | (match & avo), and the spread
  compare made only for the pod's selectors whose threshold lies below
  the block's largest count + 1 - dmin.

Each model is held bitwise against the kernel's plain version
(`row_stats_plain` / `masked_score_plain`, which the kernels equal bitwise
on the card: chip_smoke.py), and against the JAX reference's Pallas
kernels in interpret mode under tests/test_torch_kernels.py's tolerance:
masks exact, scores within 4 ulp of their scale.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_scheduler_tpu.ops import pallas_fused as ref
from kubernetes_scheduler_tpu_torch.ops import fused
from kubernetes_scheduler_tpu_torch.ops.assign import NEG
from kubernetes_scheduler_tpu_torch.ops.normalize import F32_MAX, MAX_NODE_SCORE
from kubernetes_scheduler_tpu_torch.ops.score import MAX_RAW_SCORE, alpha_beta
from tests.test_torch_kernels import (
    ULP10,
    assert_scores_match,
    make_problem,
    score_tolerance,
)

INF = float("inf")


def bits(x: torch.Tensor) -> np.ndarray:
    return x.numpy().view(np.uint32)


def assert_same(got: torch.Tensor, want: torch.Tensor) -> None:
    """NaN where `want` has NaN, the same bits everywhere else."""
    assert got.shape == want.shape and got.dtype == want.dtype
    nan = torch.isnan(want)
    np.testing.assert_array_equal(torch.isnan(got).numpy(), nan.numpy())
    np.testing.assert_array_equal(bits(got[~nan]), bits(want[~nan]))


def score_of_load(x: torch.Tensor) -> torch.Tensor:
    return MAX_RAW_SCORE - MAX_RAW_SCORE * x


# ---- K2 -----------------------------------------------------------------


def split_row_stats(alpha, beta, u, v, node_mask, splits):
    """[2, p] K2's launch with `splits` threads a block: thread t folds
    the 4-node groups t, t + splits, ..., and the block folds the
    threads."""
    p, n = alpha.shape[0], u.shape[0]
    lmin = torch.full((p,), INF)
    lmax = torch.full((p,), -INF)
    groups = torch.arange(n) // 4
    for t in range(min(splits, -(-n // 4))):
        cols = torch.nonzero(groups % splits == t).flatten()
        cols = cols[node_mask[cols]]
        if cols.numel() == 0:
            continue
        load = torch.abs(alpha[:, None] * v[None, cols] - beta[:, None] * u[None, cols])
        lmin = torch.minimum(lmin, load.amin(1))  # both propagate NaN
        lmax = torch.maximum(lmax, load.amax(1))
    none = lmax == -INF
    hi = torch.where(none, -F32_MAX, score_of_load(lmin))
    lo = torch.where(none, F32_MAX, score_of_load(lmax))
    return torch.stack([hi, lo])


def stats_problem(p, n, case, seed):
    """(alpha, beta, u, v, node_mask) with a NaN on node-masked nodes
    ("nan-valid": every row NaN), on a masked-out node only ("nan-masked":
    nothing changes), no node-masked node ("all-masked"), or NaN requests
    on a few pods ("nan-pods": those rows NaN)."""
    prob = make_problem(p, n, 3, 1, seed=seed)
    u, v, mask = prob["u"].copy(), prob["v"], prob["node_mask"].copy()
    r_cpu, r_io = prob["r_cpu"].copy(), prob["r_io"]
    masked = np.flatnonzero(~mask)
    valid = np.flatnonzero(mask)
    if case == "nan-valid":
        u[valid[[0, len(valid) // 2, -1]]] = np.nan
    elif case == "nan-masked":
        u[masked[[0, -1]]] = np.nan
    elif case == "all-masked":
        mask[:] = False
    elif case == "nan-pods":
        r_cpu[[1, p // 2]] = np.nan
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x))  # noqa: E731
    alpha, beta = alpha_beta(t(r_cpu), t(r_io))
    return alpha, beta, t(u), t(v), t(mask)


def reference_bounds(alpha, beta, u, v, node_mask):
    """[2, p] fused_score_row_stats of the JAX reference in interpret mode."""
    p = alpha.shape[0]
    pod_sc = ref._pad_axis(
        jnp.stack([jnp.asarray(alpha.numpy()), jnp.asarray(beta.numpy()),
                   jnp.ones(p, jnp.float32), jnp.full(p, -1.0, jnp.float32)]),
        1, ref.TILE_P,
    )
    m = u.shape[0]
    node_ft, _, _ = ref.prep_node_operands(
        jnp.asarray(u.numpy()), jnp.asarray(v.numpy()),
        jnp.asarray(node_mask.numpy()), jnp.zeros((m, 1), jnp.float32),
        jnp.zeros((m, 1), jnp.float32),
    )
    return np.asarray(ref.fused_score_row_stats(pod_sc, node_ft, interpret=True))[:, :p]


def bounds_of(raw):
    """fused_score_row_stats's post-step on K2's raw (max, min)."""
    highest = torch.clamp(raw[0], min=0.0)
    return torch.stack([highest, torch.where(highest == raw[1], raw[1] - 1.0, raw[1])])


STATS_CASES = ("plain", "nan-valid", "nan-masked", "all-masked", "nan-pods")
SPLITS = (1, 3, 7, 512)


@functools.cache
def stats_data(p, n, case):
    args = stats_problem(p, n, case, seed=p + n)
    return args, fused.row_stats_plain(*args), reference_bounds(*args)


@pytest.mark.parametrize("splits", SPLITS, ids=[f"splits{s}" for s in SPLITS])
@pytest.mark.parametrize("case", STATS_CASES)
@pytest.mark.parametrize("p,n", [(37, 300), (300, 1030)])
def test_torch_row_split_model_matches_plain_and_reference(p, n, case, splits):
    args, plain, want = stats_data(p, n, case)
    got = split_row_stats(*args, splits)
    assert_same(got, plain)
    np.testing.assert_allclose(bounds_of(got).numpy(), want, rtol=0, atol=4 * ULP10)
    nan_rows = torch.isnan(got).any(0)
    if case == "nan-valid":
        assert nan_rows.all() and torch.isnan(got).all()
    elif case == "nan-pods":
        assert nan_rows.numpy().nonzero()[0].tolist() == [1, p // 2]
    else:
        assert not nan_rows.any()
    if case == "nan-masked":  # the masked-out NaN changes nothing
        assert_same(got, stats_data(p, n, "plain")[1])
    if case == "all-masked":
        assert (got[0] == -F32_MAX).all() and (got[1] == F32_MAX).all()


@pytest.mark.parametrize("case", STATS_CASES)
def test_torch_row_split_order_is_irrelevant(case):
    """Max and min are exact in any order: the folds over the threads of
    a block, taken forwards, backwards and by halves, give the same bits,
    NaN included."""
    args, plain, _ = stats_data(37, 300, case)
    alpha, beta, u, v, mask = args
    load = torch.abs(alpha[:, None] * v[None, mask] - beta[:, None] * u[None, mask])
    if load.shape[1] == 0:
        return
    fold = lambda x: torch.stack([x.amin(1), x.amax(1)])  # noqa: E731
    halves = torch.split(load, (load.shape[1] + 1) // 2, dim=1)
    by_halves = torch.stack([torch.minimum(*[h.amin(1) for h in halves]) if len(halves) > 1
                             else halves[0].amin(1),
                             torch.maximum(*[h.amax(1) for h in halves]) if len(halves) > 1
                             else halves[0].amax(1)])
    for other in (fold(load.flip(1)), by_halves):
        assert_same(other, fold(load))
    got = torch.stack([score_of_load(fold(load)[0]), score_of_load(fold(load)[1])])
    assert_same(got, plain)


# ---- K1 -----------------------------------------------------------------


def words(flags: torch.Tensor) -> torch.Tensor:
    """[S, m] bool -> [m] int64: bit s set where row s is True."""
    w = torch.ones(flags.shape[0], dtype=torch.int64) << torch.arange(flags.shape[0])
    return (flags.long() * w[:, None]).sum(0)


def nan_max(x: torch.Tensor) -> float:
    """max ignoring NaN (fmaxf's rule), -inf for none."""
    x = x[~torch.isnan(x)]
    return float(x.max()) if x.numel() else -INF


def tile_masked_score(alpha, beta, pod_ok, target, u, v, node_mask, pod_request,
                      alloc, reqd, *, aff_pod=None, aff_node=None, other=None,
                      stats=None, group, cols):
    """[p, n] K1's launch: blocks of `cols` columns by `group` pods."""
    p, n = alpha.shape[0], u.shape[0]
    out = torch.empty((p, n))
    n_sel = 0 if aff_pod is None else aff_pod.shape[0] // 4
    if n_sel:
        pres, avo = words(aff_node[:n_sel] > 0), words(aff_node[n_sel:2 * n_sel] > 0)
        cplus = aff_node[2 * n_sel:]
        req_w = words(aff_pod[:n_sel] > 0)
        anti_w = words(aff_pod[n_sel:2 * n_sel] > 0)
        match_w = words(aff_pod[2 * n_sel:3 * n_sel] > 0)
        thresh = aff_pod[3 * n_sel:]
    for c0 in range(0, n, cols):
        cc = torch.arange(c0, min(n, c0 + cols))
        cmax = nan_max(cplus[:, cc]) if n_sel else -INF
        for g0 in range(0, p, group):
            gg = torch.arange(g0, min(p, g0 + group))
            score = MAX_RAW_SCORE - MAX_RAW_SCORE * torch.abs(
                alpha[gg, None] * v[None, cc] - beta[gg, None] * u[None, cc])
            fit = pod_ok[gg, None] & node_mask[None, cc]
            # the block's fit bits, one resource at a time
            for k in range(pod_request.shape[1]):
                q = pod_request[gg, k][:, None]
                fit &= (reqd[cc, k][None, :] + q <= alloc[cc, k][None, :]) | (q == 0)
            fit &= (target[gg, None] < 0) | (target[gg, None] == cc[None, :])
            if n_sel:
                word = ((req_w[gg, None] & ~pres[None, cc]) | (anti_w[gg, None] & pres[None, cc])
                        | (match_w[gg, None] & avo[None, cc]))
                fit &= word == 0
                spread = thresh[:, gg] < cmax  # [S, g]: the selectors compared
                for s in torch.nonzero(spread.any(1)).flatten().tolist():
                    bad = cplus[s, cc][None, :] > thresh[s, gg][:, None]
                    fit &= ~(spread[s][:, None] & bad)
            if other is not None:
                fit &= other[gg][:, cc] > 0
            if stats is not None:
                span = stats[0][gg] - stats[1][gg]
                score = (score - stats[1][gg, None]) * MAX_NODE_SCORE / span[:, None]
            out[gg[:, None], cc[None, :]] = torch.where(fit, score, NEG)
    return out


def score_problem(p, n, n_sel, variant, seed):
    """make_problem's K1 inputs (r = 3, or r = k for variant "rk") with S
    selectors; "pinned": every
    pod pinned, some out of range, every other one requesting nothing; "extremes": NaN and +-inf counts and
    thresholds, and thresholds at the block maxima."""
    r = int(variant[1:]) if variant.startswith("r") else 3
    prob = make_problem(p, n, r, max(n_sel, 1), seed=seed)
    rng = np.random.default_rng(seed + 1)
    if variant == "pinned":
        prob["target_node"] = rng.integers(0, n + 3, p).astype(np.int32)
        prob["pod_request"][::2] = 0.0  # these fit wherever they are pinned
    if variant == "extremes" and n_sel:
        cplus = prob["aff_node"][2 * n_sel:]
        thresh = prob["aff_pod"][3 * n_sel:]
        cplus[rng.uniform(size=cplus.shape) < 0.02] = np.nan
        cplus[0, 5] = np.inf
        thresh[rng.uniform(size=thresh.shape) < 0.05] = np.nan
        thresh[:, ::7] = cplus.max()                 # equal to the largest count
        thresh[:, 3::11] = cplus.max() - 1.0
        thresh[-1, 1::13] = -np.inf
    t = {k: torch.from_numpy(np.ascontiguousarray(x)) for k, x in prob.items()}
    alpha, beta = alpha_beta(t["r_cpu"], t["r_io"])
    pos = (alpha, beta, t["pod_mask"], t["target_node"], t["u"], t["v"],
           t["node_mask"], t["pod_request"], t["alloc"], t["reqd"])
    kw = dict(other=t["other"])
    if n_sel:
        kw.update(aff_pod=t["aff_pod"], aff_node=t["aff_node"])
    return prob, pos, kw


# (p, n, S, variant, group, cols): p and n off every tile multiple
TILE_CASES = [
    (37, 300, 0, "base", 8, 64),
    (37, 300, 1, "base", 8, 64),
    (37, 300, 8, "extremes", 5, 96),
    (70, 1100, 32, "base", 32, 1024),
    (70, 1100, 32, "extremes", 32, 1024),
    (45, 301, 8, "pinned", 32, 128),
    (45, 301, 1, "pinned", 3, 40),
    # the fit bits are built one resource at a time, for any r
    (37, 300, 1, "r1", 8, 64),
    (37, 300, 1, "r4", 8, 64),
    (70, 1100, 8, "r7", 16, 1024),
]


@functools.cache
def reference_scores(p, n, n_sel, variant, minmax):
    prob, pos, kw = score_problem(p, n, n_sel, variant, seed=p * 3 + n + n_sel)
    j = lambda k: jnp.asarray(prob[k])  # noqa: E731
    return np.asarray(ref.fused_masked_score(
        *[j(k) for k in ("u", "v", "node_mask", "alloc", "reqd", "r_cpu", "r_io",
                         "pod_request", "pod_mask")],
        target_node=j("target_node"), other=j("other"),
        aff_pod=j("aff_pod") if n_sel else None,
        aff_node=j("aff_node") if n_sel else None,
        normalizer="min_max" if minmax else "none", interpret=True,
    ))


@pytest.mark.parametrize("minmax", [False, True], ids=["raw", "minmax"])
@pytest.mark.parametrize(
    "p,n,n_sel,variant,group,cols", TILE_CASES,
    ids=[f"p{c[0]}-n{c[1]}-S{c[2]}-{c[3]}-g{c[4]}-c{c[5]}" for c in TILE_CASES],
)
def test_torch_score_tile_model_matches_plain_and_reference(
        p, n, n_sel, variant, group, cols, minmax):
    _, pos, kw = score_problem(p, n, n_sel, variant, seed=p * 3 + n + n_sel)
    if minmax:
        kw["stats"] = fused.fused_score_row_stats(pos[0], pos[1], pos[4], pos[5], pos[6])
    got = tile_masked_score(*pos, **kw, group=group, cols=cols)
    plain = fused.masked_score_plain(*pos, **kw)
    assert_same(got, plain)
    want = reference_scores(p, n, n_sel, variant, minmax)
    assert_scores_match(got.numpy(), want, score_tolerance(kw.get("stats")))
    feasible = got > NEG * 0.5
    assert feasible.any() and not feasible.all()
    if variant == "pinned":
        assert (feasible.sum(1) <= 1).all()
    # without `other` the model still equals the plain version
    kw.pop("other")
    assert_same(tile_masked_score(*pos, **kw, group=group, cols=cols),
                fused.masked_score_plain(*pos, **kw))


@pytest.mark.parametrize("n_sel", [0, 1, 8, 32])
def test_torch_selector_words_equal_per_selector_test(n_sel):
    """(req & ~pres) | (anti & pres) | (match & avo) is nonzero exactly
    where some selector's three boolean terms are."""
    rng = np.random.default_rng(n_sel)
    m = 4096
    flags = {k: torch.from_numpy(rng.uniform(size=(n_sel, m)) < prob)
             for k, prob in (("req", 0.05), ("anti", 0.05), ("match", 0.1),
                             ("pres", 0.7), ("avo", 0.05))}
    per_sel = ((flags["req"] & ~flags["pres"]) | (flags["anti"] & flags["pres"])
               | (flags["match"] & flags["avo"])).any(0)
    w = {k: words(f) for k, f in flags.items()}
    word = (w["req"] & ~w["pres"]) | (w["anti"] & w["pres"]) | (w["match"] & w["avo"])
    np.testing.assert_array_equal((word != 0).numpy(), per_sel.numpy())
    if n_sel:
        assert per_sel.any() and not per_sel.all()
        assert int(w["pres"].max()) < 1 << n_sel  # one word holds S <= 32 flags


def test_torch_unrequested_resource_changes_no_cell():
    """A resource that no pod requests excludes no node, whatever its
    capacity: r = 3 plus such a fourth resource (over capacity on half the
    nodes) gives r = 3's cells, bit for bit. chip_smoke.py times K1 on
    this case beside r = 3."""
    _, pos, kw = score_problem(70, 1100, 8, "base", seed=5)
    kw["stats"] = fused.fused_score_row_stats(pos[0], pos[1], pos[4], pos[5], pos[6])
    rng = np.random.default_rng(6)
    n = pos[4].shape[0]
    alloc4 = rng.uniform(1, 10, (n, 1)).astype(np.float32)
    reqd4 = (alloc4 * rng.uniform(0, 2, (n, 1))).astype(np.float32)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x))  # noqa: E731
    pos4 = pos[:7] + (torch.cat([pos[7], torch.zeros(pos[7].shape[0], 1)], 1),
                      torch.cat([pos[8], t(alloc4)], 1), torch.cat([pos[9], t(reqd4)], 1))
    assert (pos4[9][:, 3] > pos4[8][:, 3]).any()
    base = fused.masked_score_plain(*pos, **kw)
    assert_same(fused.masked_score_plain(*pos4, **kw), base)
    assert_same(tile_masked_score(*pos4, **kw, group=16, cols=1024), base)
