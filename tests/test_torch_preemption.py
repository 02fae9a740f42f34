"""The port's preemption pass (kubernetes_scheduler_tpu_torch/ops/preempt.py,
engine.preempt_batch, TorchEngine.preempt) against the JAX reference on
the CPU, at seeded numpy inputs. Every output is held bitwise: the victim
tables (integers, bools and float32 prefix sums), the post-eviction
affinity mask, the candidate choice, and preempt_batch's node, victims
and n_victims.

Test names avoid the substrings tests/conftest.py marks slow."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_scheduler_tpu import engine as ref_engine
from kubernetes_scheduler_tpu.ops import preempt as ref
from kubernetes_scheduler_tpu.sim import gen_cluster as ref_cluster
from kubernetes_scheduler_tpu.sim import gen_pods as ref_pods
from kubernetes_scheduler_tpu_torch import TorchEngine
from kubernetes_scheduler_tpu_torch import engine as port_engine
from kubernetes_scheduler_tpu_torch.convert import from_reference
from kubernetes_scheduler_tpu_torch.ops import preempt as port

N_NODES, K_CAP = 24, 4


def bits(x):
    a = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def assert_tuple_equal(got, want):
    for name in want._fields:
        g, w = getattr(got, name), getattr(want, name)
        assert g.shape == tuple(w.shape), name
        np.testing.assert_array_equal(bits(g), bits(w), err_msg=name)


def victims_np(case: str, seed: int, m: int = 64, s: int = 8):
    """Victim arrays for one case, as numpy."""
    rng = np.random.default_rng(seed)
    node = rng.integers(0, N_NODES, m).astype(np.int32)
    prio = rng.integers(-1000, 1000, m).astype(np.int32)
    req = rng.integers(0, 4, (m, 3)).astype(np.float32)
    mask = np.ones(m, bool)
    start = rng.integers(0, 1 << 20, m).astype(np.int32)
    if case == "limbs":
        prio = rng.choice(np.array([-2_000_000_000, -65_537, -1, 0, 65_535,
                                    65_536, 1_999_999_999, 2_000_000_000],
                                   np.int32), m)
    elif case == "ties":
        prio = rng.integers(0, 3, m).astype(np.int32)
        start = rng.permutation(m).astype(np.int32)
    elif case == "unplaced":
        node[rng.random(m) < 0.3] = -1
        node[rng.random(m) < 0.1] = N_NODES + 3
        mask[rng.random(m) < 0.2] = False
    elif case == "crowded":
        node = rng.integers(0, 3, m).astype(np.int32)   # ~21 a node, K = 4
    elif case == "fractional":
        req = rng.uniform(0.0, 3.0, (m, 3)).astype(np.float32)
        req *= np.float32(1.0) + rng.uniform(0, 1e-3, (m, 3)).astype(np.float32)
    matches = rng.random((m, s)) < 0.3
    anti = rng.random((m, s)) < 0.1
    return node, prio, req, mask, start, matches, anti


CASES = ["plain", "limbs", "ties", "unplaced", "crowded", "fractional"]


def both_tables(case, seed, with_selectors):
    node, prio, req, mask, start, matches, anti = victims_np(case, seed)
    if not with_selectors:
        matches = anti = None
    kw = dict(n_nodes=N_NODES, k_cap=K_CAP)
    want = ref.build_victim_tables(
        jnp.asarray(node), jnp.asarray(prio), jnp.asarray(req), jnp.asarray(mask),
        victim_start=jnp.asarray(start),
        victim_matches=None if matches is None else jnp.asarray(matches),
        victim_anti=None if anti is None else jnp.asarray(anti), **kw,
    )
    t = torch.from_numpy
    got = port.build_victim_tables(
        t(node), t(prio), t(req), t(mask), victim_start=t(start),
        victim_matches=None if matches is None else t(matches),
        victim_anti=None if anti is None else t(anti), **kw,
    )
    return got, want


@pytest.mark.parametrize("sel", ["s8", "nosel"])
@pytest.mark.parametrize("case", CASES)
def test_torch_victim_tables_bitwise(case, sel):
    got, want = both_tables(case, seed=CASES.index(case), with_selectors=sel == "s8")
    assert_tuple_equal(got, want)


def test_torch_victim_tables_default_start_keeps_input_order():
    node, prio, req, mask, *_ = victims_np("ties", 7)
    want = ref.build_victim_tables(
        jnp.asarray(node), jnp.asarray(prio), jnp.asarray(req), jnp.asarray(mask),
        n_nodes=N_NODES, k_cap=K_CAP)
    got = port.build_victim_tables(
        torch.from_numpy(node), torch.from_numpy(prio), torch.from_numpy(req),
        torch.from_numpy(mask), n_nodes=N_NODES, k_cap=K_CAP)
    assert_tuple_equal(got, want)


def test_torch_victim_tables_limb_sums_are_exact():
    """hi * 2^16 + lo equals the int64 prefix sum of the kept priorities."""
    got, _ = both_tables("limbs", 3, True)
    total = got.psum_hi.to(torch.int64) * 65536 + got.psum_lo.to(torch.int64)
    kept = torch.where(got.vid >= 0, got.prio.to(torch.int64), 0)
    assert torch.equal(total, kept.cumsum(1))
    assert bool(((got.psum_lo >= 0) & (got.psum_lo < 65536)).all())


def affinity_inputs(seed, p=10, s=8):
    rng = np.random.default_rng(100 + seed)
    n = N_NODES
    dom = rng.integers(0, 6, (n, s)).astype(np.int32)     # shared domains
    counts = rng.integers(0, 4, (n, s)).astype(np.float32)
    avoid = (rng.random((n, s)) < 0.2).astype(np.float32)
    node_mask = rng.random(n) < 0.9
    aff = np.where(rng.random((p, 2)) < 0.4, rng.integers(0, s, (p, 2)), -1).astype(np.int32)
    anti = np.where(rng.random((p, 2)) < 0.4, rng.integers(0, s, (p, 2)), -1).astype(np.int32)
    aff[0, 0] = s + 1                                      # out of range: never valid
    spread = np.where(rng.random((p, 2)) < 0.5, rng.integers(0, s, (p, 2)), -1).astype(np.int32)
    spread_max = rng.integers(1, 3, (p, 2)).astype(np.int32)
    matches = rng.random((p, s)) < 0.3
    return dict(domain_counts=counts, avoid_counts=avoid, domain_id=dom,
                node_mask=node_mask, affinity_sel=aff, anti_affinity_sel=anti,
                pod_matches=matches, spread_sel=spread, spread_max=spread_max)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_torch_victim_affinity_after_evictions_bitwise(seed):
    got_t, want_t = both_tables(CASES[seed], seed, True)
    a = affinity_inputs(seed)
    want = ref.affinity_after_evictions(
        ref.PreemptAffinity(**{k: jnp.asarray(v) for k, v in a.items()}), want_t)
    got = port.affinity_after_evictions(
        port.PreemptAffinity(**{k: torch.from_numpy(v) for k, v in a.items()}), got_t)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.any() and not got.all()


@pytest.mark.parametrize("aff", ["bare", "counts"])
@pytest.mark.parametrize("case", CASES)
def test_torch_victim_candidates_bitwise(case, aff):
    seed = CASES.index(case)
    got_t, want_t = both_tables(case, seed, True)
    rng = np.random.default_rng(200 + seed)
    p = 10
    req = rng.integers(0, 6, (p, 3)).astype(np.float32)
    if case == "fractional":
        req = rng.uniform(0, 5, (p, 3)).astype(np.float32)
    pprio = rng.integers(-500, 1500, p).astype(np.int32)
    if case == "limbs":
        pprio = rng.choice(np.array([0, 2_000_000_000, 2_147_483_647], np.int32), p)
    pmask = rng.random(p) < 0.9
    static_ok = rng.random((p, N_NODES)) < 0.8
    free = rng.integers(-2, 3, (N_NODES, 3)).astype(np.float32)
    a = affinity_inputs(seed, p=p) if aff == "counts" else None
    want = ref.preempt_candidates(
        jnp.asarray(req), jnp.asarray(pprio), jnp.asarray(pmask),
        jnp.asarray(static_ok), jnp.asarray(free), want_t,
        affinity=None if a is None else ref.PreemptAffinity(
            **{k: jnp.asarray(v) for k, v in a.items()}))
    t = torch.from_numpy
    got = port.preempt_candidates(
        t(req), t(pprio), t(pmask), t(static_ok), t(free), got_t,
        affinity=None if a is None else port.PreemptAffinity(
            **{k: t(v) for k, v in a.items()}))
    assert_tuple_equal(got, want)
    assert (np.asarray(want.node) >= 0).any()


def engine_problem(seed, with_selectors=True, m=96):
    """A generated constraints cluster whose nodes are full, preemptors
    from the generator, and victims on the nodes (numpy leaves)."""
    snap = ref_cluster(N_NODES, seed=seed, constraints=True)
    snap = snap._replace(requested=snap.allocatable)     # nothing fits without evictions
    pods = ref_pods(12, seed=seed + 1, constraints=True)
    pods = pods._replace(priority=jnp.asarray(
        np.random.default_rng(seed).integers(500, 2000, 12), jnp.int32))
    s = snap.domain_counts.shape[1]
    node, prio, _, mask, start, matches, anti = victims_np("fractional", seed, m=m, s=s)
    # pod-sized requests with non-integer factors (float32 sums in order)
    scale = np.random.default_rng(seed).uniform(0.5, 1.5, (m, 1)).astype(np.float32)
    req = np.asarray(ref_pods(m, seed=seed + 7).request) * scale
    victims = dict(node=node, prio=prio, req=req, mask=mask, start=start,
                   matches=matches if with_selectors else None,
                   anti=anti if with_selectors else None)
    return snap, pods, victims


@pytest.mark.parametrize("sel", ["s8", "nosel"])
@pytest.mark.parametrize("seed", [0, 1])
def test_torch_victim_pass_engine_bitwise(seed, sel):
    snap, pods, v = engine_problem(seed, with_selectors=sel == "s8")
    want = ref_engine.preempt_batch(
        snap, pods,
        ref.VictimArrays(**{k: None if x is None else jnp.asarray(x) for k, x in v.items()}),
        k_cap=K_CAP)
    got = port_engine.preempt_batch(
        from_reference(snap, device="cpu"), from_reference(pods, device="cpu"),
        port.VictimArrays(**{k: None if x is None else torch.from_numpy(x)
                             for k, x in v.items()}),
        k_cap=K_CAP)
    assert_tuple_equal(got, want)
    assert (np.asarray(want.node) >= 0).sum() >= 2


def test_torch_victim_pass_through_engines():
    """TorchEngine(device='cpu').preempt, fed host leaves as the host loop
    feeds it, equals LocalEngine().preempt and counts its call."""
    snap, pods, v = engine_problem(3)
    host = lambda nt: type(nt)(*[np.asarray(x) for x in nt])  # noqa: E731
    want = ref_engine.LocalEngine().preempt(
        host(snap), host(pods),
        ref.VictimArrays(**{k: jnp.asarray(x) for k, x in v.items()}), k_cap=K_CAP)
    eng = TorchEngine(device="cpu")
    got = eng.preempt(
        port_engine.SnapshotArrays(*host(snap)), port_engine.PodBatch(*host(pods)),
        port.VictimArrays(**v), k_cap=K_CAP)
    assert_tuple_equal(got, want)
    assert eng.preempt_calls == 1
