"""The affinity head's rounds as captured blocks (ops/assign.RoundGraphCache,
one CUDA graph a block of CHECK_EVERY rounds on the card), on the CPU.

A stand-in for the CUDA graph replays the captured Python, so the runner's
contract is held here against the eager loop (`_plain=True`):

- two calls in a row each keep their own results;
- a new shape (or budget form, or price step) captures anew, a known
  shape is a hit, and the cache keeps at most its entries;
- a `rounds` cap that is not a multiple of CHECK_EVERY runs its tail
  eagerly, and the rounds run are the eager loop's;
- a run in which no pod bids stops at the eager loop's round;
- the hit and capture counts, CycleMetrics.auction_graph_rounds and
  auction_graph_blocks_total{outcome} are right, and a failed capture
  raises and caches nothing.

Without the stand-in the CPU path is the eager loop it was: decisions
equal to the JAX reference's, no `auction_block` span, no graph rounds.
tests/test_torch_round_graph_card.py holds the real graphs on the card.

Test names avoid the substrings tests/conftest.py marks slow."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_scheduler_tpu.ops import assign as rassign
from kubernetes_scheduler_tpu_torch.host import observe
from kubernetes_scheduler_tpu_torch.ops import assign
from kubernetes_scheduler_tpu_torch.sim.cluster_gen import gen_anti_affinity_window
from kubernetes_scheduler_tpu_torch.sim.host_gen import gen_host_pods
from kubernetes_scheduler_tpu_torch.trace import analyze
from kubernetes_scheduler_tpu_torch.trace.engine_context import engine_trace
from tests.test_torch_greedy import T, affinity_problem, as_states, bits
from tests.test_torch_spans import drive, make_sched, spans_of

CHECK = assign.CHECK_EVERY


class ReplayGraph:
    """Stand-in for CudaBlockGraph: capture runs the warm-up round and
    keeps the block; replay runs it again."""

    captured = 0

    def __init__(self, device):
        self.block = None

    def capture(self, block, warm):
        warm()
        self.block = block
        ReplayGraph.captured += 1

    def replay(self):
        self.block()


class BrokenGraph(ReplayGraph):
    def capture(self, block, warm):
        raise RuntimeError("operation not permitted when stream is capturing")


@pytest.fixture
def graphs(monkeypatch):
    """A fresh cache of stand-in graphs, used on the CPU as on the card."""
    cache = assign.RoundGraphCache(make_graph=ReplayGraph)
    monkeypatch.setattr(assign, "_graph_cache", lambda device: cache)
    ReplayGraph.captured = 0
    return cache


def window(seed, pods=60, nodes=70, **kw):
    kw = {"running": 5, "window": 64, "node_axis": 80, **kw}
    return gen_anti_affinity_window(pods, nodes, seed=seed, device="cpu", **kw)


def run(args, aff, spans=None, **kw):
    """(result, EngineTrace) of one call under a published trace."""
    with engine_trace(spans) as trace:
        res = assign.auction_assign(*args, affinity=aff, **kw)
    return res, trace


def same(a, b):
    return (torch.equal(a.node_idx, b.node_idx)
            and np.array_equal(bits(a.free_after.numpy()), bits(b.free_after.numpy()))
            and int(a.n_assigned) == int(b.n_assigned))


def test_torch_round_graph_two_calls_keep_own_results(graphs):
    (a_args, a_aff), (b_args, b_aff) = window(1), window(2)
    first, t1 = run(a_args, a_aff)
    kept = (first.node_idx.clone(), first.free_after.clone())
    second, t2 = run(b_args, b_aff)
    assert t1.graph_blocks == {"capture": t1.auction_rounds // CHECK}
    assert t2.graph_blocks == {"hit": t2.auction_rounds // CHECK}
    # the second call's replays rewrote the block's buffers, not the first result
    assert torch.equal(first.node_idx, kept[0]) and torch.equal(first.free_after, kept[1])
    assert not torch.equal(first.node_idx, second.node_idx)
    for (args, aff), got, tr in (((a_args, a_aff), first, t1), ((b_args, b_aff), second, t2)):
        eager, te = run(args, aff, _plain=True)
        assert same(got, eager) and te.auction_rounds == tr.auction_rounds > CHECK
        assert te.graph_blocks == {} and te.graph_rounds == 0


def test_torch_round_graph_new_shape_captures_known_shape_hits(graphs, monkeypatch):
    outcomes = []
    for case in ({}, {"window": 128}, {}, {"window": 128}, {"node_axis": 96}):
        args, aff = window(3, **case)
        res, tr = run(args, aff)
        outcomes.append(set(tr.graph_blocks))
        assert same(res, run(args, aff, _plain=True)[0])
    assert outcomes == [{"capture"}, {"capture"}, {"hit"}, {"hit"}, {"capture"}]
    assert len(graphs) == 3 and ReplayGraph.captured == 3
    # the fold's scatter form and another price step are other kernels
    args, aff = window(3)
    monkeypatch.setattr(assign, "DENSE_FOLD_BUDGET", 0)
    assert set(run(args, aff)[1].graph_blocks) == {"capture"}
    assert set(run(args, aff, price_frac=0.5)[1].graph_blocks) == {"capture"}
    assert set(run(args, aff)[1].graph_blocks) == {"hit"}


def test_torch_round_graph_cache_keeps_its_entries(monkeypatch):
    cache = assign.RoundGraphCache(make_graph=ReplayGraph, entries=2)
    monkeypatch.setattr(assign, "_graph_cache", lambda device: cache)
    seen = []
    for w in (64, 128, 64, 256, 128, 64):
        args, aff = window(4, window=w)
        seen.append(next(iter(run(args, aff)[1].graph_blocks)))
    # 128 was the least recently used when 256 came, so it captures again
    assert seen == ["capture", "capture", "hit", "capture", "capture", "capture"]
    assert len(cache) == 2


@pytest.mark.parametrize("cap", [CHECK + 5, 3 * CHECK + 1, CHECK - 3, 2 * CHECK])
def test_torch_round_graph_cap_tail_runs_eagerly(graphs, tmp_path, cap):
    args, aff = window(5)
    eager, te = run(args, aff, rounds=cap, _plain=True)
    ss = observe.SpanSet(1)
    got, tg = run(args, aff, ss, rounds=cap)
    assert same(got, eager)
    assert tg.auction_rounds == te.auction_rounds == cap     # the cap, not the stop
    blocks = cap // CHECK
    assert tg.graph_blocks == ({"capture": blocks} if blocks else {})
    names = [name for name, *_ in ss.spans]
    assert names.count("auction_block") == blocks
    assert names.count("auction_round") == cap - blocks * CHECK
    assert [a["rounds"] for name, _, _, a in ss.spans if name == "auction"] == [cap]
    assert all(a == {"rounds": CHECK, "outcome": "capture"}
               for name, _, _, a in ss.spans if name == "auction_block")


@pytest.mark.parametrize("seed", [6, 7, 8])
def test_torch_round_graph_no_bid_stop_like_eager(graphs, seed):
    args, aff = window(seed)
    eager, te = run(args, aff, _plain=True)
    run(args, aff)                                            # the capture
    got, tg = run(args, aff)
    assert same(got, eager)
    assert tg.auction_rounds == te.auction_rounds < 1024
    assert tg.auction_rounds % CHECK == 0
    assert tg.graph_rounds == tg.auction_rounds
    assert tg.graph_blocks == {"hit": tg.auction_rounds // CHECK}


def test_torch_round_graph_shared_domains_match_reference(graphs):
    """A problem with domains shared by groups of nodes, spread terms and
    stale selector ids (tests/test_torch_greedy.affinity_problem): the
    replayed blocks give the eager loop's result and the reference's."""
    (scores, feasible, req, free, prio, mask), state = affinity_problem(48, 36, 5, seed=4)
    ra, ta = as_states(state)
    args = (scores, feasible, req, free, prio, mask)
    want = rassign.auction_assign(*[jnp.asarray(a) for a in args], rounds=64,
                                  affinity=ra, bid_kernel=False)
    eager, te = run([T(a) for a in args], ta, rounds=64, _plain=True)
    for _ in range(2):
        got, tg = run([T(a) for a in args], ta, rounds=64)
        assert same(got, eager) and tg.auction_rounds == te.auction_rounds
    np.testing.assert_array_equal(got.node_idx.numpy(), np.asarray(want.node_idx))
    np.testing.assert_array_equal(bits(got.free_after.numpy()), bits(want.free_after))
    assert tg.graph_blocks == {"hit": tg.auction_rounds // CHECK}


def test_torch_round_graph_plain_and_k3_stay_eager(graphs):
    args, aff = window(9)
    assert run(args, aff, _plain=True)[1].graph_blocks == {}
    with engine_trace(None) as tr:
        assign.auction_assign(*args, _plain=True)
        assign.auction_assign(*args)
    assert tr.graph_blocks == {} and tr.graph_rounds == 0 and tr.head == "k3"
    assert len(graphs) == 0 and ReplayGraph.captured == 0


def test_torch_round_graph_failed_capture_raises(monkeypatch):
    cache = assign.RoundGraphCache(make_graph=BrokenGraph)
    monkeypatch.setattr(assign, "_graph_cache", lambda device: cache)
    args, aff = window(10)
    with pytest.raises(RuntimeError, match="capturing"):
        assign.auction_assign(*args, affinity=aff)
    assert len(cache) == 0


def test_torch_round_graph_counts_reach_the_scheduler(graphs, tmp_path):
    path = tmp_path / "spans"
    sched, running = make_sched(str(path), constraints=True)
    ms = drive(sched, running, gen_host_pods(96, seed=1, constraints=True), cycles=4)
    events = spans_of(sched, path)
    blocks = [e for e in events if e["name"] == "auction_block"]
    by_outcome = {o: sum(e["args"]["outcome"] == o for e in blocks) for o in ("hit", "capture")}
    assert by_outcome["capture"] > 0 and by_outcome["hit"] > 0
    for outcome, count in by_outcome.items():
        assert sched.ctr_graph_blocks.value(outcome=outcome) == count
        row = f'yoda_tpu_auction_graph_blocks_total{{outcome="{outcome}"}} {count}'
        assert row in sched.ctr_graph_blocks.render()
    assert sum(m.auction_graph_rounds for m in ms) == CHECK * by_outcome["hit"]
    rounds = sum(m.auction_rounds for m in ms)
    eager = sum(e["name"] == "auction_round" for e in events)
    assert rounds == eager + CHECK * len(blocks) > 0
    assert sched.ctr_graph_blocks in sched.prom_collectors
    report = analyze.build_report(str(path))
    assert abs(sum(report["attribution_pct"].values()) - 100.0) < 0.5
    assert "auction_block" not in report["attribution_pct"]
    assert report["stages"]["auction_block"]["count"] == len(blocks)


def test_torch_round_graph_cpu_path_unchanged(tmp_path):
    """No stand-in: the CPU runs every round eagerly, equal to the
    reference, with no block span and no graph rounds."""
    for seed in (4, 5):
        args, state = affinity_problem(48, 36, 5, seed=seed)
        ra, ta = as_states(state)
        want = rassign.auction_assign(*[jnp.asarray(a) for a in args], rounds=64,
                                      affinity=ra, bid_kernel=False)
        ss = observe.SpanSet(1)
        got, tr = run([T(a) for a in args], ta, ss, rounds=64)
        np.testing.assert_array_equal(got.node_idx.numpy(), np.asarray(want.node_idx))
        np.testing.assert_array_equal(bits(got.free_after.numpy()), bits(want.free_after))
        assert tr.graph_rounds == 0 and tr.graph_blocks == {}
        assert sum(name == "auction_round" for name, *_ in ss.spans) == tr.auction_rounds
        assert not any(name == "auction_block" for name, *_ in ss.spans)
    path = tmp_path / "spans"
    sched, running = make_sched(str(path), constraints=True)
    ms = drive(sched, running, gen_host_pods(96, seed=1, constraints=True), cycles=2)
    assert sum(m.auction_rounds for m in ms) > 0
    assert all(m.auction_graph_rounds == 0 for m in ms)
    assert not any(e["name"] == "auction_block" for e in spans_of(sched, path))
    assert sched.ctr_graph_blocks.breakdown() == {}


def test_torch_round_graph_span_and_counter_registered():
    assert "auction_block" in observe.PORT_SPANS
    assert "auction_block" in observe.SHIPPED_SPANS
    assert "auction_block" in analyze.NON_ATTRIBUTED_STAGES
    assert "auction_graph_blocks_total" in observe.SHIPPED_METRICS
