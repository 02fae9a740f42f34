"""The affinity head's captured blocks on the card (marked `card`; each
test skips without a CUDA device): run there with

    python -m pytest tests/test_torch_round_graph_card.py -m card -q

- the replayed CUDA graphs give bitwise the eager loop's node_idx and
  free_after, and run the same rounds, on windows of scheduler_perf's
  SchedulingPodAntiAffinity at 5,000 nodes (1,024 pods x 8,192 nodes,
  one anti-affinity selector on the hostname): several windows of one
  shape with other contents, the first capturing and the rest hits, then
  a window of a new shape; and in the scatter forms of eviction and fold;
- one eager block of rounds makes no host synchronisation, under
  torch.cuda.set_sync_debug_mode("error").

The file imports nothing of JAX."""

import pytest
import torch

from kubernetes_scheduler_tpu_torch.ops import assign
from kubernetes_scheduler_tpu_torch.sim.cluster_gen import gen_anti_affinity_window
from kubernetes_scheduler_tpu_torch.trace.engine_context import engine_trace

pytestmark = pytest.mark.card

CHECK = assign.CHECK_EVERY


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the captured blocks run only there")
    return torch.device("cuda", 0)


def test_torch_round_graph_card_bitwise(card, monkeypatch):
    cache = assign.RoundGraphCache()
    monkeypatch.setattr(assign, "_graph_cache", lambda device: cache)
    cases = [dict(seed=s) for s in (11, 12, 13)] + [dict(seed=14, pods=500, window=512)]
    outcomes = []
    for case in cases:
        args, aff = gen_anti_affinity_window(device=card, **case)
        with engine_trace(None) as te:
            eager = assign.auction_assign(*args, affinity=aff, _plain=True)
        with engine_trace(None) as tg:
            got = assign.auction_assign(*args, affinity=aff)
        assert torch.equal(got.node_idx, eager.node_idx)
        assert torch.equal(got.free_after.view(torch.int32), eager.free_after.view(torch.int32))
        assert tg.auction_rounds == te.auction_rounds > CHECK
        assert int(got.n_assigned) == case.get("pods", 1000)
        outcomes.append(tg.graph_blocks)
    blocks = [sum(b.values()) for b in outcomes]
    assert outcomes == [{"capture": blocks[0]}, {"hit": blocks[1]}, {"hit": blocks[2]},
                        {"capture": blocks[3]}]
    assert len(cache) == 2


def test_torch_round_graph_card_scatter_forms_bitwise(card, monkeypatch):
    """Eviction and fold in their representative-row scatter forms (the
    forms of wide selector sets) capture and replay as well."""
    cache = assign.RoundGraphCache()
    monkeypatch.setattr(assign, "_graph_cache", lambda device: cache)
    monkeypatch.setattr(assign, "DENSE_EVICT_BUDGET", 0)
    monkeypatch.setattr(assign, "DENSE_FOLD_BUDGET", 0)
    for seed, outcome in ((16, "capture"), (17, "hit")):
        args, aff = gen_anti_affinity_window(device=card, seed=seed)
        with engine_trace(None) as te:
            eager = assign.auction_assign(*args, affinity=aff, _plain=True)
        with engine_trace(None) as tg:
            got = assign.auction_assign(*args, affinity=aff)
        assert torch.equal(got.node_idx, eager.node_idx)
        assert torch.equal(got.free_after.view(torch.int32), eager.free_after.view(torch.int32))
        assert tg.auction_rounds == te.auction_rounds > CHECK
        assert set(tg.graph_blocks) == {outcome}


def test_torch_round_graph_card_block_makes_no_host_sync(card):
    args, aff = gen_anti_affinity_window(device=card, seed=15)
    inv, st = assign._round_operands(*args, 1.0, aff)
    st = assign._affinity_round(inv, st, 1.0)                # lazy set-up outside the check
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(CHECK):
            st = assign._affinity_round(inv, st, 1.0)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert int((st.assigned >= 0).sum()) > 0
