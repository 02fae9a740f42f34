"""The port's scenario harness, fault injection and replicated runner
(kubernetes_scheduler_tpu_torch/sim/scenarios/, sim/faults.py) against
the JAX reference's, on the CPU.

Every scenario of SCENARIOS runs at 16 nodes through both packages (the
port on TorchEngine(device="cpu")): the summary counters are equal, the
port's inspect.diff of the two journals (one a replica for the
replicated storm) finds no decision difference, faults included, and the
port's journal replays with zero binding diffs. The same seed run twice
through the port gives the same journal.

Scenario ids are sc01-sc14 (sorted names): one of the names holds a
substring tests/conftest.py marks slow."""

import pytest

from kubernetes_scheduler_tpu.sim import scenarios as ref_scenarios
from kubernetes_scheduler_tpu_torch import TorchEngine, stack_windows
from kubernetes_scheduler_tpu_torch.sim import scenarios
from kubernetes_scheduler_tpu_torch.sim.faults import FaultInjector, FaultPlan, FaultyEngine
from kubernetes_scheduler_tpu_torch.sim.scenarios import SCENARIOS, SimClock
from kubernetes_scheduler_tpu_torch.trace import inspect as tinspect
from kubernetes_scheduler_tpu_torch.trace.replay import replay_journal

NAMES = sorted(SCENARIOS)
IDS = [f"sc{i + 1:02d}" for i in range(len(NAMES))]
# wall-clock fields and the journal paths differ between any two runs
WALL = ("seconds", "pods_per_sec", "journal", "journals")


def journals(summary, path):
    return summary.get("journals") or [path]


def test_torch_scenarios_registry_is_the_reference_registry():
    assert NAMES == sorted(ref_scenarios.SCENARIOS) and len(NAMES) == 14
    for name in NAMES:
        mine, theirs = SCENARIOS[name], ref_scenarios.SCENARIOS[name]
        for attr in ("description", "ticks", "smoke", "chaos", "replicas",
                     "config_overrides"):
            assert getattr(mine, attr, None) == getattr(theirs, attr, None), (name, attr)
        plan = mine(n_nodes=8).fault_plan()
        ref_plan = theirs(n_nodes=8).fault_plan()
        assert (plan is None) == (ref_plan is None)
        if plan is not None:
            assert [vars(w) for w in plan.windows] == [vars(w) for w in ref_plan.windows]


@pytest.mark.parametrize("name", NAMES, ids=IDS)
def test_torch_scenarios_match_reference(tmp_path, name):
    ref_path, port_path = str(tmp_path / "ref"), str(tmp_path / "port")
    want = ref_scenarios.run(name, n_nodes=16, seed=0, trace_path=ref_path)
    got = scenarios.run(name, n_nodes=16, seed=0, trace_path=port_path, device="cpu")
    assert got["pods_bound"] > 0
    assert {k: v for k, v in got.items() if k not in WALL} == {
        k: v for k, v in want.items() if k not in WALL}
    for a, b in zip(journals(want, ref_path), journals(got, port_path), strict=True):
        report = tinspect.diff(a, b)
        assert report["differences"] == 0, report
        assert report["extra_records_a"] == report["extra_records_b"] == 0
        assert report["records_compared"] > 0
        rep = replay_journal(b, engine=TorchEngine(device="cpu"))
        assert rep.replayed > 0 and rep.binding_diffs == 0, rep.to_dict()
    if SCENARIOS[name].chaos:
        assert got["recovered"], got
    else:
        assert got["fallback_cycles"] == 0


SAME_SEED = ["compound-storm", "replica-conflict-storm", "soak"]


@pytest.mark.parametrize("name", SAME_SEED, ids=[IDS[NAMES.index(n)] for n in SAME_SEED])
def test_torch_scenarios_same_seed_same_journal(tmp_path, name):
    runs = [scenarios.run(name, n_nodes=16, seed=3, trace_path=str(tmp_path / k),
                          device="cpu") for k in ("a", "b")]
    assert {k: v for k, v in runs[0].items() if k not in WALL} == {
        k: v for k, v in runs[1].items() if k not in WALL}
    for a, b in zip(journals(runs[0], str(tmp_path / "a")),
                    journals(runs[1], str(tmp_path / "b")), strict=True):
        report = tinspect.diff(a, b)
        assert report["differences"] == 0 and report["records_compared"] > 0
        assert report["extra_records_a"] == report["extra_records_b"] == 0


def test_torch_scenarios_faulty_engine_wraps_the_whole_surface():
    """FaultyEngine gates every dispatch of TorchEngine's surface (the
    stateless, resident, async and fleet calls, and preempt) and hands
    back the inner engine's PendingSchedule on the async ones; the
    capability probes and invalidate pass through."""
    from kubernetes_scheduler_tpu_torch.engine import PendingSchedule
    from kubernetes_scheduler_tpu_torch.sim import gen_cluster, gen_pods
    from kubernetes_scheduler_tpu_torch.sim.faults import FaultError, FaultWindow

    clock = SimClock()
    plan = FaultPlan([FaultWindow("engine", "error", 1.0, 2.0)])
    inner = TorchEngine(device="cpu")
    eng = FaultyEngine(inner, FaultInjector(plan, clock))
    snap = gen_cluster(12, seed=1, device="cpu")
    pods = gen_pods(8, seed=2, device="cpu")
    kw = dict(assigner="auction", normalizer="none", fused=True)

    calls = {
        "schedule_batch": lambda: eng.schedule_batch(snap, pods, **kw),
        "schedule_batch_async": lambda: eng.schedule_batch_async(snap, pods, **kw),
        "schedule_windows": lambda: eng.schedule_windows(snap, stack_windows(pods, 4), **kw),
        "schedule_resident": lambda: eng.schedule_resident(snap, pods, epoch=1, **kw),
        "schedule_resident_async": lambda: eng.schedule_resident_async(
            snap, pods, epoch=2, **kw),
        "schedule_windows_resident": lambda: eng.schedule_windows_resident(
            snap, stack_windows(pods, 4), epoch=3, **kw),
        "schedule_batch_fleet": lambda: eng.schedule_batch_fleet(
            snap, [(None, pods), (None, pods)], **kw),
    }
    public = {n for n in dir(TorchEngine) if n.startswith("schedule_")}
    assert public == set(calls)
    for name, call in calls.items():
        out = call()
        if name.endswith("_async"):
            assert isinstance(out, PendingSchedule)
            out = out.result()
        if name == "schedule_batch_fleet":
            assert len(out) == 2
    assert eng.supports_resident() and eng.supports_fused_min_max()
    eng.invalidate_resident()
    clock.advance(1.5)
    for name, call in calls.items():
        with pytest.raises(FaultError):
            call()
    with pytest.raises(FaultError):
        eng.preempt(snap, pods, None, k_cap=4)
    assert eng.healthy() is False
    clock.advance(1.0)
    assert eng.healthy() is True
