"""The engine surface (host/engine_surface.EngineSurface): every engine of
the port answers every call the host loop makes on it, where it does not
serve a call the answer is the base's default (False, None, 0, the empty
tuple, the profile error), and the port's Scheduler binds a window on
each of them, serial and pipelined, with no probe to fall back on. The
sidecar client's case lives in tests/test_torch_bridge.py beside its
in-process server.

Ids avoid the slow-test substrings of conftest.py."""

import numpy as np
import pytest

from kubernetes_scheduler_tpu_torch import TorchEngine
from kubernetes_scheduler_tpu_torch.engine import PendingSchedule
from kubernetes_scheduler_tpu_torch.host.advisor import NodeUtil, StaticAdvisor
from kubernetes_scheduler_tpu_torch.host.engine_pool import SharedEnginePool
from kubernetes_scheduler_tpu_torch.host.engine_surface import EngineSurface
from kubernetes_scheduler_tpu_torch.host.scheduler import Scheduler
from kubernetes_scheduler_tpu_torch.host.types import Container, Node, Pod
from kubernetes_scheduler_tpu_torch.models import learned
from kubernetes_scheduler_tpu_torch.parallel.engine import ShardedEngine
from kubernetes_scheduler_tpu_torch.parallel.mesh import make_mesh
from kubernetes_scheduler_tpu_torch.sim import gen_cluster, gen_pods
from kubernetes_scheduler_tpu_torch.sim.faults import FaultInjector, FaultPlan, FaultyEngine
from kubernetes_scheduler_tpu_torch.sim.scenarios.base import SimClock
from kubernetes_scheduler_tpu_torch.utils.config import SchedulerConfig

NO_PROFILE = {"armed": 0, "error": "engine has no profile surface"}
# every public name of the base: the calls and attributes consumers use
SURFACE = sorted(n for n in vars(EngineSurface) if not n.startswith("_"))


def _two_tower():
    model = learned.NodeScorer(d_model=8, width=16, depth=1)
    state, _, _ = learned.init_train_state(0, model=model, device="cpu")
    return learned.LearnedEngine(
        state.params, model=learned.NodeScorer(d_model=8, width=16, depth=1), device="cpu"
    )


# id -> (build, what the engine answers: resident, windows-resident,
# fleet, fused min-max, gangs, shards, runs preemption, profiles)
ENGINES = {
    "torch": (lambda: TorchEngine(device="cpu"),
              (True, True, True, True, True, 0, True, True)),
    "mesh1": (lambda: ShardedEngine(make_mesh(1, device="cpu")),
              (True, True, False, False, False, 1, False, False)),
    "two_tower": (_two_tower,
                  (False, False, False, False, False, 0, False, False)),
    "pool_view": (lambda: SharedEnginePool(TorchEngine(device="cpu")).view("r0"),
                  (False, False, False, True, True, 0, True, False)),
    "faulty": (lambda: FaultyEngine(TorchEngine(device="cpu"),
                                    FaultInjector(FaultPlan([]), SimClock())),
               (True, True, True, True, True, 0, True, True)),
}


@pytest.mark.parametrize("name", list(ENGINES))
def test_torch_engine_surface_answers(name, tmp_path):
    build, want = ENGINES[name]
    eng = build()
    missing = [n for n in SURFACE if not hasattr(eng, n)]
    assert not missing, missing
    answers = (
        eng.supports_resident(), eng.supports_windows_resident(), eng.supports_fleet(),
        eng.supports_fused_min_max(), eng.supports_gangs(), eng.n_shards,
    )
    assert answers == want[:6]
    assert eng.resident_used_delta is False and tuple(eng.shard_delta_bytes) == ()
    assert eng.breaker is None
    assert len(eng.collectors) == (3 if name == "pool_view" else 0)
    assert eng.healthy() is True and eng.health_info() is None
    assert eng.invalidate_resident() is None and eng.set_trace_id(7, 3) is None
    profile = eng.arm_profile(0, str(tmp_path))
    assert (profile == NO_PROFILE) is not want[7], profile
    if not want[6]:
        # the host runs the pass in-host on None
        assert eng.preempt(None, None, None, k_cap=1) is None
    snap = gen_cluster(12, seed=1, device="cpu")
    pods = gen_pods(8, seed=2, device="cpu")
    kw = dict(assigner="greedy", normalizer="min_max", fused=False)
    res = eng.schedule_batch(snap, pods, **kw)
    handle = eng.schedule_batch_async(snap, pods, **kw)
    if name != "pool_view":
        assert isinstance(handle, PendingSchedule)
    np.testing.assert_array_equal(np.asarray(handle.result().node_idx), np.asarray(res.node_idx))
    assert int((np.asarray(res.node_idx) >= 0).sum()) > 0
    eng.close()


@pytest.mark.parametrize("depth", [0, 1], ids=["serial", "pipelined"])
@pytest.mark.parametrize("name", list(ENGINES))
def test_torch_engine_surface_host_cycle(name, depth, tmp_path):
    """One Scheduler cycle binds every pod on each engine, with resident
    state on, so the resident guards answer for each engine too."""
    nodes = [
        Node(name=f"n{i}", allocatable={"cpu": 8000.0, "memory": 2**34, "pods": 110})
        for i in range(4)
    ]
    utils = {n.name: NodeUtil(cpu_pct=10.0 * i, mem_pct=20.0, disk_io=5.0)
             for i, n in enumerate(nodes)}
    config = SchedulerConfig(
        batch_window=8, pipeline_depth=depth, resident_state=True,
        min_device_work=0, profile_path=str(tmp_path),
        policy="learned" if name == "two_tower" else "balanced_cpu_diskio",
    )
    sched = Scheduler(
        config, advisor=StaticAdvisor(utils), list_nodes=lambda: nodes,
        list_running_pods=lambda: [], engine=ENGINES[name][0](),
    )
    for i in range(6):
        sched.submit(Pod(name=f"p{i}", containers=[Container(requests={"cpu": 100.0})]))
    for _ in range(3):
        sched.run_cycle()
    assert sched.totals["pods_bound"] == 6
    assert not any(m.used_fallback for m in sched.metrics)
    assert any(m.engine_seconds > 0 for m in sched.metrics)
    assert sched.arm_profile(1)["armed"] == (1 if ENGINES[name][1][7] else 0)
