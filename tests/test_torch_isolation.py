"""The port's ground rules: kubernetes_scheduler_tpu_torch and
chip_smoke.py never import jax or the JAX package, entry points default
to CUDA and never fall back to the CPU on their own, and a kernel wrapper
handed CPU tensors runs its plain version without counting a launch."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from kubernetes_scheduler_tpu_torch import TorchEngine, make_pod_batch, make_snapshot
from kubernetes_scheduler_tpu_torch.device import resolve_device
from kubernetes_scheduler_tpu_torch.ops import fused
from kubernetes_scheduler_tpu_torch.sim import gen_cluster

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "kubernetes_scheduler_tpu_torch"


def _imported_modules(path: Path) -> set[str]:
    mods = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            mods.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            mods.add(node.module)
    return mods


def test_torch_port_sources_never_import_jax_or_reference():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax", "optax", "orbax"), (path, mod)
            assert top != "kubernetes_scheduler_tpu", (path, mod)


def test_torch_port_runs_a_cpu_cycle_with_jax_blocked():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['kubernetes_scheduler_tpu'] = None\n"
        "from kubernetes_scheduler_tpu_torch import TorchEngine, stack_windows\n"
        "from kubernetes_scheduler_tpu_torch.sim import gen_cluster, gen_pods\n"
        "import chip_smoke\n"
        "snap = gen_cluster(50, seed=1, gpu=True, device='cpu')\n"
        "pods = gen_pods(32, seed=2, gpu=True, device='cpu')\n"
        "kw = dict(assigner='auction', normalizer='min_max', fused=True,"
        " affinity_aware=False)\n"
        "res = TorchEngine(device='cpu').schedule_windows("
        "snap, stack_windows(pods, 16), **kw)\n"
        "assert int(res.n_assigned) > 0\n"
        "print('ok', int(res.n_assigned))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


def test_torch_port_runs_a_host_cycle_with_jax_blocked():
    """The port's own Scheduler (queue, snapshot builder, mirror,
    resilience, preemption) binds pods on TorchEngine(device='cpu') in a
    process where jax and the JAX package cannot be imported."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['kubernetes_scheduler_tpu'] = None\n"
        "from kubernetes_scheduler_tpu_torch import TorchEngine\n"
        "from kubernetes_scheduler_tpu_torch.host.scheduler import ("
        "RecordingEvictor, Scheduler)\n"
        "from kubernetes_scheduler_tpu_torch.sim import gen_host_cluster, gen_host_pods\n"
        "from kubernetes_scheduler_tpu_torch.utils.config import SchedulerConfig\n"
        "nodes, advisor = gen_host_cluster(32, seed=0)\n"
        "sched = Scheduler(SchedulerConfig(batch_window=16, adaptive_dispatch=False,"
        " min_device_work=1), advisor=advisor, evictor=RecordingEvictor(),"
        " list_nodes=lambda: nodes, list_running_pods=lambda: [],"
        " engine=TorchEngine(device='cpu'))\n"
        "for pod in gen_host_pods(24, seed=1):\n"
        "    sched.submit(pod)\n"
        "m = sched.run_cycle()\n"
        "assert m.pods_bound > 0 and m.engine_seconds > 0, m\n"
        "assert 'jax' not in [k.split('.')[0] for k, v in sys.modules.items() if v]\n"
        "print('ok', m.pods_bound)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


def test_torch_host_default_engine_wants_cuda(tmp_path):
    """Scheduler without an engine runs on cuda and raises without it,
    with policy="learned" (a LearnedEngine) and sharded_engine (a
    ShardedEngine) too; the learned policy refuses a heuristic engine;
    trace_path / span_path open their recorders."""
    from kubernetes_scheduler_tpu_torch.host.scheduler import Scheduler
    from kubernetes_scheduler_tpu_torch.sim import gen_host_cluster
    from kubernetes_scheduler_tpu_torch.utils.config import SchedulerConfig

    nodes, advisor = gen_host_cluster(4, seed=0)
    kw = dict(advisor=advisor, list_nodes=lambda: nodes, list_running_pods=lambda: [])
    if torch.cuda.is_available():
        assert Scheduler(SchedulerConfig(), **kw).engine.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        Scheduler(SchedulerConfig(), **kw)
    for opts in ({"policy": "learned"}, {"sharded_engine": True}):
        with pytest.raises(RuntimeError, match="CUDA"):
            Scheduler(SchedulerConfig(**opts), **kw)
    with pytest.raises(ValueError, match="requires a LearnedEngine"):
        Scheduler(SchedulerConfig(policy="learned"), engine=TorchEngine(device="cpu"), **kw)
    with pytest.raises(ValueError, match="no learned-policy path"):
        Scheduler(SchedulerConfig(policy="learned", sharded_engine=True), **kw)
    sched = Scheduler(
        SchedulerConfig(trace_path=str(tmp_path / "t"), span_path=str(tmp_path / "s")),
        engine=TorchEngine(device="cpu"), **kw,
    )
    assert sched.recorder is not None and sched.spans is not None
    sched.recorder.close()
    sched.spans.close()


def test_torch_new_module_defaults_want_cuda(tmp_path):
    """Every default engine of the trace, pool, shadow, fleet and
    scenario modules is TorchEngine() on cuda: without CUDA each raises
    instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this check needs a process without CUDA")
    from kubernetes_scheduler_tpu_torch.host.engine_pool import SharedEnginePool
    from kubernetes_scheduler_tpu_torch.host.replica import ReplicaFleet
    from kubernetes_scheduler_tpu_torch.host.shadow import ShadowScheduler
    from kubernetes_scheduler_tpu_torch.sim import gen_host_cluster, scenarios
    from kubernetes_scheduler_tpu_torch.trace.replay import replay_journal
    from kubernetes_scheduler_tpu_torch.utils.config import SchedulerConfig

    journal = str(ROOT / "tests" / "torch_fixtures" / "ref-auction")
    nodes, advisor = gen_host_cluster(4, seed=0)
    calls = [
        lambda: replay_journal(journal),
        lambda: SharedEnginePool(),
        lambda: ShadowScheduler(journal, SchedulerConfig()),
        lambda: ReplicaFleet(SchedulerConfig(), n_replicas=2,
                             advisor_factory=lambda i: advisor,
                             list_nodes=lambda: nodes, list_running_pods=lambda: []),
        lambda: ReplicaFleet(SchedulerConfig(shared_engine=True), n_replicas=2,
                             advisor_factory=lambda i: advisor,
                             list_nodes=lambda: nodes, list_running_pods=lambda: []),
        lambda: scenarios.run("burst", n_nodes=8),
        lambda: scenarios.run("replica-conflict-storm", n_nodes=8),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def test_torch_new_modules_run_with_jax_blocked(tmp_path):
    """Every module of the trace, pool, shadow, fleet, lease, fault and
    scenario slice imports where jax and the JAX package cannot, and the
    port records and replays a journal there on TorchEngine(device='cpu')."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['kubernetes_scheduler_tpu'] = None\n"
        "import importlib\n"
        "for m in ('trace', 'trace.schema', 'trace.recorder', 'trace.spans',"
        " 'trace.replay', 'trace.inspect', 'trace.analyze', 'trace.trend',"
        " 'host.engine_pool', 'host.shadow', 'host.leader', 'host.replica',"
        " 'sim.faults', 'sim.scenarios', 'sim.scenarios.base',"
        " 'sim.scenarios.library'):\n"
        "    importlib.import_module('kubernetes_scheduler_tpu_torch.' + m)\n"
        "from kubernetes_scheduler_tpu_torch.sim import scenarios\n"
        "from kubernetes_scheduler_tpu_torch.trace.replay import replay_journal\n"
        f"j = {str(tmp_path / 'j')!r}\n"
        "s = scenarios.run('burst', n_nodes=8, seed=0, trace_path=j, device='cpu')\n"
        "r = replay_journal(j, device='cpu', resident=True)\n"
        "assert s['pods_bound'] > 0 and r.replayed > 0 and r.binding_diffs == 0\n"
        "assert 'jax' not in [k.split('.')[0] for k, v in sys.modules.items() if v]\n"
        "print('ok', r.replayed)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


def test_torch_journal_tools_run_with_torch_blocked():
    """The journal and span tools (trace.inspect, .spans, .analyze,
    .trend) import and run where torch cannot, as the reference's run
    without jax: stats and diff over a committed journal. The package
    __init__s with lazy exports import there too."""
    journal = str(ROOT / "tests" / "torch_fixtures" / "ref-auction")
    code = (
        "import sys\n"
        "sys.modules['torch'] = None\n"
        "sys.modules['jax'] = None\n"
        "from kubernetes_scheduler_tpu_torch.trace import analyze, inspect, spans, trend\n"
        "from kubernetes_scheduler_tpu_torch import __version__, host, models, ops, utils\n"
        "from kubernetes_scheduler_tpu_torch.ops import resources\n"
        "from kubernetes_scheduler_tpu_torch.models import get_policy\n"
        "assert resources.N_CANONICAL == 5 and get_policy('balanced_cpu_diskio')\n"
        f"st = inspect.stats({journal!r})\n"
        f"d = inspect.diff({journal!r}, {journal!r})\n"
        "assert st['records'] == 2 and d['differences'] == 0, (st, d)\n"
        "assert d['records_compared'] == 2\n"
        "assert not [k for k, v in sys.modules.items() if v and k.split('.')[0] == 'torch']\n"
        "print('ok', st['pods_bound'])\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok 2048")


def test_torch_entry_points_default_to_cuda():
    alloc = np.ones((4, 3), np.float32)
    z = np.zeros(4, np.float32)
    assert resolve_device("cpu").type == "cpu"
    if torch.cuda.is_available():
        assert TorchEngine().device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchEngine()
    with pytest.raises(RuntimeError, match="CUDA"):
        make_snapshot(alloc, alloc, z, z, z)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_pod_batch(alloc)
    with pytest.raises(RuntimeError, match="CUDA"):
        gen_cluster(8, seed=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchEngine(device="cuda")


def test_torch_wrappers_take_plain_version_on_cpu():
    rng = np.random.default_rng(0)
    p, n, r = 6, 20, 3
    f = lambda *s: torch.from_numpy(rng.uniform(0, 1, s).astype(np.float32))  # noqa: E731
    alpha, beta, u, v = f(p), f(p), f(n), f(n)
    node_mask = torch.ones(n, dtype=torch.bool)
    pod_ok = torch.ones(p, dtype=torch.bool)
    target = torch.full((p,), -1, dtype=torch.int32)
    req, alloc, reqd = f(p, r), f(n, r) + 1, f(n, r)
    fused.reset_launches()
    got = fused.masked_score(alpha, beta, pod_ok, target, u, v, node_mask, req, alloc, reqd)
    want = fused.masked_score_plain(alpha, beta, pod_ok, target, u, v, node_mask, req, alloc, reqd)
    assert torch.equal(got, want)
    assert torch.equal(
        fused.row_stats(alpha, beta, u, v, node_mask),
        fused.row_stats_plain(alpha, beta, u, v, node_mask),
    )
    sj, price, active = f(p, n), f(n), torch.ones(p, dtype=torch.bool)
    got_b, got_h = fused.auction_bid(sj, price, active, req, alloc)
    want_b, want_h = fused.auction_bid_plain(sj, price, active, req, alloc)
    assert torch.equal(got_b, want_b) and torch.equal(got_h, want_h)
    got_p, got_f = fused.greedy_scan(sj, req, alloc)
    want_p, want_f = fused.greedy_scan_plain(sj, req, alloc)
    assert torch.equal(got_p, want_p) and torch.equal(got_f, want_f)
    assert fused.launches == {
        "masked_score": 0, "row_stats": 0, "auction_bid": 0, "greedy_scan": 0,
    }


def test_torch_bridge_kube_and_command_run_with_jax_blocked():
    """The bridge, kube/, register, models and the CLI import where jax and
    the JAX package cannot; a server on the CPU answers the port's
    RemoteEngine there, and `python -m kubernetes_scheduler_tpu_torch`
    runs."""
    code = (
        "import sys, runpy\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['kubernetes_scheduler_tpu'] = None\n"
        "import importlib\n"
        "for m in ('bridge', 'bridge.codec', 'bridge.client', 'bridge.server',"
        " 'bridge.schedule_pb2', 'kube', 'kube.client', 'kube.convert', 'kube.lease',"
        " 'kube.source', 'kube.volumes', 'register', 'models', 'models.policy', 'cli'):\n"
        "    importlib.import_module('kubernetes_scheduler_tpu_torch.' + m)\n"
        "from kubernetes_scheduler_tpu_torch.bridge import RemoteEngine, make_server\n"
        "from kubernetes_scheduler_tpu_torch.sim import gen_cluster, gen_pods\n"
        "server, port, service = make_server('127.0.0.1:0', device='cpu')\n"
        "server.start()\n"
        "client = RemoteEngine(f'127.0.0.1:{port}', deadline_seconds=60.0)\n"
        "res = client.schedule_batch(gen_cluster(40, seed=1, device='cpu'),"
        " gen_pods(16, seed=2, device='cpu'), assigner='auction')\n"
        "assert int(res.n_assigned) > 0 and client.health_info().platform == 'cpu'\n"
        "client.close()\n"
        "server.stop(None)\n"
        "sys.argv = ['yoda-tpu', 'policies']\n"
        "try:\n"
        "    runpy.run_module('kubernetes_scheduler_tpu_torch', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0, e.code\n"
        "assert 'jax' not in [k.split('.')[0] for k, v in sys.modules.items() if v]\n"
        "print('ok', int(res.n_assigned))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert "ok" in proc.stdout and "yoda-tpu" in proc.stdout


def test_torch_server_and_command_default_to_cuda():
    """EngineService(), make_server(), `scheduler` (--engine local) and
    `sidecar` of the port's CLI run on cuda by default and raise without
    it; they never fall back to the CPU on their own."""
    if torch.cuda.is_available():
        pytest.skip("this check needs a process without CUDA")
    from kubernetes_scheduler_tpu_torch import cli
    from kubernetes_scheduler_tpu_torch.bridge.server import EngineService, make_server

    calls = [
        lambda: EngineService(),
        lambda: make_server("127.0.0.1:0"),
        lambda: cli.main(["scheduler", "--nodes", "4", "--pods", "4"]),
        lambda: cli.main(["scheduler", "--engine", "local", "--nodes", "4", "--pods", "4"]),
        lambda: cli.main(["sidecar", "--port", "0"]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def test_torch_two_tower_and_mesh_run_with_jax_blocked(tmp_path):
    """models.learned, parallel/ and their routes import and run where jax
    and the JAX package cannot: a checkpoint round trip, the Scheduler
    with policy="learned" and with sharded_engine on the CPU, and a server
    built with four CPU shards answering the port's RemoteEngine."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['kubernetes_scheduler_tpu'] = None\n"
        "from kubernetes_scheduler_tpu_torch.models.learned import ("
        "LearnedEngine, init_train_state, load_learned_engine, save_checkpoint)\n"
        "from kubernetes_scheduler_tpu_torch.parallel import ShardedEngine, make_mesh\n"
        "from kubernetes_scheduler_tpu_torch.bridge import RemoteEngine, make_server\n"
        "from kubernetes_scheduler_tpu_torch.models.learned import sharded_learned_score_fn\n"
        "from kubernetes_scheduler_tpu_torch.host.scheduler import Scheduler\n"
        "from kubernetes_scheduler_tpu_torch.sim import (gen_cluster, gen_pods,"
        " gen_host_cluster, gen_host_pods)\n"
        "from kubernetes_scheduler_tpu_torch.utils.config import SchedulerConfig\n"
        "state, model, tx = init_train_state(0, device='cpu')\n"
        f"save_checkpoint({str(tmp_path / 'ckpt')!r}, state)\n"
        f"learned = load_learned_engine({str(tmp_path / 'ckpt')!r}, device='cpu')\n"
        "mesh = make_mesh(4, device='cpu')\n"
        "bound = []\n"
        "pin = dict(batch_window=16, adaptive_dispatch=False, min_device_work=1)\n"
        "for cfg, eng in ((SchedulerConfig(policy='learned', **pin), learned),"
        " (SchedulerConfig(sharded_engine=True, **pin), ShardedEngine(mesh))):\n"
        "    nodes, advisor = gen_host_cluster(32, seed=0)\n"
        "    sched = Scheduler(cfg, advisor=advisor,"
        " list_nodes=lambda: nodes, list_running_pods=lambda: [], engine=eng)\n"
        "    for pod in gen_host_pods(16, seed=1):\n"
        "        sched.submit(pod)\n"
        "    m = sched.run_cycle()\n"
        "    assert m.pods_bound > 0 and not m.used_fallback, m\n"
        "    bound.append(m.pods_bound)\n"
        "server, port, service = make_server('127.0.0.1:0', engine_override=ShardedEngine("
        "mesh, score_fn=sharded_learned_score_fn(learned.params, mesh, model=learned.model)))\n"
        "server.start()\n"
        "client = RemoteEngine(f'127.0.0.1:{port}', deadline_seconds=60.0)\n"
        "res = client.schedule_batch(gen_cluster(32, seed=1, device='cpu'),"
        " gen_pods(8, seed=2, device='cpu'), policy='learned', assigner='auction')\n"
        "assert int(res.n_assigned) > 0\n"
        "client.close()\n"
        "server.stop(None)\n"
        "assert 'jax' not in [k.split('.')[0] for k, v in sys.modules.items() if v]\n"
        "print('ok', bound, int(res.n_assigned))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=180,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


def test_torch_two_tower_and_mesh_default_to_cuda():
    """The learned scorer's and the mesh's entry points run on cuda by
    default and raise without it; none falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this check needs a process without CUDA")
    from kubernetes_scheduler_tpu_torch.host.scheduler import default_engine
    from kubernetes_scheduler_tpu_torch.models.learned import LearnedEngine, init_train_state
    from kubernetes_scheduler_tpu_torch.parallel import (
        ShardedEngine,
        make_mesh,
        make_mesh_multihost,
    )
    from kubernetes_scheduler_tpu_torch.utils.config import SchedulerConfig

    params = init_train_state(0, device="cpu")[0].params
    calls = [
        lambda: init_train_state(0),
        lambda: LearnedEngine(params),
        lambda: make_mesh(2),
        lambda: make_mesh(2, device="cuda"),
        lambda: make_mesh_multihost(2),
        lambda: make_mesh_multihost(2, 1, device="cuda"),
        lambda: ShardedEngine(),
        lambda: default_engine(SchedulerConfig(policy="learned")),
        lambda: default_engine(SchedulerConfig(sharded_engine=True)),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def test_torch_exports_and_dcn_mesh_run_with_jax_blocked():
    """Every name the package __init__s re-export resolves where jax and
    the JAX package cannot be imported, and the (dcn, node) mesh runs
    there: a 2 x 2 CPU mesh schedules as the dense engine does, and one
    dp x node training step runs."""
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['kubernetes_scheduler_tpu'] = None\n"
        "import torch\n"
        "for pkg in ('', '.host', '.ops', '.utils', '.models', '.parallel', '.sim',"
        " '.kube', '.bridge'):\n"
        "    m = importlib.import_module('kubernetes_scheduler_tpu_torch' + pkg)\n"
        "    for name in getattr(m, '__all__', ()):\n"
        "        getattr(m, name)\n"
        "from kubernetes_scheduler_tpu_torch import TorchEngine, __version__\n"
        "from kubernetes_scheduler_tpu_torch.parallel import (DCN_AXIS, NODE_AXIS, Mesh,"
        " ShardedEngine, make_mesh_multihost)\n"
        "from kubernetes_scheduler_tpu_torch.models import (NodeScorer, init_train_state,"
        " make_features, sharded_train_step)\n"
        "from kubernetes_scheduler_tpu_torch.engine import compute_scores\n"
        "from kubernetes_scheduler_tpu_torch.sim import gen_cluster, gen_pods\n"
        "snap = gen_cluster(32, seed=1, device='cpu')\n"
        "pods = gen_pods(8, seed=2, device='cpu')\n"
        "se = ShardedEngine(make_mesh_multihost(2, 2, device='cpu'),"
        " node_axes=(DCN_AXIS, NODE_AXIS))\n"
        "got = se.schedule_batch(snap, pods, assigner='auction')\n"
        "want = TorchEngine(device='cpu').schedule_batch(snap, pods, assigner='auction')\n"
        "assert se.n_shards == 4 and torch.equal(got.node_idx, want.node_idx)\n"
        "state, model, tx = init_train_state(0, model=NodeScorer(8, 16), device='cpu')\n"
        "mesh = Mesh(['cpu'] * 4, (2, 2), ('dp', NODE_AXIS))\n"
        "state, loss = sharded_train_step(state, model, tx, mesh, *make_features(snap, pods),"
        " compute_scores(snap, pods, 'balanced_cpu_diskio'), snap.node_mask, pods.pod_mask)\n"
        "assert state.step == 1 and bool(torch.isfinite(loss))\n"
        "assert 'jax' not in [k.split('.')[0] for k, v in sys.modules.items() if v]\n"
        "print('ok', __version__, int(got.n_assigned))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok 0.1.0")


def test_torch_wire_schema_is_the_references():
    """schedule.proto and schedule_pb2.py are the JAX package's byte for
    byte (one file name in protobuf's default pool: a copy that differed
    would collide with it), so both packages share the message classes."""
    from kubernetes_scheduler_tpu.bridge import schedule_pb2 as ref_pb
    from kubernetes_scheduler_tpu_torch.bridge import schedule_pb2 as pb

    for name in ("schedule.proto", "schedule_pb2.py"):
        ours = (PORT / "bridge" / name).read_bytes()
        theirs = (ROOT / "kubernetes_scheduler_tpu" / "bridge" / name).read_bytes()
        assert ours == theirs, name
    assert pb.DESCRIPTOR.serialized_pb == ref_pb.DESCRIPTOR.serialized_pb
    assert pb.ScheduleRequest is ref_pb.ScheduleRequest
