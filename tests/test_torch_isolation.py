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
            assert top not in ("jax", "jaxlib", "flax", "optax"), (path, mod)
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


def test_torch_host_default_engine_wants_cuda():
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
    for opts, item in (({"policy": "learned"}, "item 9"),
                       ({"sharded_engine": True}, "item 10"),
                       ({"trace_path": "t"}, "item 7"),
                       ({"span_path": "s"}, "item 7")):
        with pytest.raises(NotImplementedError, match=item):
            Scheduler(SchedulerConfig(**opts), engine=TorchEngine(device="cpu"), **kw)


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
