"""Record the two committed reference journals beside this script.

    JAX_PLATFORMS=cpu python tests/torch_fixtures/make_journals.py

The JAX package's own Scheduler, on the CPU, drains gen_host_pods(2048,
seed=1) over gen_host_cluster(1000, seed=0) in two 1,024-pod cycles (one
window a cycle, the engine path pinned, resident state on, so the second
record carries a SnapshotDelta), once with the auction and once with
greedy, writing `ref-auction/` and `ref-greedy/`. The engine is the
reference's LocalEngine answering supports_fused_min_max() with True,
so the recorded cycle options say fused min-max, the route the port's
TorchEngine takes; replayed on a card, the journals run the port's K1
and K2 (and K3 or K4).

tests/test_torch_trace.py replays both through the reference and through
the port on the CPU with zero binding diffs, and chip_smoke.py replays
them on the card. Re-run this script after a change to the journal
format or to the reference's decisions, and commit the result.
"""

from __future__ import annotations

import os
import shutil
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
NODES, PODS, WINDOW = 1000, 2048, 1024
ASSIGNERS = {"ref-auction": "auction", "ref-greedy": "greedy"}


def record(out: str, assigner: str) -> dict:
    """Drain the backlog through the reference's Scheduler into `out`;
    returns the recorder's stats."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    from kubernetes_scheduler_tpu.engine import LocalEngine
    from kubernetes_scheduler_tpu.host.scheduler import Scheduler
    from kubernetes_scheduler_tpu.sim.host_gen import gen_host_cluster, gen_host_pods
    from kubernetes_scheduler_tpu.utils.config import SchedulerConfig

    class FusedMinMaxLocalEngine(LocalEngine):
        def supports_fused_min_max(self) -> bool:
            return True

    shutil.rmtree(out, ignore_errors=True)
    nodes, advisor = gen_host_cluster(NODES, seed=0)
    running: list = []
    clock = [0.0]
    cfg = SchedulerConfig(
        assigner=assigner, batch_window=WINDOW, max_windows_per_cycle=1,
        adaptive_dispatch=False, min_device_work=1, resident_state=True,
        trace_path=out,
    )
    sched = Scheduler(
        cfg, advisor=advisor, engine=FusedMinMaxLocalEngine(),
        list_nodes=lambda: nodes, list_running_pods=lambda: running,
        queue_clock=lambda: clock[0],
    )
    for pod in gen_host_pods(PODS, seed=1):
        sched.submit(pod)
    seen = 0
    for _ in range(PODS // WINDOW):
        sched.run_cycle()
        clock[0] += 30.0
        for b in sched.binder.bindings[seen:]:
            running.append(b.pod)
        seen = len(sched.binder.bindings)
    stats = sched.recorder.stats()
    sched.recorder.close()
    stats["pods_bound"] = seen
    return stats


def main() -> int:
    repo = os.path.dirname(os.path.dirname(HERE))
    if repo not in sys.path:
        sys.path.insert(0, repo)
    for name, assigner in ASSIGNERS.items():
        print(name, record(os.path.join(HERE, name), assigner))
    return 0


if __name__ == "__main__":
    sys.exit(main())
