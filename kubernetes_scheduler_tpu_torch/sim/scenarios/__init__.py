"""Scenario harness: registry + runner (see base.py for the contract).

    from kubernetes_scheduler_tpu_torch.sim.scenarios import SCENARIOS, run
    summary = run("burst", n_nodes=64, seed=0, trace_path="/tmp/j")

The port's copy of kubernetes_scheduler_tpu/sim/scenarios/__init__.py;
`device=` picks the engines' device (cuda unless given).
"""

from kubernetes_scheduler_tpu_torch.sim.scenarios.base import (
    FleetScenarioWorld,
    Scenario,
    ScenarioWorld,
    SimClock,
    run_scenario,
    run_scenario_replicated,
    scenario_config,
)
from kubernetes_scheduler_tpu_torch.sim.scenarios.library import SCENARIOS


def run(
    name: str,
    *,
    n_nodes: int = 64,
    intensity: float = 1.0,
    seed: int = 0,
    trace_path: str | None = None,
    span_path: str | None = None,
    config=None,
    faults: bool = True,
    device=None,
) -> dict:
    """Instantiate and run a registered scenario by name. faults=False
    runs a chaos program's traffic WITHOUT its fault plan (the clean
    A/B twin). Scenarios declaring `replicas` > 1 run through the
    replicated-fleet runner (N schedulers over a partitioned queue,
    per-replica journals under <trace_path>/r<i>)."""
    cls = SCENARIOS.get(name)
    if cls is None:
        raise ValueError(
            f"unknown scenario {name!r}; expected one of {sorted(SCENARIOS)}"
        )
    scenario = cls(n_nodes=n_nodes, intensity=intensity)
    runner = (
        run_scenario_replicated
        if getattr(scenario, "replicas", 1) > 1
        else run_scenario
    )
    return runner(
        scenario,
        seed=seed,
        trace_path=trace_path,
        span_path=span_path,
        config=config,
        faults=faults,
        device=device,
    )
