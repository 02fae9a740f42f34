"""Out-of-tree plugin registration gate.

The reference's entire pkg/register/register.go is a one-call shim that
registers the yoda plugin with the embedded upstream scheduler
(app.NewSchedulerCommand(app.WithPlugin(yoda.Name, yoda.New)),
register.go:9-13). This is the same gate for this framework: named
factories for the scalar extension-point plugin surface
(host/plugins.SchedulerPlugin) so alternative plugins can be dropped in
without touching the scheduler loop, plus the feature-gate check that
decides batch-on-device vs. scalar per cycle.

The port's copy of kubernetes_scheduler_tpu/register.py.
"""

from __future__ import annotations

from typing import Callable

from kubernetes_scheduler_tpu_torch.host.plugins import ScalarYodaPlugin, SchedulerPlugin

YODA = "yoda-tpu"

_REGISTRY: dict[str, Callable[..., SchedulerPlugin]] = {}


def register_plugin(name: str, factory: Callable[..., SchedulerPlugin]) -> None:
    """app.WithPlugin(name, factory) analog; later registrations win so an
    embedder can shadow the built-in."""
    _REGISTRY[name] = factory


def make_plugin(name: str, /, **kwargs) -> SchedulerPlugin:
    try:
        factory = _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown plugin {name!r}; registered: {sorted(_REGISTRY)}"
        ) from None
    return factory(**kwargs)


def registered_plugins() -> list[str]:
    return sorted(_REGISTRY)


register_plugin(YODA, ScalarYodaPlugin)
