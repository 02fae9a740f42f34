"""Cycle flight recorder: deterministic capture & replay of scheduling
cycles (the port's copy of kubernetes_scheduler_tpu/trace/; the journal
format is the same, so a journal written by either package reads in the
other).

- trace/schema.py    journal record schema (tags + pinned dtypes)
- trace/recorder.py  CRC-framed rotating journal writer + reader
- trace/replay.py    re-execute a journal through any engine mode and
                     diff bindings bitwise against the recording
- trace/inspect.py   dump / stats / diff backends for the `trace` CLI
"""

from kubernetes_scheduler_tpu_torch._exports import lazy_getattr, names_in
from kubernetes_scheduler_tpu_torch.trace.recorder import (  # noqa: F401
    CycleRecorder,
    TraceError,
    TraceVersionError,
    read_journal,
)

# replay.py imports the engine (and so torch), which the read-only
# journal tooling (dump/stats/diff) must not pull in for the package import
__getattr__ = lazy_getattr(names_in(
    "kubernetes_scheduler_tpu_torch.trace.replay", "ReplayReport", "replay_journal"))
