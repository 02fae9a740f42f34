"""The handle through which a cycle's open span set reaches the engine's
window loop and the auction, and the auction's round count comes back
(re-exported by host/observe, beside SpanSet). It lives here, with no
imports of its own, so that engine.py and ops/assign.py read it without
depending on the host package.
"""

from __future__ import annotations

import contextlib
import contextvars


class EngineTrace:
    """What one engine call shares with the cycle that made it: the
    cycle's open SpanSet (host/observe; None with spans off), into which
    the engine's window loop and the auction add their spans, and the
    auction rounds the call ran with the bid head that ran them (host
    integers: no device read)."""

    __slots__ = ("spans", "auction_rounds", "head")

    def __init__(self, spans=None):
        self.spans = spans
        self.auction_rounds = 0
        self.head = ""


# the handle the engine code reads (engine.py, ops/assign.py); set by
# engine_trace around the host's engine dispatch and the sidecar's
# device_step. Unset, the engine records nothing.
ENGINE_TRACE: contextvars.ContextVar = contextvars.ContextVar(
    "yoda_tpu_engine_trace", default=None
)


@contextlib.contextmanager
def engine_trace(spans=None):
    """Publish `spans` (a cycle's open SpanSet, or None) to the engine
    calls made inside the block; yields the EngineTrace they fill."""
    trace = EngineTrace(spans)
    token = ENGINE_TRACE.set(trace)
    try:
        yield trace
    finally:
        ENGINE_TRACE.reset(token)
