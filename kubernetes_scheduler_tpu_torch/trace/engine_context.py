"""The handle through which a cycle's open span set reaches the engine's
window loop, its card path and the auction, and the auction's round count
and the card path's work come back (re-exported by host/observe, beside
SpanSet). It lives here, with no imports of its own, so that engine.py
and ops/assign.py read it without depending on the host package.
"""

from __future__ import annotations

import contextlib
import contextvars


class EngineTrace:
    """What one engine call shares with the cycle that made it: the
    cycle's open SpanSet (host/observe; None with spans off), into which
    the engine's window loop, its card path and the auction add their
    spans; the auction rounds the call ran with the bid head that ran them
    (host integers: no device read), with `graph_rounds`, those of the
    affinity head run by replaying a block of rounds an earlier call
    captured, and `graph_blocks`, the replayed blocks by outcome ("hit":
    captured by an earlier call; "capture": by this one); and the card
    path's work. `cards` is the card slots a node of the call's snapshot holds, as the host knew
    them when it built the snapshot (0: no node has a card, and the card
    path records nothing). `card_cells` counts pods x nodes x card slots
    of each card region by stage, from the shapes; `card_events` holds a
    (stage, start, end) CUDA event pair per region, made only with spans
    on, read by the host once the call's result is read."""

    __slots__ = ("spans", "auction_rounds", "head", "graph_rounds", "graph_blocks",
                 "cards", "card_cells", "card_events")

    def __init__(self, spans=None, cards: int = 0):
        self.spans = spans
        self.auction_rounds = 0
        self.head = ""
        self.graph_rounds = 0
        self.graph_blocks: dict = {}
        self.cards = cards
        self.card_cells: dict = {}
        self.card_events: list = []


# the handle the engine code reads (engine.py, ops/assign.py); set by
# engine_trace around the host's engine dispatch and the sidecar's
# device_step. Unset, the engine records nothing.
ENGINE_TRACE: contextvars.ContextVar = contextvars.ContextVar(
    "yoda_tpu_engine_trace", default=None
)


@contextlib.contextmanager
def engine_trace(spans=None, cards: int = 0):
    """Publish `spans` (a cycle's open SpanSet, or None) and the card
    slots of the snapshot (EngineTrace.cards) to the engine calls made
    inside the block; yields the EngineTrace they fill."""
    trace = EngineTrace(spans, cards)
    token = ENGINE_TRACE.set(trace)
    try:
        yield trace
    finally:
        ENGINE_TRACE.reset(token)
