"""Bytes and operations of the GPU-card path of one engine window, for
card_roofline.saturated, counted as schedbench/roofline.py counts a
kernel's: the work of one pass over the window's cells, whatever computes
it, each input byte read once and each output byte written once.

A window of p pods over n nodes of c card slots has p x n x c card cells
(pod, node, card). Per card cell, 48 operations:

- fit (filter.go:11-58), 10: the card's free memory against the pod's
  demand and its clock against the pod's clock (2 compares), each ANDed
  with the card's health (2) and counted toward the node's tallies (2);
  the marks of the cards that score (free memory and clock at least the
  demand: 2 compares, each ANDed with the card's presence: 2);
- maxima (collection.go:30-76), 12: for each of the 6 metrics, the card's
  value selected by its mark (1) and a max (1);
- score (algorithm.go:264-291), 26: for each of the 6 metrics a product
  by 100, a quotient by the pod's maximum, a product by the weight and a
  sum (4), then the mark's select and the sum over the node's cards (2).

Per (pod, node) cell, 8 more: the node's verdict from its tallies (the
card count, memory and clock tallies against the demanded number: 3
compares; two ORs with an absent demand; the ANDs and the OR with no
demand: 3).

Bytes: the cards [n, c, 6] float32, their presence and health [n, c]
bool, and the pods' three demands [p] (number int32, memory and clock
float32) read once; the [p, n] float32 score and the [p, n] bool fit
written once.

The program evaluates the card fit twice a window under the card policy
(in compute_scores and in other_fit); the count is of one pass.
"""

from __future__ import annotations

from schedbench.roofline import BOOL, F32, I32

CARD_METRICS = 6
OPS_PER_CARD_CELL = 10 + 2 * CARD_METRICS + (4 * CARD_METRICS + 2)
OPS_PER_NODE_CELL = 8


def card_cost(p: int, n: int, c: int) -> tuple:
    """(bytes, operations) of the card path of one window of p pods over
    n nodes of c card slots."""
    nbytes = (
        F32 * CARD_METRICS * n * c + 2 * BOOL * n * c
        + (I32 + 2 * F32) * p
        + (F32 + BOOL) * p * n
    )
    return nbytes, OPS_PER_CARD_CELL * p * n * c + OPS_PER_NODE_CELL * p * n


def window_pods(pods_in: int, batch_window: int) -> list:
    """The pods of each engine window of a cycle that popped `pods_in`:
    full windows of `batch_window`, then the rest, as
    schedbench.metrics._shared.windows counts them."""
    full, rest = divmod(int(pods_in), int(batch_window))
    return [int(batch_window)] * full + ([rest] if rest else [])
