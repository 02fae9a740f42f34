"""Peaks of the card and the least time of a kernel launch at its shapes.

The peaks are chip_smoke.py's (NVIDIA's H100 SXM data sheet, dense rates
at the 700 W limit): 3.35 TB/s of HBM, and 67 TFLOP/s of float32 counted
with an FMA as two operations, so 33.5e12 operations a second for kernels
that round every product and sum on its own, as the port's do.

The counts are this benchmark's own, frozen: each input byte is read once
and each output byte written once, and the operations are those the
algorithm needs per cell. A launch's least time is the larger of its
bytes over the bandwidth and its operations over the operation rate; the
share of the roofline is the least time over the measured device time.
"""

from __future__ import annotations

PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_NONFMA_OPS_PER_S = 33.5e12

F32 = 4
BOOL = 1
I32 = 4


def least_s(nbytes: float, ops: float) -> float:
    return max(nbytes / PEAK_BYTES_PER_S, ops / PEAK_F32_NONFMA_OPS_PER_S)


def k1_cost(p: int, n: int, r: int, n_sel: int, other: bool, stats: bool) -> tuple:
    """(bytes, operations) of one K1 masked_score launch on [p, n] cells.

    Reads alpha, beta, target [p] f32/i32 and pod_ok [p] bool; u, v [n]
    f32 and node_mask [n] bool; pod_request [p, r], alloc and reqd [n, r]
    f32; the selector rows aff_pod [4S, p] and aff_node [3S, n] f32; the
    [p, n] f32 `other` mask and the [2, p] f32 min-max bounds when given.
    Writes the [p, n] f32 scores. Per cell: the live score
    10 - 10 * |alpha * v - beta * u| (2 products, a difference, an
    absolute value, a product, a difference), a sum and a compare per
    resource, 4 compares per selector, a compare for `other`, and the
    min-max epilogue (a difference, a product, a quotient)."""
    nbytes = (
        p * (2 * F32 + I32 + BOOL) + n * (2 * F32 + BOOL)
        + F32 * (p * r + 2 * n * r)
        + F32 * (4 * n_sel * p + 3 * n_sel * n)
        + (F32 * p * n if other else 0)
        + (2 * F32 * p if stats else 0)
        + F32 * p * n
    )
    per_cell = 6 + 2 * r + 4 * n_sel + (1 if other else 0) + (3 if stats else 0)
    return nbytes, p * n * per_cell


def k3_cost(p: int, n: int, r: int, active: int) -> tuple:
    """(bytes, operations) of one K3 auction_bid launch: the sj rows of the
    `active` pods read once, price [n] f32, active [p] bool, req [p, r] and
    free [n, r] f32 read once; bid and has [p] i32 written. Per active cell:
    a difference with the price and a compare."""
    nbytes = (
        F32 * active * n + F32 * n + BOOL * p + F32 * (p * r + n * r) + 2 * I32 * p
    )
    return nbytes, 2 * active * n
