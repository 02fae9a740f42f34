"""The algorithm of K4 `greedy_scan` (kubernetes_scheduler_tpu_torch/csrc/fused.cu)
held on the CPU: per-pod candidate lists under the capacity before the
window, then an in-order pass that takes each pod's first listed cell that
still fits, a row scan restricted to the cells ranked after a full list
that is used up, and the guard that makes every pod scan its whole row
from the first request with a component below zero.

The CUDA kernel cannot run here, so `two_phase_scan` below models it step
by step in PyTorch: each of a row block's warps keeps the top L cells of
the column chunks it reads, the warp lists are merged, and the merged list
counts as exact down to the best last entry of a full warp list. L and the
chunk width are parameters (the kernel's are 32 and 128 columns; the model
takes narrow chunks so that small rows spread over all warps). On seeded
numpy inputs the model must equal, bitwise, K4's plain version
(`greedy_scan_plain`, which the kernel equals bitwise on the card:
chip_smoke.py) and the JAX reference's `fused_greedy_scan` in interpret
mode. The order is the kernel's total order on cells: a NaN ranks above
every number and among NaN the smaller column first. On the case with
NaN cells the reference is its XLA scan body (`greedy_assign` with
greedy_kernel=False, the rule it runs off the TPU), since its Pallas scan
does not qualify a NaN cell.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_scheduler_tpu.ops import assign as rassign
from kubernetes_scheduler_tpu.ops.pallas_fused import fused_greedy_scan
from kubernetes_scheduler_tpu_torch.ops import fused
from kubernetes_scheduler_tpu_torch.ops.assign import NEG

WARPS = 8
CHUNK = 8
# (L: a warp list's length, the cap on the merged list: _list_len)
LISTS = ((1, 8), (2, 16), (32, 256), (32, 1))


def bits(x):
    return np.asarray(x).view(np.uint32)


def cap_ok(q, free):
    """[n] bool: every requested resource fits; an unrequested one never
    excludes a node."""
    return ((q[None, :] <= free) | (q[None, :] == 0)).all(-1)


def qualifies(row):
    """[n] bool: the cells not <= NEG/2 (NaN included)."""
    return ~(row <= NEG * 0.5)


def first_max(row, ok) -> int:
    """The first column of the row maximum over `ok` (the first NaN
    first), -1 when none."""
    if not bool(ok.any()):
        return -1
    return int(torch.argmax(torch.where(ok, row, NEG)))


def ranked(row, cols):
    """`cols` in the order "greater value (NaN greatest), then smaller
    column": a stable descending sort puts NaN first, in column order."""
    cols = torch.sort(cols).values
    return cols[torch.sort(row[cols], descending=True, stable=True).indices]


def candidate_list(row, ok, warp_len, list_len):
    """(columns, full): phase 1 for one row. Warp w reads the chunks w,
    w + WARPS, ... and keeps its first `warp_len` qualifying cells; the
    merged lists are exact down to B, the best last entry of a full warp
    list; `full` unless the list holds every qualifying cell."""
    cols = torch.arange(row.shape[0])
    warp_lists = [
        ranked(row, torch.nonzero(ok & ((cols // CHUNK) % WARPS == w)).flatten())[:warp_len]
        for w in range(WARPS)
    ]
    merged = ranked(row, torch.cat(warp_lists))
    lasts = torch.stack([wl[-1] for wl in warp_lists if len(wl) == warp_len] or [cols[:0]])
    complete = lasts.numel() == 0
    exact = len(merged) if complete else int((merged == ranked(row, lasts)[0]).nonzero()) + 1
    cnt = min(exact, list_len)
    return merged[:cnt], not complete or cnt < len(merged)


def two_phase_scan(sj, req, free0, warp_len, list_len):
    """(picks, free_after, row scans): the kernel's two phases.

    Phase 1: candidate_list under free0 for every row. Phase 2, pods in
    order: the first listed cell that fits the current capacity; else -1
    when the list holds every qualifying cell; else a row scan over the
    cells ranked after the list's last entry. Once a request has a
    component < 0 or NaN, every pod scans its whole row."""
    p, n = sj.shape
    cols = torch.arange(n)
    lists = [
        candidate_list(sj[i], qualifies(sj[i]) & cap_ok(req[i], free0), warp_len, list_len)
        for i in range(p)
    ]
    free = free0.clone()
    picks = torch.full((p,), -1, dtype=torch.int32)
    exact, scans = True, 0
    for i in range(p):
        q = req[i]
        exact = exact and not bool(((q < 0) | torch.isnan(q)).any())
        ok = qualifies(sj[i]) & cap_ok(q, free)
        lst, full = lists[i]
        if not exact:
            pick = first_max(sj[i], ok)
            scans += 1
        elif bool(ok[lst].any()):
            pick = int(lst[torch.nonzero(ok[lst])[0, 0]])
        elif not full:
            pick = -1
        else:
            last = int(lst[-1])
            v, row = sj[i, last], sj[i]
            later = cols > last
            if bool(torch.isnan(v)):
                after = ~torch.isnan(row) | later
            else:
                after = (row < v) | ((row == v) & later)
            pick = first_max(sj[i], ok & after)
            scans += 1
        if pick >= 0:
            picks[i] = pick
            free[pick] = free[pick] - q
    return picks, free, scans


def _mixed(rng):
    """Exact ties between columns and whole rows, an all-NEG row, zero
    requests, and capacity that runs out."""
    p, n, r = 48, 160, 3
    sj = rng.uniform(0, 10, (p, n)).astype(np.float32)
    sj[:, n // 2] = sj[:, n // 3]
    sj[p // 2] = sj[p // 3]
    sj[rng.uniform(size=(p, n)) < 0.3] = NEG
    sj[-1] = NEG
    req = rng.uniform(0, 4, (p, r)).astype(np.float32)
    req[rng.uniform(size=(p, r)) < 0.3] = 0.0
    free = rng.uniform(1, 6, (n, r)).astype(np.float32)
    return sj, req, free


def _contended(rng):
    """Every pod ranks the nodes alike and a node holds one to four pods,
    so lists run out and later pods fall back."""
    p, n, r = 64, 96, 3
    rank = rng.permutation(n).astype(np.float32)
    sj = np.where(rng.uniform(size=(p, n)) < 0.9, rank[None, :], np.float32(NEG))
    req = rng.integers(1, 4, (p, r)).astype(np.float32)
    free = np.broadcast_to(req.max(0) * 1.5, (n, r)).astype(np.float32)
    return sj.astype(np.float32), req, free


def _boundary_ties(rng):
    """64 equal maxima per row at spread columns (twice the longest list),
    the same columns in every row, on nodes that hold one pod each: lists
    run out at a tie boundary and the fallback must keep the smaller
    columns of equal values first."""
    p, n, r = 80, 256, 2
    sj = rng.uniform(0, 10, (p, n)).astype(np.float32)
    sj[:, 3::4] = 50.0
    req = np.broadcast_to(np.float32([2.0, 1.0]), (p, r)).copy()
    free = np.broadcast_to(np.float32([2.0, 1.0]), (n, r)).copy()
    return sj, req, free


def _neg_rows_zero_requests(rng):
    """All-NEG rows; a resource most pods do not request, oversubscribed
    (negative free) on half the nodes."""
    p, n, r = 40, 120, 4
    sj = rng.uniform(0, 10, (p, n)).astype(np.float32)
    sj[1::7] = NEG
    req = rng.integers(1, 3, (p, r)).astype(np.float32)
    req[:, 3] *= rng.uniform(size=p) < 0.3
    free = rng.uniform(2, 6, (n, r)).astype(np.float32)
    free[:, 3] = np.where(rng.uniform(size=n) < 0.5, -1.0, 4.0)
    return sj, req, free


def _r7(rng):
    """Seven resources, three of them unrequested by most pods and tight."""
    p, n, r = 40, 100, 7
    sj = rng.uniform(0, 10, (p, n)).astype(np.float32)
    sj[rng.uniform(size=(p, n)) < 0.2] = NEG
    req = rng.integers(0, 3, (p, r)).astype(np.float32)
    req[:, 4:] *= rng.uniform(size=(p, 3)) < 0.2
    free = rng.integers(1, 5, (n, r)).astype(np.float32)
    return sj, req, free


def _nan_cells(rng):
    """NaN cells in several rows (some at a row's columns shared with other
    rows, so later pods find them taken), a row with NaN and +inf, a NaN
    cell on a node without capacity, and contended capacity, so lists of
    one or two entries run out at NaN cells."""
    sj, req, free = _contended(rng)
    p, n = sj.shape
    nan_rows = np.arange(0, p, 3)
    for k, col in enumerate((5, 17, 40)):
        sj[nan_rows[k::3], col] = np.nan
    sj[4, [2, 60]] = np.inf
    sj[4, [30, 70]] = np.nan
    sj[7, 11] = np.nan
    free[11] = 0.0      # pod 7's NaN cell has no capacity
    return sj, req, free


def _negative_request(rng):
    """A pod in the first third requests a negative amount, which gives
    capacity back: the subset argument fails and the guard must trip."""
    sj, req, free = _contended(rng)
    req[9, 0] = -3.0
    return sj, req, free


CASES = {
    "mixed": _mixed,
    "contended": _contended,
    "boundary-ties": _boundary_ties,
    "neg-rows-zero-requests": _neg_rows_zero_requests,
    "r7": _r7,
    "negative-request": _negative_request,
    "nan-cells": _nan_cells,
}


@functools.cache
def case_data(name):
    """(sj, req, free0, reference picks, reference free_after) as numpy."""
    seed = sorted(CASES).index(name) + 11
    sj, req, free = CASES[name](np.random.default_rng(seed))
    if np.isnan(sj).any():
        p = sj.shape[0]
        want = rassign.greedy_assign(
            jnp.asarray(sj), jnp.asarray(~(sj <= np.float32(NEG * 0.5))),
            jnp.asarray(req), jnp.asarray(free), jnp.zeros(p, jnp.int32),
            jnp.ones(p, bool), greedy_kernel=False,
        )
        return sj, req, free, np.asarray(want.node_idx), np.asarray(want.free_after)
    want_p, want_f = fused_greedy_scan(
        jnp.asarray(sj), jnp.asarray(req), jnp.asarray(free), interpret=True
    )
    return sj, req, free, np.asarray(want_p), np.asarray(want_f)


@pytest.mark.parametrize("lists", LISTS, ids=[f"L{w}-cap{c}" for w, c in LISTS])
@pytest.mark.parametrize("case", list(CASES))
def test_torch_greedy_two_phase_model_matches_plain_and_reference(case, lists):
    sj, req, free, want_p, want_f = case_data(case)
    args = (torch.from_numpy(sj), torch.from_numpy(req), torch.from_numpy(free))
    picks, free_after, scans = two_phase_scan(*args, *lists)
    plain_p, plain_f = fused.greedy_scan_plain(*args)
    np.testing.assert_array_equal(picks.numpy(), plain_p.numpy())
    np.testing.assert_array_equal(bits(free_after.numpy()), bits(plain_f.numpy()))
    np.testing.assert_array_equal(picks.numpy(), want_p)
    np.testing.assert_array_equal(bits(free_after.numpy()), bits(want_f))
    assert (picks.numpy() >= 0).any()
    # each case drives the path it was built for
    if case in ("contended", "boundary-ties", "nan-cells") and lists != (32, 256):
        assert scans > 0  # (32, 256) lists hold every qualifying cell here
    if case == "negative-request":
        assert scans >= sj.shape[0] - 9
    if case == "neg-rows-zero-requests":
        assert (picks.numpy()[1::7] == -1).all()
    if case == "nan-cells":
        # pod 0 takes its NaN cell, pod 4 its first NaN over +inf, pod 7
        # no NaN cell (no capacity there)
        assert picks[0] == 5 and picks[4] == 30 and picks[7] != 11
    if case == "boundary-ties" and lists[0] == 32:
        # the first 64 pods take the 64 tied columns in column order
        np.testing.assert_array_equal(picks.numpy()[:64], np.arange(3, 256, 4))


def test_torch_greedy_scan_list_len_checked_and_plain_on_cpu():
    sj, req, free, want_p, want_f = case_data("mixed")
    args = (torch.from_numpy(sj), torch.from_numpy(req), torch.from_numpy(free))
    for bad in (0, fused.GREEDY_LIST_LEN + 1):  # the kernel's bounds
        with pytest.raises(ValueError, match="_list_len"):
            fused.greedy_scan(*args, _list_len=bad)
    before = dict(fused.launches)
    picks, free_after = fused.greedy_scan(*args, _list_len=1)
    assert fused.launches == before  # CPU tensors never launch a kernel
    assert fused.last_greedy_fallbacks is None
    np.testing.assert_array_equal(picks.numpy(), want_p)
    np.testing.assert_array_equal(bits(free_after.numpy()), bits(want_f))
