"""The plain reference that decides `correct`: numpy and PyTorch only.

It rebuilds the cluster's state cycle by cycle from the harness's own
records (the node and pod draws, the bindings the program reported and
the harness's deletions), never from the program's arrays, and judges
every binding of the run by what it says:

- double_binds: bindings of a pod beyond its first;
- lost_pods: created pods neither bound nor still in the queue;
- unknown_nodes: bindings to a node the cluster does not have;
- over_capacity: (node, resource) pairs whose requests exceed allocatable
  at a cycle's end, summed over cycles;
- anti_affinity_breaks: nodes that hold a pod with required anti-affinity
  and another pod its selector matches, at a cycle's end, summed;
- unplaced_with_room: pods the program left unschedulable in a cycle at
  whose end some node still had room for them;
- score_gap: the live policy's score (pkg/yoda/score/algorithm.go:99-119,
  min-max scaled over the nodes whose resources fit the pod at the
  cycle's start, a superset of the nodes the program scales over) of the
  best node that still has room for the pod at the cycle's end, less the
  score of the node the pod took; the widest over every bound pod. A
  cycle the engine served is judged by the engine's float32 scores: its
  auction admits a pod to the node of highest score less price, plus a
  tie jitter below 1% of the row's range, and a node that still has room
  at the end never rejected a bid of these pods, so its price stayed 0; a
  sound run reads below 0.01. A cycle the program's scalar path served
  (CycleMetrics.used_fallback) is judged by that path's own arithmetic,
  the Go reference's: the raw score truncated to an integer (algorithm.go
  :113) and the first node of the highest score taken, one pod after the
  other; a sound run reads 0 there;
- k1_score_err: the widest gap, in score points of 0-100, between K1's
  min-max scaled score (ops.fused.masked_score, the engine's output that
  the auction reads) and the reference's in float64, over the cells the
  reference finds feasible, for the last engine window of the measured
  window: the rows are the pods the host loop handed the engine, in its
  order, the columns the cluster's nodes in the order the harness lists
  them; the scale is the program's (max and min over all nodes, the
  highest floored at 0);
- k1_mask_errors: cells of that window where K1's feasibility (a score
  above NEG / 2) differs from the reference's resource fit at the
  window's start (the cycle's start and the bindings of the cycle's
  earlier windows); padding rows and columns are never feasible.

The live policy, its min-max and the fit are a frozen copy of the numpy
per-pod emulation in kubernetes_scheduler_tpu_torch/bench.py (baseline_rate).
The inputs are taken as the program receives them: node utilisation and
the diskIO annotations rounded to float32, the arithmetic in float64.

`control_check` is the control: the reference put in the program's place
and computed in bfloat16, the precision below the float32 the
configuration states. The pods of each engine-served cycle are placed one
by one on the same start states, each on the node of the best bfloat16
score with room (score_gap), and K1's last window is scored in bfloat16
(k1_score_err); its numbers carry the program's names and go through the
same verdict.

This module imports neither jax, the JAX package, nor the program.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from schedbench.gen.cluster import label_match, pod_request

LIMITS_FILE = Path(__file__).resolve().parent / "limits.json"
# rows of the [pods, nodes] score matrix handled at once
ROW_BLOCK = 2048
MAX_RAW_SCORE = 10.0
MAX_NODE_SCORE = 100.0
DISK_IO_DIVISOR = 50.0
CPU_DIVISOR = 100.0
# the program's infeasible score; a cell above NEG / 2 is feasible
NEG = -1.0e30


def limits(config: dict) -> dict:
    """Each check's limit: limits.json, with the configuration's own
    `limits` over it."""
    out = json.loads(LIMITS_FILE.read_text())["limits"]
    out.update(config.get("limits", {}))
    return out


class PodClasses:
    """The pods of one configuration: its template, in the namespace the
    pod was created in. All pods share the template's request."""

    def __init__(self, config: dict):
        t = config["pod"]
        self.req = pod_request(t)
        anti = t.get("anti_affinity")
        self.has_anti = anti is not None
        labels = t.get("labels", {})

        def matches(ns: str) -> bool:
            if anti is None:
                return False
            nss = anti.get("namespaces")
            return label_match(labels, anti["match_labels"]) and (nss is None or ns in nss)

        init_ns = t.get("init_namespace") or t["namespace"]
        self.match_init = matches(init_ns)
        self.match_new = matches(t["namespace"])


class State:
    """Requests and anti-affinity counts per node."""

    def __init__(self, alloc: np.ndarray):
        n = alloc.shape[0]
        self.alloc = alloc
        self.req = np.zeros_like(alloc)
        self.match = np.zeros(n, np.int64)
        self.anti = np.zeros(n, np.int64)
        self.both = np.zeros(n, np.int64)

    def copy(self) -> "State":
        s = State(self.alloc)
        s.req, s.match, s.anti, s.both = (
            self.req.copy(), self.match.copy(), self.anti.copy(), self.both.copy()
        )
        return s

    def add(self, nodes: np.ndarray, req: np.ndarray, match: np.ndarray,
            anti: bool, sign: int = 1) -> None:
        np.add.at(self.req, nodes, sign * req[None, :])
        np.add.at(self.match, nodes, sign * match.astype(np.int64))
        if anti:
            np.add.at(self.anti, nodes, sign)
            np.add.at(self.both, nodes, sign * match.astype(np.int64))

    def room(self, req: np.ndarray, match: bool, anti: bool) -> np.ndarray:
        """[n] bool: a pod of this class fits the node now."""
        ok = ((self.req + req[None, :]) <= self.alloc).all(1)
        if anti:
            ok &= self.match == 0
        if match:
            ok &= self.anti == 0
        return ok

    def over(self) -> int:
        return int((self.req > self.alloc).sum())

    def anti_breaks(self) -> int:
        bad = (self.anti >= 1) & (self.match >= 1)
        alone = (self.anti == 1) & (self.match == 1) & (self.both == 1)
        return int((bad & ~alone).sum())


def live_scores(io: torch.Tensor, cpu_req: float, u: torch.Tensor,
                v: torch.Tensor, trunc: bool = False) -> torch.Tensor:
    """[p, n] float64 raw live-policy scores of pods with diskIO `io`;
    with trunc, truncated to integers as the Go reference does."""
    beta = torch.where(io > 0, 1.0 / (1.0 + cpu_req / torch.clamp(io, min=1e-300)), 0.0)
    alpha = 1.0 - beta
    s = MAX_RAW_SCORE - MAX_RAW_SCORE * torch.abs(
        alpha[:, None] * v[None, :] - beta[:, None] * u[None, :]
    )
    return torch.clamp(torch.trunc(s), min=0.0) if trunc else s


def score_gaps(io, cpu_req, u, v, feas, avail, chosen, trunc: bool = False) -> torch.Tensor:
    """[p] float64: best min-max-scaled score among `avail` nodes less the
    chosen node's, the scale taken over `feas` nodes (both [n] bool)."""
    out = []
    for a in range(0, io.shape[0], ROW_BLOCK):
        s = live_scores(io[a:a + ROW_BLOCK], cpu_req, u, v, trunc)
        hi = torch.where(feas[None, :], s, -torch.inf).amax(1)
        lo = torch.where(feas[None, :], s, torch.inf).amin(1)
        span = torch.clamp(hi - lo, min=1e-12)
        best = torch.where(avail[None, :], s, -torch.inf).amax(1)
        got = s.gather(1, chosen[a:a + ROW_BLOCK, None])[:, 0]
        gap = torch.where(torch.isfinite(best), (best - got) / span, 0.0)
        out.append(torch.clamp(gap, min=0.0))
    return torch.cat(out) if out else torch.zeros(0, dtype=torch.float64)


def norm_scores(io, cpu_req: float, u, v, dtype=torch.float64) -> torch.Tensor:
    """[p, n] live-policy scores min-max scaled to 0-100 over all nodes as
    the program scales them (the highest floored at 0, the lowest lowered
    by 1 where the two are equal), every operation in `dtype`."""
    io = torch.as_tensor(io, device=u.device).to(dtype)
    u, v = u.to(dtype), v.to(dtype)
    beta = torch.where(io > 0, 1.0 / (1.0 + cpu_req / torch.where(io > 0, io, 1.0)), 0.0)
    alpha = 1.0 - beta
    s = MAX_RAW_SCORE - MAX_RAW_SCORE * torch.abs(alpha[:, None] * v[None, :]
                                                  - beta[:, None] * u[None, :])
    hi = torch.clamp(s.amax(1), min=0.0)
    lo = s.amin(1)
    lo = torch.where(hi == lo, lo - 1.0, lo)
    return (s - lo[:, None]) * MAX_NODE_SCORE / (hi - lo)[:, None]


def _place_bf16(io_np: np.ndarray, cpu_req: float, u, v, state: State, req,
                match: np.ndarray, anti: bool) -> np.ndarray:
    """The control's placement: pods one by one, each on the node of the
    highest bfloat16 score among those with room."""
    out = np.full(io_np.shape[0], -1, np.int64)
    for a in range(0, io_np.shape[0], ROW_BLOCK):
        s = norm_scores(io_np[a:a + ROW_BLOCK], cpu_req, u, v, torch.bfloat16)
        s = s.float().cpu().numpy()
        for i in range(s.shape[0]):
            k = a + i
            ok = state.room(req, bool(match[k]), anti)
            if not ok.any():
                continue
            j = int(np.argmax(np.where(ok, s[i], -np.inf)))
            out[k] = j
            state.add(np.array([j]), req, match[k:k + 1], anti)
    return out


def check(rec, device="cpu") -> dict:
    """{name: value} of every compared number over all cycles of a run."""
    return _walk(rec, device, control=False)


def control_check(rec, device="cpu") -> dict:
    """The control's numbers, under the names check gives them."""
    return _walk(rec, device, control=True)


def _walk(rec, device, *, control: bool) -> dict:
    cfg = rec.config
    cls = PodClasses(cfg)
    cluster = rec.cluster
    io_all = _f32(rec.pod_io)
    init = np.asarray(rec.pod_init, dtype=bool)
    match_all = np.where(init, cls.match_init, cls.match_new)
    dev = torch.device(device)
    u = torch.as_tensor(_f32(cluster.disk_io) / DISK_IO_DIVISOR, device=dev)
    v = torch.as_tensor(_f32(cluster.cpu_pct) / CPU_DIVISOR, device=dev)
    cpu_req = float(cls.req[0])
    state = State(cluster.alloc.astype(np.int64))
    bound_count = np.zeros(rec.submitted, np.int64)
    out = dict(double_binds=0, lost_pods=0, unknown_nodes=0, over_capacity=0,
               anti_affinity_breaks=0, unplaced_with_room=0, score_gap=0.0)
    ctrl = dict(score_gap=0.0)
    k1 = rec.k1
    if k1 is None:
        # no engine window was captured: nothing holds K1 to the reference
        out.update(k1_score_err=float("inf"), k1_mask_errors=1)
    for ci, c in enumerate(rec.cycles):
        pids, nodes = c.bound_pids, c.bound_nodes
        known = nodes >= 0
        out["unknown_nodes"] += int((~known).sum())
        pids, nodes = pids[known], nodes[known]
        np.add.at(bound_count, pids, 1)
        start = state.copy()
        if k1 is not None and ci == k1["cycle"]:
            got = _k1_numbers(k1, start, pids, nodes, match_all, cls, io_all, cpu_req,
                              u, v, control)
            (ctrl if control else out).update(got)
        state.add(nodes, cls.req, match_all[pids], cls.has_anti)
        out["over_capacity"] += state.over()
        out["anti_affinity_breaks"] += state.anti_breaks()
        unsched = int(getattr(c.metrics, "pods_unschedulable", 0))
        if unsched and state.room(cls.req, cls.match_new, cls.has_anti).any():
            out["unplaced_with_room"] += unsched
        if len(pids):
            scalar = bool(getattr(c.metrics, "used_fallback", False))
            if not control:
                out["score_gap"] = max(out["score_gap"], _cycle_gap(
                    io_all[pids], nodes, match_all[pids], start, state, cls,
                    cpu_req, u, v, dev, trunc=scalar))
            elif not scalar:
                cstate = start.copy()
                cnodes = _place_bf16(io_all[pids], cpu_req, u, v, cstate,
                                     cls.req, match_all[pids], cls.has_anti)
                placed = cnodes >= 0
                ctrl["score_gap"] = max(ctrl["score_gap"], _cycle_gap(
                    io_all[pids][placed], cnodes[placed], match_all[pids][placed],
                    start, cstate, cls, cpu_req, u, v, dev))
        if len(c.deleted_pids):
            # a deleted pod leaves the node it was bound to last
            gone = c.deleted_pids
            where = _last_node(rec, gone)
            ok = where >= 0
            state.add(where[ok], cls.req, match_all[gone[ok]], cls.has_anti, -1)
    if control:
        return ctrl
    out["double_binds"] = int(np.clip(bound_count - 1, 0, None).sum())
    out["lost_pods"] = int(rec.submitted - (bound_count > 0).sum() - rec.queued_at_end)
    return out


def _k1_numbers(k1, start: State, pids, nodes, match_all, cls: PodClasses, io_all,
                cpu_req, u, v, control: bool) -> dict:
    """k1_score_err and k1_mask_errors of the captured K1 window; with
    control, k1_score_err of the same window scored in bfloat16."""
    got = k1["out"]
    rows, cols = got.shape
    w = k1["window"]
    window = k1["pids"][w * rows:(w + 1) * rows]
    n = u.shape[0]
    if cols < n or not len(window):
        # the output does not cover the window's pods and nodes
        return dict(k1_score_err=float("inf"), k1_mask_errors=rows * cols)
    # the window starts from the cycle's start and its earlier windows' bindings
    state = start.copy()
    earlier = np.isin(pids, k1["pids"][:w * rows])
    state.add(nodes[earlier], cls.req, match_all[pids[earlier]], cls.has_anti)
    fit = torch.as_tensor(state.room(cls.req, False, False), device=u.device)
    ref_mask = torch.zeros(rows, cols, dtype=torch.bool, device=u.device)
    ref_mask[:len(window), :n] = fit[None, :]
    err = 0.0
    for a in range(0, len(window), ROW_BLOCK):
        b = min(a + ROW_BLOCK, len(window))
        ref = norm_scores(io_all[window[a:b]], cpu_req, u, v)
        if control:
            mine = norm_scores(io_all[window[a:b]], cpu_req, u, v, torch.bfloat16)
        else:
            mine = got[a:b, :n].to(device=u.device)
        gap = torch.where(ref_mask[a:b, :n], (mine.double() - ref).abs(), 0.0)
        err = max(err, float(gap.max()))
    if control:
        return dict(k1_score_err=err)
    mask_errors = int((ref_mask != (got.to(u.device) > NEG * 0.5)).sum())
    return dict(k1_score_err=err, k1_mask_errors=mask_errors)


def _cycle_gap(io, nodes, match, start: State, end: State, cls: PodClasses,
               cpu_req, u, v, dev, trunc: bool = False) -> float:
    """The widest score gap of one cycle's bindings, per pod class."""
    worst = 0.0
    for m in np.unique(match):
        sel = match == m
        feas = torch.as_tensor(start.room(cls.req, False, False), device=dev)
        avail = torch.as_tensor(end.room(cls.req, bool(m), cls.has_anti), device=dev)
        g = score_gaps(
            torch.as_tensor(io[sel], dtype=torch.float64, device=dev), cpu_req, u, v,
            feas, avail, torch.as_tensor(nodes[sel], dtype=torch.int64, device=dev), trunc,
        )
        if g.numel():
            worst = max(worst, float(g.max()))
    return worst


def _f32(x) -> np.ndarray:
    """float64 copy of x rounded to float32, as the program holds it."""
    return np.asarray(x, dtype=np.float32).astype(np.float64)


def _last_node(rec, pids: np.ndarray) -> np.ndarray:
    """Node of each pod's latest binding (cached on the records)."""
    table = getattr(rec, "_node_of", None)
    if table is None or table.shape[0] < rec.submitted:
        table = np.full(rec.submitted, -1, np.int64)
        for c in rec.cycles:
            ok = c.bound_nodes >= 0
            table[c.bound_pids[ok]] = c.bound_nodes[ok]
        rec._node_of = table
    return table[pids]


def verdict(values: dict, lim: dict) -> tuple[bool, dict]:
    """(correct, {name: {value, limit}}) over the compared numbers."""
    shown = {k: {"value": values[k], "limit": lim[k]} for k in lim if k in values}
    return all(v["value"] <= v["limit"] for v in shown.values()), shown
