"""Seeded SPMD mutants: the analyzer and the budget must catch each class.

The counterpart of kubernetes_scheduler_tpu/analysis/spmd_mutants.py: an
analyzer that has never caught anything is an assertion, not a tool.
Each mutant re-introduces one real SPMD bug class into a miniature
sharded scoring module over the port's Mesh and collectives (BASE below:
a psum statistic, a pmax / pmin bound pair, a candidate election by
to_lead and torch.cat, and its own declared collective budget), and the
layer that owns the class MUST report it:

- `dropped-psum`: the global-sum psum deleted — shard 0's local sum
  ships as the global mean. Caught by the AST rule (`xs[k]` of a sharded
  list flows into the return) AND by the collective budget (psum sites
  drift down);
- `wrong-axis`: a reduction moved onto an axis name no mesh declares.
  Caught by the AST rule's unbound-axis check;
- `replicated-double-count`: a second psum around the already
  replicated sums — counts them D times. Caught by the AST rule's
  replicated-psum check, and the budget drifts too;
- `extra-gather-over-budget`: a gratuitous gather of the shards' local
  minima — AST-silent by construction (gathering per-shard values is a
  legitimate shape), so ONLY the budget catches it: the per-round
  latency class the budget exists for.

`check_spmd_mutants` runs on every full-repo lint next to the contract
layer: the unmutated BASE must be clean on both layers, and every mutant
caught by every layer it declares — a survived mutant is itself a lint
violation. The budget half runs the module on the device asked for (a
4-shard mesh of one device), so it needs torch, imported inside the
function; the AST half reads source only.
"""

from __future__ import annotations

import os
import tempfile

from kubernetes_scheduler_tpu_torch.analysis.core import Violation

RULE = "spmd-mutant"

MUTANTS_PATH = "kubernetes_scheduler_tpu_torch/analysis/spmd_mutants.py"

# the miniature sharded surface every mutant perturbs, with its own
# declared collective budget (distinct call sites per kind)
BASE = '''\
"""SPMD mutant base: a miniature node-sharded scoring surface."""

import torch

from kubernetes_scheduler_tpu_torch.parallel.engine import shard_snapshot
from kubernetes_scheduler_tpu_torch.parallel.mesh import (
    Mesh,
    broadcast,
    pmax,
    pmin,
    psum,
    to_lead,
)

NODE_AXIS = "node"

BUDGET = {"psum": 1, "pmax": 1, "pmin": 1, "all_gather": 0, "gather_cat": 0,
          "broadcast": 2, "to_lead": 2, "reduce_lead": 0}


def make_mesh(device):
    return Mesh([device] * 4, (4,), (NODE_AXIS,))


def score(snapshot, w, mesh):
    shards = shard_snapshot(snapshot, mesh)
    xs = [s.cpu_pct for s in shards]
    ws = broadcast(w, mesh)
    totals = psum([x.sum() for x in xs], mesh, NODE_AXIS)
    mean = totals[0] / snapshot.cpu_pct.shape[0]
    his = pmax([x.max() for x in xs], mesh, NODE_AXIS)
    los = pmin([x.min() for x in xs], mesh)
    scaled = [
        (x - m) * wk.sum() / torch.clamp(hi - lo, min=1e-6)
        for x, m, wk, hi, lo in zip(xs, broadcast(mean, mesh), ws, his, los)
    ]
    n_local = xs[0].shape[0]
    vals = torch.stack(to_lead([s.max() for s in scaled], mesh))
    cols = torch.cat(to_lead(
        [s.argmax().view(1) + k * n_local for k, s in enumerate(scaled)], mesh))
    best = cols[torch.argmax(vals)]
    return best, mean
'''

# name -> (literal pattern, replacement, layers that MUST catch it)
SPMD_MUTANTS = {
    "dropped-psum": (
        "    totals = psum([x.sum() for x in xs], mesh, NODE_AXIS)\n",
        "    totals = [x.sum() for x in xs]\n",
        ("ast", "budget"),
    ),
    "wrong-axis": (
        "    his = pmax([x.max() for x in xs], mesh, NODE_AXIS)\n",
        '    his = pmax([x.max() for x in xs], mesh, "nodez")\n',
        ("ast",),
    ),
    "replicated-double-count": (
        "    mean = totals[0] / snapshot.cpu_pct.shape[0]\n",
        "    totals = psum(totals, mesh, NODE_AXIS)\n"
        "    mean = totals[0] / snapshot.cpu_pct.shape[0]\n",
        ("ast", "budget"),
    ),
    "extra-gather-over-budget": (
        "    best = cols[torch.argmax(vals)]\n",
        "    extra = torch.cat(to_lead([s.min().view(1) for s in scaled], mesh))\n"
        "    best = cols[torch.argmax(vals)] + extra.min().long() * 0\n",
        ("budget",),
    ),
}


def mutate(name: str) -> str:
    pattern, replacement, _ = SPMD_MUTANTS[name]
    mutated = BASE.replace(pattern, replacement)
    if mutated == BASE:
        raise ValueError(
            f"mutant {name!r}: pattern no longer matches the BASE "
            "module — the harness drifted from its own source"
        )
    return mutated


def _ast_findings(source: str, workdir: str) -> list:
    """The spmd-collective family's findings on `source` (written to a
    scratch module so the normal lint path runs unchanged)."""
    from kubernetes_scheduler_tpu_torch.analysis.core import run_lint

    path = os.path.join(workdir, "spmd_mutant_mod.py")
    with open(path, "w", encoding="utf-8") as f:
        f.write(source)
    return [v for v in run_lint([path], rules=["spmd-collective"]) if not v.waived]


def _budget_findings(source: str, workdir: str, device) -> list:
    """Run the module's surface on a 4-shard mesh of `device` and diff
    its collective call sites against its own declared BUDGET (the walk
    the repo-level gate runs against COLLECTIVE_BUDGET.json). A module
    that fails to run counts as caught — the mutation broke the program
    outright."""
    import importlib.util

    import numpy as np
    import torch

    from kubernetes_scheduler_tpu_torch.analysis.contracts import (
        COLLECTIVE_KINDS,
        site_counts,
    )
    from kubernetes_scheduler_tpu_torch.device import resolve_device
    from kubernetes_scheduler_tpu_torch.engine import make_snapshot

    dev = resolve_device(device)
    path = os.path.join(workdir, "spmd_mutant_run.py")
    with open(path, "w", encoding="utf-8") as f:
        f.write(source)
    spec = importlib.util.spec_from_file_location("_spmd_mutant_mod", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    n, r = 16, 3
    rng = np.random.default_rng(0)
    snap = make_snapshot(
        np.ones((n, r), np.float32), np.zeros((n, r), np.float32),
        np.zeros(n, np.float32), (rng.random(n) * 100).astype(np.float32),
        np.zeros(n, np.float32), device=dev,
    )
    w = torch.ones(4, dtype=torch.float32, device=dev)
    try:
        mesh = mod.make_mesh(dev)
        _, counts = site_counts(lambda: mod.score(snap, w, mesh))
    except Exception as e:  # noqa: BLE001 — a broken run IS a catch
        return [Violation(RULE, "spmd_mutant_run.py", 1, f"run failed: {e}")]
    return [
        Violation(
            RULE, "spmd_mutant_run.py", 1,
            f"{kind}: reached {counts.get(kind, 0)} != budgeted {mod.BUDGET.get(kind, 0)}",
        )
        for kind in COLLECTIVE_KINDS
        if counts.get(kind, 0) != mod.BUDGET.get(kind, 0)
    ]


def run_spmd_mutant(name: str, device=None, workdir: str | None = None) -> dict:
    """{"ast": [findings], "budget": [findings]} for one mutant."""
    source = mutate(name)
    with tempfile.TemporaryDirectory() as tmp:
        wd = workdir or tmp
        return {
            "ast": _ast_findings(source, wd),
            "budget": _budget_findings(source, wd, device),
        }


def check_spmd_mutants(device=None) -> list[Violation]:
    """The lint entry point: [] when the unmutated base is clean on both
    layers and every mutant is caught by every layer it declares. A
    survived mutant means the SPMD analyzer (or the budget) lost its
    teeth for that bug class — a checker regression, not a code bug.
    `device` as for contracts.check_contracts (default cuda)."""
    from kubernetes_scheduler_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    out: list[Violation] = []
    with tempfile.TemporaryDirectory() as tmp:
        for v in _ast_findings(BASE, tmp) + _budget_findings(BASE, tmp, dev):
            out.append(Violation(
                RULE, MUTANTS_PATH, 1,
                "the UNMUTATED spmd-mutant base module is dirty "
                f"(every catch would be vacuous): {v.message}",
            ))
        if out:
            return out
        for name, (_, _, expect) in SPMD_MUTANTS.items():
            try:
                got = run_spmd_mutant(name, dev, workdir=tmp)
            except Exception as e:  # noqa: BLE001
                out.append(Violation(
                    RULE, MUTANTS_PATH, 1,
                    f"seeded SPMD mutant `{name}` harness error: {e}",
                ))
                continue
            for layer in expect:
                if not got[layer]:
                    out.append(Violation(
                        RULE, MUTANTS_PATH, 1,
                        f"seeded SPMD mutant `{name}` SURVIVED the {layer} "
                        "layer — the analyzer lost its teeth for this bug "
                        f"class (see SPMD_MUTANTS[{name!r}])",
                    ))
    return out
