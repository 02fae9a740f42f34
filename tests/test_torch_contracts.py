"""The port's engine-contract layer (kubernetes_scheduler_tpu_torch.analysis.contracts)
against the JAX package's (tests/test_analysis.py's contract and budget
tests): every entry point and kernel wrapper returns its declared spec on
the CPU grid, the fused path the unfused spec; the contract-drift fixture
pair on meta tensors; the sharded surfaces on the 4-shard and 2 x 2 CPU
meshes equal the dense specs, the divisibility formula predicts success
and failure, and the collective call sites equal the checked-in budget;
every budget-file failure is loud; the collective observer counts sites
once; the device rule holds (cuda by default, RuntimeError without it);
and an extra collective in a copy of the sharded greedy fails the full
lint. The dense specs are also held to the JAX package's eval_shape."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from kubernetes_scheduler_tpu_torch.analysis import contracts
from kubernetes_scheduler_tpu_torch.analysis.__main__ import main
from kubernetes_scheduler_tpu_torch.ops import fused
from kubernetes_scheduler_tpu_torch.parallel import mesh as mesh_mod

ROOT = Path(__file__).resolve().parents[1]
FIXTURES = ROOT / "tests" / "torch_fixtures" / "lint"
PORT = "kubernetes_scheduler_tpu_torch"
MESHES = ["mesh4", "mesh2x2"]


def test_torch_contract_drift_fixture_pair():
    """The violating fixture's transposed and retyped returns are caught at
    every declared grid point; the clean twin passes, on meta tensors."""
    vs = contracts.check_fixture_module(str(FIXTURES / "contract_drift_violation.py"))
    msgs = [v.message for v in vs]
    assert len(vs) == 3, msgs
    assert all(v.rule == "engine-contract" for v in vs)
    assert any("(4, 8)" in m and "(8, 4)" in m for m in msgs)  # transpose
    assert any("int32" in m for m in msgs)                      # dtype drift
    clean = contracts.check_fixture_module(str(FIXTURES / "contract_drift_clean.py"))
    assert clean == [], [v.format() for v in clean]


def test_torch_fixture_call_failure_is_a_finding(tmp_path):
    bad = tmp_path / "broken_fixture.py"
    bad.write_text(
        "def rows(x):\n    return x.item()\n\n"
        "CONTRACTS = [{'fn': 'rows', 'args': [('float32', ('n',))],\n"
        "              'out': ('float32', ()), 'grid': [{'n': 1}]}]\n"
    )
    (v,) = contracts.check_fixture_module(str(bad))
    assert "call on meta failed" in v.message


def test_torch_engine_contracts_clean_and_covering():
    """Every declared entry point returns its spec across the CPU grid, and
    the declared coverage is the reference's ten surfaces (the auction
    wrapper under the port's name) plus K4's greedy_scan."""
    assert set(contracts.CONTRACT_NAMES) == {
        "schedule_batch", "schedule_batch(auction)", "schedule_batch(fused)",
        "schedule_windows", "apply_snapshot_delta", "apply_layout_delta",
        "build_fused_layout", "fused_masked_score", "fused_score_row_stats",
        "auction_bid", "greedy_scan",
    }
    fused.reset_launches()
    checked = []
    vs = contracts.check_contracts(device="cpu", checked=checked)
    assert vs == [], "\n".join(v.format() for v in vs)
    assert {name for name, _ in checked} == set(contracts.CONTRACT_NAMES)
    assert len(checked) == len(contracts.CONTRACT_NAMES) * len(contracts.GRID)
    # on CPU tensors the wrappers run their plain versions
    assert all(v == 0 for v in fused.launches.values()), fused.launches


def test_torch_contract_drift_in_a_wrapper_is_caught(monkeypatch):
    """A wrapper that returns a transposed matrix fails its contract."""
    real = fused.fused_masked_score
    monkeypatch.setattr(fused, "fused_masked_score", lambda *a, **k: real(*a, **k).T)
    vs = contracts.check_contracts(device="cpu", grid=contracts.GRID[:1])
    assert [v.rule for v in vs] == ["engine-contract"]
    assert "fused_masked_score: returned (16, 8)/float32 != declared (8, 16)/float32" in (
        vs[0].message)


def test_torch_kernel_path_spec_drift_is_caught(monkeypatch):
    """The fused path must present the unfused spec leaf for leaf."""
    from kubernetes_scheduler_tpu_torch import engine

    real = engine.schedule_batch

    def drifted(*a, **k):
        res = real(*a, **k)
        return res._replace(feasible=res.feasible.to(torch.int32)) if k.get("fused") else res

    monkeypatch.setattr(engine, "schedule_batch", drifted)
    vs = contracts.check_contracts(device="cpu", grid=contracts.GRID[:1])
    assert len(vs) == 1 and "schedule_batch(fused).feasible" in vs[0].message
    assert "int32" in vs[0].message and "bool" in vs[0].message


def test_torch_layout_formula_is_row_major():
    lay = contracts.layout_spec(dict(n=64, r=7))
    assert lay.u == ((64,), torch.float32) and lay.alloc == ((64, 7), torch.float32)


def test_torch_contract_layer_raises_without_cuda(capsys):
    """Without a device the layer runs on cuda, as every entry point of the
    port: without a card it raises, and never falls back to the CPU."""
    from kubernetes_scheduler_tpu_torch.analysis.spmd_mutants import check_spmd_mutants

    if torch.cuda.is_available():
        pytest.skip("checks the device rule on a machine without CUDA")

    for fn in (contracts.check_contracts, contracts.check_sharded_contracts,
               contracts.traced_surface_counts, check_spmd_mutants):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn()
    with pytest.raises(SystemExit) as e:
        main(["--no-models"])
    assert e.value.code == 2
    assert "--device" in capsys.readouterr().err


def test_torch_mesh_contracts_and_budget_clean():
    """The sharded half: every surface on the 4-shard and the 2 x 2 CPU
    mesh returns the dense spec (the resident folds spec-preserving, the
    layout build the row-major formula), the divisibility formula predicts
    both success and failure, and the call sites match the budget."""
    assert set(contracts.SHARDED_CONTRACT_NAMES) == {
        "sharded_schedule(greedy)", "sharded_schedule(auction)",
        "sharded_windows(greedy)", "sharded_windows(auction)",
        "sharded_schedule(fused)", "sharded_apply_delta",
        "sharded_build_layout", "sharded_apply_layout_delta",
        # the options whose collective sites the defaults never reach
        "sharded_schedule(greedy, constraints)", "sharded_schedule(auction, constraints)",
        "sharded_schedule(balanced_diskio)", "sharded_schedule(free_capacity)",
        "sharded_schedule(card)", "sharded_schedule(least_allocated)",
        "sharded_schedule(balanced_allocation)", "sharded_schedule(image_locality)",
        "sharded_schedule(softmax)", "sharded_schedule(soft)", "sharded_schedule(plugins)",
    }
    checked = []
    vs = contracts.check_sharded_contracts(device="cpu", checked=checked)
    assert vs == [], "\n".join(v.format() for v in vs)
    assert {(m, name) for m, name, _ in checked} == {
        (m, name) for m in MESHES for name in contracts.SHARDED_CONTRACT_NAMES
    }


@pytest.mark.parametrize("target, surfaces", [
    ("affinity_ok_from_counts", {"sharded_schedule(greedy, constraints)"}),
    ("_evict_conflicts_core", {"sharded_schedule(auction, constraints)"}),
    ("balanced_diskio_from_m", {"sharded_schedule(balanced_diskio)"}),
    ("card_score", {"sharded_schedule(card)"}),
    ("softmax_normalize", {"sharded_schedule(softmax)"}),
    ("compute_soft_scores", {"sharded_schedule(soft)"}),
], ids=["greedy-constraints", "evict", "diskio", "card", "softmax", "soft"])
def test_torch_collective_in_an_option_branch_moves_the_budget(monkeypatch, target, surfaces):
    """An extra collective on a path that only a constraints window or a
    non-default option takes (the greedy's live-count block, the
    auction's eviction, a policy's bounds, softmax, the soft term) is a
    budget drift of exactly the surfaces that take it, on both meshes."""
    from kubernetes_scheduler_tpu_torch.parallel import engine as par_engine

    real = getattr(par_engine, target)
    spare = mesh_mod.make_mesh(2, device="cpu")

    def with_extra(*a, **k):
        mesh_mod.broadcast(torch.zeros(()), spare)
        return real(*a, **k)

    monkeypatch.setattr(par_engine, target, with_extra)
    vs = contracts.check_sharded_contracts(device="cpu", grid=contracts.GRID[:1])
    assert all(v.rule == "collective-budget" and "broadcast: reached" in v.message
               for v in vs), [v.format() for v in vs]
    drifted = {(v.message[1:].split("]")[0], v.message.split("`")[1]) for v in vs}
    assert drifted == {(m, name) for m in MESHES for name in surfaces}


def test_torch_divisibility_failure_must_be_predicted(monkeypatch):
    """A formula that stops predicting the engine's ValueError is a finding."""
    from kubernetes_scheduler_tpu_torch.parallel import engine as par_engine

    real = par_engine.shard_snapshot

    def lenient(snapshot, mesh, **kw):
        n = int(np.shape(snapshot.node_mask)[0])
        if n % mesh.size:
            snapshot = type(snapshot)(*[x[: n - n % mesh.size] for x in snapshot])
        return real(snapshot, mesh, **kw)

    monkeypatch.setattr(par_engine, "shard_snapshot", lenient)
    vs = contracts.check_sharded_contracts(device="cpu", grid=contracts.GRID[:1])
    msgs = [v.message for v in vs]
    assert any("runs despite violating the declared divisibility formula" in m
               for m in msgs), msgs


@pytest.mark.parametrize("name", MESHES)
def test_torch_checked_in_budget_matches_sites_reached(name):
    """The acceptance pin: COLLECTIVE_BUDGET.json budgets exactly the
    declared surfaces, with the call sites each reaches on either mesh."""
    doc = json.loads((ROOT / contracts.COLLECTIVE_BUDGET_NAME).read_text())
    mesh = contracts.meshes("cpu")[name]
    assert doc["surfaces"] == contracts.traced_surface_counts("cpu", mesh)
    assert set(doc["surfaces"]) == set(contracts.SHARDED_CONTRACT_NAMES)
    assert all(set(c) == set(contracts.COLLECTIVE_KINDS) for c in doc["surfaces"].values())


def test_torch_collective_budget_staleness_fails_loudly(tmp_path):
    """Every budget-file failure mode is a finding, never a silent pass:
    missing, unparseable, per-kind drift, a stale entry, an unbudgeted new
    surface; a surface whose run failed is exempt from staleness."""
    check = contracts.check_collective_budget
    traced = {"sharded_schedule(greedy)": {
        "psum": 0, "pmax": 2, "pmin": 1, "all_gather": 0, "gather_cat": 7,
        "broadcast": 3, "to_lead": 3, "reduce_lead": 1,
    }}
    vs = check(str(tmp_path / "nope.json"), traced=traced)
    assert len(vs) == 1 and "missing" in vs[0].message
    garbage = tmp_path / "garbage.json"
    garbage.write_text("{not json")
    vs = check(str(garbage), traced=traced)
    assert len(vs) == 1 and "does not parse" in vs[0].message
    doc = {"surfaces": {
        "sharded_schedule(greedy)": dict(traced["sharded_schedule(greedy)"], broadcast=2),
        "ghost_surface": {"psum": 1},
    }}
    drifted = tmp_path / "drifted.json"
    drifted.write_text(json.dumps(doc))
    msgs = [v.message for v in check(str(drifted), traced=traced)]
    assert any("broadcast: reached 3 != budgeted 2" in m for m in msgs), msgs
    assert any("`ghost_surface`" in m and "stale" in m for m in msgs)
    vs = check(str(drifted), traced={**traced, "sharded_schedule(new)": {"psum": 1}})
    assert any("has no budget entry" in v.message for v in vs)
    vs = check(str(drifted), traced=traced, failed={"ghost_surface"})
    assert not any("`ghost_surface`" in v.message for v in vs), [v.format() for v in vs]
    assert all(v.rule == "collective-budget" for v in vs)


def test_torch_budget_drift_reported_per_mesh(tmp_path, monkeypatch):
    doc = json.loads((ROOT / contracts.COLLECTIVE_BUDGET_NAME).read_text())
    doc["surfaces"]["sharded_schedule(greedy)"]["pmax"] += 1
    path = tmp_path / "budget.json"
    path.write_text(json.dumps(doc))
    monkeypatch.setattr(contracts, "COLLECTIVE_BUDGET_NAME", str(path))
    vs = contracts.check_sharded_contracts(device="cpu", grid=contracts.GRID[:1])
    assert sorted(v.message.split("]")[0] for v in vs) == ["[mesh2x2", "[mesh4"]
    assert all("pmax: reached 2 != budgeted 3" in v.message for v in vs)


def test_torch_write_collective_budget_round_trips(tmp_path):
    path = tmp_path / "budget.json"
    doc = contracts.write_collective_budget(str(path), device="cpu")
    assert json.loads(path.read_text()) == doc
    assert doc["surfaces"] == json.loads(
        (ROOT / contracts.COLLECTIVE_BUDGET_NAME).read_text())["surfaces"]
    assert contracts.check_collective_budget(str(path), traced=doc["surfaces"]) == []


# ---- the collective observer ----------------------------------------------


def test_torch_collective_observer_counts_outer_sites_once():
    """A collective that another one calls (to_lead inside all_gather and
    gather_cat) is not told; the site is the caller's line; a site reached
    twice counts once; with no observer installed nothing is recorded."""
    mesh = mesh_mod.make_mesh(4, device="cpu")
    xs = [torch.ones(2) for _ in range(4)]
    seen = []
    previous = mesh_mod.set_observer(lambda *site: seen.append(site))
    try:
        mesh_mod.all_gather(xs, mesh)
        mesh_mod.gather_cat(xs, mesh)
        for _ in range(3):
            mesh_mod.psum(xs, mesh)
    finally:
        assert mesh_mod.set_observer(previous) is not None
    assert previous is None
    kinds = [k for k, _, _ in seen]
    assert kinds == ["all_gather", "gather_cat", "psum", "psum", "psum"]
    assert all(f == __file__ for _, f, _ in seen)
    _, counts = contracts.site_counts(lambda: [mesh_mod.psum(xs, mesh) for _ in range(3)])
    assert counts["psum"] == 1 and sum(counts.values()) == 1
    mesh_mod.psum(xs, mesh)  # no observer: nothing to tell
    assert mesh_mod._observer is None


# ---- both packages held to the same dense specs --------------------------


def _ref_specs(g):
    import jax

    from kubernetes_scheduler_tpu import engine as ref_engine
    from kubernetes_scheduler_tpu.analysis import contracts as ref_contracts

    snap_c, pods_c, _ = ref_contracts._make_inputs(g)
    snap, pods = ref_contracts._spec_tree(snap_c), ref_contracts._spec_tree(pods_c)
    pods_w = jax.tree_util.tree_map(
        lambda s: jax.ShapeDtypeStruct((g["w"],) + tuple(s.shape), s.dtype), pods)
    return (jax.eval_shape(ref_engine.schedule_batch, snap, pods),
            jax.eval_shape(ref_engine.schedule_windows, snap, pods_w))


@pytest.mark.parametrize("gi", range(len(contracts.GRID)))
def test_torch_dense_specs_equal_the_reference(gi):
    g = contracts.GRID[gi]
    ref_sched, ref_win = _ref_specs(g)
    for port, ref in ((contracts.schedule_spec(g), ref_sched),
                      (contracts.windows_spec(g), ref_win)):
        assert type(port)._fields == type(ref)._fields
        for (shape, dtype), r in zip(port, ref):
            assert shape == tuple(r.shape)
            assert str(dtype).replace("torch.", "") == str(r.dtype)


# ---- an extra collective fails the full lint -------------------------------


def test_torch_extra_collective_in_the_greedy_fails_lint(tmp_path):
    shutil.copytree(ROOT / PORT, tmp_path / PORT,
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    shutil.copy(ROOT / "README.md", tmp_path / "README.md")
    engine_py = tmp_path / PORT / "parallel" / "engine.py"
    src = engine_py.read_text()
    anchor = "        win = torch.argmax(best_all).view(1)\n"
    assert src.count(anchor) == 1
    engine_py.write_text(src.replace(
        anchor, anchor + "        best_r = broadcast(best_all, mesh)  # noqa: F841\n"))
    proc = subprocess.run(
        [sys.executable, "-m", f"{PORT}.analysis", "--device", "cpu"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(tmp_path)),
    )
    assert proc.returncode == 1, proc.stdout + proc.stderr
    budget = [x for x in proc.stdout.splitlines() if "[collective-budget]" in x]
    assert any("`sharded_schedule(greedy)`" in x and "broadcast: reached 4 != budgeted 3" in x
               for x in budget), proc.stdout
    assert not any("[spmd-collective]" in x for x in proc.stdout.splitlines())


def test_torch_changed_only_contract_surfaces_wired():
    """A parallel/ edit's closure contains the edited file, and the
    contracts SURFACE patterns match it and the SPMD analyzer's files."""
    import fnmatch

    from kubernetes_scheduler_tpu_torch.analysis.core import (
        Context,
        collect_files,
        load_file,
        reverse_dependency_closure,
    )

    files = [load_file(p, str(ROOT)) for p in collect_files(str(ROOT))]
    ctx = Context(root=str(ROOT), files=[f for f in files if f is not None])
    engine_path = f"{PORT}/parallel/engine.py"
    assert engine_path in reverse_dependency_closure(ctx, {engine_path})
    for p in (engine_path, f"{PORT}/parallel/mesh.py", f"{PORT}/analysis/spmd.py",
              f"{PORT}/analysis/spmd_mutants.py", f"{PORT}/ops/fused.py",
              f"{PORT}/engine.py"):
        assert any(fnmatch.fnmatch(p, pat) for pat in contracts.SURFACE), p
