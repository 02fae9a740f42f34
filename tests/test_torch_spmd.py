"""The port's spmd-collective family (analysis/spmd.py) and its two mutant
harnesses, against the JAX package's tests/test_analysis.py: the violating
fixture fires each of the five checks with a message that teaches the fix,
the clean twin and the real sharded engine lint clean, the analyzer
catches one shard's value returned from a copy of the real engine, each
seeded SPMD mutant is caught by every layer it declares, each thread
mutant by its family with the reference harness's very findings, the
changed-only surfaces are wired, and a psum of a broadcast list in a copy
of parallel/engine.py fails the full lint."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from kubernetes_scheduler_tpu.analysis import thread_mutants as ref_thread_mutants
from kubernetes_scheduler_tpu_torch.analysis import run_lint, spmd, spmd_mutants, thread_mutants
from kubernetes_scheduler_tpu_torch.analysis.core import (
    Context,
    collect_files,
    load_file,
    reverse_dependency_closure,
)

ROOT = Path(__file__).resolve().parents[1]
FIXTURES = ROOT / "tests" / "torch_fixtures" / "lint"
PORT = "kubernetes_scheduler_tpu_torch"
PARALLEL = [f"{PORT}/parallel/engine.py", f"{PORT}/parallel/mesh.py"]


def active(vs):
    return [v for v in vs if not v.waived]


def lint_fixture(name):
    return active(run_lint([str(FIXTURES / name)], rules=["spmd-collective"]))


def test_torch_spmd_collective_covers_every_check():
    """Each SPMD failure mode fires with a message teaching the fix: the
    double-counting psum, the unbound axis, the redundant gather of a
    replicated list, gather_cat's dim misuse, and one shard's value as the
    answer (sharded and varying flavors, in a return and a result field);
    the clean twin and the real sharded engine lint clean."""
    vs = lint_fixture("spmd_collective_violation.py")
    msgs = [v.message for v in vs]
    assert all(v.rule == "spmd-collective" for v in vs)
    assert any("double-counts" in m for m in msgs)
    assert any("'nodez'" in m and "no mesh" in m for m in msgs)
    assert any("identical copies" in m for m in msgs)
    assert any("`dim=` is the tensor dimension" in m for m in msgs)
    assert any("provably sharded" in m and m.startswith("returns") for m in msgs)
    assert any("provably varying" in m and "(field `node`)" in m
               and m.startswith("stores") for m in msgs)
    assert all("gather_cat" in m and "reduce_lead" in m
               for m in msgs if "one shard's value" in m)
    src = (FIXTURES / "spmd_collective_violation.py").read_text().splitlines()
    # every seeded site is reported, and only those: the first code line
    # after each VIOLATION comment (1-based)
    seeded = {
        next(j for j in range(i, len(src)) if not src[j].strip().startswith("#")) + 1
        for i, line in enumerate(src) if "# VIOLATION" in line
    }
    assert {v.line for v in vs} == seeded
    assert lint_fixture("spmd_collective_clean.py") == []
    assert active(run_lint(PARALLEL, rules=["spmd-collective"])) == []


def test_torch_spmd_family_clean_on_the_port():
    vs = run_lint(rules=["spmd-collective"])
    assert active(vs) == [], [v.format() for v in vs]


@pytest.mark.parametrize("case", ["greedy-return", "window-field", "shard-mask",
                                  "affinity-gate"])
def test_torch_spmd_analyzer_catches_one_shard_as_global(case, tmp_path):
    """The shard-as-global check's teeth on the REAL engine source: one
    shard's capacity, mask or live-count gate shipped as the global answer
    fires. The gate's case keeps every decision the bitwise mesh tests
    compare (the live-count path is exact whether or not the gate opens,
    and their constraint windows name selectors, which open it anyway):
    those tests pass on it, and of the other checks only the collective
    budget sees it, by the pmax it drops."""
    src = (ROOT / PORT / "parallel" / "engine.py").read_text()
    old, new = {
        "greedy-return": ("    return node_idx, free, added2\n\n\ndef _fold_placements",
                          "    return node_idx, free[0], added2\n\n\ndef _fold_placements"),
        "window-field": (
            "            free_after=gather_cat([sh.allocatable - rq for sh, rq in "
            "zip(shards, requested)], mesh),",
            "            free_after=shards[0].allocatable - requested[0],"),
        "shard-mask": ("    n_valid = torch.clamp(gather_cat(masks, mesh).sum(), min=1.0)",
                       "    n_valid = torch.clamp(masks[0].sum(), min=1.0)"),
        "affinity-gate": (
            "    avoided = pmax([(s.avoid_counts > 0).any(0).to(_I32) for s in shards], "
            "mesh)[0] > 0",
            "    avoided = [(s.avoid_counts > 0).any(0) for s in shards][0]"),
    }[case]
    assert src.count(old) == 1, case
    work = tmp_path / "engine_mutant.py"
    work.write_text(src.replace(old, new))
    shutil.copy(ROOT / PORT / "parallel" / "mesh.py", tmp_path / "mesh.py")
    vs = active(run_lint([str(work), str(tmp_path / "mesh.py")], rules=["spmd-collective"]))
    assert vs and all("one shard's value as the global answer" in v.message for v in vs), [
        v.format() for v in vs]


def test_torch_spmd_lattice_joins():
    assert spmd.join(spmd.REP, spmd.SHD) == spmd.SHD
    assert spmd.join(("L", spmd.REP), ("L", spmd.SHD)) == ("L", spmd.SHD)
    assert spmd.join(("E", spmd.SHD), spmd.REP) == ("E", spmd.SHD)
    assert spmd.join(("E", spmd.SHD), spmd.UNK) == spmd.UNK
    assert spmd.pure([("E", spmd.VAR), spmd.REP]) == ("E", spmd.VAR)
    assert spmd.mark(spmd.REP) == spmd.REP and spmd.mark(spmd.SHD) == ("E", spmd.SHD)
    assert spmd.collapse(("L", ("T", spmd.REP, spmd.VAR))) == spmd.VAR


# ---- the SPMD mutant harness ------------------------------------------------


def test_torch_spmd_mutant_base_clean():
    assert spmd_mutants.check_spmd_mutants(device="cpu") == []


@pytest.mark.parametrize("name", list(spmd_mutants.SPMD_MUTANTS))
def test_torch_spmd_mutant_caught(name):
    """Each mutant is caught by every layer it declares, and the AST-silent
    one stays silent there (only the budget sees an extra gather)."""
    _, _, layers = spmd_mutants.SPMD_MUTANTS[name]
    got = spmd_mutants.run_spmd_mutant(name, device="cpu")
    for layer in layers:
        assert got[layer], f"mutant {name} survived the {layer} layer"
    if "ast" not in layers:
        assert got["ast"] == []
    want = {
        "dropped-psum": ("returns one shard's value", "psum: reached 0 != budgeted 1"),
        "wrong-axis": ("'nodez'", None),
        "replicated-double-count": ("double-counts", "psum: reached 2 != budgeted 1"),
        "extra-gather-over-budget": (None, "to_lead: reached 3 != budgeted 2"),
    }[name]
    if want[0]:
        assert any(want[0] in v.message for v in got["ast"]), got["ast"]
    if want[1]:
        assert any(want[1] in v.message for v in got["budget"]), got["budget"]


def test_torch_spmd_mutant_patterns_match_base():
    for name in spmd_mutants.SPMD_MUTANTS:
        assert spmd_mutants.mutate(name) != spmd_mutants.BASE
    with pytest.raises(KeyError):
        spmd_mutants.mutate("no-such-mutant")


# ---- the thread mutant harness ---------------------------------------------


def test_torch_thread_mutants_each_caught():
    """The unmutated base is clean under both families, and each mutant is
    caught by the family that owns its bug class, with the rendered
    evidence naming the access pair (or tainted field)."""
    assert thread_mutants.check_thread_mutants() == []
    evidence_frag = {
        "drop-mirror-lock": "`MiniMirror._dirty`",
        "event-set-before-write": "`MiniMirror.published`",
        "unsorted-dirty-iter": "set-order",
        "wallclock-journal-field": "journal-record field `seq`",
        "latch-check-then-act": "`MiniMirror.cache`",
        "unjoined-shutdown-read": "read in `close`",
    }
    assert set(evidence_frag) == set(thread_mutants.THREAD_MUTANTS)
    for name, (_, _, family) in thread_mutants.THREAD_MUTANTS.items():
        hits = thread_mutants.run_thread_mutant(name)[family]
        assert hits, f"mutant {name} survived {family}"
        assert any(evidence_frag[name] in v.message for v in hits), (
            name, [v.message for v in hits])


@pytest.mark.parametrize("name", list(thread_mutants.THREAD_MUTANTS))
def test_torch_thread_mutant_findings_match_reference(name):
    """Fact for fact the reference harness's findings on the same mutant
    (the package name replaced in messages)."""
    assert thread_mutants.BASE == ref_thread_mutants.BASE
    assert thread_mutants.THREAD_MUTANTS[name] == ref_thread_mutants.THREAD_MUTANTS[name]

    def facts(got):
        return {fam: sorted((v.rule, v.line, v.message.replace("kubernetes_scheduler_tpu_torch",
                                                                "kubernetes_scheduler_tpu"))
                            for v in vs) for fam, vs in got.items()}

    assert facts(thread_mutants.run_thread_mutant(name)) == facts(
        ref_thread_mutants.run_thread_mutant(name))


def _full_ctx():
    files = [load_file(p, str(ROOT)) for p in collect_files(str(ROOT))]
    return Context(root=str(ROOT), files=[f for f in files if f is not None])


def test_torch_changed_only_thread_surfaces_wired():
    """The thread-mutant SURFACE covers the analyzer files and every
    threaded layer, and a closure touching host/mirror.py pulls in every
    declared thread root's file."""
    import fnmatch

    from kubernetes_scheduler_tpu_torch.analysis.threads import THREAD_ROOTS

    for p in (
        f"{PORT}/analysis/threads.py",
        f"{PORT}/analysis/rules/thread_race.py",
        f"{PORT}/analysis/rules/determinism_taint.py",
        f"{PORT}/host/mirror.py",
        f"{PORT}/kube/source.py",
        f"{PORT}/bridge/server.py",
        f"{PORT}/trace/spans.py",
    ):
        assert any(fnmatch.fnmatch(p, pat) for pat in thread_mutants.SURFACE), p
    closure = reverse_dependency_closure(_full_ctx(), {f"{PORT}/host/mirror.py"})
    for root in THREAD_ROOTS:
        assert root.path in closure, root.path


def test_torch_changed_only_model_surface_covers_every_anchor():
    import fnmatch

    from kubernetes_scheduler_tpu_torch.analysis.model.protocols import build_models
    from kubernetes_scheduler_tpu_torch.analysis.model.runner import SURFACE

    paths = {a.path for m in build_models() for t in m.transitions for a in t.anchors}
    for p in paths:
        assert any(fnmatch.fnmatch(p, pat) for pat in SURFACE), p


# ---- a psum of a broadcast list fails the full lint ---------------------------


def test_torch_psum_of_broadcast_fails_lint(tmp_path):
    shutil.copytree(ROOT / PORT, tmp_path / PORT,
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    shutil.copy(ROOT / "README.md", tmp_path / "README.md")
    engine_py = tmp_path / PORT / "parallel" / "engine.py"
    src = engine_py.read_text()
    anchor = "    n_valid = torch.clamp(gather_cat(masks, mesh).sum(), min=1.0)\n"
    assert src.count(anchor) == 1
    src = src.replace(anchor, anchor + "    n_valid = psum(broadcast(n_valid, mesh), mesh)[0]\n")
    src = src.replace("    pmin,\n    reduce_lead,", "    pmin,\n    psum,\n    reduce_lead,")
    engine_py.write_text(src)
    proc = subprocess.run(
        [sys.executable, "-m", f"{PORT}.analysis", "--device", "cpu"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(tmp_path)),
    )
    assert proc.returncode == 1, proc.stdout + proc.stderr
    hits = [x for x in proc.stdout.splitlines() if "[spmd-collective]" in x]
    assert any("parallel/engine.py" in x and "double-counts" in x for x in hits), proc.stdout
