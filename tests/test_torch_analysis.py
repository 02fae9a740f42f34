"""The port's static checker (kubernetes_scheduler_tpu_torch.analysis)
against the JAX package's: the ten copied families give the JAX
package's findings on its own fixtures, the waiver and baseline
mechanics agree, the four twins fire on their violating fixtures and stay
quiet on their clean ones, and the port lints itself clean. Everything
here runs on the CPU: the checker reads source text and needs no nvcc."""

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from kubernetes_scheduler_tpu.analysis import run_lint as ref_run_lint
from kubernetes_scheduler_tpu.analysis.__main__ import main as ref_main
from kubernetes_scheduler_tpu.analysis.core import (
    apply_baseline as ref_apply_baseline,
    load_baseline as ref_load_baseline,
)
from kubernetes_scheduler_tpu_torch.analysis import dataflow, kernel_budget, threads
from kubernetes_scheduler_tpu_torch.analysis import run_lint
from kubernetes_scheduler_tpu_torch.analysis.__main__ import _rule_docs, main
from kubernetes_scheduler_tpu_torch.analysis.core import (
    BASELINE_NAME,
    Context,
    _check_readme_rules,
    apply_baseline,
    collect_files,
    load_baseline,
    load_file,
    reverse_dependency_closure,
)
from kubernetes_scheduler_tpu_torch.analysis.rules import RULES, cuda_kernel
from kubernetes_scheduler_tpu_torch.analysis.sarif import render_sarif, validate_sarif

ROOT = Path(__file__).resolve().parents[1]
REF_FIXTURES = ROOT / "tests" / "analysis_fixtures"
FIXTURES = ROOT / "tests" / "torch_fixtures" / "lint"
PORT = "kubernetes_scheduler_tpu_torch"
CSRC = ROOT / PORT / "csrc"


def active(vs):
    return [v for v in vs if not v.waived]


def facts(vs, rename=False):
    """(rule, path, line, message, waived, reason) of each finding; with
    `rename`, the JAX package's name becomes the port's in messages."""
    out = []
    for v in vs:
        msg = v.message
        if rename:
            msg = msg.replace("kubernetes_scheduler_tpu", PORT)
        out.append((v.rule, v.path, v.line, msg, v.waived, v.waiver_reason))
    return out


# ---- the ten copied families: the JAX package's findings ------------------

# family -> the JAX package's fixture groups (each group linted as one run)
COPIED = {
    "lock-discipline": [["lock_discipline_violation.py"],
                        ["lock_discipline_clean.py"]],
    "wire-schema": [["wire_schema_violation.py"], ["wire_schema_clean.py"],
                    ["journal_schema_violation.py"], ["journal_schema_clean.py"]],
    "timeout-hygiene": [["timeout_violation.py"], ["timeout_clean.py"],
                        ["timeout_swallow_violation.py"],
                        ["timeout_swallow_clean.py"]],
    "metric-hygiene": [["metric_hygiene_violation.py"],
                       ["metric_hygiene_clean.py"]],
    "sim-determinism": [["sim_determinism_violation.py"],
                        ["sim_determinism_clean.py"]],
    "span-hygiene": [["span_hygiene_violation.py"], ["span_hygiene_clean.py"]],
    "capability-completeness": [["capability_completeness_violation.py"],
                                ["capability_completeness_clean.py"]],
    "lockset-race": [["lockset_race_violation.py"], ["lockset_race_clean.py"]],
    "thread-race": [["thread_race_violation.py"], ["thread_race_clean.py"],
                    ["thread_race_xfile_state.py", "thread_race_xfile_threads.py"]],
    "determinism-taint": [["determinism_taint_violation.py"],
                          ["determinism_taint_clean.py"]],
}


@pytest.mark.parametrize("rule", sorted(COPIED))
def test_torch_lint_copied_family_matches_reference(rule):
    fired = False
    for group in COPIED[rule]:
        paths = [str(REF_FIXTURES / name) for name in group]
        ref = facts(ref_run_lint(paths, rules=[rule]), rename=True)
        port = facts(run_lint(paths, rules=[rule]))
        assert port == ref, group
        if any(name.endswith("_clean.py") for name in group):
            assert ref == [] and port == [], group
        else:
            fired = fired or any(not f[4] for f in port)
    assert fired, f"{rule} found nothing on its violating fixtures"


# ---- waiver and baseline mechanics -----------------------------------------


@pytest.mark.parametrize("fixture,rule", [
    ("waiver_fixture.py", "timeout-hygiene"),
    ("waiver_structural_fixture.py", "timeout-hygiene"),
])
def test_torch_lint_waiver_mechanics_match_reference(fixture, rule):
    path = [str(REF_FIXTURES / fixture)]
    ref = facts(ref_run_lint(path, rules=[rule]))
    port = facts(run_lint(path, rules=[rule]))
    assert port == ref
    assert any(f[4] and f[5] for f in port)      # a waiver took effect
    assert any(not f[4] for f in port)           # and one did not


def test_torch_lint_bad_waiver_is_a_finding():
    vs = run_lint([str(REF_FIXTURES / "waiver_fixture.py")],
                  rules=["timeout-hygiene"])
    bad = [v for v in vs if v.rule == "bad-waiver"]
    assert bad and all(not v.waived for v in bad)


def test_torch_lint_waiver_above_decorator_covers_def():
    vs = run_lint([str(FIXTURES / "waiver_decorator_fixture.py")],
                  rules=["dtype-shape"])
    waived = [v for v in vs if v.waived]
    act = active(vs)
    assert len(waived) == 1 and "decorated-def" in waived[0].waiver_reason
    assert len(act) == 1 and act[0].line > waived[0].line


def _baseline(tmp_path, entries):
    p = tmp_path / "LINT_BASELINE.json"
    p.write_text(json.dumps({"entries": entries}))
    return str(p)


@pytest.mark.parametrize("case", ["suppress", "stale", "unexplained", "malformed"])
def test_torch_lint_baseline_mechanics_match_reference(case, tmp_path):
    fixture = "timeout_clean.py" if case in ("stale", "unexplained") else (
        "timeout_violation.py")
    path = [str(REF_FIXTURES / fixture)]
    entries = {
        "suppress": [{"rule": "timeout-hygiene",
                      "path": f"tests/analysis_fixtures/{fixture}",
                      "contains": "timeout", "reason": "triage window"}],
        "stale": [{"rule": "timeout-hygiene", "path": "nowhere.py",
                   "reason": "points at nothing"}],
        "unexplained": [{"rule": "timeout-hygiene", "path": "nowhere.py",
                         "reason": ""}],
        "malformed": ["oops", 7, {"rule": "stale-baseline",
                                  "path": "LINT_BASELINE.json",
                                  "reason": "trying to silence the police"}],
    }[case]
    bpath = _baseline(tmp_path, entries)
    ref_vs = ref_run_lint(path, rules=["timeout-hygiene"])
    port_vs = run_lint(path, rules=["timeout-hygiene"])
    ref_extra = ref_apply_baseline(ref_vs, ref_load_baseline(bpath), bpath)
    port_extra = apply_baseline(port_vs, load_baseline(bpath), bpath)
    assert facts(port_extra) == facts(ref_extra)
    assert facts(port_vs) == facts(ref_vs)
    if case == "suppress":
        assert port_extra == [] and all(v.waived for v in port_vs)
    else:
        assert port_extra and all(
            v.rule in ("bad-baseline", "stale-baseline") for v in port_extra
        )


def test_torch_lint_baseline_file_is_empty_and_its_own():
    entries = load_baseline(ROOT / BASELINE_NAME)
    assert entries == []
    assert BASELINE_NAME.startswith(f"{PORT}/analysis/")


# ---- the twins: violating and clean fixtures -------------------------------

TWINS = {
    "host-sync": ("host_sync_violation.py", "host_sync_clean.py", [
        "torch.cuda.synchronize", ".synchronize() on an event", ".item()",
        ".cpu()", ".tolist()", ".numpy()", "np.asarray()",
    ]),
    "host-transfer": ("host_transfer_violation.py", "host_transfer_clean.py", [
        ".item() on tensor `total`", "float() on tensor `m`",
        "np.asarray() on tensor `x`", "branch on tensor `best`",
        "branch on tensor `flag`", "boolean-mask indexing of `x`",
        ".nonzero() on tensor `x`", "torch.unique()", "torch.masked_select()",
        ".tolist() on tensor `x`", '.to("cpu") on tensor `x`',
        ".cpu() on tensor `leaf`", "int() on tensor `t`",
    ]),
    "dtype-shape": ("dtype_shape_violation.py", "dtype_shape_clean.py", [
        "torch.float64", ".double()", "float64 dtype argument", "astype to float64",
    ]),
    "cuda-kernel": ("cuda_kernel_violation.cu", "cuda_kernel_clean.cu", [
        "`unbounded_kernel` has no __launch_bounds__",
        "assert() in device code of `chatty_kernel`",
        "printf() in device code of `chatty_kernel`",
        "__half accumulator `acc` in `half_sum_kernel`",
        "`big_smem_kernel` declares 65536 bytes of static shared memory",
        "kernel `half_sum_kernel` has no row",
        "row `removed_kernel` names no kernel",
        "row `unbounded_kernel` records",
    ]),
}


@pytest.mark.parametrize("rule", sorted(TWINS))
def test_torch_lint_twin_fires_and_stays_quiet(rule):
    violating, clean, expected = TWINS[rule]
    hits = active(run_lint([str(FIXTURES / violating)], rules=[rule]))
    assert all(v.rule == rule for v in hits)
    msgs = [v.message for v in hits]
    for fragment in expected:
        assert any(fragment in m for m in msgs), (fragment, msgs)
    quiet = run_lint([str(FIXTURES / clean)], rules=[rule])
    assert active(quiet) == [], [v.format() for v in quiet]


@pytest.mark.parametrize("rule,fixture", [
    ("host-sync", "host_sync_violation.py"),
    ("host-transfer", "host_transfer_violation.py"),
    ("dtype-shape", "dtype_shape_violation.py"),
    ("cuda-kernel", "cuda_kernel_violation.cu"),
])
def test_torch_lint_main_fails_on_twin_fixture(rule, fixture, capsys):
    assert main([str(FIXTURES / fixture), "--rules", rule]) == 1
    assert rule in capsys.readouterr().out


def test_torch_lint_ctypes_table_drift():
    cu = str(FIXTURES / "cuda_kernel_clean.cu")
    clean = run_lint([cu, str(FIXTURES / "cuda_kernel_signatures_clean.py")],
                     rules=["cuda-kernel"])
    assert active(clean) == []
    bad = active(run_lint(
        [cu, str(FIXTURES / "cuda_kernel_signatures_violation.py")],
        rules=["cuda-kernel"]))
    msgs = [v.message for v in bad]
    assert any("`fx_sum` has 3 arguments" in m and "definition 4" in m for m in msgs)
    assert any("`fx_scale` argument 1 is pointer" in m for m in msgs)
    assert any("`fx_gone`" in m for m in msgs)


def test_torch_lint_ctypes_table_drops_an_argument(tmp_path):
    """A copy of the port's ops/_build.py with one argument of
    ks_masked_score dropped fails against csrc/fused.cu."""
    src = (ROOT / PORT / "ops" / "_build.py").read_text()
    assert '"ks_masked_score": [_P] * 15 + [_I] * 4 + [_P],' in src
    binding = tmp_path / "_build.py"
    binding.write_text(src.replace(
        '"ks_masked_score": [_P] * 15 + [_I] * 4 + [_P],',
        '"ks_masked_score": [_P] * 15 + [_I] * 3 + [_P],'))
    vs = active(run_lint([str(CSRC / "fused.cu"), str(binding)],
                         rules=["cuda-kernel"]))
    assert [v.message for v in vs] == [
        "ctypes entry `ks_masked_score` has 19 arguments, the extern \"C\" "
        "definition 20 — a wrong arity corrupts the call's arguments with "
        "no error"
    ]


def test_torch_lint_cuda_waiver_in_a_cu_file(tmp_path):
    src = (FIXTURES / "cuda_kernel_violation.cu").read_text()
    waived = src.replace(
        "__global__ void unbounded_kernel(",
        "// graftlint: disable=cuda-kernel -- fixture: bounds set by the launch\n"
        "__global__ void unbounded_kernel(")
    unexplained = src.replace(
        "__global__ void unbounded_kernel(",
        "// graftlint: disable=cuda-kernel\n__global__ void unbounded_kernel(")
    for name, text in (("waived.cu", waived), ("unexplained.cu", unexplained)):
        (tmp_path / name).write_text(text)
    vs = run_lint([str(tmp_path / "waived.cu")], rules=["cuda-kernel"])
    bounds = [v for v in vs if "__launch_bounds__" in v.message]
    assert bounds and all(v.waived for v in bounds)
    vs = run_lint([str(tmp_path / "unexplained.cu")], rules=["cuda-kernel"])
    assert any(v.rule == "bad-waiver" and "//" in v.message for v in vs)
    assert any("__launch_bounds__" in v.message and not v.waived for v in vs)


# ---- the CUDA source as the family reads it --------------------------------


def test_torch_lint_cuda_source_facts():
    text = cuda_kernel.strip_comments((CSRC / "fused.cu").read_text())
    fns = cuda_kernel.functions(text)
    kernels = sorted(f.name for f in fns if f.kind == "__global__")
    assert kernels == ["auction_bid_kernel", "greedy_lists_kernel",
                       "greedy_pass_kernel", "masked_score_kernel",
                       "row_stats_kernel"]
    labels = cuda_kernel.instantiations(text, fns)
    assert labels["greedy_pass_kernel"] == [
        "greedy_pass_kernel<false>", "greedy_pass_kernel<true>"]
    assert sum(len(v) for v in labels.values()) == 10
    consts = cuda_kernel.constants(text)
    structs = cuda_kernel.struct_sizes(text, consts)
    assert structs["PodRow"] == (48, 16)
    smem = {f.name: cuda_kernel.static_smem(f, text, consts, structs)
            for f in fns if f.kind == "__global__"}
    # ptxas on the H100 (kernel_budget.json) agrees for K1-K3 and pads
    # K4's two to 2,192 and 400 bytes (8 bytes for each scalar)
    assert smem == {"masked_score_kernel": 4896, "row_stats_kernel": 1344,
                    "auction_bid_kernel": 192, "greedy_lists_kernel": 2184,
                    "greedy_pass_kernel": 396}


def test_torch_lint_budget_rows_match_the_source():
    doc = kernel_budget.load_budget(CSRC / "kernel_budget.json")
    text = cuda_kernel.strip_comments((CSRC / "fused.cu").read_text())
    labels = cuda_kernel.instantiations(text, cuda_kernel.functions(text))
    assert sorted(r["kernel"] for r in doc["kernels"]) == sorted(
        label for v in labels.values() for label in v)
    for row in doc["kernels"]:
        assert row["source"] == "fused.cu"
        assert all(row[f] == 0 for f in kernel_budget.MUST_BE_ZERO), row
        assert set(kernel_budget.FIELDS) <= set(row)


# ---- reading ptxas (the card's side, held here on recorded text) -----------

PTXAS = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN40_GLOBAL__N__b066502c_8_fused_cu_80a0636318greedy_pass_kernelILb0EEEvPKfS2_S2_PKjPKiS6_PfPiS8_iiii' for 'sm_90a'
ptxas info    : Function properties for _ZN40_GLOBAL__N__b066502c_8_fused_cu_80a0636318greedy_pass_kernelILb0EEEvPKfS2_S2_PKjPKiS6_PfPiS8_iiii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 55 registers, used 1 barriers, 400 bytes smem
ptxas info    : Compiling entry function '_ZN40_GLOBAL__N__b066502c_8_fused_cu_80a0636319greedy_lists_kernelILb1EEEvPKfS2_S2_PjPiS4_iiii' for 'sm_90a'
ptxas info    : Function properties for _ZN40_GLOBAL__N__b066502c_8_fused_cu_80a0636319greedy_lists_kernelILb1EEEvPKfS2_S2_PjPiS4_iiii
    8 bytes stack frame, 8 bytes spill stores, 16 bytes spill loads
ptxas info    : Used 40 registers, used 1 barriers, 8 bytes cumulative stack size, 2192 bytes smem
ptxas info    : Compiling entry function '_Z6kernelPf' for 'sm_90a'
ptxas info    : Function properties for _Z6kernelPf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 8 registers, 16 bytes lmem, 360 bytes cmem[0]
"""


def test_torch_ptxas_log_parses():
    rows = kernel_budget.parse_ptxas(PTXAS)
    assert rows == {
        "greedy_pass_kernel<false>": {
            "registers": 55, "static_smem_bytes": 400, "stack_frame_bytes": 0,
            "spill_stores_bytes": 0, "spill_loads_bytes": 0, "local_bytes": 0},
        "greedy_lists_kernel<true>": {
            "registers": 40, "static_smem_bytes": 2192, "stack_frame_bytes": 8,
            "spill_stores_bytes": 8, "spill_loads_bytes": 16, "local_bytes": 0},
        "kernel": {
            "registers": 8, "static_smem_bytes": 0, "stack_frame_bytes": 0,
            "spill_stores_bytes": 0, "spill_loads_bytes": 0, "local_bytes": 16},
    }


@pytest.mark.parametrize("mangled,label", [
    ("_ZN12_GLOBAL__N_119masked_score_kernelILb1EEEvPKf", "masked_score_kernel<true>"),
    ("_Z19masked_score_kernelILb0EEvPKf", "masked_score_kernel<false>"),
    ("_ZN2ks6kernelILi3ELin2EEEvPf", "ks::kernel<3, -2>"),
    ("_Z6kernelPf", "kernel"),
    ("ks_plain", "ks_plain"),
])
def test_torch_ptxas_names_demangle(mangled, label):
    assert kernel_budget.demangle(mangled) == label


def test_torch_ptxas_unreadable_log_raises():
    with pytest.raises(ValueError, match="names no kernel"):
        kernel_budget.parse_ptxas("nvcc ran without -Xptxas -v\n")
    with pytest.raises(ValueError, match="no registers"):
        kernel_budget.parse_ptxas(PTXAS.replace("Used 55 registers, ", ""))
    with pytest.raises(ValueError, match="cannot demangle"):
        kernel_budget.demangle("_ZN3fooIXadL_Z3barEEEEvv")


def test_torch_budget_compare_names_every_difference():
    rows = kernel_budget.parse_ptxas(PTXAS)
    measured = {"nvcc": "a", "nvcc_flags": ["-v"], "kernels": [
        {"source": "fused.cu", "kernel": k, **v} for k, v in rows.items()]}
    same = json.loads(json.dumps(measured))
    same["kernels"] = [r for r in same["kernels"]
                       if r["kernel"] == "greedy_pass_kernel<false>"]
    assert kernel_budget.compare(json.loads(json.dumps(same)), same) == []
    moved = json.loads(json.dumps(same))
    moved["kernels"][0]["registers"] = 54
    moved["kernels"].append({"source": "fused.cu", "kernel": "gone", **rows["kernel"]})
    problems = kernel_budget.compare(measured, moved)
    text = "\n".join(problems)
    assert "greedy_lists_kernel<true>: {'spill_stores_bytes': 8, 'spill_loads_bytes': 16} must be 0" in text
    assert "greedy_lists_kernel<true> (fused.cu) has no row" in text
    assert "greedy_pass_kernel<false>: budget differs" in text and "(54, 55)" in text
    assert "row gone (fused.cu) names no built kernel" in text
    assert "kernel: {'local_bytes': 16} must be 0" in text


def test_torch_budget_write_round_trips(tmp_path):
    doc = kernel_budget.load_budget(CSRC / "kernel_budget.json")
    out = tmp_path / "kernel_budget.json"
    kernel_budget.write_budget(doc, out)
    assert kernel_budget.load_budget(out) == doc
    assert out.read_text() == (CSRC / "kernel_budget.json").read_text()


def test_torch_write_kernel_budget_needs_nvcc(monkeypatch, tmp_path):
    """Without the CUDA toolkit the writer raises; it never skips, and the
    checked-in budget stays as it was."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    before = (CSRC / "kernel_budget.json").read_bytes()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        main(["--write-kernel-budget"])
    assert (CSRC / "kernel_budget.json").read_bytes() == before


# ---- the port lints itself -------------------------------------------------


@pytest.fixture(scope="module")
def port_run():
    ctx_sink = []
    vs = run_lint(ctx_out=ctx_sink)
    return vs, ctx_sink[0]


def test_torch_port_lints_clean(port_run):
    vs, _ = port_run
    assert active(vs) == [], [v.format() for v in active(vs)]
    assert all(v.waiver_reason for v in vs if v.waived)
    assert not any(v.rule == "bad-waiver" for v in vs)


def test_torch_port_waivers_put_back(port_run):
    vs, _ = port_run
    waived = {(v.rule, v.path) for v in vs if v.waived}
    assert ("lock-discipline", f"{PORT}/host/queue.py") in waived
    assert ("lock-discipline", f"{PORT}/trace/spans.py") in waived
    assert ("host-transfer", f"{PORT}/device.py") in waived


def test_torch_port_thread_roots_verified(port_run):
    _, ctx = port_run
    index = dataflow.get_index(ctx)
    assert threads.verify_thread_roots(index) == []
    paths = {r.path for r in threads.THREAD_ROOTS}
    assert paths and all(p.startswith(f"{PORT}/") for p in paths)


def test_torch_port_cuda_family_clean():
    vs = run_lint(rules=["cuda-kernel"])
    assert active(vs) == [], [v.format() for v in vs]


def test_torch_port_collects_cuda_sources():
    files = collect_files(str(ROOT))
    rel = {os.path.relpath(p, ROOT).replace(os.sep, "/") for p in files}
    assert f"{PORT}/csrc/fused.cu" in rel
    assert not any("/_build/" in p or p.endswith("_pb2.py") for p in rel)


def test_torch_lint_registry_has_fourteen_families():
    assert set(RULES) == {
        "host-sync", "lock-discipline", "wire-schema", "dtype-shape",
        "timeout-hygiene", "cuda-kernel", "metric-hygiene", "sim-determinism",
        "span-hygiene", "host-transfer", "lockset-race",
        "capability-completeness", "thread-race", "determinism-taint",
    }
    docs = _rule_docs()
    assert set(docs) == set(RULES) and all(docs.values())


def test_torch_lint_readme_table_matches_registry():
    assert _check_readme_rules(str(ROOT), RULES) == []
    extra = dict(RULES, **{"brand-new-family": RULES["host-sync"]})
    assert any("brand-new-family" in v.message
               for v in _check_readme_rules(str(ROOT), extra))
    missing = dict(RULES)
    missing.pop("cuda-kernel")
    assert any("`cuda-kernel`" in v.message and "not a registered" in v.message
               for v in _check_readme_rules(str(ROOT), missing))


def test_torch_analysis_imports_no_jax_torch_or_reference():
    for path in sorted((ROOT / PORT / "analysis").rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
                names = [node.module]
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "torch"), (path, name)
                assert top != "kubernetes_scheduler_tpu", (path, name)


def test_torch_lint_runs_with_jax_and_torch_blocked():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['torch'] = None\n"
        "sys.modules['kubernetes_scheduler_tpu'] = None\n"
        "from kubernetes_scheduler_tpu_torch.analysis.__main__ import main\n"
        "sys.exit(main([]))\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
        timeout=300, env=dict(os.environ, PYTHONPATH=str(ROOT)),
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "0 violation(s)" in proc.stderr


def test_torch_lint_sarif_validates(capsys):
    rc = main([str(REF_FIXTURES / "waiver_fixture.py"),
               "--rules", "timeout-hygiene", "--format", "sarif"])
    assert rc == 1
    doc = json.loads(capsys.readouterr().out)
    validate_sarif(doc)
    results = doc["runs"][0]["results"]
    assert any(r.get("suppressions") for r in results)
    vs = run_lint([str(FIXTURES / "cuda_kernel_violation.cu")], rules=["cuda-kernel"])
    validate_sarif(render_sarif(vs, _rule_docs()))


@pytest.mark.parametrize("args", [
    ["timeout_violation.py", "--rules", "timeout-hygiene"],
    ["timeout_clean.py", "--rules", "timeout-hygiene"],
    ["timeout_violation.py", "--rules", "timeout-hygiene", "--format", "json"],
    ["timeout_violation.py", "--rules", "timeout-hygiene", "--format", "sarif"],
    ["timeout_clean.py", "--rules", "timeout-hygiene", "--budget-seconds", "0.0"],
    ["timeout_clean.py", "--rules", "timeout-hygiene", "--budget-seconds", "600"],
    ["lock_discipline_violation.py", "--rules", "lock-discipline", "--verbose"],
    ["waiver_fixture.py", "--rules", "timeout-hygiene", "--no-baseline"],
    ["timeout_clean.py", "--rules", "no-such-rule"],
    ["timeout_clean.py", "--changed-only", "HEAD"],
], ids=["violation", "clean", "json", "sarif", "over-budget", "in-budget",
        "verbose", "no-baseline", "unknown-rule", "changed-with-paths"])
def test_torch_lint_exit_codes_match_reference(args, tmp_path, capsys):
    argv = [str(REF_FIXTURES / args[0])] + args[1:] + [
        "--json-artifact", str(tmp_path / "out.json")]

    def rc(fn):
        try:
            return fn(argv)
        except SystemExit as e:
            return e.code

    ref = rc(ref_main)
    ref_out = capsys.readouterr()
    port = rc(main)
    port_out = capsys.readouterr()
    assert port == ref
    if args[0] == "timeout_violation.py" and "--format" not in args:
        assert port_out.out == ref_out.out


def test_torch_lint_json_artifact(tmp_path, capsys):
    art = tmp_path / "findings.json"
    rc = main([str(REF_FIXTURES / "lock_discipline_violation.py"),
               "--rules", "lock-discipline", "--format", "json",
               "--json-artifact", str(art)])
    assert rc == 1
    printed = json.loads(capsys.readouterr().out)
    assert printed == json.loads(art.read_text())
    assert printed[0]["rule"] == "lock-discipline"


def test_torch_lint_changed_only_couples_the_cuda_surface(port_run):
    _, ctx = port_run
    closure = reverse_dependency_closure(ctx, {f"{PORT}/csrc/fused.cu"})
    assert f"{PORT}/ops/_build.py" in closure
    assert f"{PORT}/csrc/kernel_budget.json" in closure
    closure = reverse_dependency_closure(ctx, {f"{PORT}/engine.py"})
    assert f"{PORT}/csrc/fused.cu" not in closure


def test_torch_lint_changed_only_is_a_subset(tmp_path, capsys):
    """--changed-only against HEAD reports a subset of the full run's
    findings (here both empty on a clean tree, and the run succeeds)."""
    if shutil.which("git") is None or not (ROOT / ".git").exists():
        pytest.skip("needs a git checkout")
    assert main(["--changed-only", "HEAD", "--format", "json"]) == 0
    changed = json.loads(capsys.readouterr().out)
    assert main(["--format", "json"]) == 0
    full = json.loads(capsys.readouterr().out)
    key = lambda v: (v["rule"], v["path"], v["line"], v["message"])  # noqa: E731
    assert {key(v) for v in changed} <= {key(v) for v in full}


def test_torch_lint_index_parses_port_once():
    root = str(ROOT)
    files = [load_file(p, root) for p in collect_files(root)]
    ctx = Context(root=root, files=[f for f in files if f is not None])
    index = dataflow.get_index(ctx)
    assert dataflow.get_index(ctx) is index
    # the call graph reaches the kernels' wrappers from the engine
    graph = index.call_graph()
    assert any(q.startswith(f"{PORT}/engine.py::") for q in graph)
    assert not hasattr(index, "jit_entries")
