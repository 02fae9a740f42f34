"""graftlint core for the PyTorch/CUDA package: violations, inline
waivers, file collection, runner.

Rules are pure functions `check(ctx) -> list[Violation]` registered in
rules/__init__.py. The runner parses every in-scope file once; rules pick
their own file subsets (kernel dirs, host cycle path, bridge) unless the
caller passed explicit paths (fixture mode), in which case every given
file is in scope for every requested rule.

Besides the package's .py files the runner collects the CUDA sources
under csrc/ (`*.cu`): they carry no AST (an empty module stands in), but
their `// graftlint: disable=<rule> -- <reason>` waivers are parsed and
applied like the Python ones, so the cuda-kernel family's findings are
waivable where they are reported.
"""

from __future__ import annotations

import ast
import fnmatch
import json
import os
import re
from dataclasses import dataclass, field

_REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
_PKG_DIR = os.path.join(_REPO_ROOT, "kubernetes_scheduler_tpu_torch")

# generated / vendored files never linted
_EXCLUDE = ("*_pb2.py",)
# CUDA sources: scanned as text by the cuda-kernel family
CUDA_SUFFIX = ".cu"

# graftlint: disable=<rule>[,<rule>|all] -- <justification>
_WAIVER_RE = re.compile(
    r"#\s*graftlint:\s*disable=([\w,\-]+)(?:\s+--\s*(\S.*))?"
)
# the same waiver in a CUDA source's `//` comment
_CU_WAIVER_RE = re.compile(
    r"//\s*graftlint:\s*disable=([\w,\-]+)(?:\s+--\s*(\S.*))?"
)


@dataclass
class Violation:
    rule: str
    path: str          # repo-relative
    line: int
    message: str
    waived: bool = False
    waiver_reason: str | None = None

    def format(self) -> str:
        tag = " (waived: %s)" % self.waiver_reason if self.waived else ""
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}{tag}"


@dataclass
class SourceFile:
    path: str          # repo-relative, forward slashes
    abspath: str
    source: str
    tree: ast.AST
    lines: list[str] = field(default_factory=list)
    # line -> (set of rule names | {"all"}, reason | None)
    waivers: dict[int, tuple[set, str | None]] = field(default_factory=dict)
    # (start, end, rules, reason) spans: a waiver above a decorator
    # covers the whole def; one on a multi-line statement covers every
    # line of the statement
    waiver_spans: list[tuple] = field(default_factory=list)

    def matches(self, patterns) -> bool:
        return any(fnmatch.fnmatch(self.path, p) for p in patterns)

    def waiver_for(self, line: int, rule: str):
        """(rules, reason) of the waiver covering `line` for `rule`, or
        None — exact-line waivers first, then statement/def spans."""
        w = self.waivers.get(line)
        if w and (rule in w[0] or "all" in w[0]):
            return w
        for start, end, rules, reason in self.waiver_spans:
            if start <= line <= end and (rule in rules or "all" in rules):
                return (rules, reason)
        return None


@dataclass
class Context:
    root: str
    files: list[SourceFile]
    # explicit file list given (fixture mode): rules scan everything
    explicit: bool = False
    # proto override for the wire-schema rule (tests)
    proto_path: str | None = None
    # the run's shared parse-once ModuleIndex (analysis/dataflow.py),
    # built lazily by dataflow.get_index and reused by every family
    _index: object | None = None

    def scoped(self, patterns) -> list[SourceFile]:
        if self.explicit:
            return self.files
        return [f for f in self.files if f.matches(patterns)]


def _parse_waivers(sf: SourceFile) -> list[Violation]:
    """Populate sf.waivers; a waiver with no justification is itself a
    violation (`bad-waiver`, unwaivable)."""
    bad = []
    cuda = sf.path.endswith(CUDA_SUFFIX)
    regex, mark = (_CU_WAIVER_RE, "//") if cuda else (_WAIVER_RE, "#")
    for i, line in enumerate(sf.lines, start=1):
        m = regex.search(line)
        if not m:
            continue
        rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
        reason = m.group(2)
        if not reason:
            bad.append(
                Violation(
                    "bad-waiver", sf.path, i,
                    "waiver missing justification: write "
                    f"`{mark} graftlint: disable=<rule> -- <why this is safe>`",
                )
            )
            continue
        target = i
        # a comment-only line waives the NEXT line
        if line.split(mark, 1)[0].strip() == "":
            target = i + 1
        entry = sf.waivers.setdefault(target, (set(), reason.strip()))
        entry[0].update(rules)
    _resolve_waiver_spans(sf)
    return bad


def _resolve_waiver_spans(sf: SourceFile) -> None:
    """Widen line-targeted waivers whose target is structural:

    - a waiver landing on a DECORATOR line (a comment above `@cache`)
      waives the whole decorated def — the finding it suppresses is a
      property of the function, not of the one line the parser happened
      to attribute it to;
    - a waiver landing on the first line of a MULTI-LINE simple
      statement covers every line of that statement (a violating
      `dtype=` keyword two lines into a call is the same finding).

    Waivers already inside the def/statement keep exact-line semantics —
    widening those would let one waiver silence unrelated findings."""
    if not sf.waivers:
        return
    dec_spans = []   # (first decorator line, def line, def end)
    stmt_spans = {}  # lineno -> end_lineno for multi-line simple stmts
    for node in ast.walk(sf.tree):
        if isinstance(
            node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
        ) and node.decorator_list:
            first = min(d.lineno for d in node.decorator_list)
            dec_spans.append((first, node.lineno, node.end_lineno or node.lineno))
        elif isinstance(node, ast.stmt) and not isinstance(
            node,
            (
                ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef,
                ast.If, ast.For, ast.AsyncFor, ast.While, ast.With,
                ast.AsyncWith, ast.Try,
            ),
        ):
            end = node.end_lineno or node.lineno
            if end > node.lineno:
                stmt_spans[node.lineno] = max(
                    end, stmt_spans.get(node.lineno, 0)
                )
    for target, (rules, reason) in sf.waivers.items():
        for first, def_line, def_end in dec_spans:
            if first <= target < def_line:
                sf.waiver_spans.append((first, def_end, rules, reason))
                break
        else:
            if target in stmt_spans:
                sf.waiver_spans.append(
                    (target, stmt_spans[target], rules, reason)
                )


def load_file(abspath: str, root: str) -> SourceFile | None:
    with open(abspath, encoding="utf-8") as f:
        source = f.read()
    if abspath.endswith(CUDA_SUFFIX):
        # no Python AST: an empty module keeps the index and the
        # structural waiver pass uniform
        tree = ast.Module(body=[], type_ignores=[])
    else:
        try:
            tree = ast.parse(source, filename=abspath)
        except SyntaxError:
            return None
    rel = os.path.relpath(abspath, root).replace(os.sep, "/")
    return SourceFile(
        path=rel, abspath=abspath, source=source, tree=tree,
        lines=source.splitlines(),
    )


def collect_files(root: str | None = None) -> list[str]:
    """Every lintable .py file in the package (the linter's own code
    included — it must hold itself to the repo's invariants), and the
    CUDA sources under csrc/."""
    root = root or _REPO_ROOT
    out = []
    for dirpath, dirnames, filenames in os.walk(
        os.path.join(root, "kubernetes_scheduler_tpu_torch")
    ):
        dirnames[:] = sorted(
            d for d in dirnames if d not in ("__pycache__", "_build")
        )
        for name in sorted(filenames):
            if not name.endswith((".py", CUDA_SUFFIX)):
                continue
            if any(fnmatch.fnmatch(name, p) for p in _EXCLUDE):
                continue
            out.append(os.path.join(dirpath, name))
    return out


def run_lint(
    paths: list[str] | None = None,
    *,
    rules: list[str] | None = None,
    root: str | None = None,
    proto_path: str | None = None,
    ctx_out: list | None = None,
) -> list[Violation]:
    """Lint `paths` (default: the whole package) with `rules` (default:
    all). Returns every violation, waived ones flagged. `ctx_out`, if
    given, receives the run's Context (the CLI's --changed-only mode
    reuses its parse-once index for the reverse-dependency closure
    instead of re-parsing the repo)."""
    from kubernetes_scheduler_tpu_torch.analysis.rules import RULES

    root = root or _REPO_ROOT
    explicit = paths is not None
    abspaths = (
        [os.path.abspath(p) for p in paths]
        if explicit
        else collect_files(root)
    )
    files = []
    violations: list[Violation] = []
    for p in abspaths:
        sf = load_file(p, root)
        if sf is None:
            violations.append(
                Violation(
                    "parse", os.path.relpath(p, root).replace(os.sep, "/"),
                    1, "file does not parse",
                )
            )
            continue
        violations.extend(_parse_waivers(sf))
        files.append(sf)
    ctx = Context(
        root=root, files=files, explicit=explicit, proto_path=proto_path
    )
    if ctx_out is not None:
        ctx_out.append(ctx)
    selected = rules or list(RULES)
    unknown = set(selected) - set(RULES)
    if unknown:
        raise ValueError(f"unknown lint rules: {sorted(unknown)}")
    for name in selected:
        violations.extend(RULES[name](ctx))
    if not explicit and rules is None:
        violations.extend(_check_readme_rules(root, RULES))
    # apply waivers
    by_path = {f.path: f for f in files}
    for v in violations:
        sf = by_path.get(v.path)
        if sf is None or v.rule == "bad-waiver":
            continue
        w = sf.waiver_for(v.line, v.rule)
        if w is not None:
            v.waived = True
            v.waiver_reason = w[1]
    violations.sort(key=lambda v: (v.path, v.line, v.rule))
    return violations


# the heading of the README section that documents this package's lint
# families (the JAX package's table sits under its own "## Static analysis")
README_HEADING = "### Static analysis of the port"


def _check_readme_rules(root: str, rules: dict) -> list[Violation]:
    """README's lint table for this package must name EXACTLY the
    registered rule families — drift in either direction fails lint
    (pseudo-rule `docs-drift`, unwaivable like bad-waiver). The table is
    the block of `| \\`rule\\` | ... |` rows under README_HEADING."""
    readme = os.path.join(root, "README.md")
    if not os.path.exists(readme):
        return []
    with open(readme, encoding="utf-8") as f:
        text = f.read()
    m = re.search(r"^" + re.escape(README_HEADING) + r".*?$", text, re.M)
    if m is None:
        return [
            Violation(
                "docs-drift", "README.md", 1,
                f"README has no `{README_HEADING}` section documenting "
                "the lint families",
            )
        ]
    section = text[m.end():]
    # the families table lives in the section intro; subsections (the
    # contract and protocol-model layers) may carry tables of their own
    # (model inventories), which are not rule rows
    nxt = re.search(r"^#{2,4} ", section, re.M)
    if nxt:
        section = section[: nxt.start()]
    documented: dict[str, int] = {}
    base_line = text[: m.end()].count("\n") + 1
    for i, line in enumerate(section.splitlines()):
        row = re.match(r"\|\s*`([a-z][\w-]*)`\s*\|", line)
        if row:
            documented[row.group(1)] = base_line + i
    out = []
    for name in sorted(set(rules) - set(documented)):
        out.append(
            Violation(
                "docs-drift", "README.md", base_line,
                f"registered lint family `{name}` is missing from the "
                "README's Static analysis table",
            )
        )
    for name, line in sorted(documented.items()):
        if name not in rules:
            out.append(
                Violation(
                    "docs-drift", "README.md", line,
                    f"README's Static analysis table documents `{name}`, "
                    "which is not a registered lint family",
                )
            )
    return out


# ---- changed-only scoping (fast pre-commit loop) ---------------------------


def changed_vs_ref(root: str, ref: str) -> set[str]:
    """Repo-relative paths changed vs `ref` (committed diff + working
    tree + untracked). A change to bridge/schedule.proto counts as a
    change to the bridge modules that encode it — the wire-schema and
    capability-completeness families check .py files against the proto,
    so a proto-only edit must still pull them into scope. A CUDA source
    and the kernel budget file count as themselves: the cuda-kernel
    family reports on them directly."""
    import subprocess

    out: set[str] = set()
    for args in (
        ["git", "diff", "--name-only", ref, "--"],
        ["git", "ls-files", "--others", "--exclude-standard"],
    ):
        try:
            res = subprocess.run(
                args, cwd=root, capture_output=True, text=True,
                check=True, timeout=30,
            )
        except (OSError, subprocess.SubprocessError) as e:
            detail = getattr(e, "stderr", "") or str(e)
            raise ValueError(
                f"--changed-only {ref}: {' '.join(args)} failed: "
                f"{detail.strip()}"
            ) from e
        out.update(p.strip() for p in res.stdout.splitlines() if p.strip())
    changed: set[str] = set()
    for p in out:
        p = p.replace(os.sep, "/")
        if p.endswith("schedule.proto"):
            changed.update((
                "kubernetes_scheduler_tpu_torch/bridge/client.py",
                "kubernetes_scheduler_tpu_torch/bridge/server.py",
                "kubernetes_scheduler_tpu_torch/bridge/codec.py",
            ))
        elif p.startswith("kubernetes_scheduler_tpu_torch/") and p.endswith(
            (".py", CUDA_SUFFIX, "kernel_budget.json")
        ):
            changed.add(p)
    return changed


def reverse_dependency_closure(ctx: Context, changed: set[str]) -> set[str]:
    """`changed` plus every package file that depends on one of them,
    transitively — dependence meaning a module import OR a resolved
    call-graph edge into the file (the shared parse-once ModuleIndex).
    A pre-commit lint scoped to this closure sees every finding the
    edit could have created or fixed; findings wholly outside it are
    unaffected by construction (pinned: changed-only findings are a
    subset of the full run's)."""
    from kubernetes_scheduler_tpu_torch.analysis import dataflow

    index = dataflow.get_index(ctx)
    known = {f.path for f in ctx.files}
    # file -> files it depends on (imports + call edges)
    deps: dict[str, set[str]] = {p: set() for p in known}
    for path, imports in index.imports.items():
        for dotted in imports.values():
            # `from pkg.mod import name` records pkg.mod.name; resolve
            # the longest module prefix actually in the package
            parts = dotted.split(".")
            for i in range(len(parts), 0, -1):
                target = index.by_module.get(".".join(parts[:i]))
                if target is not None:
                    if target.path != path:
                        deps[path].add(target.path)
                    break
    for caller, edges in index.call_graph().items():
        cfile = caller.split("::", 1)[0]
        for callee, _ in edges:
            tfile = callee.split("::", 1)[0]
            if tfile != cfile and cfile in deps:
                deps[cfile].add(tfile)
    closure = set(changed) & known
    frontier = list(closure)
    rev: dict[str, list[str]] = {}
    for p, targets in deps.items():
        for t in targets:
            rev.setdefault(t, []).append(p)
    while frontier:
        t = frontier.pop()
        for p in rev.get(t, ()):
            if p not in closure:
                closure.add(p)
                frontier.append(p)
    # the declared thread model couples its root modules: a cross-file
    # race pairs a write in one root's file with a read reachable from
    # another root's, so a change to any thread-root module (or to the
    # model itself) pulls EVERY root module into scope — the thread-race
    # family must see both sides of each pair. Closure only grows, so
    # changed-only stays a subset of the full run.
    from kubernetes_scheduler_tpu_torch.analysis.threads import THREAD_ROOTS

    root_paths = {r.path for r in THREAD_ROOTS} & known
    model_path = "kubernetes_scheduler_tpu_torch/analysis/threads.py"
    if closure & (root_paths | {model_path}):
        closure |= root_paths
    # the CUDA surface is one contract: the sources, the ctypes table in
    # ops/_build.py and the kernel budget file are checked against each
    # other, so a change to any of them scopes in all of them
    cuda = {p for p in known if p.endswith(CUDA_SUFFIX)} | {
        CUDA_BINDING, CUDA_BUDGET,
    }
    if (closure | set(changed)) & cuda:
        closure |= cuda
    return closure


# the ctypes table and the kernel budget file the cuda-kernel family
# holds the CUDA sources against
CUDA_BINDING = "kubernetes_scheduler_tpu_torch/ops/_build.py"
CUDA_BUDGET = "kubernetes_scheduler_tpu_torch/csrc/kernel_budget.json"


# ---- baseline (CI suppression) file ---------------------------------------

# the package's own suppression file (the JAX package's LINT_BASELINE.json
# at the repo root is that package's)
BASELINE_NAME = "kubernetes_scheduler_tpu_torch/analysis/LINT_BASELINE.json"

# hygiene pseudo-rules police the suppression machinery itself — letting
# the baseline waive them would let it silence its own failure modes
UNBASELINABLE = frozenset(
    {"bad-waiver", "docs-drift", "bad-baseline", "stale-baseline"}
)


def load_baseline(path: str) -> list[dict]:
    """Entries of a checked-in baseline file: each {"rule", "path",
    "contains", "reason"} suppresses active findings whose rule+path
    match and whose message contains the fragment. CI diffs findings
    against this instead of grepping logs."""
    with open(path, encoding="utf-8") as f:
        doc = json.load(f)
    if not isinstance(doc, dict) or not isinstance(doc.get("entries"), list):
        raise ValueError(f"{path}: baseline must be {{'entries': [...]}}")
    return doc["entries"]


def apply_baseline(
    violations: list[Violation], entries: list[dict], baseline_path: str,
    check_stale: bool = True,
) -> list[Violation]:
    """Waive findings matched by baseline entries. Returns EXTRA
    violations: an entry with no reason, and an entry matching nothing
    (stale — the finding it blessed is gone), both fail lint so the
    baseline can only hold explained, live suppressions. Pass
    check_stale=False for path/rule-scoped runs: an entry whose target
    is outside the scope produces no finding to match, and only the
    full-repo run can tell 'out of scope' from 'actually stale'."""
    rel = os.path.basename(baseline_path)
    extra: list[Violation] = []
    for i, e in enumerate(entries):
        if not isinstance(e, dict):
            extra.append(
                Violation(
                    "bad-baseline", rel, i + 1,
                    f"baseline entry {i} is {type(e).__name__!s}, not an "
                    "object — each entry must be {rule, path, contains, "
                    "reason}",
                )
            )
            continue
        reason = (e.get("reason") or "").strip()
        if not reason:
            extra.append(
                Violation(
                    "bad-baseline", rel, i + 1,
                    f"baseline entry {i} ({e.get('rule')}: {e.get('path')}) "
                    "has no reason — every suppression must be explained",
                )
            )
            continue
        if e.get("rule") in UNBASELINABLE:
            extra.append(
                Violation(
                    "bad-baseline", rel, i + 1,
                    f"baseline entry {i} targets hygiene pseudo-rule "
                    f"`{e.get('rule')}` — waiver/baseline/docs findings "
                    "cannot be suppressed",
                )
            )
            continue
        matched = False
        for v in violations:
            if v.waived or v.rule != e.get("rule"):
                continue
            if v.path != e.get("path"):
                continue
            if e.get("contains") and e["contains"] not in v.message:
                continue
            v.waived = True
            v.waiver_reason = f"baseline: {reason}"
            matched = True
        if not matched and check_stale:
            extra.append(
                Violation(
                    "stale-baseline", rel, i + 1,
                    f"baseline entry {i} ({e.get('rule')}: {e.get('path')}) "
                    "matches no current finding — delete it",
                )
            )
    return extra


# ---- shared AST helpers ---------------------------------------------------


def dotted_name(node: ast.AST) -> str | None:
    """'a.b.c' for Name/Attribute chains, else None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def has_kwarg(call: ast.Call, name: str) -> bool:
    return any(kw.arg == name for kw in call.keywords)
