"""Interprocedural dataflow core shared by the graftlint rule families.

The PyTorch/CUDA package's copy of the JAX package's dataflow core. One
build per lint run, cached on the Context:

- a parse-once, WALK-once module index: every file's AST node list,
  function/class/import tables, and dotted-module resolution, so the
  rule families share one traversal instead of re-walking the tree per
  family (the wall-time budget `--budget-seconds` asserts rides on
  this);
- a project call graph with call-site attribution, resolved through
  imports (`from kubernetes_scheduler_tpu_torch import engine` →
  `engine.apply_snapshot_delta` lands on the real def in engine.py),
  same-file scopes, `self.method` dispatch within a class, and a
  conservative bare-name fallback (over-approximation flags at worst an
  extra waivable site);
- per-function def-use with BRANCH PATHS: each load/store/call carries
  the tuple of enclosing suites, so a rule can tell "after the call on
  the same control path" from a read in a mutually exclusive arm;
- torch-value taint: names bound to a `torch.*` call, a tensor method
  or a project function annotated to return a tensor (host-transfer's
  engine);
- a lockset walker: per-class `with self._lock:` contexts threaded
  through intra-class helper calls to a fixpoint of entry locksets
  (lockset-race's engine).

Left out of the copy: jit entry points and jit reachability, and the
donation summaries. They serve only the JAX families jit-purity,
tracer-leak and donation-aliasing, which have no counterpart in an
eager program with no traces and no donated buffers.

Everything here is name-based and syntactic — no imports of the
analyzed code, no type inference. Precision choices are documented at
each helper; the inline-waiver syntax absorbs the residue.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field

from kubernetes_scheduler_tpu_torch.analysis.core import (
    Context,
    SourceFile,
    dotted_name,
)

# ---- module index ---------------------------------------------------------


@dataclass
class FuncInfo:
    """One function/method def, with enough scope context to resolve
    calls against it."""

    qname: str                  # "<path>::Outer.inner" — unique per def
    name: str                   # bare name
    sf: SourceFile
    node: ast.AST               # FunctionDef | AsyncFunctionDef
    cls: ast.ClassDef | None    # enclosing class, if a method
    module: str                 # dotted module ("kubernetes_scheduler_tpu_torch.engine")


def module_dotted(path: str) -> str:
    """Repo-relative path -> dotted module name."""
    mod = path[:-3] if path.endswith(".py") else path
    mod = mod.replace("/", ".")
    if mod.endswith(".__init__"):
        mod = mod[: -len(".__init__")]
    return mod


class ModuleIndex:
    """Parse-once/walk-once project index. Built lazily by
    `Context.index` and shared by every rule family in the run."""

    def __init__(self, files: list[SourceFile]):
        self.files = files
        self._walks: dict[str, list[ast.AST]] = {}
        self.funcs: dict[str, FuncInfo] = {}
        self.by_name: dict[str, list[FuncInfo]] = {}
        # class name -> [(sf, ClassDef)] (name collisions kept — resolution
        # stays conservative)
        self.classes: dict[str, list[tuple]] = {}
        self.by_module: dict[str, SourceFile] = {}
        # path -> alias -> dotted target ("np" -> "numpy",
        # "engine" -> "kubernetes_scheduler_tpu_torch.engine",
        # "apply_snapshot_delta" -> "kubernetes_scheduler_tpu_torch.engine.apply_snapshot_delta")
        self.imports: dict[str, dict[str, str]] = {}
        self._call_graph: dict[str, list[tuple[str, ast.Call]]] | None = None
        # (callee qname, id(call)) pairs where the edge comes from a bare
        # function REFERENCE passed as an argument, not a direct call
        self._ref_edges: set[tuple[str, int]] = set()
        for sf in files:
            self.by_module[module_dotted(sf.path)] = sf
            self._index_file(sf)

    # -- construction --

    def _index_file(self, sf: SourceFile) -> None:
        nodes = list(ast.walk(sf.tree))
        self._walks[sf.path] = nodes
        imports: dict[str, str] = {}
        self.imports[sf.path] = imports
        pkg = module_dotted(sf.path).rsplit(".", 1)[0]
        for node in nodes:
            if isinstance(node, ast.Import):
                for a in node.names:
                    imports[a.asname or a.name.split(".")[0]] = (
                        a.name if a.asname else a.name.split(".")[0]
                    )
            elif isinstance(node, ast.ImportFrom):
                base = node.module or ""
                if node.level:  # relative: resolve against this package
                    up = pkg.split(".")
                    up = up[: len(up) - (node.level - 1)]
                    base = ".".join(up + ([base] if base else []))
                for a in node.names:
                    if a.name == "*":
                        continue
                    imports[a.asname or a.name] = f"{base}.{a.name}"
            elif isinstance(node, ast.ClassDef):
                self.classes.setdefault(node.name, []).append((sf, node))
        self._index_scope(sf, sf.tree, (), None)

    def _index_scope(self, sf, node, scope, cls) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qname = f"{sf.path}::{'.'.join(scope + (child.name,))}"
                fi = FuncInfo(
                    qname=qname, name=child.name, sf=sf, node=child,
                    cls=cls, module=module_dotted(sf.path),
                )
                self.funcs[qname] = fi
                self.by_name.setdefault(child.name, []).append(fi)
                self._index_scope(sf, child, scope + (child.name,), cls)
            elif isinstance(child, ast.ClassDef):
                self._index_scope(
                    sf, child, scope + (child.name,), child
                )
            else:
                self._index_scope(sf, child, scope, cls)

    # -- shared traversal --

    def walk(self, sf: SourceFile) -> list[ast.AST]:
        """The file's full node list from the ONE walk done at index
        build — rules filter by isinstance instead of re-walking."""
        return self._walks[sf.path]

    def functions(self, sf: SourceFile) -> list[FuncInfo]:
        return [fi for fi in self.funcs.values() if fi.sf is sf]

    # -- call resolution --

    def resolve_call(
        self, fi: FuncInfo, call: ast.Call, *, loose: bool = True
    ) -> list[FuncInfo]:
        """Candidate defs a call may land on. Resolution order: `self.m`
        within the enclosing class; imported names (module attr chains
        included); same-file bare names; then — with loose=True — every
        same-named def project-wide (an over-approximation,
        minus `self.` chains, which never leave the class)."""
        dn = dotted_name(call.func)
        if dn is None:
            return []
        parts = dn.split(".")
        if parts[0] == "self":
            if len(parts) == 2 and fi.cls is not None:
                return [
                    cand
                    for cand in self.by_name.get(parts[1], ())
                    if cand.cls is fi.cls
                ]
            return []
        imports = self.imports.get(fi.sf.path, {})
        if parts[0] in imports:
            target = ".".join([imports[parts[0]]] + parts[1:])
            mod, _, name = target.rpartition(".")
            sf2 = self.by_module.get(mod)
            if sf2 is None:
                # suffix match: fixture files are linted by explicit
                # path, so `from helper_mod import f` must still land on
                # the sibling file indexed as tests.….helper_mod
                for m2, cand_sf in self.by_module.items():
                    if m2 == mod or m2.endswith("." + mod):
                        sf2 = cand_sf
                        break
            if sf2 is not None:
                return [
                    cand
                    for cand in self.by_name.get(name, ())
                    if cand.sf is sf2 and cand.cls is None
                ]
            # import of something outside the project (numpy, torch, ...)
            return []
        same_file = [
            cand
            for cand in self.by_name.get(parts[-1], ())
            if cand.sf is fi.sf
        ]
        if same_file or not loose:
            return same_file
        return list(self.by_name.get(parts[-1], ()))

    def call_graph(self) -> dict[str, list[tuple[str, ast.Call]]]:
        """qname -> [(callee qname, call site)] over every resolved call
        (and bare function reference passed as an argument — scan/vmap
        bodies transfer control too)."""
        if self._call_graph is not None:
            return self._call_graph
        graph: dict[str, list[tuple[str, ast.Call]]] = {}
        for fi in self.funcs.values():
            edges: list[tuple[str, ast.Call]] = []
            for node in shallow_walk(fi.node):
                if not isinstance(node, ast.Call):
                    continue
                for callee in self.resolve_call(fi, node):
                    edges.append((callee.qname, node))
                for arg in list(node.args) + [
                    kw.value for kw in node.keywords
                ]:
                    aname = dotted_name(arg)
                    if aname and not aname.startswith("self."):
                        for cand in self.by_name.get(
                            aname.rsplit(".", 1)[-1], ()
                        ):
                            edges.append((cand.qname, node))
                            self._ref_edges.add((cand.qname, id(node)))
            graph[fi.qname] = edges
        self._call_graph = graph
        return graph

    def ref_edges(self) -> set[tuple[str, int]]:
        """(callee qname, id(call site)) for every bare-reference edge in
        the call graph. Reachability WANTS these (a scan body transfers
        control); argument-position analyses must SKIP them — the outer
        call's positional args do not line up with the referenced
        callee's signature, so indexing them invents facts."""
        self.call_graph()
        return self._ref_edges

    def callees(self, qname: str) -> set[str]:
        return {c for c, _ in self.call_graph().get(qname, ())}

    def reachable_from(self, roots: set[str]) -> set[str]:
        """Transitive closure over the call graph."""
        seen: set[str] = set()
        stack = [q for q in roots if q in self.funcs]
        while stack:
            q = stack.pop()
            if q in seen:
                continue
            seen.add(q)
            stack.extend(c for c in self.callees(q) if c not in seen)
        return seen


def get_index(ctx: Context) -> ModuleIndex:
    """The run's shared index, built once and cached on the Context."""
    idx = getattr(ctx, "_index", None)
    if idx is None:
        idx = ModuleIndex(ctx.files)
        ctx._index = idx
    return idx


# ---- scope-bounded traversal ---------------------------------------------

_FN_DEFS = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
_SUITE_FIELDS = ("body", "orelse", "finalbody")


def shallow_walk(fn: ast.AST):
    """Every node in `fn`'s own scope — nested function/class bodies
    excluded (they are indexed as their own scopes)."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        yield node
        if not isinstance(node, _FN_DEFS + (ast.ClassDef,)):
            stack.extend(ast.iter_child_nodes(node))


def _shallow_stmt(node):
    """The statement plus its expression-level parts — never descending
    into nested suites (those get their own branch path) or nested
    function scopes."""
    yield node
    for fname, value in ast.iter_fields(node):
        if fname in _SUITE_FIELDS or fname == "handlers":
            continue
        for child in value if isinstance(value, list) else [value]:
            if isinstance(child, ast.AST) and not isinstance(child, _FN_DEFS):
                yield from _shallow_stmt(child)


def visit_suites(stmts, path, sink):
    """Walk statement suites recording each node's BRANCH PATH — a tuple
    of (enclosing statement id, suite field) — so a dataflow rule can
    tell 'after the call on the same control path' from a load in a
    mutually exclusive arm. `sink(node, path)` is called for every
    expression-level node."""
    for st in stmts:
        if isinstance(st, _FN_DEFS):
            continue  # separate scope: indexed as its own function
        for node in _shallow_stmt(st):
            sink(node, path)
        for fname in _SUITE_FIELDS:
            suite = getattr(st, fname, None)
            if suite:
                visit_suites(suite, path + ((id(st), fname),), sink)
        for h in getattr(st, "handlers", None) or ():
            visit_suites(h.body, path + ((id(st), id(h)),), sink)
        # match arms: each case body is its own mutually-exclusive suite
        # (match_case.body is a suite field _shallow_stmt rightly skips,
        # but Match itself has no `body`, so without this the arms were
        # invisible to every def_use-based rule)
        for case in getattr(st, "cases", None) or ():
            visit_suites(case.body, path + ((id(st), id(case)),), sink)


def path_prefix(a: tuple, b: tuple) -> bool:
    """True when branch path `a` structurally precedes `b` (same control
    path or an enclosing one)."""
    return b[: len(a)] == a


@dataclass
class DefUse:
    """Flat def-use facts for one function body, branch paths attached.
    Loads/assigns track full dotted names (`x`, `self._state.snapshot`),
    so attribute chains participate in the def-use rules too."""

    calls: list = field(default_factory=list)    # (lineno, ast.Call, path)
    assigns: list = field(default_factory=list)  # (lineno, dotted target, path)
    loads: list = field(default_factory=list)    # (lineno, dotted name, path)


def def_use(fn: ast.AST) -> DefUse:
    du = DefUse()

    def sink(node, path):
        if isinstance(node, ast.Call):
            du.calls.append((node.lineno, node, path))
        elif isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            targets = (
                node.targets
                if isinstance(node, ast.Assign)
                else [node.target]
            )
            for t in targets:
                for leaf in ast.walk(t):
                    dn = dotted_name(leaf)
                    if dn:
                        du.assigns.append((node.lineno, dn, path))
                    elif isinstance(leaf, ast.Name):
                        du.assigns.append((node.lineno, leaf.id, path))
        elif isinstance(node, (ast.Attribute, ast.Name)) and isinstance(
            getattr(node, "ctx", None), ast.Load
        ):
            dn = dotted_name(node)
            if dn:
                du.loads.append((node.lineno, dn, path))

    visit_suites(fn.body, (), sink)
    return du


# ---- torch-value taint ----------------------------------------------------

_TORCH_PREFIXES = ("torch.",)
# torch.* APIs that return HOST values (flags, devices, dtypes, info
# objects, context managers, events and streams) — not tensor sources
_TORCH_HOST_RETURNS = {
    "torch.device", "torch.is_tensor", "torch.is_floating_point",
    "torch.finfo", "torch.iinfo", "torch.get_default_dtype",
    "torch.no_grad", "torch.inference_mode", "torch.enable_grad",
    "torch.Size", "torch.Generator", "torch.manual_seed",
    "torch.from_numpy", "torch.cuda.is_available",
    "torch.cuda.device_count", "torch.cuda.current_device",
    "torch.cuda.get_device_name", "torch.cuda.get_device_properties",
    "torch.cuda.current_stream", "torch.cuda.Event", "torch.cuda.Stream",
    "torch.cuda.stream", "torch.cuda.device", "torch.cuda.synchronize",
    "torch.cuda.memory_allocated", "torch.cuda.max_memory_allocated",
    "torch.load", "torch.save",
}
# converting through these MATERIALIZES on host: the call is the sync
# (host-transfer flags it where it matters), but the NAME bound to the
# result is a host value from then on — not tainted
_HOST_MATERIALIZERS = {
    "np.asarray", "np.array", "numpy.asarray", "numpy.array",
    "float", "int", "bool",
}
_HOST_METHODS = {"item", "tolist", "cpu", "numpy"}
# reading these attributes off a tensor yields host metadata (no sync):
# `n = y.shape[0]` binds a Python int, not a tensor
_STATIC_META_ATTRS = {
    "shape", "ndim", "dtype", "device", "is_cuda", "nbytes", "itemsize",
    "layout", "requires_grad", "is_sparse",
}
# ... and so do these methods (`t.size(0)`, `t.numel()`, `t.dim()`)
_STATIC_META_METHODS = {
    "size", "dim", "numel", "nelement", "ndimension", "stride",
    "element_size", "data_ptr", "is_contiguous", "get_device",
    "storage_offset",
}


def static_meta_node_ids(node: ast.AST) -> set[int]:
    """ids of every sub-node living under a static-metadata read —
    `x.shape[0]`, `y.ndim`, `t.size(1)`, `len(x)` — taint walks skip
    these: the value is host metadata even when the base is a tensor."""
    meta: set[int] = set()
    for sub in ast.walk(node):
        if id(sub) in meta:
            continue
        is_meta_attr = (
            isinstance(sub, ast.Attribute) and sub.attr in _STATIC_META_ATTRS
        )
        is_meta_call = isinstance(sub, ast.Call) and (
            (isinstance(sub.func, ast.Name) and sub.func.id == "len")
            or (
                isinstance(sub.func, ast.Attribute)
                and sub.func.attr in _STATIC_META_METHODS
            )
        )
        if is_meta_attr or is_meta_call:
            meta.update(id(inner) for inner in ast.walk(sub))
    return meta


def tensor_returning_names(index: "ModuleIndex") -> set[str]:
    """Bare names of project defs annotated to return a tensor
    (`-> torch.Tensor`, `-> Tensor`): a call to one taints its binding
    even though the def lives in another module."""
    out: set[str] = set()
    for fi in index.funcs.values():
        ann = getattr(fi.node, "returns", None)
        if ann is not None and any(
            (dotted_name(sub) or "") in ("torch.Tensor", "Tensor")
            for sub in ast.walk(ann)
        ):
            out.add(fi.name)
    return out


_HOST_ANNOTATIONS = {"bool", "int", "float", "str", "None"}


def host_returning_names(index: "ModuleIndex") -> set[str]:
    """Bare names of project defs annotated to return a plain host value
    (`-> bool`, `-> int`, `-> float`, `-> str`, `-> None`): the result of
    a call to one is a host value even when its arguments are tensors
    (the read, if any, happens inside and is flagged there)."""
    out: set[str] = set()
    for fi in index.funcs.values():
        ann = getattr(fi.node, "returns", None)
        if isinstance(ann, ast.Constant) and ann.value is None:
            out.add(fi.name)
        elif isinstance(ann, ast.Name) and ann.id in _HOST_ANNOTATIONS:
            out.add(fi.name)
    return out


def _is_host_materializer(value: ast.AST) -> bool:
    if not isinstance(value, ast.Call):
        return False
    if dotted_name(value.func) in _HOST_MATERIALIZERS:
        return True
    return (
        isinstance(value.func, ast.Attribute)
        and value.func.attr in _HOST_METHODS
    )


def host_call_node_ids(node: ast.AST, host_fns: set[str]) -> set[int]:
    """ids of every sub-node under a call to a host-returning project
    function (`host_returning_names`): taint walks skip these."""
    skip: set[int] = set()
    for sub in ast.walk(node):
        if id(sub) in skip or not isinstance(sub, ast.Call):
            continue
        dn = dotted_name(sub.func) or ""
        if dn and dn.rsplit(".", 1)[-1] in host_fns:
            skip.update(id(inner) for inner in ast.walk(sub))
    return skip


def torch_tainted_names(
    fn: ast.AST,
    extra_sources: set[str] = frozenset(),
    host_fns: set[str] = frozenset(),
    seed: set[str] = frozenset(),
) -> set[str]:
    """Names in `fn`'s scope ever bound to a tensor expression: a call
    into torch.*, a call whose final segment names a project function
    annotated to return a tensor (`extra_sources`), a method or
    attribute chain hanging off an already-tainted name, or a
    tuple-unpack of either. A call to a project function annotated to
    return a host value (`host_fns`) never taints. `seed` names start
    tainted (parameters annotated as tensors). Flow-insensitive by
    design: one binding taints the name for the whole function (a
    rebind-to-host pattern earns an inline waiver)."""
    tainted: set[str] = set(seed)

    def expr_tainted(node: ast.AST) -> bool:
        meta = static_meta_node_ids(node) | host_call_node_ids(
            node, host_fns
        )
        for sub in ast.walk(node):
            if id(sub) in meta:
                continue
            if isinstance(sub, ast.Call):
                dn = dotted_name(sub.func) or ""
                if dn in _TORCH_HOST_RETURNS:
                    continue
                if dn.startswith(_TORCH_PREFIXES):
                    return True
                base = dn.split(".")[0]
                if base in tainted:
                    return True
                if dn.rsplit(".", 1)[-1] in extra_sources:
                    return True
            elif isinstance(sub, ast.Name) and isinstance(
                sub.ctx, ast.Load
            ):
                if sub.id in tainted:
                    return True
        return False

    changed = True
    while changed:
        changed = False
        for node in shallow_walk(fn):
            if not isinstance(
                node, (ast.Assign, ast.AugAssign, ast.AnnAssign)
            ):
                continue
            value = node.value
            if value is None or not expr_tainted(value):
                continue
            if _is_host_materializer(value):
                continue  # x = t.item(): x is a host value now
            targets = (
                node.targets
                if isinstance(node, ast.Assign)
                else [node.target]
            )
            for t in targets:
                # only PLAIN name bindings (tuple unpack included) taint:
                # `self._x = torch...` stores through an attribute — the
                # base object is not itself a tensor
                leaves = (
                    t.elts if isinstance(t, (ast.Tuple, ast.List)) else [t]
                )
                for leaf in leaves:
                    if isinstance(leaf, ast.Name) and leaf.id not in tainted:
                        tainted.add(leaf.id)
                        changed = True
    return tainted


# ---- lockset walker -------------------------------------------------------

_LOCK_CTORS = {"Lock", "RLock", "Condition", "Semaphore"}
_MUTATORS = {
    "append", "extend", "insert", "pop", "popitem", "clear", "update",
    "add", "discard", "remove", "setdefault", "appendleft", "popleft",
    "move_to_end",
}


@dataclass
class LockFacts:
    """Per-class lockset facts: which self attributes hold locks, and —
    per method — every self-attr mutation and every intra-class
    `self.m(...)` call with the LOCAL lockset held at that site."""

    locks: set = field(default_factory=set)
    # method -> [(attr, lineno, frozenset(held locks))]
    mutations: dict = field(default_factory=dict)
    # method -> [(callee method name, lineno, frozenset(held locks))]
    self_calls: dict = field(default_factory=dict)
    methods: dict = field(default_factory=dict)  # name -> ast def


def class_lock_facts(cls: ast.ClassDef) -> LockFacts:
    facts = LockFacts()
    for node in ast.walk(cls):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
            fn = node.value.func
            ctor = fn.attr if isinstance(fn, ast.Attribute) else (
                fn.id if isinstance(fn, ast.Name) else None
            )
            if ctor in _LOCK_CTORS:
                for t in node.targets:
                    if (
                        isinstance(t, ast.Attribute)
                        and isinstance(t.value, ast.Name)
                        and t.value.id == "self"
                    ):
                        facts.locks.add(t.attr)
        elif isinstance(node, ast.With):
            for item in node.items:
                e = item.context_expr
                if (
                    isinstance(e, ast.Attribute)
                    and isinstance(e.value, ast.Name)
                    and e.value.id == "self"
                    and "lock" in e.attr.lower()
                ):
                    facts.locks.add(e.attr)
    if not facts.locks:
        return facts
    for item in cls.body:
        if not isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        facts.methods[item.name] = item
        muts: list = []
        calls: list = []
        _walk_locked(item, facts.locks, frozenset(), muts, calls)
        facts.mutations[item.name] = muts
        facts.self_calls[item.name] = calls
    return facts


def _walk_locked(node, locks, held, muts, calls):
    for child in ast.iter_child_nodes(node):
        child_held = held
        if isinstance(child, ast.With):
            acquired = {
                item.context_expr.attr
                for item in child.items
                if (
                    isinstance(item.context_expr, ast.Attribute)
                    and isinstance(item.context_expr.value, ast.Name)
                    and item.context_expr.value.id == "self"
                    and item.context_expr.attr in locks
                )
            }
            if acquired:
                child_held = held | acquired
        mut = _self_attr_mutation(child)
        if mut is not None:
            muts.append((mut[0], mut[1], child_held))
        if (
            isinstance(child, ast.Call)
            and isinstance(child.func, ast.Attribute)
            and isinstance(child.func.value, ast.Name)
            and child.func.value.id == "self"
        ):
            calls.append((child.func.attr, child.lineno, child_held))
        if not isinstance(child, _FN_DEFS):
            _walk_locked(child, locks, child_held, muts, calls)


def keyed_dict_attr(sub) -> str | None:
    """'key' for a `self.__dict__["key"]` Subscript: the memoized-
    property store IS an assignment to `self.key`, and conflating every
    memo under one `__dict__` attr would couple unrelated caches to
    whichever lock guards one of them."""
    if (
        isinstance(sub, ast.Subscript)
        and isinstance(sub.value, ast.Attribute)
        and sub.value.attr == "__dict__"
        and isinstance(sub.value.value, ast.Name)
        and sub.value.value.id == "self"
        and isinstance(sub.slice, ast.Constant)
        and isinstance(sub.slice.value, str)
    ):
        return sub.slice.value
    return None


def _self_attr_mutation(node) -> tuple[str, int] | None:
    """(attr, lineno) when `node` mutates a self attribute (assignment,
    augmented assignment, subscript store, or a mutating method call)."""
    if isinstance(node, (ast.Assign, ast.AugAssign)):
        targets = (
            node.targets if isinstance(node, ast.Assign) else [node.target]
        )
        for t in targets:
            base = t
            if isinstance(base, ast.Subscript):
                key = keyed_dict_attr(base)
                if key is not None:
                    return key, node.lineno
                base = base.value
            if (
                isinstance(base, ast.Attribute)
                and isinstance(base.value, ast.Name)
                and base.value.id == "self"
            ):
                return base.attr, node.lineno
    elif isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
        if node.func.attr in _MUTATORS:
            owner = node.func.value
            if isinstance(owner, ast.Subscript):
                key = keyed_dict_attr(owner)
                if key is not None:
                    return key, node.lineno
                owner = owner.value
            if (
                isinstance(owner, ast.Attribute)
                and isinstance(owner.value, ast.Name)
                and owner.value.id == "self"
            ):
                return owner.attr, node.lineno
    return None


def method_entry_locksets(facts: LockFacts) -> dict[str, set[frozenset]]:
    """For each method, the set of locksets it can be ENTERED with.

    Entry model: public methods (no leading underscore), `__init__`-like
    dunders, and private methods never called intra-class are entries
    with the empty lockset (anyone may call them lock-free). A private
    helper with at least one intra-class call site inherits ONLY its
    call-site locksets — the discipline the repo's `called only from X,
    which holds the lock` waivers hand-assert today, promoted into the
    analysis. Propagated to a fixpoint through helper chains."""
    called_privately: set[str] = set()
    for calls in facts.self_calls.values():
        for name, _, _ in calls:
            called_privately.add(name)
    contexts: dict[str, set[frozenset]] = {}
    for name in facts.methods:
        # dunders (__enter__) are public protocol entries; name-mangled
        # privates (__flush) are MORE private than a single underscore
        is_dunder = name.startswith("__") and name.endswith("__")
        is_private = name.startswith("_") and not is_dunder
        if not (is_private and name in called_privately):
            contexts[name] = {frozenset()}
        else:
            contexts[name] = set()
    changed = True
    while changed:
        changed = False
        for caller, calls in facts.self_calls.items():
            if caller == "__init__":
                # construction happens-before publication: a lock-free
                # helper call from __init__ cannot race anything
                continue
            for callee, _, held in calls:
                if callee not in contexts:
                    continue
                # iterate the caller's REAL context set: a private helper
                # whose contexts are still empty this pass propagates
                # nothing yet — the fixpoint revisits once they fill.
                # (Defaulting to {frozenset()} here would inject a
                # spurious lock-free entry that monotone growth could
                # never retract, making findings depend on method
                # definition order.)
                for c in contexts.get(caller, ()):
                    ctx = frozenset(c | held)
                    if ctx not in contexts[callee]:
                        contexts[callee].add(ctx)
                        changed = True
    return contexts
