"""SPMD replication/collective analysis over the port's per-shard lists.

The counterpart of kubernetes_scheduler_tpu/analysis/spmd.py. The
reference interprets shard_map bodies; the port has none: its sharded
engine (parallel/engine.py) is single-controller, and a sharded value is
a Python LIST with one tensor per shard, joined by the functions of
parallel/mesh.py. Its correctness rests on the same REPLICATION facts —
which lists hold one value copied to every shard (replicated), which
hold the blocks of one global array (sharded), which hold per-shard
values of another kind (varying: local column offsets, shard ids) — and
its bugs are as silent: a psum of a replicated list counts the value D
times, a gather of one stacks D copies for nothing, and `xs[k]` of a
sharded list returned as the answer ships one shard's block as the
global result.

This module is an abstract interpreter on the dataflow core
(analysis/dataflow.py) with the reference's four-point lattice

    replicated < sharded < varying < unknown

over two kinds of value: a per-shard list, state ("L", element state),
and a single value (one tensor or host value), a bare lattice point. A
single replicated value is a global one (on the lead, or host data).
Flow is the reference's: assignments strong-update, `if` arms join,
loops run to a two-pass fixpoint, project-local calls are analyzed
interprocedurally (memoized per argument-state tuple, depth- and
cycle-guarded to unknown). Every function of the linted files is a root
(parameters unknown); a nested def runs after its parent, over the
parent's final bindings.

Seeds:

- replicated lists: the results of `broadcast`, `psum`, `pmax`, `pmin`,
  `all_gather` (and `_replicate`, the engine's broadcast of a PodBatch);
- sharded lists: `shard_snapshot`, `_as_shards`, and comprehensions or
  `zip`s over a sharded list (a comprehension over a per-shard list is a
  per-shard list; one over `mesh.devices` too);
- global values on the lead: `gather_cat`, `reduce_lead`,
  `torch.cat`/`torch.stack` of a per-shard list (`torch.cat(to_lead(...))`),
  and `rep[k]` of a replicated list;
- varying: an `enumerate` index over a per-shard list, and the target of
  `for k in range(...)` when the body indexes a per-shard list with it.

`xs[k]` of a sharded or varying list is a single value marked as one
shard's ("E", state); the mark survives the pure operations that follow
it, so it can be followed into a return.

Checks (rule family `spmd-collective`), twins of the reference's five:

- unbound-axis: an `axes=` (or `node_axes=`) string, or the name given to
  `mesh.axes(...)` / `mesh.blocks(...)`, that no `*_AXIS` module constant
  or `Mesh(devices, shape, axis_names)` in the linted set declares;
- replicated-psum: `psum` of a provably replicated list — every shard
  contributes the same value, so the sum counts it D times;
- replicated-gather: `all_gather` or `gather_cat` of a provably
  replicated list — D identical copies for one collective;
- gather-axis-misuse: a string passed as `dim=` (or the third
  positional) of `gather_cat`: `dim` is the tensor dimension the shards
  are concatenated along, an int; mesh axes are not a gather_cat
  operand;
- shard-as-global (the twin of out-spec-replication): `xs[k]` of a
  provably sharded or varying list flowing into a return, into a field
  of a `...Result(...)`, or into `broadcast` (which declares its operand
  the value every shard holds, as a `P()` out_spec does) — one shard's
  value ships as the global answer.

Everything unresolvable is `unknown`, which never fires a finding.
"""

from __future__ import annotations

import ast

from kubernetes_scheduler_tpu_torch.analysis import dataflow
from kubernetes_scheduler_tpu_torch.analysis.core import (
    Context,
    SourceFile,
    Violation,
    dotted_name,
)

RULE = "spmd-collective"

# ---- the lattice ----------------------------------------------------------

REP = "replicated"
SHD = "sharded"
VAR = "varying"
UNK = "unknown"

_RANK = {REP: 0, SHD: 1, VAR: 2, UNK: 3}

# state encodings: a bare rank string (a single value); ("L", e) a
# per-shard list with element state e; ("E", s) one shard's value of a
# sharded or varying list; ("T", s0, s1, ...) tuples; ("F", (("field", s),
# ...)) keyword-constructed records; ("FN", name, id(def node)) local
# function values


def is_scalar(s) -> bool:
    return isinstance(s, str)


def collapse(s) -> str:
    """Fold a structured state to one lattice point (join of leaves)."""
    if is_scalar(s):
        return s
    tag = s[0]
    if tag == "FN":
        return REP  # a Python function object is host data
    if tag in ("L", "E"):
        return collapse(s[1])
    parts = s[1:] if tag == "T" else tuple(v for _, v in s[1])
    if not parts:
        return REP
    return max((collapse(p) for p in parts), key=lambda x: _RANK[x])


def _is_elem(s) -> bool:
    return not is_scalar(s) and s[0] == "E"


def _is_list(s) -> bool:
    return not is_scalar(s) and s[0] == "L"


def mark(s):
    """The state of one element picked out of a list whose elements are
    `s`: one shard's value where they are sharded or varying."""
    if is_scalar(s):
        return ("E", s) if s in (SHD, VAR) else s
    if s[0] == "T":
        return ("T",) + tuple(mark(p) for p in s[1:])
    if s[0] == "F":
        return ("F", tuple((k, mark(v)) for k, v in s[1]))
    return s


def strip(s):
    """An element stored into a per-shard list is a shard's value, not a
    value picked out of one."""
    if is_scalar(s):
        return s
    if s[0] == "E":
        return s[1]
    if s[0] == "T":
        return ("T",) + tuple(strip(p) for p in s[1:])
    if s[0] == "F":
        return ("F", tuple((k, strip(v)) for k, v in s[1]))
    return s


def join(a, b):
    if a == b:
        return a
    if _is_list(a) and _is_list(b):
        return ("L", join(a[1], b[1]))
    if _is_elem(a) or _is_elem(b):
        r = join(collapse(a), collapse(b))
        return ("E", r) if r in (SHD, VAR) else r
    if is_scalar(a) or is_scalar(b) or _is_list(a) or _is_list(b):
        sa, sb = collapse(a), collapse(b)
        return sa if _RANK[sa] >= _RANK[sb] else sb
    if a[0] == "T" and b[0] == "T" and len(a) == len(b):
        return ("T",) + tuple(join(x, y) for x, y in zip(a[1:], b[1:]))
    if a[0] == "F" and b[0] == "F":
        da, db = dict(a[1]), dict(b[1])
        if set(da) == set(db):
            return ("F", tuple(sorted((k, join(da[k], db[k])) for k in da)))
    return join(collapse(a), collapse(b))


def join_all(states):
    states = list(states)
    if not states:
        return REP
    out = states[0]
    for s in states[1:]:
        out = join(out, s)
    return out


def pure(states):
    """The state of a pure function of `states` (torch math, methods):
    the join of the operands, one shard's value if any operand is."""
    r = join_all([collapse(s) for s in states])
    if r in (SHD, VAR) and any(_is_elem(s) for s in states):
        return ("E", r)
    return r


def _elem_leaves(s, prefix=""):
    """(field, state) of every one-shard leaf of a state."""
    if is_scalar(s) or s[0] in ("L", "FN"):
        return
    if s[0] == "E":
        yield prefix, s[1]
    elif s[0] == "T":
        for i, p in enumerate(s[1:]):
            yield from _elem_leaves(p, prefix or str(i))
    elif s[0] == "F":
        for k, v in s[1]:
            yield from _elem_leaves(v, k)


# ---- collectives and seeds ---------------------------------------------------

# parallel/mesh.py's collectives -> their result kind
_REPLICATED_LIST = {"psum", "pmax", "pmin", "all_gather", "broadcast", "_replicate"}
_GLOBAL = {"gather_cat", "reduce_lead"}
_SHARDED_LIST = {"shard_snapshot", "_as_shards"}
COLLECTIVES = _REPLICATED_LIST | _GLOBAL | {"to_lead"}
# shape-only constructors: the VALUE is fresh data whatever the donor
_SHAPE_ONLY = {"zeros_like", "ones_like", "empty_like", "full_like"}

_MAX_DEPTH = 7


def _tail(name: str | None) -> str | None:
    return name.rsplit(".", 1)[-1] if name else None


# ---- declared mesh axis names ---------------------------------------------


def axis_constants(files: list[SourceFile]) -> dict[str, str]:
    """name -> value of every module-level `*_AXIS` string constant."""
    return {
        k: v for sf in files if sf.path.endswith(".py")
        for k, v in _module_str_consts(sf).items() if k.endswith("_AXIS")
    }


def declared_axis_names(files: list[SourceFile], index: dataflow.ModuleIndex) -> set[str]:
    """Every axis name the linted file set declares: module-level
    `*_AXIS = "name"` string constants plus string literals inside the
    axis-name tuple of a `Mesh(devices, shape, axis_names)` construction."""
    out: set[str] = set()
    for sf in files:
        for node in index.walk(sf):
            if isinstance(node, ast.Assign) and len(node.targets) == 1:
                t = node.targets[0]
                if (
                    isinstance(t, ast.Name)
                    and t.id.endswith("_AXIS")
                    and isinstance(node.value, ast.Constant)
                    and isinstance(node.value.value, str)
                ):
                    out.add(node.value.value)
            elif isinstance(node, ast.Call) and _tail(dotted_name(node.func)) == "Mesh":
                for arg in list(node.args[2:3]) + [
                    kw.value for kw in node.keywords if kw.arg == "axis_names"
                ]:
                    if isinstance(arg, (ast.Tuple, ast.List)):
                        for el in arg.elts:
                            if isinstance(el, ast.Constant) and isinstance(el.value, str):
                                out.add(el.value)
    return out


def _module_str_consts(sf: SourceFile, axis_consts: dict | None = None) -> dict[str, str]:
    """The file's module-level string constants, over `axis_consts` (the
    linted set's `*_AXIS` constants, which a file imports by name)."""
    out: dict[str, str] = dict(axis_consts or {})
    for node in sf.tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            t = node.targets[0]
            if (
                isinstance(t, ast.Name)
                and isinstance(node.value, ast.Constant)
                and isinstance(node.value.value, str)
            ):
                out[t.id] = node.value.value
    return out


def resolve_axis_operand(expr: ast.AST, consts: dict[str, str]):
    """The axis names an axis operand denotes, as a list of strings — or
    None when unresolvable (a runtime `axes` parameter, an import)."""
    if isinstance(expr, ast.Constant) and isinstance(expr.value, str):
        return [expr.value]
    if isinstance(expr, ast.Name) and expr.id in consts:
        return [consts[expr.id]]
    if isinstance(expr, (ast.Tuple, ast.List)):
        names = []
        for el in expr.elts:
            got = resolve_axis_operand(el, consts)
            if got is None:
                return None
            names.extend(got)
        return names
    return None


def _is_str_operand(expr: ast.AST, consts: dict[str, str]) -> bool:
    return (isinstance(expr, ast.Constant) and isinstance(expr.value, str)) or (
        isinstance(expr, ast.Name) and expr.id in consts
    )


# ---- the abstract interpreter ---------------------------------------------


class Analyzer:
    """One lint run's interpreter: shared across roots so helper
    summaries memoize across call sites."""

    def __init__(self, ctx: Context, report, scoped_paths: set[str]):
        self.ctx = ctx
        self.axis_consts = axis_constants(ctx.files)
        self.index = dataflow.get_index(ctx)
        self._report = report            # (sf, lineno, message) sink
        self.scoped_paths = scoped_paths
        self._memo: dict = {}
        self._stack: list = []
        self._fnval_nodes: dict[int, object] = {}
        self._file_funcs: dict[str, list] = {}
        self._enclosing_memo: dict = {}
        self._degraded = False

    def report(self, sf, lineno, message) -> None:
        # findings land in the linted files only: a helper elsewhere
        # analyzed on their behalf reports through its callers
        if sf.path in self.scoped_paths:
            self._report(sf, lineno, message)

    def _fnval(self, name: str, node: ast.AST):
        self._fnval_nodes[id(node)] = node
        return ("FN", name, id(node))

    # -- roots --

    def analyze_file(self, sf: SourceFile) -> None:
        """Every top-level function and method of `sf` as a root, its
        parameters unknown; nested defs after their parents."""
        for node in sf.tree.body:
            defs = [node] if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) else (
                [n for n in node.body if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
                if isinstance(node, ast.ClassDef) else []
            )
            for fn in defs:
                self._run_root(fn, {}, sf)

    def _run_root(self, fn, outer_env, sf) -> None:
        env = dict(outer_env)
        for a in fn.args.posonlyargs + fn.args.args + fn.args.kwonlyargs:
            env[a.arg] = UNK
        for a in (fn.args.vararg, fn.args.kwarg):
            if a is not None:
                env[a.arg] = UNK
        self._stack = []
        self._run_function(fn, env, sf, depth=0)
        for node in ast.walk(fn):
            if node is not fn and isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if self._parent_def(fn, node) is fn:
                    self._run_root(node, env, sf)

    @staticmethod
    def _parent_def(root, target):
        """The innermost def of `root` (root included) that holds `target`."""
        def visit(node, owner):
            for child in ast.iter_child_nodes(node):
                if child is target:
                    return owner
                inner = owner
                if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                    inner = child
                got = visit(child, inner)
                if got is not None:
                    return got
            return None
        return visit(root, root)

    # -- function execution --

    def _run_function(self, fn, env, sf, depth):
        """Execute a function body; returns [(return node, state)]."""
        rets: list = []
        self._exec_suite(fn.body, env, sf, depth, rets)
        for ret, state in rets:
            self._check_result(sf, ret, state, "returns")
        return rets

    def _summary(self, fi, arg_states, depth, kw_states=None):
        """Return-state of a project function under positional
        `arg_states` and keyword `kw_states`, memoized; UNK on recursion
        or depth exhaustion (such summaries are not memoized)."""
        kw_states = kw_states or {}
        key = (
            fi.qname,
            tuple(self._key_of(s) for s in arg_states),
            tuple(sorted((k, self._key_of(v)) for k, v in kw_states.items())),
        )
        if key in self._memo:
            return self._memo[key]
        if depth >= _MAX_DEPTH or fi.qname in self._stack:
            self._degraded = True
            return UNK
        self._stack.append(fi.qname)
        env = self._seed_params(fi.node, fi.cls, arg_states, kw_states)
        was_degraded, self._degraded = self._degraded, False
        rets = self._run_function(fi.node, env, fi.sf, depth + 1)
        self._stack.pop()
        out = join_all([s for _, s in rets]) if rets else REP
        if not self._degraded:
            self._memo[key] = out
        self._degraded = self._degraded or was_degraded
        return out

    @staticmethod
    def _seed_params(fn, cls, arg_states, kw_states):
        """Bind a call's argument states onto a def's parameters; an
        unmatched parameter with a default takes REP (a default is
        evaluated once, in module scope: host data, never a per-shard
        list), one without stays UNK."""
        params = list(fn.args.posonlyargs + fn.args.args)
        if cls is not None and params and params[0].arg == "self":
            params = params[1:]
        env = {p.arg: s for p, s in zip(params, arg_states)}
        defaults = dict(
            zip(
                [p.arg for p in params[len(params) - len(fn.args.defaults):]],
                fn.args.defaults,
            )
        )
        for a, d in zip(fn.args.kwonlyargs, fn.args.kw_defaults):
            if d is not None:
                defaults[a.arg] = d
        declared = {p.arg for p in params + list(fn.args.kwonlyargs)}
        leftover_kw = []
        for name, state in kw_states.items():
            if name in declared:
                env[name] = state
            else:
                leftover_kw.append(state)
        for p in params + list(fn.args.kwonlyargs):
            if p.arg not in env:
                env[p.arg] = REP if p.arg in defaults else UNK
        spill = list(arg_states[len(params):])
        if fn.args.vararg:
            env[fn.args.vararg.arg] = collapse(join_all(spill)) if spill else REP
        if fn.args.kwarg:
            env[fn.args.kwarg.arg] = collapse(join_all(leftover_kw)) if leftover_kw else REP
        return env

    @staticmethod
    def _key_of(s):
        if is_scalar(s):
            return s
        if s[0] == "FN":
            return ("FN", s[1])
        if s[0] in ("L", "E"):
            return (s[0], Analyzer._key_of(s[1]))
        if s[0] == "T":
            return ("T",) + tuple(Analyzer._key_of(x) for x in s[1:])
        return ("F", tuple((k, Analyzer._key_of(v)) for k, v in s[1]))

    # -- the shard-as-global check --

    def _check_result(self, sf, node, state, how) -> None:
        for field, s in _elem_leaves(state):
            where = f" (field `{field}`)" if field else ""
            self.report(
                sf, node.lineno,
                f"{how} one shard's value as the global answer{where}: `xs[k]` of "
                f"a provably {s} per-shard list flows here, so shard k's value "
                "ships as the result — join the shards first (gather_cat, "
                "torch.cat(to_lead(...))) or reduce them (reduce_lead, or "
                "pmax/pmin over values that are equal on every shard)",
            )

    # -- statements --

    def _exec_suite(self, stmts, env, sf, depth, rets):
        for st in stmts:
            if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)):
                env[st.name] = self._fnval(st.name, st)
                continue
            if isinstance(st, ast.Return):
                state = self._eval(st.value, env, sf, depth) if st.value is not None else REP
                rets.append((st, state))
                continue
            if isinstance(st, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
                self._exec_assign(st, env, sf, depth)
                continue
            if isinstance(st, ast.If):
                self._eval(st.test, env, sf, depth)
                e1, e2 = dict(env), dict(env)
                self._exec_suite(st.body, e1, sf, depth, rets)
                self._exec_suite(st.orelse, e2, sf, depth, rets)
                env.clear()
                env.update(self._join_envs(e1, e2))
                continue
            if isinstance(st, (ast.For, ast.AsyncFor, ast.While)):
                if isinstance(st, ast.While):
                    self._eval(st.test, env, sf, depth)
                else:
                    elem = self._iter_elem(st.iter, env, sf, depth, st.target, st.body)[1]
                    self._bind_target(st.target, elem, env)
                # two passes to a (cheap) fixpoint over the loop carry
                for _ in range(2):
                    before = dict(env)
                    self._exec_suite(st.body, env, sf, depth, rets)
                    env.update(self._join_envs(before, env))
                self._exec_suite(st.orelse, env, sf, depth, rets)
                continue
            if isinstance(st, (ast.With, ast.AsyncWith)):
                for item in st.items:
                    self._eval(item.context_expr, env, sf, depth)
                self._exec_suite(st.body, env, sf, depth, rets)
                continue
            if isinstance(st, ast.Try):
                self._exec_suite(st.body, env, sf, depth, rets)
                for h in st.handlers:
                    self._exec_suite(h.body, dict(env), sf, depth, rets)
                self._exec_suite(st.orelse, env, sf, depth, rets)
                self._exec_suite(st.finalbody, env, sf, depth, rets)
                continue
            if isinstance(st, ast.Expr):
                self._eval(st.value, env, sf, depth)
                continue
            if isinstance(st, ast.Raise):
                continue
            for child in ast.iter_child_nodes(st):
                if isinstance(child, ast.expr):
                    self._eval(child, env, sf, depth)

    @staticmethod
    def _join_envs(e1, e2):
        out = {}
        for k in set(e1) | set(e2):
            if k in e1 and k in e2:
                out[k] = join(e1[k], e2[k])
            else:
                out[k] = e1.get(k, e2.get(k))
        return out

    def _exec_assign(self, st, env, sf, depth):
        value = st.value
        if value is None:
            return
        state = self._eval(value, env, sf, depth)
        if isinstance(st, ast.AugAssign):
            if isinstance(st.target, ast.Name):
                env[st.target.id] = join(env.get(st.target.id, REP), state)
            return
        targets = st.targets if isinstance(st, ast.Assign) else [st.target]
        for t in targets:
            if isinstance(t, ast.Subscript):
                self._store_into(t.value, state, env)
            else:
                self._bind_target(t, state, env)

    def _store_into(self, base: ast.AST, state, env) -> None:
        """`name[i] = v` (and an in-place method on `name` or `name[i]`):
        a per-shard list takes v as one more shard's value; a single value
        joins it."""
        if isinstance(base, ast.Subscript):
            base = base.value
        if not isinstance(base, ast.Name) or base.id not in env:
            return
        old = env[base.id]
        if _is_list(old):
            env[base.id] = ("L", join(old[1], strip(state)))
        elif not is_scalar(old) and old[0] == "T":
            env[base.id] = ("L", join(collapse(old), strip(state)))
        else:
            env[base.id] = join(old, state)

    def _bind_target(self, target, state, env):
        if isinstance(target, ast.Name):
            env[target.id] = state
        elif isinstance(target, (ast.Tuple, ast.List)):
            elts = target.elts
            if not is_scalar(state) and state[0] == "T" and len(state) - 1 == len(elts):
                for el, s in zip(elts, state[1:]):
                    self._bind_target(el, s, env)
            else:
                flat = collapse(state)
                if _is_elem(state):
                    flat = state
                for el in elts:
                    self._bind_target(el, flat, env)
        elif isinstance(target, ast.Starred):
            self._bind_target(target.value, collapse(state), env)

    # -- iteration --

    def _iter_elem(self, node, env, sf, depth, target=None, body=()):
        """(per_shard, element state) of iterating `node`: a per-shard
        list, a zip or enumerate over one, or `mesh.devices` iterates per
        shard; `range(...)` yields host ints, or shard indices (varying)
        when `body` indexes a per-shard list with the loop target."""
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name):
            if node.func.id == "zip" and not node.keywords:
                parts = [self._iter_elem(a, env, sf, depth) for a in node.args]
                return any(p for p, _ in parts), ("T",) + tuple(e for _, e in parts)
            if node.func.id == "enumerate" and node.args:
                per_shard, e = self._iter_elem(node.args[0], env, sf, depth)
                return per_shard, ("T", VAR if per_shard else REP, e)
            if node.func.id == "range":
                for a in node.args:
                    self._eval(a, env, sf, depth)
                shard = isinstance(target, ast.Name) and self._indexes_shards(
                    target.id, body, env
                )
                return False, VAR if shard else REP
        if isinstance(node, ast.Attribute) and node.attr == "devices":
            self._eval(node.value, env, sf, depth)
            return True, REP
        s = self._eval(node, env, sf, depth)
        if _is_list(s):
            return True, s[1]
        if not is_scalar(s) and s[0] == "T":
            return False, join_all(s[1:])
        return False, s if _is_elem(s) else collapse(s)

    @staticmethod
    def _indexes_shards(name: str, body, env) -> bool:
        for stmt in body:
            for node in ast.walk(stmt):
                if (
                    isinstance(node, ast.Subscript)
                    and isinstance(node.slice, ast.Name)
                    and node.slice.id == name
                    and isinstance(node.value, ast.Name)
                    and _is_list(env.get(node.value.id, REP))
                ):
                    return True
        return False

    def _eval_comprehension(self, node, env, sf, depth):
        inner = dict(env)
        per_shard = None
        for gen in node.generators:
            body = [node.elt] if hasattr(node, "elt") else [node.key, node.value]
            is_shard, elem = self._iter_elem(
                gen.iter, inner, sf, depth, gen.target, body + list(gen.ifs)
            )
            if per_shard is None:
                per_shard = is_shard
            self._bind_target(gen.target, elem, inner)
            for cond in gen.ifs:
                self._eval(cond, inner, sf, depth)
        if isinstance(node, ast.DictComp):
            self._eval(node.key, inner, sf, depth)
            return collapse(self._eval(node.value, inner, sf, depth))
        state = self._eval(node.elt, inner, sf, depth)
        if per_shard and isinstance(node, ast.ListComp):
            return ("L", strip(state))
        return collapse(state)

    # -- expressions --

    def _eval(self, node, env, sf, depth):
        if node is None:
            return REP
        if isinstance(node, ast.Constant):
            return REP
        if isinstance(node, ast.Name):
            if node.id in env:
                return env[node.id]
            # module-level names and imports: host config -> replicated;
            # a local def visible by name -> its function value
            cands = [fi for fi in self.index.by_name.get(node.id, ()) if fi.sf is sf]
            if len(cands) == 1:
                return self._fnval(node.id, cands[0].node)
            return REP
        if isinstance(node, ast.Attribute):
            if node.attr in dataflow._STATIC_META_ATTRS:
                self._eval(node.value, env, sf, depth)
                return REP  # shapes and dtypes are host metadata
            base = self._eval(node.value, env, sf, depth)
            if not is_scalar(base) and base[0] == "F":
                d = dict(base[1])
                return d[node.attr] if node.attr in d else pure([base])
            return pure([base])
        if isinstance(node, ast.Subscript):
            base = self._eval(node.value, env, sf, depth)
            idx = self._eval(node.slice, env, sf, depth)
            if _is_list(base):
                return base if isinstance(node.slice, ast.Slice) else mark(base[1])
            if not is_scalar(base) and base[0] == "T":
                if isinstance(node.slice, ast.Constant) and isinstance(node.slice.value, int):
                    i = node.slice.value
                    if -len(base) + 1 <= i < len(base) - 1:
                        return base[1:][i]
                return join_all(base[1:])
            return pure([base, idx])
        if isinstance(node, (ast.Tuple, ast.List)):
            return ("T",) + tuple(self._eval(el, env, sf, depth) for el in node.elts)
        if isinstance(node, ast.Dict):
            return join_all([
                collapse(self._eval(v, env, sf, depth))
                for v in list(node.keys) + list(node.values) if v is not None
            ])
        if isinstance(node, ast.BinOp):
            left = self._eval(node.left, env, sf, depth)
            right = self._eval(node.right, env, sf, depth)
            if isinstance(node.op, ast.Mult) and not is_scalar(left) and left[0] == "T":
                # [x] * d: a list of d copies
                return ("L", strip(join_all(left[1:])))
            return pure([left, right])
        if isinstance(node, ast.BoolOp):
            return pure([self._eval(v, env, sf, depth) for v in node.values])
        if isinstance(node, ast.UnaryOp):
            return pure([self._eval(node.operand, env, sf, depth)])
        if isinstance(node, ast.Compare):
            return pure(
                [self._eval(node.left, env, sf, depth)]
                + [self._eval(c, env, sf, depth) for c in node.comparators]
            )
        if isinstance(node, ast.IfExp):
            self._eval(node.test, env, sf, depth)
            return join(self._eval(node.body, env, sf, depth),
                        self._eval(node.orelse, env, sf, depth))
        if isinstance(node, ast.Call):
            return self._eval_call(node, env, sf, depth)
        if isinstance(node, ast.NamedExpr):
            state = self._eval(node.value, env, sf, depth)
            if isinstance(node.target, ast.Name):
                env[node.target.id] = state
            return state
        if isinstance(node, ast.Starred):
            return self._eval(node.value, env, sf, depth)
        if isinstance(node, (ast.ListComp, ast.SetComp, ast.GeneratorExp, ast.DictComp)):
            return self._eval_comprehension(node, env, sf, depth)
        if isinstance(node, ast.Lambda):
            return self._fnval("<lambda>", node)
        if isinstance(node, ast.Slice):
            return join_all([
                collapse(self._eval(p, env, sf, depth))
                for p in (node.lower, node.upper, node.step) if p is not None
            ])
        if isinstance(node, ast.JoinedStr):
            return REP
        return UNK

    def _eval_call(self, call: ast.Call, env, sf, depth):
        fname = dotted_name(call.func)
        tail = _tail(fname) or (
            call.func.attr if isinstance(call.func, ast.Attribute) else None
        )
        arg_states = [self._eval(a, env, sf, depth) for a in call.args]
        kw_states = [self._eval(kw.value, env, sf, depth) for kw in call.keywords]

        if tail in COLLECTIVES:
            self._check_collective(call, tail, arg_states, sf)
            if tail in _REPLICATED_LIST:
                return ("L", REP)
            if tail in _GLOBAL:
                return REP
            # to_lead: the same shards' values, moved
            s = arg_states[0] if arg_states else UNK
            return s if _is_list(s) else ("L", strip(s))
        if tail in _SHARDED_LIST:
            return ("L", SHD)
        if tail in ("cat", "stack") and fname and fname.startswith("torch."):
            s = arg_states[0] if arg_states else UNK
            if _is_list(s):
                # the shards' values assembled into one array on the lead
                return REP if collapse(s[1]) != UNK else UNK
            return pure(arg_states + kw_states)
        if tail in ("len", "isinstance", "hasattr", "getattr", "type", "id"):
            return REP
        if tail in _SHAPE_ONLY or (
            isinstance(call.func, ast.Attribute)
            and call.func.attr in dataflow._STATIC_META_METHODS
        ):
            return REP

        if isinstance(call.func, ast.Attribute):
            recv_node = call.func.value
            if call.func.attr in ("append", "extend") and isinstance(recv_node, ast.Name):
                v = arg_states[0] if arg_states else REP
                if call.func.attr == "extend":
                    v = v[1] if _is_list(v) else collapse(v)
                old = env.get(recv_node.id, REP)
                if _is_list(old) or (not is_scalar(old) and old[0] == "T"):
                    self._store_into(recv_node, v, env)
                return REP
            if call.func.attr.endswith("_") and not call.func.attr.startswith("_"):
                # an in-place torch method: the receiver takes the result
                recv = self._eval(recv_node, env, sf, depth)
                out = pure([recv] + arg_states + kw_states)
                self._store_into(recv_node, out, env)
                return out

        # project-local resolution through the shared index; keywords
        # bind BY NAME onto the callee's parameters
        fi_caller = self._enclosing_fi(sf, call)
        cands = (
            self.index.resolve_call(fi_caller, call, loose=False)
            if fi_caller is not None else []
        )
        named_kw = {
            kw.arg: s for kw, s in zip(call.keywords, kw_states) if kw.arg is not None
        }
        splat_kw = [s for kw, s in zip(call.keywords, kw_states) if kw.arg is None]
        if cands and all(fi.sf.path in self.scoped_paths for fi in cands):
            summaries = [self._summary(fi, arg_states, depth, named_kw) for fi in cands]
            return join_all(summaries + [collapse(s) for s in splat_kw])
        if cands:
            # engine and ops code outside the linted files computes on one
            # shard's tensors or on global ones and calls no collective: a
            # pure function of its operands
            return pure(arg_states + kw_states)
        fn = self._as_fnval(call.func, env, sf)
        if fn is not None:
            return self._apply_fnval(fn, arg_states, env, sf, depth, named_kw)

        # a NamedTuple-style ctor: a BARE NAME called with keywords only
        if (
            isinstance(call.func, ast.Name)
            and call.keywords and not call.args
            and all(kw.arg is not None for kw in call.keywords)
        ):
            record = ("F", tuple(sorted(
                (kw.arg, s) for kw, s in zip(call.keywords, kw_states)
            )))
            if call.func.id.endswith("Result"):
                self._check_result(sf, call, record, "stores")
            return record
        recv = []
        if isinstance(call.func, ast.Attribute):
            recv = [self._eval(call.func.value, env, sf, depth)]
        return pure(recv + arg_states + kw_states)

    def _enclosing_fi(self, sf, node):
        key = (sf.path, node.lineno)
        if key in self._enclosing_memo:
            return self._enclosing_memo[key]
        funcs = self._file_funcs.get(sf.path)
        if funcs is None:
            funcs = [fi for fi in self.index.funcs.values() if fi.sf is sf]
            self._file_funcs[sf.path] = funcs
        best = None
        for fi in funcs:
            n = fi.node
            if n.lineno <= node.lineno <= (n.end_lineno or n.lineno):
                if best is None or n.lineno > best.node.lineno:
                    best = fi
        self._enclosing_memo[key] = best
        return best

    def _as_fnval(self, expr, env, sf):
        if isinstance(expr, ast.Name):
            v = env.get(expr.id)
            if isinstance(v, tuple) and v and v[0] == "FN":
                return v
            cands = [fi for fi in self.index.by_name.get(expr.id, ()) if fi.sf is sf]
            if len(cands) == 1:
                return self._fnval(expr.id, cands[0].node)
        return None

    def _apply_fnval(self, fn, arg_states, env, sf, depth, kw_states=None):
        node = self._fnval_nodes.get(fn[2])
        if node is None or depth >= _MAX_DEPTH:
            self._degraded = True
            return UNK
        if isinstance(node, ast.Lambda):
            params = [a.arg for a in node.args.posonlyargs + node.args.args]
            inner = dict(env)
            inner.update(dict(zip(params, arg_states)))
            return self._eval(node.body, inner, sf, depth + 1)
        inner = dict(env)  # closure environment; params shadow it
        inner.update(self._seed_params(node, None, arg_states, kw_states or {}))
        rets = self._run_function(node, inner, sf, depth + 1)
        return join_all([s for _, s in rets]) if rets else REP

    # -- the collective checks (replication-dependent half) --

    def _check_collective(self, call, tail, arg_states, sf) -> None:
        operand = arg_states[0] if arg_states else UNK
        if tail == "broadcast":
            # broadcast declares its operand the global value every shard
            # holds: one shard's value there is the out_specs class
            self._check_result(sf, call, operand, "broadcasts")
        replicated = _is_list(operand) and collapse(operand[1]) == REP
        if tail == "psum" and replicated:
            self.report(
                sf, call.lineno,
                "psum of a provably-replicated list double-counts by the mesh "
                "size — every shard contributes the same value; use the value "
                "directly, reduce one shard's contribution, or multiply by "
                "mesh.size explicitly",
            )
        if tail in ("all_gather", "gather_cat") and replicated:
            self.report(
                sf, call.lineno,
                f"{tail} of a provably-replicated list stacks D identical copies "
                "for one collective — use the value directly (every shard "
                "already holds it)",
            )
        if tail == "gather_cat":
            consts = _module_str_consts(sf, self.axis_consts)
            dims = list(call.args[2:3]) + [kw.value for kw in call.keywords if kw.arg == "dim"]
            for d in dims:
                if _is_str_operand(d, consts):
                    self.report(
                        sf, d.lineno,
                        "gather_cat's `dim=` is the tensor dimension the shards "
                        "are concatenated along (an int); a mesh axis name here "
                        "always misindexes the gathered dimension — gather_cat "
                        "joins over every axis of the mesh",
                    )


# ---- context-free axis-name check -----------------------------------------

# call tail -> (positional index, keyword) of its axis-name operand
_AXIS_OPERANDS = {
    "psum": (2, "axes"),
    "pmax": (2, "axes"),
    "axes": (0, "names"),
    "blocks": (0, "names"),
}


def check_axis_names(files, declared: set[str], report, index, axis_consts=None) -> None:
    """Every axis operand that RESOLVES to string names must use names
    some mesh declares — the wrong-axis class. Runtime axis parameters
    are skipped, not guessed."""
    if not declared:
        return
    for sf in files:
        consts = _module_str_consts(sf, axis_consts)
        for node in index.walk(sf):
            if not isinstance(node, ast.Call):
                continue
            tail = _tail(dotted_name(node.func)) or (
                node.func.attr if isinstance(node.func, ast.Attribute) else None
            )
            operands = [kw.value for kw in node.keywords if kw.arg == "node_axes"]
            if tail in _AXIS_OPERANDS and (
                tail not in ("axes", "blocks") or isinstance(node.func, ast.Attribute)
            ):
                pos, key = _AXIS_OPERANDS[tail]
                if len(node.args) > pos:
                    operands.append(node.args[pos])
                operands += [kw.value for kw in node.keywords if kw.arg == key]
            for axis_expr in operands:
                names = resolve_axis_operand(axis_expr, consts)
                for name in names or ():
                    if name not in declared:
                        report(
                            sf, axis_expr.lineno,
                            f"`{tail}` names axis {name!r}, which no mesh in the "
                            f"linted set declares (declared: {sorted(declared)}) — "
                            "an unbound axis raises at run time or reduces over "
                            "the wrong groups",
                        )


# ---- rule entry -----------------------------------------------------------


def check_files(ctx: Context, scoped: list[SourceFile]) -> list[Violation]:
    """The spmd-collective family over `scoped` (deduplicated across the
    many analysis paths that can reach one site)."""
    seen: set = set()
    out: list[Violation] = []
    scoped = [sf for sf in scoped if sf.path.endswith(".py")]

    def report(sf, lineno, message):
        key = (sf.path, lineno, message)
        if key in seen:
            return
        seen.add(key)
        out.append(Violation(RULE, sf.path, lineno, message))

    analyzer = Analyzer(ctx, report, {sf.path for sf in scoped})
    for sf in scoped:
        analyzer.analyze_file(sf)
    check_axis_names(
        scoped, declared_axis_names(ctx.files, analyzer.index), report, analyzer.index,
        analyzer.axis_consts,
    )
    out.sort(key=lambda v: (v.path, v.line))
    return out
