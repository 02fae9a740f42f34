"""wire-schema: wire contracts must match their declared schemas.

Two wire surfaces, one rule family:

gRPC bridge — the hand-written stubs mean no compiler checks that the
Python side's field names still exist in the .proto; a renamed field
would silently serialize nothing (proto3 default) instead of failing.
This rule parses the .proto's message blocks and checks, in every file
that imports a `*_pb2` module:

- keyword arguments of `pb.<Message>(...)` constructors;
- first-level attribute access on variables whose Message type is known
  (parameter annotations `x: pb.Message` and direct `x = pb.Message(...)`
  assignments).

Protobuf runtime API names (CopyFrom, SerializeToString, ...) pass.

Trace journal (trace/schema.py) — the flight recorder's record layout
is declared as a JOURNAL_FIELDS tag table plus a TENSOR_DTYPES pinning
map, and the same schema-drift failure modes apply: a reused tag makes
old journals decode into the wrong field, an unpinned or drifted dtype
makes "bitwise replay parity" silently meaningless. In any file that
declares those tables the rule checks: field tags are unique integer
LITERALS (a computed tag has no stable wire identity), field names are
unique, kinds come from the declared set, every tensor dtype is a
literal from the pinned dtype set (float64 is deliberately absent), and
every dtype key's field prefix is a declared `tensors`-kind field.
"""

from __future__ import annotations

import ast
import os
import re

from kubernetes_scheduler_tpu_torch.analysis import dataflow
from kubernetes_scheduler_tpu_torch.analysis.core import (
    Context,
    SourceFile,
    Violation,
    dotted_name,
)

RULE = "wire-schema"

SCOPE = ("kubernetes_scheduler_tpu_torch/bridge/*.py",)
TRACE_SCOPE = ("kubernetes_scheduler_tpu_torch/trace/*.py",)

# the journal's pinned dtype vocabulary — float64 deliberately absent
# (device parity is float32; a silent f64 leaf would diff every replay)
_PINNED_DTYPES = {"float32", "int32", "int64", "bool", "uint8"}
_JOURNAL_KINDS = {"u64", "f64", "str", "json", "tensors"}

_DEFAULT_PROTO = os.path.join(
    "kubernetes_scheduler_tpu_torch", "bridge", "schedule.proto"
)

_PROTOBUF_API = {
    "CopyFrom", "MergeFrom", "SerializeToString", "FromString",
    "ParseFromString", "HasField", "ClearField", "WhichOneof",
    "ByteSize", "IsInitialized", "DESCRIPTOR", "Clear",
}

_MSG_RE = re.compile(r"^\s*message\s+(\w+)\s*\{", re.M)
_FIELD_RE = re.compile(
    r"^\s*(?:repeated\s+|optional\s+)?"
    r"(map\s*<[^>]+>|[\w.]+)\s+(\w+)\s*=\s*\d+\s*;",
)


def parse_proto_fields(path: str) -> dict[str, dict[str, str]]:
    """message name -> {field name: declared type}, by brace-tracking
    text scan (enough for the proto3 subset this repo uses). The ONE
    proto tokenizer: parse_proto derives its name sets from this, and
    capability_completeness filters HealthReply's bool fields off the
    types."""
    messages: dict[str, dict[str, str]] = {}
    current = None
    depth = 0
    with open(path, encoding="utf-8") as f:
        for raw in f:
            line = raw.split("//", 1)[0]
            m = _MSG_RE.match(line)
            if m and depth == 0:
                current = m.group(1)
                messages[current] = {}
                # count the rest of the line too: `message Empty {}`
                # opens and closes in one line
                depth = line.count("{") - line.count("}")
                if depth <= 0:
                    current = None
                    depth = 0
                continue
            if current is not None:
                if depth == 1:
                    fm = _FIELD_RE.match(line)
                    if fm:
                        messages[current][fm.group(2)] = fm.group(1)
                depth += line.count("{") - line.count("}")
                if depth <= 0:
                    current = None
                    depth = 0
    return messages


def parse_proto(path: str) -> dict[str, set]:
    """message name -> set of field names (parse_proto_fields sans
    types — the shape the wire-schema checks key on)."""
    return {
        msg: set(fields) for msg, fields in parse_proto_fields(path).items()
    }


def _pb_aliases(tree: ast.AST) -> set:
    """Local names bound to a *_pb2 module import."""
    out: set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name.endswith("_pb2"):
                    out.add(a.asname or a.name.split(".")[-1])
        elif isinstance(node, ast.ImportFrom):
            for a in node.names:
                if a.name.endswith("_pb2"):
                    out.add(a.asname or a.name)
    return out


def _proto_for(ctx: Context, sf: SourceFile) -> str | None:
    if ctx.proto_path:
        return ctx.proto_path
    sibling_dir = os.path.dirname(sf.abspath)
    for name in sorted(os.listdir(sibling_dir)):
        if name.endswith(".proto"):
            return os.path.join(sibling_dir, name)
    default = os.path.join(ctx.root, _DEFAULT_PROTO)
    return default if os.path.exists(default) else None


def _message_of(node: ast.AST, aliases: set) -> str | None:
    """Message name when `node` is `pb.<Message>` / `pb.<Message>(...)`."""
    if isinstance(node, ast.Call):
        node = node.func
    name = dotted_name(node)
    if not name:
        return None
    parts = name.split(".")
    if len(parts) == 2 and parts[0] in aliases:
        return parts[1]
    return None


def _const(node) -> object:
    return node.value if isinstance(node, ast.Constant) else _NOT_CONST


_NOT_CONST = object()


def _journal_tables(tree: ast.AST):
    """Top-level JOURNAL_FIELDS / TENSOR_DTYPES assignments, or Nones."""
    fields_node = dtypes_node = None
    for node in getattr(tree, "body", ()):
        if (
            isinstance(node, ast.Assign)
            and len(node.targets) == 1
            and isinstance(node.targets[0], ast.Name)
        ):
            if node.targets[0].id == "JOURNAL_FIELDS":
                fields_node = node.value
            elif node.targets[0].id == "TENSOR_DTYPES":
                dtypes_node = node.value
    return fields_node, dtypes_node


def _check_journal_schema(sf: SourceFile) -> list[Violation]:
    out: list[Violation] = []
    fields_node, dtypes_node = _journal_tables(sf.tree)
    if fields_node is None and dtypes_node is None:
        return out
    tensor_fields: set[str] = set()
    have_fields = fields_node is not None
    if have_fields:
        seen_tags: dict[int, str] = {}
        seen_names: set[str] = set()
        elts = (
            fields_node.elts
            if isinstance(fields_node, (ast.Tuple, ast.List))
            else ()
        )
        for e in elts:
            if not (
                isinstance(e, ast.Call)
                and dotted_name(e.func) in ("Field",)
            ):
                continue
            slots = {"tag": None, "name": None, "kind": None}
            for pos, arg in zip(("tag", "name", "kind"), e.args):
                slots[pos] = arg
            for kw in e.keywords:
                if kw.arg in slots:
                    slots[kw.arg] = kw.value
            tag = _const(slots["tag"]) if slots["tag"] is not None else _NOT_CONST
            name = _const(slots["name"]) if slots["name"] is not None else _NOT_CONST
            kind = _const(slots["kind"]) if slots["kind"] is not None else _NOT_CONST
            if not isinstance(tag, int) or isinstance(tag, bool) or tag <= 0:
                out.append(
                    Violation(
                        RULE, sf.path, e.lineno,
                        "journal field tag must be a positive integer "
                        "LITERAL — tags are wire identity and a computed "
                        "tag has no stable value to keep",
                    )
                )
            elif tag in seen_tags:
                out.append(
                    Violation(
                        RULE, sf.path, e.lineno,
                        f"journal field tag {tag} reused (already "
                        f"`{seen_tags[tag]}`) — reuse makes old journals "
                        "decode into the wrong field",
                    )
                )
            else:
                seen_tags[tag] = name if isinstance(name, str) else "?"
            if isinstance(name, str):
                if name in seen_names:
                    out.append(
                        Violation(
                            RULE, sf.path, e.lineno,
                            f"journal field name `{name}` declared twice",
                        )
                    )
                seen_names.add(name)
                if kind == "tensors":
                    tensor_fields.add(name)
            if not isinstance(kind, str):
                # a computed or missing kind has no stable wire identity
                # — the same drift class as a computed tag
                out.append(
                    Violation(
                        RULE, sf.path, e.lineno,
                        "journal field kind must be a string LITERAL "
                        f"from {sorted(_JOURNAL_KINDS)}",
                    )
                )
            elif kind not in _JOURNAL_KINDS:
                out.append(
                    Violation(
                        RULE, sf.path, e.lineno,
                        f"unknown journal field kind {kind!r}; expected "
                        f"one of {sorted(_JOURNAL_KINDS)}",
                    )
                )
    if dtypes_node is not None and isinstance(dtypes_node, ast.Dict):
        seen_keys: set[str] = set()
        for k, v in zip(dtypes_node.keys, dtypes_node.values):
            key = _const(k) if k is not None else _NOT_CONST
            val = _const(v)
            line = (k or v).lineno
            if not isinstance(key, str):
                out.append(
                    Violation(
                        RULE, sf.path, line,
                        "TENSOR_DTYPES keys must be string literals "
                        "(`<field>.<leaf>`)",
                    )
                )
                continue
            if key in seen_keys:
                out.append(
                    Violation(
                        RULE, sf.path, line,
                        f"TENSOR_DTYPES key `{key}` declared twice",
                    )
                )
            seen_keys.add(key)
            prefix = key.split(".", 1)[0]
            if have_fields and prefix not in tensor_fields:
                out.append(
                    Violation(
                        RULE, sf.path, line,
                        f"TENSOR_DTYPES key `{key}`: `{prefix}` is not a "
                        "declared `tensors`-kind journal field",
                    )
                )
            if not isinstance(val, str) or val not in _PINNED_DTYPES:
                shown = val if val is not _NOT_CONST else "<non-literal>"
                out.append(
                    Violation(
                        RULE, sf.path, v.lineno,
                        f"tensor dtype for `{key}` must be a literal from "
                        f"{sorted(_PINNED_DTYPES)}; got {shown!r} — an "
                        "unpinned dtype makes bitwise replay parity "
                        "unverifiable",
                    )
                )
    return out


def check(ctx: Context) -> list[Violation]:
    out: list[Violation] = []
    for sf in ctx.scoped(TRACE_SCOPE):
        out.extend(_check_journal_schema(sf))
    for sf in ctx.scoped(SCOPE):
        aliases = _pb_aliases(sf.tree)
        if not aliases:
            continue
        proto = _proto_for(ctx, sf)
        if proto is None:
            out.append(
                Violation(
                    RULE, sf.path, 1,
                    "imports a *_pb2 module but no .proto schema found "
                    "to check against",
                )
            )
            continue
        messages = parse_proto(proto)

        # pass 1: constructor kwargs anywhere in the file
        for node in dataflow.get_index(ctx).walk(sf):
            if not isinstance(node, ast.Call):
                continue
            msg = _message_of(node, aliases)
            if msg is None:
                continue
            if msg not in messages:
                out.append(
                    Violation(
                        RULE, sf.path, node.lineno,
                        f"message `{msg}` does not exist in "
                        f"{os.path.basename(proto)}",
                    )
                )
                continue
            for kw in node.keywords:
                if kw.arg and kw.arg not in messages[msg]:
                    out.append(
                        Violation(
                            RULE, sf.path, kw.value.lineno,
                            f"`{msg}` has no field `{kw.arg}` in "
                            f"{os.path.basename(proto)}",
                        )
                    )

        # pass 2: attribute access on vars of known Message type,
        # function by function
        for fn in dataflow.get_index(ctx).walk(sf):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            var_types: dict[str, str] = {}
            for a in fn.args.args + fn.args.kwonlyargs + fn.args.posonlyargs:
                if a.annotation is not None:
                    msg = _message_of(a.annotation, aliases)
                    if msg:
                        var_types[a.arg] = msg
            for node in ast.walk(fn):
                if isinstance(node, ast.Assign) and isinstance(
                    node.value, ast.Call
                ):
                    msg = _message_of(node.value, aliases)
                    if msg:
                        for t in node.targets:
                            if isinstance(t, ast.Name):
                                var_types[t.id] = msg
            if not var_types:
                continue
            for node in ast.walk(fn):
                if not isinstance(node, ast.Attribute):
                    continue
                if not (
                    isinstance(node.value, ast.Name)
                    and node.value.id in var_types
                ):
                    continue
                msg = var_types[node.value.id]
                fields = messages.get(msg)
                if fields is None:
                    continue
                if node.attr in fields or node.attr in _PROTOBUF_API:
                    continue
                out.append(
                    Violation(
                        RULE, sf.path, node.lineno,
                        f"`{node.value.id}.{node.attr}`: `{msg}` has no "
                        f"field `{node.attr}` in {os.path.basename(proto)}",
                    )
                )
    return out
