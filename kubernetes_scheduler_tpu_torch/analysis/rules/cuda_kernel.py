"""cuda-kernel: CUDA kernel hygiene — launch bounds, no host callbacks,
float32 accumulators, static shared memory, the ctypes table and the
kernel budget file.

The twin of the JAX package's pallas-vmem for the hand-written CUDA
kernels (csrc/*.cu) and their ctypes binding (ops/_build.py). A text
scan, so it needs no nvcc and runs with the CPU tests:

- launch bounds: every `__global__` kernel carries `__launch_bounds__`
  — without it ptxas may spend registers a launch of the block size the
  host uses cannot get, and the launch fails on the card only;
- no host callbacks: no `printf` or `assert` in device code (a
  `__global__` or `__device__` body) — each stalls the kernel on a host
  round trip and bloats its registers;
- float32 accumulators: no local of type `half`, `__half`,
  `__nv_bfloat16` (or their 2-wide forms) that is accumulated into
  (`+=`, `-=`, `*=`, `x = x op ...`) — a reduced-precision accumulator
  loses mantissa on long reductions and breaks the bitwise checks
  against the plain versions;
- static shared memory: each kernel's `__shared__` arrays whose sizes
  resolve from `constexpr` constants (and structs of known members) fit
  in the 48 KB a block gets without opting in; a size that does not
  resolve skips the kernel rather than guess. `extern __shared__`
  (dynamic) memory is the host's to size and is not counted;
- the ctypes table: `SIGNATURES` in ops/_build.py (and any explicit
  `lib.<name>.argtypes = [...]`) and the `extern "C"` functions of the
  sources match both ways — the same names, the same arity, and pointer
  against integer in each position. A wrong arity there corrupts the
  call's arguments with no error;
- the budget file: every `__global__` kernel and every template
  instantiation the sources launch has a row in csrc/kernel_budget.json,
  every row names a kernel that exists, and no row records spills or
  local memory. The numbers themselves are read from ptxas on the card
  (analysis/kernel_budget.py); this family never pretends to have read
  them.

Findings in a .cu file are waived with `// graftlint: disable=cuda-kernel
-- <reason>`.
"""

from __future__ import annotations

import ast
import json
import os
import re
from dataclasses import dataclass

from kubernetes_scheduler_tpu_torch.analysis.core import (
    CUDA_SUFFIX,
    Context,
    Violation,
    dotted_name,
)

RULE = "cuda-kernel"

SCOPE = (
    "kubernetes_scheduler_tpu_torch/csrc/*.cu",
    "kubernetes_scheduler_tpu_torch/ops/_build.py",
)
BUDGET_NAME = "kernel_budget.json"

STATIC_SMEM_LIMIT = 48 * 1024   # a block's static shared memory, no opt-in

# bytes of the scalar and vector types a `__shared__` array may hold
_TYPE_BYTES = {
    "char": 1, "signed char": 1, "unsigned char": 1, "bool": 1,
    "int8_t": 1, "uint8_t": 1, "short": 2, "unsigned short": 2,
    "int16_t": 2, "uint16_t": 2, "half": 2, "__half": 2,
    "__nv_bfloat16": 2, "int": 4, "unsigned": 4, "unsigned int": 4,
    "int32_t": 4, "uint32_t": 4, "float": 4, "half2": 4, "__half2": 4,
    "__nv_bfloat162": 4, "long long": 8, "unsigned long long": 8,
    "int64_t": 8, "uint64_t": 8, "double": 8, "float2": 8, "int2": 8,
    "float4": 16, "int4": 16, "uint4": 16,
}
_LOW_PRECISION = ("half", "__half", "__nv_bfloat16", "half2", "__half2",
                  "__nv_bfloat162")
_POINTER_CTYPES = {"c_void_p", "c_char_p", "c_wchar_p", "POINTER"}
_INT_CTYPES = {
    "c_int", "c_uint", "c_long", "c_ulong", "c_longlong", "c_ulonglong",
    "c_int8", "c_uint8", "c_int16", "c_uint16", "c_int32", "c_uint32",
    "c_int64", "c_uint64", "c_size_t", "c_ssize_t", "c_bool", "c_short",
    "c_ushort", "c_char", "c_byte", "c_ubyte",
}
_FLOAT_CTYPES = {"c_float", "c_double"}


# ---- source text -----------------------------------------------------------


def strip_comments(text: str, keep_strings: bool = False) -> str:
    """`text` with comments, and unless `keep_strings` string and char
    literals, blanked to spaces (newlines kept), so offsets and line
    numbers stay the source's."""
    out = list(text)
    i, n = 0, len(text)

    def blank(a, b):
        for k in range(a, b):
            if out[k] != "\n":
                out[k] = " "

    while i < n:
        c = text[i]
        if text.startswith("//", i):
            j = text.find("\n", i)
            j = n if j < 0 else j
            blank(i, j)
            i = j
        elif text.startswith("/*", i):
            j = text.find("*/", i + 2)
            j = n if j < 0 else j + 2
            blank(i, j)
            i = j
        elif c in "\"'":
            j = i + 1
            while j < n and text[j] != c:
                j += 2 if text[j] == "\\" else 1
            if not keep_strings:
                blank(i + 1, min(j, n))
            i = j + 1
        else:
            i += 1
    return "".join(out)


def _line(text: str, pos: int) -> int:
    return text.count("\n", 0, pos) + 1


def _match_brace(text: str, open_pos: int) -> int:
    """Index just past the `}` closing the `{` at open_pos."""
    depth = 0
    for k in range(open_pos, len(text)):
        if text[k] == "{":
            depth += 1
        elif text[k] == "}":
            depth -= 1
            if depth == 0:
                return k + 1
    return len(text)


def _skip_parens(text: str, pos: int) -> int:
    """Index just past the `)` closing the `(` at pos."""
    depth = 0
    for k in range(pos, len(text)):
        if text[k] == "(":
            depth += 1
        elif text[k] == ")":
            depth -= 1
            if depth == 0:
                return k + 1
    return len(text)


@dataclass
class Function:
    """One function definition of a CUDA source: its qualifiers, name,
    template parameters, and the span of its body."""

    kind: str              # "__global__", "__device__" or "host"
    name: str
    line: int
    header: str            # text from the qualifier to the parameters
    body_start: int        # index of `{`
    body_end: int          # index past `}`
    template_params: list  # ["kVec"], [] if none


_TEMPLATE_RE = re.compile(r"template\s*<([^<>]*)>\s*$")
_QUALIFIER_RE = re.compile(r"\b(__global__|__device__)\b")


def _template_params(text: str, pos: int) -> list[str]:
    """Names of the `template <...>` parameters right before pos."""
    m = _TEMPLATE_RE.search(text[max(0, pos - 400):pos])
    if m is None:
        return []
    names = []
    for part in m.group(1).split(","):
        words = re.findall(r"\w+", part.split("=")[0])
        if words:
            names.append(words[-1])
    return names


def functions(text: str) -> list[Function]:
    """Every `__global__` / `__device__` definition in comment-stripped
    `text`, and every templated host function (a launch may instantiate
    a kernel through one)."""
    found: list[Function] = []
    for m in _QUALIFIER_RE.finditer(text):
        fn = _function_at(text, m.start(), m.group(1))
        if fn is not None:
            found.append(fn)
    for m in re.finditer(r"template\s*<[^<>]*>", text):
        after = m.end()
        semi = text.find(";", after)
        brace = text.find("{", after)
        if brace < 0 or (0 <= semi < brace):
            continue
        head = text[after:brace]
        if _QUALIFIER_RE.search(head) or "struct" in head or "class" in head:
            continue
        fn = _function_at(text, after, "host")
        if fn is not None:
            found.append(fn)
    return found


def _function_at(text: str, start: int, kind: str) -> Function | None:
    """The definition whose declaration starts at `start`, or None for a
    declaration with no body (`;` first)."""
    k = start
    name = None
    while k < len(text):
        if text.startswith("__launch_bounds__", k):
            k = _skip_parens(text, text.index("(", k))
            continue
        m = re.compile(r"(\w+)\s*\(").match(text, k)
        if m and m.group(1) not in ("__global__", "__device__", "__host__"):
            name = m.group(1)
            k = _skip_parens(text, m.end() - 1)
            break
        if text[k] in ";{":
            return None
        k += 1
    if name is None:
        return None
    brace = k
    while brace < len(text) and text[brace] not in "{;":
        brace += 1
    if brace >= len(text) or text[brace] == ";":
        return None
    return Function(
        kind, name, _line(text, start), text[start:k], brace,
        _match_brace(text, brace), _template_params(text, start),
    )


# ---- constexpr and struct resolution ---------------------------------------


_CONSTEXPR_RE = re.compile(
    r"constexpr\s+(?:unsigned\s+|signed\s+)?(?:int|long|size_t|unsigned)"
    r"\s+(\w+)\s*=\s*([^;]+);"
)


def _eval_int(expr: str, consts: dict[str, int]) -> int | None:
    """Value of an integer expression over known constants, or None."""
    expr = re.sub(r"(?<=\d)[uUlL]+\b", "", expr.strip())
    try:
        tree = ast.parse(expr, mode="eval")
    except SyntaxError:
        return None

    def ev(node):
        if isinstance(node, ast.Constant) and isinstance(node.value, int):
            return node.value
        if isinstance(node, ast.Name):
            return consts.get(node.id)
        if isinstance(node, ast.BinOp):
            a, b = ev(node.left), ev(node.right)
            if a is None or b is None:
                return None
            if isinstance(node.op, ast.Add):
                return a + b
            if isinstance(node.op, ast.Sub):
                return a - b
            if isinstance(node.op, ast.Mult):
                return a * b
            if isinstance(node.op, (ast.Div, ast.FloorDiv)) and b:
                return a // b
            if isinstance(node.op, ast.LShift):
                return a << b
            return None
        if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
            v = ev(node.operand)
            return None if v is None else -v
        return None

    return ev(tree.body)


def constants(text: str) -> dict[str, int]:
    """Every `constexpr` integer whose value resolves (file-level and
    local alike: the kernels' names are unique in a source)."""
    pending = {m.group(1): m.group(2) for m in _CONSTEXPR_RE.finditer(text)}
    consts: dict[str, int] = {}
    changed = True
    while changed:
        changed = False
        for name, expr in list(pending.items()):
            v = _eval_int(expr, consts)
            if v is not None:
                consts[name] = v
                del pending[name]
                changed = True
    return consts


def _type_bytes(typ: str, structs: dict[str, tuple[int, int]]) -> tuple | None:
    """(size, alignment) of a type name, or None when unknown."""
    typ = " ".join(typ.replace("const", " ").split())
    if typ in _TYPE_BYTES:
        size = _TYPE_BYTES[typ]
        return size, min(size, 16)
    return structs.get(typ)


def struct_sizes(text: str, consts: dict[str, int]) -> dict[str, tuple]:
    """name -> (size, alignment) of every struct whose members resolve."""
    out: dict[str, tuple[int, int]] = {}
    for m in re.finditer(
        r"struct\s+(?:__align__\s*\(\s*(\w+)\s*\)\s*)?(\w+)\s*\{", text
    ):
        body = text[m.end():_match_brace(text, m.end() - 1) - 1]
        align = _eval_int(m.group(1), consts) if m.group(1) else 1
        size, ok = 0, align is not None
        for decl in body.split(";"):
            decl = decl.strip()
            if not decl or not ok:
                continue
            dm = re.match(r"([\w\s]+?)\s+(\w+(?:\s*\[[^\]]*\])*(?:\s*,\s*\w+"
                          r"(?:\s*\[[^\]]*\])*)*)$", decl)
            tb = _type_bytes(dm.group(1), out) if dm else None
            if tb is None:
                ok = False
                continue
            for var in dm.group(2).split(","):
                count = _array_count(var, consts)
                if count is None:
                    ok = False
                    break
                size = -(-size // tb[1]) * tb[1] + tb[0] * count
                align = max(align, tb[1])
        if ok:
            out[m.group(2)] = (-(-size // align) * align, align)
    return out


def _array_count(declarator: str, consts: dict[str, int]) -> int | None:
    count = 1
    for dim in re.findall(r"\[([^\]]*)\]", declarator):
        v = _eval_int(dim, consts)
        if v is None:
            return None
        count *= v
    return count


_SHARED_RE = re.compile(
    r"(extern\s+)?__shared__\s+(?:__align__\s*\(\s*\w+\s*\)\s*|"
    r"alignas\s*\(\s*\w+\s*\)\s*)?([A-Za-z_][\w\s]*?)\s+(\w+)((?:\s*\[[^\]]*\])*)"
    r"\s*;"
)


def static_smem(fn: Function, text: str, consts, structs) -> int | None:
    """Static `__shared__` bytes of a kernel's body, or None when a type
    or a dimension does not resolve."""
    total = 0
    for m in _SHARED_RE.finditer(text, fn.body_start, fn.body_end):
        if m.group(1):
            continue  # extern: dynamic shared memory, sized at launch
        tb = _type_bytes(m.group(2), structs)
        count = _array_count(m.group(4), consts)
        if tb is None or count is None:
            return None
        total = -(-total // tb[1]) * tb[1] + tb[0] * count
    return total


# ---- instantiations --------------------------------------------------------


_LITERAL_RE = re.compile(r"^(true|false|-?\d+[uUlL]*)$")


def _norm_literal(a: str) -> str:
    return re.sub(r"[uUlL]+$", "", a.strip())


def instantiations(text: str, fns: list[Function]) -> dict[str, list[str]]:
    """kernel name -> labels of the instantiations the source launches:
    `k<true>` from literal template arguments, and through a templated
    host function (`launch<true>` whose body launches `k<kVec>`) one
    level of substitution per call chain. A plain kernel is its own
    label."""
    kernels = [f for f in fns if f.kind == "__global__"]

    def enclosing(pos):
        for f in fns:
            if f.body_start <= pos < f.body_end:
                return f
        return None

    def literal_uses(name, depth=0) -> list[list[str]]:
        """Argument lists `name<...>` is used with, resolved to literals."""
        found: list[list[str]] = []
        for m in re.finditer(rf"\b{re.escape(name)}\s*<([^<>;{{}}]*)>", text):
            args = [a.strip() for a in m.group(1).split(",")]
            if all(_LITERAL_RE.match(a) for a in args):
                found.append([_norm_literal(a) for a in args])
                continue
            outer = enclosing(m.start())
            if outer is None or not outer.template_params or depth > 4:
                continue
            for outer_args in literal_uses(outer.name, depth + 1):
                binding = dict(zip(outer.template_params, outer_args))
                sub = [binding.get(a, a) for a in args]
                if all(_LITERAL_RE.match(a) for a in sub):
                    found.append([_norm_literal(a) for a in sub])
        return found

    out: dict[str, list[str]] = {}
    for k in kernels:
        if not k.template_params:
            out[k.name] = [k.name]
            continue
        labels = sorted({
            f"{k.name}<{', '.join(args)}>" for args in literal_uses(k.name)
            if len(args) == len(k.template_params)
        })
        out[k.name] = labels
    return out


# ---- the extern "C" interface and the ctypes table -------------------------


def extern_c_functions(text: str) -> dict[str, tuple[int, list[str]]]:
    """name -> (line, argument kinds) of every function defined in an
    `extern "C"` block or with an `extern "C"` prefix. Kinds are
    "pointer", "int" and "float". `text` keeps its string literals (the
    block is found by its `"C"`), comments stripped."""
    out: dict[str, tuple[int, list[str]]] = {}
    spans = []
    for m in re.finditer(r'extern\s+"C"\s*(\{)?', text):
        if m.group(1):
            spans.append((m.end(), _match_brace(text, m.end() - 1) - 1))
        else:
            end = text.find("{", m.end())
            spans.append((m.end(), _match_brace(text, end) if end >= 0
                          else len(text)))
    for a, b in spans:
        k = a
        while k < b:
            m = re.compile(r"\s*([\w\s\*]+?)\s*\b(\w+)\s*\(").match(text, k)
            if m is None:
                k += 1
                continue
            close = _skip_parens(text, m.end() - 1)
            params = text[m.end():close - 1]
            rest = close
            while rest < b and text[rest] in " \t\n":
                rest += 1
            if rest < b and text[rest] == "{":
                out[m.group(2)] = (
                    _line(text, m.start(2)), _param_kinds(params)
                )
                k = _match_brace(text, rest)
            else:
                k = close
    return out


def _param_kinds(params: str) -> list[str]:
    params = params.strip()
    if not params or params == "void":
        return []
    kinds = []
    for p in params.split(","):
        if "*" in p or "[" in p:
            kinds.append("pointer")
        elif re.search(r"\b(float|double)\b", p):
            kinds.append("float")
        else:
            kinds.append("int")
    return kinds


def _ctype_kind(node: ast.AST, aliases: dict[str, str]) -> str | None:
    name = dotted_name(node.func if isinstance(node, ast.Call) else node)
    if name is None:
        return None
    if name in aliases:
        return aliases[name]
    last = name.rsplit(".", 1)[-1]
    if last in _POINTER_CTYPES:
        return "pointer"
    if last in _INT_CTYPES:
        return "int"
    if last in _FLOAT_CTYPES:
        return "float"
    return None


def _kinds_of(node: ast.AST, aliases) -> list[str] | None:
    """The argument kinds a list expression spells (`[_P] * 6 + [_I]`)."""
    if isinstance(node, (ast.List, ast.Tuple)):
        kinds = [_ctype_kind(e, aliases) for e in node.elts]
        return None if None in kinds else kinds
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
        a, b = _kinds_of(node.left, aliases), _kinds_of(node.right, aliases)
        return None if a is None or b is None else a + b
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Mult):
        for seq, num in ((node.left, node.right), (node.right, node.left)):
            if isinstance(num, ast.Constant) and isinstance(num.value, int):
                k = _kinds_of(seq, aliases)
                return None if k is None else k * num.value
    return None


def ctypes_table(tree: ast.AST) -> dict[str, tuple[int, list[str] | None]]:
    """name -> (line, argument kinds) of the binding's ctypes table: the
    entries of a `SIGNATURES = {...}` dict, and every explicit
    `<lib>.<name>.argtypes = [...]`. Kinds are None where the expression
    does not resolve (reported as such, never guessed)."""
    aliases: dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            t = node.targets[0]
            if isinstance(t, ast.Name):
                kind = _ctype_kind(node.value, {})
                if kind is not None:
                    aliases[t.id] = kind
    out: dict[str, tuple[int, list[str] | None]] = {}
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Assign) and len(node.targets) == 1):
            continue
        t = node.targets[0]
        if (
            isinstance(t, ast.Name) and t.id == "SIGNATURES"
            and isinstance(node.value, ast.Dict)
        ):
            for key, val in zip(node.value.keys, node.value.values):
                if isinstance(key, ast.Constant) and isinstance(key.value, str):
                    out[key.value] = (key.lineno, _kinds_of(val, aliases))
        elif (
            isinstance(t, ast.Attribute) and t.attr == "argtypes"
            and isinstance(t.value, ast.Attribute)
        ):
            out[t.value.attr] = (node.lineno, _kinds_of(node.value, aliases))
    return out


def _has_table(tree: ast.AST) -> bool:
    return any(
        isinstance(n, ast.Assign)
        and any(isinstance(t, ast.Name) and t.id == "SIGNATURES"
                for t in n.targets)
        for n in ast.walk(tree)
    )


# ---- the family ------------------------------------------------------------


def _check_source(sf, text, out: list[Violation]) -> list[Function]:
    fns = functions(text)
    consts = constants(text)
    structs = struct_sizes(text, consts)
    for fn in fns:
        if fn.kind == "host":
            continue
        body = text[fn.body_start:fn.body_end]
        if fn.kind == "__global__" and "__launch_bounds__" not in fn.header:
            out.append(Violation(
                RULE, sf.path, fn.line,
                f"kernel `{fn.name}` has no __launch_bounds__ — ptxas may "
                "give it more registers than a block of the launch's size "
                "can get, and the launch then fails on the card only",
            ))
        for m in re.finditer(r"(?<![\w.])(printf|assert)\s*\(", body):
            out.append(Violation(
                RULE, sf.path, _line(text, fn.body_start + m.start()),
                f"{m.group(1)}() in device code of `{fn.name}` — a host "
                "callback stalls the kernel and costs registers; check on "
                "the host against the plain version instead",
            ))
        for typ in _LOW_PRECISION:
            for m in re.finditer(
                rf"(?<![\w:]){re.escape(typ)}\s+(\w+)\s*(?:=|;|\[)", body
            ):
                var = m.group(1)
                acc = re.search(
                    rf"\b{var}\s*(?:\[[^\]]*\]\s*)?[-+*]=|"
                    rf"\b{var}\s*=\s*[^;]*\b{var}\b",
                    body[m.end():],
                )
                if acc:
                    out.append(Violation(
                        RULE, sf.path, _line(text, fn.body_start + m.start()),
                        f"{typ} accumulator `{var}` in `{fn.name}` — "
                        "accumulate in float32 (a reduced-precision "
                        "accumulator loses mantissa on long reductions)",
                    ))
        if fn.kind == "__global__":
            smem = static_smem(fn, text, consts, structs)
            if smem is not None and smem > STATIC_SMEM_LIMIT:
                out.append(Violation(
                    RULE, sf.path, fn.line,
                    f"kernel `{fn.name}` declares {smem} bytes of static "
                    f"shared memory, over the {STATIC_SMEM_LIMIT} a block "
                    "gets without opting in — the launch fails; move the "
                    "large array to dynamic shared memory",
                ))
    return fns


def _check_budget(sf, text, fns, budget_path, rel_budget,
                  out: list[Violation]) -> None:
    labels = instantiations(text, fns)
    source = os.path.basename(sf.path)
    if not os.path.exists(budget_path):
        out.append(Violation(
            RULE, sf.path, 1,
            f"no {BUDGET_NAME} beside {source}: every kernel needs a "
            "budget row (write it on the card with `python -m "
            "kubernetes_scheduler_tpu_torch.analysis --write-kernel-budget`)",
        ))
        return
    with open(budget_path, encoding="utf-8") as f:
        raw = f.read()
    try:
        doc = json.loads(raw)
        rows = [r for r in doc["kernels"] if r.get("source") == source]
    except (ValueError, KeyError, TypeError, AttributeError) as e:
        out.append(Violation(
            RULE, rel_budget, 1,
            f"{BUDGET_NAME} does not parse as {{'kernels': [...]}}: {e}",
        ))
        return
    raw_lines = raw.splitlines()

    def row_line(label):
        needle = json.dumps(label)
        for i, line in enumerate(raw_lines, start=1):
            if needle in line:
                return i
        return 1

    recorded = {r.get("kernel") for r in rows}
    wanted = set()
    for fn in fns:
        if fn.kind != "__global__":
            continue
        for label in labels.get(fn.name, ()):
            wanted.add(label)
            if label not in recorded:
                out.append(Violation(
                    RULE, sf.path, fn.line,
                    f"kernel `{label}` has no row in {BUDGET_NAME} — its "
                    "registers, shared memory and spills are pinned there "
                    "(rerun --write-kernel-budget on the card)",
                ))
    from kubernetes_scheduler_tpu_torch.analysis.kernel_budget import (
        FIELDS,
        MUST_BE_ZERO,
    )

    for r in rows:
        label = r.get("kernel")
        if label not in wanted:
            out.append(Violation(
                RULE, rel_budget, row_line(label),
                f"{BUDGET_NAME} row `{label}` names no kernel of {source} "
                "— delete it (rerun --write-kernel-budget on the card)",
            ))
            continue
        bad = [f for f in FIELDS if not isinstance(r.get(f), int)]
        if bad:
            out.append(Violation(
                RULE, rel_budget, row_line(label),
                f"{BUDGET_NAME} row `{label}` lacks {', '.join(bad)}",
            ))
        spills = {f: r[f] for f in MUST_BE_ZERO if r.get(f)}
        if spills:
            out.append(Violation(
                RULE, rel_budget, row_line(label),
                f"{BUDGET_NAME} row `{label}` records {spills}: spills and "
                "local memory must be 0",
            ))


def _check_table(binding, table, exported, export_path, out) -> None:
    """The binding's ctypes table against the sources' extern "C"
    functions, both ways: names, arity, and each argument's kind."""
    for name in sorted(set(table) | set(exported)):
        if name not in exported:
            out.append(Violation(
                RULE, binding.path, table[name][0],
                f"ctypes table names `{name}`, which no extern \"C\" "
                "function of the CUDA sources defines",
            ))
            continue
        line, kinds = exported[name]
        if name not in table:
            out.append(Violation(
                RULE, export_path[name], line,
                f"extern \"C\" `{name}` has no entry in the ctypes table "
                f"of {os.path.basename(binding.path)} (SIGNATURES or an "
                "explicit .argtypes)",
            ))
            continue
        tline, tkinds = table[name]
        if tkinds is None:
            out.append(Violation(
                RULE, binding.path, tline,
                f"ctypes entry `{name}` does not resolve to a list of "
                "ctypes types",
            ))
        elif len(tkinds) != len(kinds):
            out.append(Violation(
                RULE, binding.path, tline,
                f"ctypes entry `{name}` has {len(tkinds)} arguments, the "
                f"extern \"C\" definition {len(kinds)} — a wrong arity "
                "corrupts the call's arguments with no error",
            ))
        else:
            for i, (a, b) in enumerate(zip(tkinds, kinds)):
                if a != b:
                    out.append(Violation(
                        RULE, binding.path, tline,
                        f"ctypes entry `{name}` argument {i} is {a}, the "
                        f"extern \"C\" definition's is {b}",
                    ))


def check(ctx: Context) -> list[Violation]:
    out: list[Violation] = []
    scoped = ctx.scoped(SCOPE)
    sources = [sf for sf in scoped if sf.path.endswith(CUDA_SUFFIX)]
    bindings = [
        sf for sf in scoped
        if sf.path.endswith(".py") and _has_table(sf.tree)
    ]
    exported: dict[str, tuple[int, list[str]]] = {}
    export_path: dict[str, str] = {}
    for sf in sources:
        text = strip_comments(sf.source)
        fns = _check_source(sf, text, out)
        budget = os.path.join(os.path.dirname(sf.abspath), BUDGET_NAME)
        rel_budget = os.path.relpath(budget, ctx.root).replace(os.sep, "/")
        _check_budget(sf, text, fns, budget, rel_budget, out)
        # the extern "C" block is found by its "C": literals kept
        for name, entry in extern_c_functions(
            strip_comments(sf.source, keep_strings=True)
        ).items():
            exported[name] = entry
            export_path[name] = sf.path
    if sources:
        for binding in bindings:
            _check_table(
                binding, ctypes_table(binding.tree), exported, export_path, out
            )
    return out
