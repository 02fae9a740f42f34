"""The kernels' resource budget: what ptxas gave every CUDA kernel, pinned.

`csrc/kernel_budget.json` records, for every `__global__` kernel and
template instantiation of the CUDA sources, its registers, static shared
memory, stack frame, spill stores, spill loads and local memory, as
ptxas reports them (`-Xptxas -v` in ops/_build.NVCC_FLAGS) for sm_90a.
Like the JAX package's collective budget it is an exact pin: a change to
a kernel that moves any of these numbers updates the file in the same
change, and a stale file fails loudly, naming the kernel and the new
numbers. Spill stores, spill loads and local memory must be 0.

Reading the numbers needs nvcc, so it runs on the card's machine:
chip_smoke's `kernel_resources` phase holds a fresh build against the
file, and `python -m kubernetes_scheduler_tpu_torch.analysis
--write-kernel-budget` regenerates it. The CPU-side cuda-kernel family
checks the file's rows against the sources (one row for every kernel and
instantiation, none for a kernel that is gone) without reading any
resources. This module imports neither torch nor the compiled library.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
BUDGET_PATH = _PKG / "csrc" / "kernel_budget.json"
# the per-kernel numbers, in the order the file lists them
FIELDS = (
    "registers", "static_smem_bytes", "stack_frame_bytes",
    "spill_stores_bytes", "spill_loads_bytes", "local_bytes",
)
# numbers that must be 0 for every kernel
MUST_BE_ZERO = ("spill_stores_bytes", "spill_loads_bytes", "local_bytes")

_ENTRY_RE = re.compile(r"Compiling entry function '(\w+)'")
_PROPS_RE = re.compile(r"Function properties for (\w+)")
_FRAME_RE = re.compile(
    r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
    r"(\d+) bytes spill loads"
)
_USED_RE = re.compile(r"Used (\d+) registers")
_SMEM_RE = re.compile(r"(\d+) bytes smem")
_LMEM_RE = re.compile(r"(\d+) bytes lmem")


# ---- demangling ------------------------------------------------------------


def _source_name(mangled: str, pos: int) -> tuple[str, int]:
    m = re.match(r"\d+", mangled[pos:])
    if m is None:
        raise ValueError(f"cannot demangle {mangled!r} at {pos}")
    n = int(m.group())
    start = pos + len(m.group())
    return mangled[start:start + n], start + n


def _template_args(mangled: str, pos: int) -> tuple[list[str], int]:
    """`I L b1 E L i3 E E` -> (["true", "3"], end): literal arguments
    only — the kernels are templated on bools and ints."""
    assert mangled[pos] == "I"
    pos += 1
    args = []
    while mangled[pos] != "E":
        m = re.match(r"L([bijlmst])(n?\d+)E", mangled[pos:])
        if m is None:
            raise ValueError(
                f"cannot demangle template argument of {mangled!r} at {pos}"
            )
        kind, val = m.group(1), m.group(2).replace("n", "-")
        args.append({"0": "false", "1": "true"}[val] if kind == "b" else val)
        pos += len(m.group())
    return args, pos + 1


def demangle(mangled: str) -> str:
    """The kernel's label as the budget file writes it
    (`masked_score_kernel<true>`) from an Itanium-mangled entry name
    (`_ZN12_GLOBAL__N_119masked_score_kernelILb1EEEvPKf...`). The
    anonymous namespace is dropped, a named one kept (`ns::k`); a plain
    `extern "C"` kernel is its own name. Raises on anything else: a
    reading that cannot be parsed fails, it is never guessed."""
    if not mangled.startswith("_Z"):
        return mangled
    pos = 2
    parts: list[str] = []
    args: list[str] | None = None
    if mangled[pos] == "N":
        pos += 1
        while mangled[pos] != "E":
            if mangled[pos] == "I":
                args, pos = _template_args(mangled, pos)
                continue
            name, pos = _source_name(mangled, pos)
            parts.append(name)
    else:
        name, pos = _source_name(mangled, pos)
        parts.append(name)
        if pos < len(mangled) and mangled[pos] == "I":
            args, pos = _template_args(mangled, pos)
    parts = [p for p in parts if not p.startswith("_GLOBAL__N")]
    if not parts:
        raise ValueError(f"cannot demangle {mangled!r}: no name")
    label = "::".join(parts)
    return f"{label}<{', '.join(args)}>" if args is not None else label


# ---- reading ptxas ---------------------------------------------------------


def parse_ptxas(log: str) -> dict[str, dict[str, int]]:
    """kernel label -> {field: int} from the `-Xptxas -v` lines of one
    build. Only entry functions (kernels) are read; a non-inlined device
    function's properties are skipped. Raises when the log names no
    kernel, or a kernel misses its frame or register line."""
    out: dict[str, dict[str, int]] = {}
    entries: set[str] = set(_ENTRY_RE.findall(log))
    current: str | None = None
    for line in log.splitlines():
        m = _ENTRY_RE.search(line) or _PROPS_RE.search(line)
        if m:
            current = m.group(1) if m.group(1) in entries else None
            if current is not None:
                out.setdefault(current, {})
            continue
        if current is None:
            continue
        row = out[current]
        m = _FRAME_RE.search(line)
        if m:
            row["stack_frame_bytes"] = int(m.group(1))
            row["spill_stores_bytes"] = int(m.group(2))
            row["spill_loads_bytes"] = int(m.group(3))
            continue
        m = _USED_RE.search(line)
        if m:
            row["registers"] = int(m.group(1))
            sm = _SMEM_RE.search(line)
            lm = _LMEM_RE.search(line)
            row["static_smem_bytes"] = int(sm.group(1)) if sm else 0
            row["local_bytes"] = int(lm.group(1)) if lm else 0
    if not out:
        raise ValueError("the ptxas log names no kernel (is -Xptxas -v set?)")
    labelled: dict[str, dict[str, int]] = {}
    for mangled, row in out.items():
        missing = [f for f in FIELDS if f not in row]
        if missing:
            raise ValueError(
                f"the ptxas log gives no {', '.join(missing)} for {mangled}"
            )
        label = demangle(mangled)
        if label in labelled:
            raise ValueError(f"two kernels demangle to {label}")
        labelled[label] = {f: row[f] for f in FIELDS}
    return labelled


def nvcc_version(nvcc: str) -> str:
    """The last line of `nvcc --version` (the release and build)."""
    proc = subprocess.run(
        [nvcc, "--version"], capture_output=True, text=True, timeout=60,
        check=True,
    )
    return proc.stdout.strip().splitlines()[-1]


def measure(source: Path | None = None) -> dict:
    """Build `source` (csrc/fused.cu) into a fresh temporary directory,
    so the ptxas log is never the empty log of a reused library, and
    return the budget document it gives. Needs nvcc: raises without it,
    never skips."""
    from kubernetes_scheduler_tpu_torch.ops import _build

    source = Path(source or _build.SOURCE)
    with tempfile.TemporaryDirectory(prefix="kernel_budget_") as tmp:
        _lib, log = _build.build(source, Path(tmp))
    if not log.strip():
        raise RuntimeError(f"nvcc gave no ptxas log building {source}")
    rows = parse_ptxas(log)
    return {
        "nvcc": nvcc_version(_build.nvcc_path()),
        "nvcc_flags": list(_build.NVCC_FLAGS),
        "kernels": [
            {"source": source.name, "kernel": label, **rows[label]}
            for label in sorted(rows)
        ],
    }


# ---- the file --------------------------------------------------------------


def load_budget(path: Path | str = BUDGET_PATH) -> dict:
    with open(path, encoding="utf-8") as f:
        doc = json.load(f)
    if not isinstance(doc, dict) or not isinstance(doc.get("kernels"), list):
        raise ValueError(f"{path}: a kernel budget is {{'kernels': [...]}}")
    return doc


def write_budget(doc: dict, path: Path | str = BUDGET_PATH) -> None:
    """Write `doc` with one kernel row a line, so a diff names the kernel
    that moved."""
    head = {k: v for k, v in doc.items() if k != "kernels"}
    lines = ["{"]
    for k, v in head.items():
        lines.append(f"  {json.dumps(k)}: {json.dumps(v)},")
    lines.append('  "kernels": [')
    rows = [
        "    " + json.dumps(row, separators=(", ", ": "))
        for row in doc["kernels"]
    ]
    lines.append(",\n".join(rows))
    lines.append("  ]")
    lines.append("}")
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")
    os.replace(tmp, path)


def compare(measured: dict, budget: dict) -> list[str]:
    """Every way `measured` (a fresh build's document) breaks `budget`:
    a kernel with spills or local memory, a kernel with no row, a row
    with no kernel, and any register or shared-memory count that differs
    from its row. Empty when the build matches the file exactly."""
    problems: list[str] = []
    if measured.get("nvcc_flags") != budget.get("nvcc_flags"):
        problems.append(
            f"nvcc flags {measured.get('nvcc_flags')} differ from the "
            f"budget's {budget.get('nvcc_flags')}"
        )
    rows = {(r["source"], r["kernel"]): r for r in budget["kernels"]}
    seen = set()
    for row in measured["kernels"]:
        key = (row["source"], row["kernel"])
        seen.add(key)
        nonzero = {f: row[f] for f in MUST_BE_ZERO if row[f]}
        if nonzero:
            problems.append(f"{row['kernel']}: {nonzero} must be 0")
        want = rows.get(key)
        if want is None:
            problems.append(
                f"{row['kernel']} ({row['source']}) has no row in the "
                f"budget: {json.dumps({f: row[f] for f in FIELDS})}"
            )
            continue
        moved = {
            f: (want.get(f), row[f]) for f in FIELDS if want.get(f) != row[f]
        }
        if moved:
            problems.append(
                f"{row['kernel']}: budget differs, (recorded, built) = "
                f"{moved}; if the change is meant, rerun "
                "`python -m kubernetes_scheduler_tpu_torch.analysis "
                "--write-kernel-budget` on the card"
            )
    for key in sorted(set(rows) - seen):
        problems.append(
            f"the budget's row {key[1]} ({key[0]}) names no built kernel"
        )
    if problems and measured.get("nvcc") != budget.get("nvcc"):
        problems.append(
            f"(nvcc is {measured.get('nvcc')!r}; the budget was recorded "
            f"with {budget.get('nvcc')!r})"
        )
    return problems
