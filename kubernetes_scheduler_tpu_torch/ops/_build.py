"""Build and bind the hand-written CUDA kernels (csrc/fused.cu).

nvcc compiles the source into a shared library with a plain C interface
at first use, into `_build/` inside the package (listed in .gitignore),
named by a hash of the source and flags so that an edited source is
rebuilt and an unchanged one is reused. The library is loaded with
ctypes: every pointer and the stream pass as c_void_p. Nothing here runs
at import time, so CPU-only processes never look for nvcc.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "fused.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
NVCC_TIMEOUT_S = 600

_BUILD_LOCK = threading.Lock()

_P = ctypes.c_void_p
_I = ctypes.c_int
SIGNATURES = {
    # alpha, beta, pod_ok, target, u, v, node_mask, pod_req, alloc, reqd,
    # aff_pod, aff_node, other, stats, out, p, n, r, n_sel, stream
    "ks_masked_score": [_P] * 15 + [_I] * 4 + [_P],
    # alpha, beta, u, v, node_mask, out, p, n, stream
    "ks_row_stats": [_P] * 6 + [_I] * 2 + [_P],
    # sj, price, active, req, free, bid, has, p, n, r, stream
    "ks_auction_bid": [_P] * 7 + [_I] * 3 + [_P],
    # sj, req, free0, free_after, picks, list_key, list_col, list_cnt,
    # fallbacks, p, n, r, list_len, stream
    "ks_greedy_scan": [_P] * 9 + [_I] * 4 + [_P],
}


def nvcc_path() -> str:
    """nvcc from PATH, else from $CUDA_HOME (default /usr/local/cuda)."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    raise RuntimeError(
        "nvcc not found on PATH or under $CUDA_HOME/bin: the CUDA kernels "
        "are built from csrc/fused.cu at first use and need the CUDA toolkit"
    )


def library_path(source: Path = SOURCE, build_dir: Path = BUILD_DIR) -> Path:
    key = hashlib.sha256(source.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return build_dir / f"libfused_{key.hexdigest()[:16]}.so"


def build(source: Path = SOURCE, build_dir: Path = BUILD_DIR) -> tuple[Path, str]:
    """(library path, compiler log): compile `source` (csrc/fused.cu unless
    another tree's copy is named, as chip_smoke's before/after comparison
    does) unless a library of the same source and flags exists. The log
    (ptxas register and spill counts) is empty when the library was
    reused."""
    with _BUILD_LOCK:
        lib = library_path(source, build_dir)
        if lib.is_file():
            return lib, ""
        build_dir.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
        proc = subprocess.run(
            cmd, capture_output=True, text=True, timeout=NVCC_TIMEOUT_S
        )
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}) building {source}:\n"
                f"{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, lib)
        return lib, proc.stdout + proc.stderr


@functools.cache
def load_library() -> ctypes.CDLL:
    """The built kernel library with argtypes/restype declared (built on
    first call; loaded once per process)."""
    path, _log = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.ks_error_string.argtypes = [ctypes.c_int]
    lib.ks_error_string.restype = ctypes.c_char_p
    return lib


def check_launch(lib: ctypes.CDLL, rc: int, kernel: str) -> None:
    """Raise when a ks_* function reported a CUDA error (a refused launch
    never runs, and a later synchronize would not report it)."""
    if rc != 0:
        msg = lib.ks_error_string(rc).decode(errors="replace")
        raise RuntimeError(f"CUDA kernel {kernel} failed to launch: {msg} ({rc})")
