"""ctypes bindings for the native host runtime (native/libyoda_host.so).

The reference's host is compiled Go; ours keeps the host hot paths native
too: the scheduling queue, the scalar fallback cycle, and requested-matrix
aggregation run in C++ (native/*.cc), reached from Python without
pybind11 (not in this image) via ctypes over flat numpy buffers.

The library is built on demand with `make -C native` the first time it is
needed; `available()` reports whether a toolchain/library exists so every
caller can fall back to the pure-Python implementations.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading

import numpy as np

log = logging.getLogger("yoda_tpu.native")

_REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
_NATIVE_DIR = os.path.join(_REPO_ROOT, "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "build", "libyoda_host.so")
ABI_VERSION = 4

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_load_failed = False


def _sources_newer_than_lib() -> bool:
    if not os.path.exists(_LIB_PATH):
        return True
    lib_mtime = os.path.getmtime(_LIB_PATH)
    for name in os.listdir(_NATIVE_DIR):
        if name.endswith((".cc", ".h")):
            if os.path.getmtime(os.path.join(_NATIVE_DIR, name)) > lib_mtime:
                return True
    return False


def _build() -> bool:
    try:
        subprocess.run(
            ["make", "-C", _NATIVE_DIR],
            check=True,
            capture_output=True,
            text=True,
            timeout=120,
        )
        return True
    except (subprocess.SubprocessError, OSError) as e:
        out = getattr(e, "stderr", "") or str(e)
        log.warning("native build failed, using pure-Python host paths: %s", out)
        return False


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    u64p = ctypes.POINTER(ctypes.c_uint64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    f32p = ctypes.POINTER(ctypes.c_float)
    i64 = ctypes.c_int64

    lib.yoda_host_abi_version.restype = ctypes.c_int32
    lib.yoda_queue_new.restype = ctypes.c_void_p
    lib.yoda_queue_new.argtypes = [ctypes.c_double, ctypes.c_double]
    lib.yoda_queue_free.argtypes = [ctypes.c_void_p]
    lib.yoda_queue_push.argtypes = [ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int32]
    lib.yoda_queue_requeue_unschedulable.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int32, ctypes.c_double,
    ]
    lib.yoda_queue_mark_scheduled.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.yoda_queue_mark_scheduled_batch.argtypes = [ctypes.c_void_p, u64p, i64]
    lib.yoda_queue_pop_window.restype = i64
    lib.yoda_queue_pop_window.argtypes = [ctypes.c_void_p, ctypes.c_double, u64p, i64]
    lib.yoda_queue_len.restype = i64
    lib.yoda_queue_len.argtypes = [ctypes.c_void_p]

    # Tensor pointers are declared c_void_p so callers can pass the raw
    # integer address (ndarray.ctypes.data): extracting the address is
    # ~2.5x cheaper than building a typed POINTER per call, and on tiny
    # cycles marshaling — not the C++ — is the entire cost.
    vp = ctypes.c_void_p
    lib.yoda_scalar_cycle.restype = i64
    lib.yoda_scalar_cycle.argtypes = [
        i64, i64, i64, vp, vp, vp, vp, vp, ctypes.c_int, vp,
    ]
    lib.yoda_scalar_cycle_buf.restype = i64
    lib.yoda_scalar_cycle_buf.argtypes = [
        i64, i64, i64, vp, vp, vp, vp, vp, vp, ctypes.c_int, vp,
    ]
    lib.yoda_aggregate_requested.argtypes = [i64, i64, i64, vp, vp, vp]
    lib.yoda_native_loop.restype = i64
    lib.yoda_native_loop.argtypes = [
        ctypes.c_void_p, i64, i64, i64, i64, i64, vp, vp, vp, vp, vp, vp,
        ctypes.c_int, ctypes.c_int, ctypes.c_double, ctypes.c_double,
        vp, vp,
    ]
    return lib


def _load() -> ctypes.CDLL | None:
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    with _lock:
        if _lib is not None or _load_failed:
            return _lib
        # YODA_NATIVE_LIB: load an alternate build verbatim (the
        # sanitizer harness points here at build-asan/; no rebuild logic
        # — a stale override should fail its ABI check, not be silently
        # replaced by an unsanitized rebuild)
        override = os.environ.get("YODA_NATIVE_LIB")
        if override:
            try:
                lib = _bind(ctypes.CDLL(override))
            except OSError as e:
                log.warning("could not load YODA_NATIVE_LIB=%s: %s", override, e)
                _load_failed = True
                return None
            if lib.yoda_host_abi_version() != ABI_VERSION:
                log.warning(
                    "YODA_NATIVE_LIB=%s has ABI %d, expected %d",
                    override, lib.yoda_host_abi_version(), ABI_VERSION,
                )
                _load_failed = True
                return None
            _lib = lib
            return _lib
        if _sources_newer_than_lib() and not _build():
            _load_failed = True
            return None
        try:
            lib = _bind(ctypes.CDLL(_LIB_PATH))
        except OSError as e:
            log.warning("could not load %s: %s", _LIB_PATH, e)
            _load_failed = True
            return None
        got = lib.yoda_host_abi_version()
        if got != ABI_VERSION:
            log.warning("native ABI %d != expected %d; rebuilding", got, ABI_VERSION)
            subprocess.run(
                ["make", "-C", _NATIVE_DIR, "clean"],
                capture_output=True,
                timeout=60,
            )
            if not _build():
                _load_failed = True
                return None
            lib = _bind(ctypes.CDLL(_LIB_PATH))
        _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def _f32(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.float32)


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _addr(a: np.ndarray) -> int:
    """Raw buffer address for c_void_p parameters (cheap marshaling)."""
    return a.ctypes.data


class NativeQueue:
    """Priority + backoff queue over opaque uint64 pod handles.

    Callers map handles to Pod objects (host/queue.py's NativeBackedQueue
    does this); `now` is injected for testable clocks.
    """

    def __init__(self, *, initial_backoff: float = 1.0, max_backoff: float = 10.0):
        lib = _load()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        self._q = lib.yoda_queue_new(initial_backoff, max_backoff)

    def push(self, pod: int, priority: int) -> None:
        self._lib.yoda_queue_push(self._q, pod, priority)

    def requeue_unschedulable(self, pod: int, priority: int, now: float) -> None:
        self._lib.yoda_queue_requeue_unschedulable(self._q, pod, priority, now)

    def mark_scheduled(self, pod: int) -> None:
        self._lib.yoda_queue_mark_scheduled(self._q, pod)

    def mark_scheduled_batch(self, pods: np.ndarray) -> None:
        """One foreign call for a whole cycle's binds (uint64 handles)."""
        self._lib.yoda_queue_mark_scheduled_batch(
            self._q, _ptr(pods, ctypes.c_uint64), len(pods)
        )

    def pop_window(self, max_pods: int, now: float) -> np.ndarray:
        out = np.empty(max_pods, dtype=np.uint64)
        n = self._lib.yoda_queue_pop_window(
            self._q, now, _ptr(out, ctypes.c_uint64), max_pods
        )
        return out[:n]

    def __len__(self) -> int:
        return int(self._lib.yoda_queue_len(self._q))

    def __del__(self):
        q = getattr(self, "_q", None)
        if q:
            self._lib.yoda_queue_free(q)
            self._q = None


def scalar_cycle(
    pod_req,
    r_io,
    free_cap,
    disk_io,
    cpu_pct,
    *,
    truncate: bool = True,
) -> tuple[np.ndarray, np.ndarray, int]:
    """Run the native scalar fallback cycle.

    Returns (node_idx [P], free_after [N,R], n_bound). Inputs are any
    array-likes; row order of pod_req is the scheduling (priority) order.
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    pod_req = _f32(pod_req)
    r_io = _f32(r_io)
    free = _f32(free_cap).copy()
    disk_io = _f32(disk_io)
    cpu_pct = _f32(cpu_pct)
    p, r = pod_req.shape
    n = free.shape[0]
    if free.shape != (n, r):
        raise ValueError(f"free_cap shape {free.shape} != ({n}, {r})")
    if r_io.shape != (p,) or disk_io.shape != (n,) or cpu_pct.shape != (n,):
        raise ValueError("inconsistent scalar_cycle input shapes")
    out = np.empty(p, dtype=np.int32)
    bound = lib.yoda_scalar_cycle(
        p, n, r,
        _addr(pod_req), _addr(r_io), _addr(free), _addr(disk_io),
        _addr(cpu_pct), int(truncate), _addr(out),
    )
    return out, free, int(bound)


class ScalarCycler:
    """Prebound scalar cycle for repeated same-shape cluster state.

    Binds every buffer address once; each `run()` is a single foreign
    call into yoda_scalar_cycle_buf with free capacity restored from the
    bound `free` buffer (the input is never mutated). For tiny cycles —
    the adaptive-dispatch scalar regime, e.g. the single-pod BASELINE.md
    config — this removes the per-call marshaling that otherwise costs
    ~10x the C++ cycle itself.

    Change state between runs with `update(...)` (copies into the bound
    buffers) or by writing the array attributes in place
    (``cyc.free[:] = new_free``). The attributes are read-only
    properties: the raw addresses are cached, so rebinding them must be
    impossible — a dropped buffer would leave C++ reading freed memory.
    A new shape means constructing a new cycler.
    """

    __slots__ = (
        "_lib", "_pod_req", "_r_io", "_free", "_disk_io", "_cpu_pct",
        "_free_after", "_node_idx", "_args",
    )

    def __init__(self, pod_req, r_io, free_cap, disk_io, cpu_pct, *,
                 truncate: bool = True):
        lib = _load()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        # always copy: the cached addresses must point at buffers this
        # object owns, never at caller arrays whose lifetime we can't see
        self._pod_req = _f32(pod_req).copy()
        self._r_io = _f32(r_io).copy()
        self._free = _f32(free_cap).copy()
        self._disk_io = _f32(disk_io).copy()
        self._cpu_pct = _f32(cpu_pct).copy()
        p, r = self._pod_req.shape
        n = self._free.shape[0]
        if self._free.shape != (n, r):
            raise ValueError(
                f"free_cap shape {self._free.shape} != ({n}, {r})"
            )
        if (
            self._r_io.shape != (p,)
            or self._disk_io.shape != (n,)
            or self._cpu_pct.shape != (n,)
        ):
            raise ValueError("inconsistent ScalarCycler input shapes")
        self._free_after = np.empty_like(self._free)
        self._node_idx = np.empty(p, dtype=np.int32)
        self._args = (
            p, n, r, _addr(self._pod_req), _addr(self._r_io),
            _addr(self._free), _addr(self._free_after),
            _addr(self._disk_io), _addr(self._cpu_pct), int(truncate),
            _addr(self._node_idx),
        )

    pod_req = property(lambda self: self._pod_req)
    r_io = property(lambda self: self._r_io)
    free = property(lambda self: self._free)
    disk_io = property(lambda self: self._disk_io)
    cpu_pct = property(lambda self: self._cpu_pct)
    free_after = property(lambda self: self._free_after)
    node_idx = property(lambda self: self._node_idx)

    @property
    def shape(self) -> tuple[int, int, int]:
        """(pods, nodes, resources) this cycler is bound to."""
        return tuple(self._args[:3])

    def update(self, *, pod_req=None, r_io=None, free=None, disk_io=None,
               cpu_pct=None) -> None:
        """Copy new state into the bound buffers (shapes must match)."""
        for buf, val in (
            (self._pod_req, pod_req), (self._r_io, r_io),
            (self._free, free), (self._disk_io, disk_io),
            (self._cpu_pct, cpu_pct),
        ):
            if val is not None:
                buf[...] = val

    def run(self) -> int:
        """One cycle; results land in .node_idx / .free_after. Returns
        the number of pods bound."""
        return int(self._lib.yoda_scalar_cycle_buf(*self._args))


class NativeLoop:
    """The fully-native tiny-cycle host loop (native/loop.cc): queue pop
    -> scalar cycle -> bind/requeue, many cycles per foreign call.

    This is the single-pod-regime answer to the ctypes dispatch floor
    (PARITY.md): where ScalarCycler pays one foreign call PER cycle
    (~2us, ~20x the C++ work), this pays one per `run(n_cycles)` batch.
    Decisions are identical to driving the scalar cycle one popped
    window at a time from Python — pinned by tests/test_native.py.

    Pod handles are row indices into the bound [M, R] pod arrays; push
    them with `submit`. The clock is simulated: it starts at 0 and each
    cycle advances dt_per_cycle, so backoff requeues behave
    deterministically.
    """

    __slots__ = (
        "_lib", "_queue", "_pod_req", "_r_io", "_prio", "_free",
        "_disk_io", "_cpu_pct", "_node_idx", "_truncate", "_dt", "_now",
        "_window", "_reset_free",
    )

    def __init__(self, pod_req, r_io, prio, free_cap, disk_io, cpu_pct, *,
                 window: int = 1, truncate: bool = True,
                 initial_backoff: float = 1.0, max_backoff: float = 10.0,
                 dt_per_cycle: float = 1e-6, reset_free: bool = False):
        lib = _load()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        self._pod_req = _f32(pod_req).copy()
        self._r_io = _f32(r_io).copy()
        self._prio = np.ascontiguousarray(prio, dtype=np.int32).copy()
        self._free = _f32(free_cap).copy()
        self._disk_io = _f32(disk_io).copy()
        self._cpu_pct = _f32(cpu_pct).copy()
        m, r = self._pod_req.shape
        n = self._free.shape[0]
        if self._free.shape != (n, r):
            raise ValueError(f"free_cap shape {self._free.shape} != ({n}, {r})")
        if self._r_io.shape != (m,) or self._prio.shape != (m,):
            raise ValueError("inconsistent NativeLoop pod-side shapes")
        if self._disk_io.shape != (n,) or self._cpu_pct.shape != (n,):
            raise ValueError("inconsistent NativeLoop node-side shapes")
        self._node_idx = np.full(m, -1, dtype=np.int32)
        self._truncate = int(truncate)
        # reset_free: every cycle schedules against the original capacity
        # (steady-state cluster regime; see loop.cc)
        self._reset_free = int(reset_free)
        self._dt = float(dt_per_cycle)
        self._now = 0.0
        self._window = int(window)
        self._queue = lib.yoda_queue_new(initial_backoff, max_backoff)

    node_idx = property(lambda self: self._node_idx)
    free = property(lambda self: self._free)

    def __len__(self) -> int:
        return int(self._lib.yoda_queue_len(self._queue))

    def submit(self, handle: int) -> None:
        """Queue pod `handle` (a row of the bound pod arrays)."""
        self._lib.yoda_queue_push(
            self._queue, int(handle), int(self._prio[handle])
        )

    def submit_all(self) -> None:
        for h in range(self._pod_req.shape[0]):
            self.submit(h)

    def run(self, n_cycles: int) -> tuple[int, int]:
        """Run up to n_cycles cycles natively; returns (binds, cycles)."""
        out_cycles = ctypes.c_int64(0)
        bound = self._lib.yoda_native_loop(
            self._queue, int(n_cycles), self._window,
            self._pod_req.shape[0], self._free.shape[0],
            self._free.shape[1],
            _addr(self._pod_req), _addr(self._r_io), _addr(self._prio),
            _addr(self._free), _addr(self._disk_io), _addr(self._cpu_pct),
            self._truncate, self._reset_free, self._now, self._dt,
            _addr(self._node_idx), ctypes.addressof(out_cycles),
        )
        if bound < 0:
            raise RuntimeError("native loop: pod handle out of range")
        cycles = int(out_cycles.value)
        self._now += cycles * self._dt
        return int(bound), cycles

    def reset(self, free_cap=None) -> None:
        """Restore capacity (and clear decisions) for a fresh pass."""
        if free_cap is not None:
            self._free[...] = _f32(free_cap)
        self._node_idx[...] = -1
        self._now = 0.0

    def __del__(self):
        q = getattr(self, "_queue", None)
        if q:
            self._lib.yoda_queue_free(q)
            self._queue = None


def aggregate_requested(pod_node, pod_req, n_nodes: int) -> np.ndarray:
    """Sum running-pod requests into a fresh [n_nodes, R] matrix."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    pod_node = np.ascontiguousarray(pod_node, dtype=np.int32)
    pod_req = _f32(pod_req)
    m, r = pod_req.shape
    if pod_node.shape != (m,):
        raise ValueError("pod_node/pod_req length mismatch")
    out = np.zeros((n_nodes, r), dtype=np.float32)
    lib.yoda_aggregate_requested(
        m, n_nodes, r, _addr(pod_node), _addr(pod_req), _addr(out)
    )
    return out
