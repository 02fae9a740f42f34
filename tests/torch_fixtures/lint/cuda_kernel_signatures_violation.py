"""Lint fixture: a ctypes table that drifted from cuda_kernel_clean.cu
(never imported)."""

import ctypes

_P = ctypes.c_void_p
_I = ctypes.c_int
SIGNATURES = {
    # x, out, n, stream: the stream argument was dropped
    "fx_sum": [_P] * 2 + [_I],
    # x, n, stream: n passed as a pointer
    "fx_scale": [_P, _P, _P],
    # no such extern "C" function
    "fx_gone": [_P],
}
