"""Lint fixture: the ctypes table of cuda_kernel_clean.cu (never
imported)."""

import ctypes

_P = ctypes.c_void_p
_I = ctypes.c_int
SIGNATURES = {
    # x, out, n, stream
    "fx_sum": [_P] * 2 + [_I] + [_P],
    # x, n, stream
    "fx_scale": [_P, _I, _P],
}
