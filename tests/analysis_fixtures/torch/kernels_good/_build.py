"""Fixture: a compliant kernel build table (parsed, not run)."""
import ctypes

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_STRIDES = ctypes.POINTER(ctypes.c_longlong)
_SIGNATURES = {
    "scale.cu": {
        "rt_scale": [_P, _P, _F, _I, _P],
    },
    "shaped.cu": {
        "rt_shaped": [_P, _P, _I, _STRIDES, _P],
    },
}


def library():
    raise NotImplementedError


def check(err, name):
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}")
