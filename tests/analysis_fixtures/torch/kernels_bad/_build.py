"""Fixture: a kernel build table out of step with csrc/ (parsed, not run).

A trailing ``# expect: <rule>`` marks each line the port's lint must flag.
"""
import ctypes

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "bad.cu": {
        "rt_plain": [_P, _P, _I, _P],
        "rt_count": [_P, _P, _I, _P],        # expect: kernel-abi
        "rt_kind": [_P, _I, _P, _I, _P],     # expect: kernel-abi
        "rt_ghost": [_P, _P],                # expect: kernel-abi
        "rt_strides": [_P, _P, _P],          # expect: kernel-abi
    },
}


def library():
    raise NotImplementedError


def check(err, name):
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}")
