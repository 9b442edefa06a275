"""Wrapper of the flash-attention CUDA kernel (``csrc/flash_attention.cu``).

The PyTorch counterpart of the JAX package's
``kernels/flash_attention_pallas.py``, with its signature less the TPU
tile sizes.  CPU tensors run the plain version
(:func:`repro_torch.kernels.ref.flash_attention_ref`); CUDA tensors launch
the kernel, or raise: a differentiated call (the kernel has no backward)
raises too.  The kernel reads q, k and v in the JAX layout
through their strides (the head dimension must be unit-stride), so the
TPU wrapper's pads and transposes have no counterpart.  bf16 inputs go
to the tensor-core body, which copies rows in 16-byte pieces: their
batch, sequence and head strides must be multiples of 8 elements and
their data 16-byte aligned.  f32 inputs go to the CUDA-core body, which
takes any strides.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels._common import (check_no_grad, check_tensors,
                                         launched, stream)

#: (dh, dv) = (q and k width, v width) pairs the kernel is instantiated
#: for: the square widths, and deepseek-v3's MLA prefill (q/k 128 + 64
#: RoPE against v 128) and its reduced config's (32 + 16 against 32)
HEAD_DIMS = ((32, 32), (64, 64), (128, 128), (256, 256), (192, 128),
             (48, 32))
_DTYPES = (torch.float32, torch.bfloat16)


def flash_attention(q, k, v, *, causal: bool = True, window=None,
                    scale=None):
    """GQA attention with an online softmax.

    q (B, S, H, dh); k (B, T, K, dh), v (B, T, K, dv) with H = K·G (q
    head h attends KV head h // G), scores scaled by ``scale`` (None:
    1/sqrt(dh)).  Masks: causal ``t <= s``, window ``t > s - window``,
    with q and k positions 0..S-1 and 0..T-1.  Returns (B, S, H, dv) in
    v's dtype.
    """
    name = "flash_attention"
    dev = check_tensors(name, dtypes=_DTYPES, contiguous=False, q=q, k=k,
                        v=v)
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"{name}: q, k and v must be 4-D (B, S, H, d)")
    B, S, H, dh = q.shape
    T, K = k.shape[1], k.shape[2]
    if k.shape[0] != B or v.shape[:3] != k.shape[:3] or k.shape[3] != dh:
        raise ValueError(f"{name}: q {tuple(q.shape)}, k {tuple(k.shape)} "
                         f"and v {tuple(v.shape)} do not match")
    if H % K:
        raise ValueError(f"{name}: {H} query heads over {K} KV heads")
    if window is not None and int(window) < 1:
        raise ValueError(f"{name}: window={window} must be >= 1")
    if dev.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                       scale=scale)
    check_no_grad(name, q, k, v)
    if not q.dtype == k.dtype == v.dtype:
        raise TypeError(f"{name}: q, k and v must share a dtype, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    dv = v.shape[3]
    if (dh, dv) not in HEAD_DIMS:
        raise ValueError(f"{name}: the CUDA kernel takes (dh, dv) in "
                         f"{HEAD_DIMS}, got dh={dh}, dv={dv}")
    for label, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"{name}: {label} must have unit stride along "
                             f"its head dimension")
        if t.dtype == torch.bfloat16 and (
                any(t.stride(i) % 8 for i in range(3) if t.shape[i] > 1)
                or t.data_ptr() % 16):
            raise ValueError(
                f"{name}: bf16 {label} needs batch, sequence and head "
                f"strides that are multiples of 8 elements and 16-byte "
                f"aligned data, got strides {t.stride()[:3]}")
    scale = 1.0 / np.sqrt(dh) if scale is None else float(scale)
    strides = (ctypes.c_longlong * 9)(*(t.stride(i) for t in (q, k, v)
                                        for i in range(3)))
    out = torch.empty((B, S, H, dv), dtype=v.dtype, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.rt_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPES.index(q.dtype), B, S, T, H, K, dh, dv, scale,
            int(causal), 0 if window is None else int(window), strides,
            stream(dev))
    _build.check(err, name)
    launched(name)
    return out
