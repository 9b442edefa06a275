"""Wrapper of the SSD intra-chunk CUDA kernel (``csrc/ssd.cu``).

The PyTorch counterpart of the JAX package's ``kernels/ssd_pallas.py``.
CPU tensors run the plain version (:func:`repro_torch.kernels.ref.
ssd_chunk_ref`); CUDA tensors launch the kernel, or raise.  One launch
computes every (batch, chunk, head) cell: the diagonal-block outputs and
the per-chunk states.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels._common import check_tensors, launched, stream

#: (P, N) = (head_dim, d_state) the kernel is instantiated for: the
#: reduced configs' and mamba2's
SHAPES = ((16, 16), (64, 128))
_DTYPES = (torch.float32, torch.bfloat16)


def ssd_chunk(xdt, cs, Bm, Cm):
    """Intra-chunk SSD: shapes as in :func:`ref.ssd_chunk_ref`.

    xdt (B,c,Q,H,P), cs (B,c,Q,H), Bm/Cm (B,c,Q,G,N) with H = G·R.
    Returns (y_diag (B,c,Q,H,P), states (B,c,H,P,N)), float32.
    """
    name = "ssd_chunk"
    dev = check_tensors(name, dtypes=_DTYPES, xdt=xdt, cs=cs, Bm=Bm, Cm=Cm)
    if xdt.dim() != 5 or cs.dim() != 4 or Bm.dim() != 5:
        raise ValueError(f"{name}: xdt, cs, Bm must be 5-, 4-, 5-D")
    B, c, Q, H, P = xdt.shape
    G, N = Bm.shape[3], Bm.shape[4]
    if (tuple(cs.shape) != (B, c, Q, H) or Bm.shape[:3] != (B, c, Q)
            or Cm.shape != Bm.shape or H % G):
        raise ValueError(f"{name}: xdt {tuple(xdt.shape)}, cs "
                         f"{tuple(cs.shape)}, Bm {tuple(Bm.shape)} and Cm "
                         f"{tuple(Cm.shape)} do not match")
    if dev.type == "cpu":
        return ref.ssd_chunk_ref(xdt, cs, Bm, Cm)
    if xdt.dtype != torch.float32 or cs.dtype != torch.float32:
        raise TypeError(f"{name}: the CUDA kernel takes float32 xdt and cs")
    if Bm.dtype != Cm.dtype:
        raise TypeError(f"{name}: Bm and Cm must share a dtype")
    if (P, N) not in SHAPES:
        raise ValueError(f"{name}: the CUDA kernel takes (P, N) in {SHAPES}, "
                         f"got ({P}, {N})")
    if min(B, c, Q) < 1 or max(B, c) > 65535:
        raise ValueError(f"{name}: B={B}, c={c}, Q={Q} out of range")
    y = torch.empty((B, c, Q, H, P), dtype=torch.float32, device=dev)
    st = torch.empty((B, c, H, P, N), dtype=torch.float32, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.rt_ssd_chunk(
            xdt.data_ptr(), cs.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
            y.data_ptr(), st.data_ptr(), _DTYPES.index(Bm.dtype), B, c, Q, H,
            G, P, N, stream(dev))
    _build.check(err, name)
    launched(name)
    return y, st
