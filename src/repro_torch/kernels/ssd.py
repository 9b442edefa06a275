"""Wrapper of the SSD intra-chunk CUDA kernel (``csrc/ssd.cu``).

The PyTorch counterpart of the JAX package's ``kernels/ssd_pallas.py``.
CPU tensors run the plain version (:func:`repro_torch.kernels.ref.
ssd_chunk_ref`); CUDA tensors launch the kernel, or raise (a
differentiated call too: the kernel has no backward).  Fake tensors (the
dry run's) take a shape-only route: empty outputs of the kernel's shapes
on their device, and the kernel's work (:func:`ssd_work`) handed to the
step's counters (``roofline/counting.py``).  One launch
computes every (batch, chunk, head) cell: the diagonal-block outputs and
the per-chunk states.  :func:`ssd_plan` and :func:`ssd_blocks` mirror how
the kernel splits that work into blocks.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels._common import (check_no_grad, check_tensors,
                                         is_fake, launched, stream)
from repro_torch.roofline.counting import kernel_work

#: (P, N) = (head_dim, d_state) the kernel is instantiated for: the
#: reduced configs', mamba2's and jamba-v0.1's
SHAPES = ((16, 16), (64, 128), (64, 16))
_DTYPES = (torch.float32, torch.bfloat16)
_HEAD_SET = 4          # kHeads in ssd.cu: heads of one group a block owns
_ROW_TILE = 64         # kRowTile: rows of y a row-tile block owns
_STATE_COLS = 64       # kStateCols: state columns a state block owns
_MAX_GRID_X = 2 ** 31 - 1


def ssd_plan(B: int, c: int, Q: int, H: int, G: int, N: int) -> dict:
    """How the kernel splits one call into blocks: a pure function of the
    shapes.

    A block owns a head set (up to ``_HEAD_SET`` heads of one group; the
    last set of a group is partial when the set size does not divide
    H / G), one (batch, chunk) and one role: a slice of
    ``state_cols`` state columns or a ``_ROW_TILE``-row tile of y.
    """
    R = H // G
    state_cols = min(N, _STATE_COLS)
    plan = dict(head_set=_HEAD_SET, sets_per_group=math.ceil(R / _HEAD_SET),
                state_cols=state_cols, state_blocks=N // state_cols,
                row_tiles=math.ceil(Q / _ROW_TILE))
    plan["sets"] = G * plan["sets_per_group"]
    plan["roles"] = plan["state_blocks"] + plan["row_tiles"]
    plan["blocks"] = plan["roles"] * B * c * plan["sets"]
    return plan


def ssd_blocks(B: int, c: int, Q: int, H: int, G: int, N: int):
    """Every block of the 1-D grid in launch order, as the kernel decodes
    ``blockIdx.x``: (role, slice, batch, chunk, heads).  ``role`` is
    "state" (``slice`` = first state column) or "rows" (``slice`` = first
    row); the state slices come first, then the row tiles from the last,
    the heaviest blocks first."""
    plan = ssd_plan(B, c, Q, H, G, N)
    R, per_group, sets = H // G, plan["sets_per_group"], plan["sets"]
    cells = B * c * sets
    for idx in range(plan["blocks"]):
        role, cell = divmod(idx, cells)
        bc, s = divmod(cell, sets)
        g, k = divmod(s, per_group)
        h0 = g * R + k * _HEAD_SET
        heads = tuple(range(h0, min(h0 + _HEAD_SET, (g + 1) * R)))
        if role < plan["state_blocks"]:
            kind, first = "state", role * plan["state_cols"]
        else:
            kind = "rows"
            first = (plan["row_tiles"] - 1 - (role - plan["state_blocks"])) \
                * _ROW_TILE
        yield kind, first, bc // c, bc % c, heads


def ssd_work(B, c, Q, H, P, G, N, *, bc_itemsize=4) -> tuple:
    """(operations at B and C's type, float32 operations, bytes) of one
    call, over the lower triangle the mask keeps: C.B^T (2N a kept
    entry) once per (batch, chunk, group), since every head of a group
    shares it; the decay (2), M.x (2P) and the state (2PN a row, plus
    the B scale) per head, in float32.  xdt, cs, B and C read once (B
    and C at ``bc_itemsize`` bytes), y and the states written once.
    ``chip_smoke.py``'s bound and the dry run count this."""
    tri = Q * (Q + 1) // 2
    cells = B * c * H
    ops_bc = B * c * G * tri * 2 * N
    ops_f32 = cells * (tri * (2 + 2 * P) + Q * (2 * P * N + N + 1))
    nbytes = (4 * (2 * B * c * Q * H * P + B * c * Q * H + B * c * H * P * N)
              + bc_itemsize * 2 * B * c * Q * G * N)
    return ops_bc, ops_f32, nbytes


def ssd_chunk(xdt, cs, Bm, Cm):
    """Intra-chunk SSD: shapes as in :func:`ref.ssd_chunk_ref`.

    xdt (B,c,Q,H,P), cs (B,c,Q,H), Bm/Cm (B,c,Q,G,N) with H = G·R.
    Returns (y_diag (B,c,Q,H,P), states (B,c,H,P,N)), float32.
    """
    name = "ssd_chunk"
    dev = check_tensors(name, dtypes=_DTYPES, fake=True, xdt=xdt, cs=cs,
                        Bm=Bm, Cm=Cm)
    if xdt.dim() != 5 or cs.dim() != 4 or Bm.dim() != 5:
        raise ValueError(f"{name}: xdt, cs, Bm must be 5-, 4-, 5-D")
    B, c, Q, H, P = xdt.shape
    G, N = Bm.shape[3], Bm.shape[4]
    if (tuple(cs.shape) != (B, c, Q, H) or Bm.shape[:3] != (B, c, Q)
            or Cm.shape != Bm.shape or H % G):
        raise ValueError(f"{name}: xdt {tuple(xdt.shape)}, cs "
                         f"{tuple(cs.shape)}, Bm {tuple(Bm.shape)} and Cm "
                         f"{tuple(Cm.shape)} do not match")
    fake = is_fake(xdt)
    if dev.type == "cpu" and not fake:
        return ref.ssd_chunk_ref(xdt, cs, Bm, Cm)
    check_no_grad(name, xdt, cs, Bm, Cm)
    if xdt.dtype != torch.float32 or cs.dtype != torch.float32:
        raise TypeError(f"{name}: the CUDA kernel takes float32 xdt and cs")
    if Bm.dtype != Cm.dtype:
        raise TypeError(f"{name}: Bm and Cm must share a dtype")
    if (P, N) not in SHAPES:
        raise ValueError(f"{name}: the CUDA kernel takes (P, N) in {SHAPES}, "
                         f"got ({P}, {N})")
    if min(B, c, Q) < 1 or max(B, c) > 65535:
        raise ValueError(f"{name}: B={B}, c={c}, Q={Q} out of range")
    if ssd_plan(B, c, Q, H, G, N)["blocks"] > _MAX_GRID_X:
        raise ValueError(f"{name}: {B}x{c} chunks of {H} heads need more "
                         f"than {_MAX_GRID_X} blocks")
    if fake:
        ops_bc, ops_f32, nbytes = ssd_work(B, c, Q, H, P, G, N,
                                           bc_itemsize=Bm.element_size())
        kernel_work(name, dev, ops_bc + ops_f32, nbytes)
        return (torch.empty((B, c, Q, H, P), dtype=torch.float32, device=dev),
                torch.empty((B, c, H, P, N), dtype=torch.float32, device=dev))
    if any(t.data_ptr() % 16 for t in (xdt, Bm, Cm)):
        raise ValueError(f"{name}: the CUDA kernel copies xdt, Bm and Cm "
                         f"in 16-byte pieces; their data must be 16-byte "
                         f"aligned")
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
