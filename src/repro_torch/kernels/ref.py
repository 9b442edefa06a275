"""Plain PyTorch versions of the hand-written kernels.

Twins of the oracles in the JAX package's ``kernels/ref.py``: the
semantic ground truth, deliberately naive (the (n, m) affinity and the
(S, T) attention scores are materialized).  A kernel wrapper in
:mod:`repro_torch.kernels.nystrom`, :mod:`~repro_torch.kernels.affinity`,
:mod:`~repro_torch.kernels.flash_attention` or
:mod:`~repro_torch.kernels.ssd` runs these for tensors on the CPU; on the
card they are what each CUDA kernel is held against.
"""

from __future__ import annotations

import numpy as np
import torch

_EPS = 1e-12
NEG_INF = -1e30


def pairwise_sq_dists_ref(x, y):
    """(n, d), (m, d) -> (n, m) squared euclidean distances, f32."""
    x = x.float()
    y = y.float()
    diff = x[:, None, :] - y[None, :, :]
    return (diff * diff).sum(-1)


def rbf_affinity_ref(x, gamma):
    """exp(-gamma * d2) with zero diagonal (spectral-clustering affinity)."""
    a = torch.exp(-gamma * pairwise_sq_dists_ref(x, x))
    return a * (1.0 - torch.eye(x.shape[0], dtype=a.dtype, device=a.device))


def rbf_cross_affinity_ref(x, y, gamma):
    """Rectangular exp(-gamma * d2(x, y)): the Nyström cross-affinity."""
    return torch.exp(-gamma * pairwise_sq_dists_ref(x, y))


def panel_matmul_ref(w, q):
    """The eigensolver's row-panel product: the plain f32 matmul."""
    return w.float() @ q.float()


def _quantized_points_ref(a, affinity_dtype: str):
    """The (de)quantized operand the tile math actually dots.

    Per-row symmetric int8 scales / bf16 rounding: row-wise, so the
    result does not depend on how a kernel partitions rows into tiles.
    ``torch.round`` rounds half to even, like ``jnp.round``.
    """
    a = a.float()
    if affinity_dtype == "f32":
        return a
    if affinity_dtype == "bf16":
        return a.to(torch.bfloat16).float()
    if affinity_dtype == "int8":
        scale = torch.clamp_min(a.abs().amax(-1, keepdim=True) / 127.0, 1e-8)
        return torch.clamp(torch.round(a / scale), -127.0, 127.0) * scale
    raise ValueError(f"unknown affinity_dtype {affinity_dtype!r}")


def quantized_cross_affinity_ref(x, y, gamma, *, affinity_dtype="f32"):
    """Cross-affinity exp(-γ d²) on the quantized points."""
    xq = _quantized_points_ref(x, affinity_dtype)
    yq = _quantized_points_ref(y, affinity_dtype)
    return torch.exp(-gamma * pairwise_sq_dists_ref(xq, yq))


def _masked_c_ref(x, z, gamma, mask, affinity_dtype):
    c = quantized_cross_affinity_ref(x, z, gamma,
                                     affinity_dtype=affinity_dtype)
    if mask is not None:
        c = c * mask.float().reshape(-1)[:, None]
    return c


def nystrom_colsum_ref(x, z, gamma, mask=None, *, affinity_dtype="f32"):
    """col = Σᵢ maskᵢ·C_ij, (m,)."""
    return _masked_c_ref(x, z, gamma, mask, affinity_dtype).sum(0)


def _s_ref(c, u):
    d_hat = c @ u.float().reshape(-1)
    return c * torch.rsqrt(torch.clamp_min(d_hat, _EPS))[:, None]


def nystrom_gram_ref(x, z, gamma, u, w_isqrt, mask=None, *,
                     affinity_dtype="f32"):
    """W⁻¹ᐟ² (SᵀS) W⁻¹ᐟ² with S = C·rsqrt(max(C·u, 1e-12)), (m, m)."""
    s = _s_ref(_masked_c_ref(x, z, gamma, mask, affinity_dtype), u)
    w_isqrt = w_isqrt.float()
    return w_isqrt @ (s.T @ s) @ w_isqrt


def nystrom_extension_ref(x, z, gamma, u, proj, mask=None, *,
                          affinity_dtype="f32"):
    """row_normalize(S @ proj) with a 1e-12 floor, (n, k)."""
    s = _s_ref(_masked_c_ref(x, z, gamma, mask, affinity_dtype), u)
    v = s @ proj.float()
    norm = torch.sqrt((v * v).sum(-1, keepdim=True))
    return v / torch.clamp_min(norm, _EPS)


def attention_ref(q, k, v, *, causal=True, window=None, scale=None):
    """Naive GQA attention.  q: (B,S,H,d), k/v: (B,T,K,dv); out in v's
    dtype."""
    B, S, H, dh = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    scale = scale if scale is not None else 1.0 / np.sqrt(dh)
    qf = q.float().reshape(B, S, K, G, dh)
    s = torch.einsum("bskgd,btkd->bkgst", qf, k.float()) * scale
    qp = torch.arange(S, device=q.device)[:, None]
    kp = torch.arange(T, device=q.device)[None, :]
    mask = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kp <= qp
    if window is not None:
        mask &= kp > qp - window
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", w, v.float())
    return out.reshape(B, S, H, v.shape[-1]).to(v.dtype)


def flash_attention_ref(q, k, v, *, causal=True, window=None, scale=None):
    """The flash-attention kernel's function: naive GQA attention (the
    online-softmax tiling is the kernel's business)."""
    return attention_ref(q, k, v, causal=causal, window=window, scale=scale)


def ssd_chunk_ref(xdt, cs, Bm, Cm):
    """Intra-chunk SSD, what the SSD kernel computes.

    xdt (B,c,Q,H,P) inputs times dt; cs (B,c,Q,H) cumulative dt·A within
    each chunk; Bm/Cm (B,c,Q,G,N) with H = G·R heads.  Returns
    (y_diag (B,c,Q,H,P), states (B,c,H,P,N)), both float32.
    """
    B, c, Q, H, P = xdt.shape
    G, N = Bm.shape[3], Bm.shape[4]
    R = H // G
    x_g = xdt.reshape(B, c, Q, G, R, P).float()
    cs_g = cs.reshape(B, c, Q, G, R).float()
    att = torch.einsum("bcqgn,bclgn->bcgql", Cm.float(), Bm.float())
    diff = cs_g[:, :, :, :, :, None] - torch.movedim(cs_g, 2, -1)[:, :, None]
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                 device=xdt.device))[None, None, :, None,
                                                     None, :]
    ldec = torch.where(mask, torch.exp(diff), torch.zeros_like(diff))
    m = torch.einsum("bcgql,bcqgrl->bcqgrl", att, ldec)
    y_diag = torch.einsum("bcqgrl,bclgrp->bcqgrp", m, x_g)
    decay_last = torch.exp(cs_g[:, :, -1:] - cs_g)
    states = torch.einsum("bcqgn,bcqgr,bcqgrp->bcgrpn", Bm.float(),
                          decay_last, x_g)
    return y_diag.reshape(B, c, Q, H, P), states.reshape(B, c, H, P, N)
