"""Primitive layers: linear, norms, rotary embeddings, gated MLPs, embedding.

Port of the JAX package's ``models/layers.py``.  Layers are plain tensor
functions over parameter dicts shaped as in the JAX package: a dense
weight is (in, out) and ``dense`` computes ``x @ w``, so converting JAX
weights is a copy (``repro_torch.convert.lm_params_from_jax``).  Each
``*_init`` draws from an explicit ``torch.Generator`` on the device the
parameters are made on; the two packages draw different numbers from the
same seed, so tests convert the JAX parameters instead.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def dtype_of(name) -> torch.dtype:
    """torch dtype of a config's dtype name (``"bfloat16"``, ``"float32"``)."""
    return name if isinstance(name, torch.dtype) else getattr(torch, name)


def _normal(gen, shape, device):
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=device)


# -- linear -------------------------------------------------------------------

def dense_init(gen, in_dim: int, out_dim: int, *, bias: bool = False,
               dtype="bfloat16", scale=None, device=None):
    scale = scale if scale is not None else 1.0 / np.sqrt(in_dim)
    p = {"w": (_normal(gen, (in_dim, out_dim), device) * scale).to(
        dtype_of(dtype))}
    if bias:
        p["b"] = torch.zeros((out_dim,), dtype=dtype_of(dtype), device=device)
    return p


def dense(p, x):
    y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


# -- norms --------------------------------------------------------------------

def rmsnorm_init(dim: int, dtype="bfloat16", device=None):
    return {"scale": torch.ones((dim,), dtype=dtype_of(dtype), device=device)}


def rmsnorm(p, x, eps: float = 1e-6):
    dt = x.dtype
    x = x.float()
    var = (x * x).mean(-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * p["scale"].float()).to(dt)


# -- rotary position embeddings -----------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None):
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)


def apply_rope(x, positions, theta: float = 10_000.0):
    """Rotate ``x`` (..., seq, heads, head_dim) by ``positions``.

    ``positions``: integers broadcastable to x.shape[:-2] + (seq,).  The
    split-half convention (GPT-NeoX / Llama); angles in float32.
    """
    freqs = rope_freqs(x.shape[-1], theta, device=x.device)
    angles = positions[..., None].float() * freqs       # (..., s, hd/2)
    cos = torch.cos(angles)[..., None, :]                # (..., s, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# -- MLPs ---------------------------------------------------------------------

def _gelu(x):
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


_ACTS = {"gelu": _gelu, "relu": torch.relu, "silu": F.silu}


def mlp_init(gen, d_model: int, d_ff: int, act: str = "swiglu",
             dtype="bfloat16", device=None):
    p = {"up": dense_init(gen, d_model, d_ff, dtype=dtype, device=device),
         "down": dense_init(gen, d_ff, d_model, dtype=dtype, device=device)}
    if act in ("swiglu", "geglu"):
        p["gate"] = dense_init(gen, d_model, d_ff, dtype=dtype, device=device)
    return p


def mlp(p, x, act: str = "swiglu"):
    if act == "swiglu":
        h = F.silu(dense(p["gate"], x)) * dense(p["up"], x)
    elif act == "geglu":
        h = _gelu(dense(p["gate"], x)) * dense(p["up"], x)
    else:
        h = _ACTS[act](dense(p["up"], x))
    return dense(p["down"], h)


# -- embedding ----------------------------------------------------------------

def embed_init(gen, vocab: int, d_model: int, dtype="bfloat16", device=None):
    return {"w": (_normal(gen, (vocab, d_model), device) * 0.02).to(
        dtype_of(dtype))}


def embed(p, tokens):
    return p["w"][tokens]


def unembed(p, x):
    """Logits through the (possibly tied) embedding."""
    return x @ p["w"].to(x.dtype).T
