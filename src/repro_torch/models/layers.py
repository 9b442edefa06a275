"""Primitive layers: linear, norms, rotary embeddings, gated MLPs, embedding.

Port of the JAX package's ``models/layers.py``.  Layers are plain tensor
functions over parameter dicts shaped as in the JAX package: a dense
weight is (in, out) and ``dense`` computes ``x @ w``, so converting JAX
weights is a copy (``repro_torch.convert.lm_params_from_jax``).  Each
``*_init`` draws from an explicit ``torch.Generator`` on the device the
parameters are made on; the two packages draw different numbers from the
same seed, so tests convert the JAX parameters instead.

The ``*_tp`` functions are the tensor-parallel forms over the ``model``
ranks of a :class:`repro_torch.models.parallel.Group`: per-rank lists of
parameter slices and activations (``models/parallel.py``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models.parallel import held, work


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


def dense_col(group, ps, xs, n: int, want):
    """A column-parallel dense layer of ``n`` outputs: rank j multiplies
    its slice of ``ps[j]`` (``w`` (d, n_j), optional ``b``) and receives
    the span ``want[j]`` of the outputs (gathered from the ranks that
    computed it where its own slice does not cover it).  A rank whose
    slice is the whole layer and that wants nothing computes nothing."""
    have, ys = [], []
    for j, (p, x, w) in enumerate(zip(ps, xs, want)):
        have.append(held(j, group.size, p["w"].shape[1], n))
        ys.append(None if have[-1] == (0, n) and w is None else dense(p, x))
    return group.redistribute(ys, have, want)


def dense_row(group, ps, hs):
    """A row-parallel dense layer: rank j's product of its rows of
    ``ps[j]["w"]`` with ``hs[j]`` (None: no work), summed over the ranks
    and copied to every rank."""
    return group.all_reduce([None if h is None else dense(p, h)
                             for p, h in zip(ps, hs)])


# -- norms --------------------------------------------------------------------

def rmsnorm_init(dim: int, dtype="bfloat16", device=None):
    return {"scale": torch.ones((dim,), dtype=dtype_of(dtype), device=device)}


def rmsnorm(p, x, eps: float = 1e-6):
    dt = x.dtype
    x = x.float()
    var = (x * x).mean(-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * p["scale"].float()).to(dt)


def layernorm_init(dim: int, dtype="bfloat16", device=None):
    return {"scale": torch.ones((dim,), dtype=dtype_of(dtype), device=device),
            "bias": torch.zeros((dim,), dtype=dtype_of(dtype), device=device)}


def layernorm(p, x, eps: float = 1e-6):
    """LayerNorm in float32 (the biased variance, as ``jnp.var``), cast
    back to the input's dtype."""
    dt = x.dtype
    x = x.float()
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + eps)
    return (x * p["scale"].float() + p["bias"].float()).to(dt)


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


def _mlp_hidden(p, x, act):
    if act == "swiglu":
        return F.silu(dense(p["gate"], x)) * dense(p["up"], x)
    if act == "geglu":
        return _gelu(dense(p["gate"], x)) * dense(p["up"], x)
    return _ACTS[act](dense(p["up"], x))


def mlp(p, x, act: str = "swiglu"):
    return dense(p["down"], _mlp_hidden(p, x, act))


def mlp_tp(group, ps, xs, d_ff: int, act: str = "swiglu"):
    """The MLP over a group's ranks: ``gate``/``up`` column-parallel and
    ``down`` row-parallel over the hidden dim ``d_ff`` (rank j computes
    its block of it); per-rank copies of the output."""
    M = group.size
    hs = [None if work(j, M, p["down"]["w"].shape[0], d_ff) is None
          else _mlp_hidden(p, x, act)
          for j, (p, x) in enumerate(zip(ps, xs))]
    return dense_row(group, [p["down"] for p in ps], hs)


# -- embedding ----------------------------------------------------------------

def embed_init(gen, vocab: int, d_model: int, dtype="bfloat16", device=None):
    return {"w": (_normal(gen, (vocab, d_model), device) * 0.02).to(
        dtype_of(dtype))}


def embed(p, tokens):
    return p["w"][tokens]


def embed_tp(group, ps, tokens, vocab: int):
    """Vocab-parallel lookup: rank j's block of the table gives the rows
    of the ids in its span and 0 for the others, and the group sums
    them (one nonzero term per entry: the plain lookup's values).
    ``tokens``: per-rank copies of the ids."""
    M = group.size
    parts = []
    for j, (p, t) in enumerate(zip(ps, tokens)):
        span = work(j, M, p["w"].shape[0], vocab)
        if span is None or span == (0, vocab):
            parts.append(None if span is None else embed(p, t))
            continue
        inside = (t >= span[0]) & (t < span[1])
        rows = p["w"][torch.where(inside, t - span[0], 0)]
        parts.append(torch.where(inside[..., None], rows,
                                 torch.zeros((), dtype=rows.dtype,
                                             device=rows.device)))
    return group.all_reduce(parts)


def unembed(p, x):
    """Logits through the (possibly tied) embedding."""
    return x @ p["w"].to(x.dtype).T
