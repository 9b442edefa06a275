"""Mixture-of-Experts FFN with sort-based token-choice dispatch.

Port of the JAX package's ``models/moe.py``: token-choice top-k routing
with renormalized gates, optional always-on shared experts, and the
sort-based (MegaBlocks-style) dispatch:

  1. flatten the top-k assignments and sort them by expert id (stable),
  2. each row's rank within its expert from the sorted ids,
  3. scatter the rows into an (E, C, d) buffer (rows past capacity C
     drop into a discarded slot),
  4. grouped expert GEMMs (E, C, d) x (E, d, ff) as batched matmuls,
  5. gather back through the inverse permutation, weight by the gates,
     sum the k copies.

The JAX package computes the expert GEMMs with ``jnp.einsum`` outside
any Pallas kernel, so here they are ``torch.bmm``.  Its data-parallel
``vmap`` over token shards is a constant 1 and its ``constrain`` calls
are TPU sharding hints: neither has a counterpart.

Ties: ``lax.top_k`` breaks ties toward the lower expert index and
``jnp.argsort`` is stable; :func:`_top_k` sorts by (probability
descending, index ascending) and the dispatch uses a stable argsort, so
the kept and dropped rows are the JAX package's.  Every routed token
uses capacity, the prompt bucket's pad tokens included, as in the
reference.  The router runs in float32.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L

# capacity is lossless (C = T·k) up to this many expanded rows
_LOSSLESS_ROWS = 4096
# tokens of one dispatch: a longer call whose length it divides is
# routed chunk by chunk, each chunk with its own capacity
_DISPATCH_CHUNK = 8192


def moe_init(gen, cfg, *, device=None):
    """Router (d, E) in float32; experts ``gate``/``up`` (E, d, ff) and
    ``down`` (E, ff, d); shared experts as one MLP ``ff · shared`` wide.
    Each tensor is drawn in float32 and cast, one at a time."""
    d, E, ff = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    dt = L.dtype_of(cfg.param_dtype)

    def expert_weights(a, b):
        return (L._normal(gen, (E, a, b), device) / math.sqrt(a)).to(dt)

    p = {"router": {"w": L._normal(gen, (d, E), device) * 0.02},
         "experts": {"gate": expert_weights(d, ff),
                     "up": expert_weights(d, ff),
                     "down": expert_weights(ff, d)}}
    if cfg.num_shared_experts:
        p["shared"] = L.mlp_init(gen, d, ff * cfg.num_shared_experts,
                                 act=cfg.mlp_act, dtype=cfg.param_dtype,
                                 device=device)
    return p


def _capacity(num_tokens: int, cfg) -> int:
    """Expert capacity C: lossless ``T·k`` for small calls (decode steps),
    else ``T·k·capacity_factor / E``."""
    expanded = num_tokens * cfg.experts_per_token
    if expanded <= _LOSSLESS_ROWS:
        return expanded
    cap = int(expanded * cfg.capacity_factor / cfg.num_experts)
    return max(min(cap, expanded), 1)


def _top_k(probs, k: int):
    """Top-k along the last axis, ties to the lower index (``lax.top_k``)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(p, xf, cfg):
    """The router and the dispatch plan of (T, d) tokens.

    Returns a dict: ``logits`` and ``probs`` (T, E) in float32, ``top_p``
    (T, k) renormalized gates, ``counts`` (E,) rows routed to each expert,
    ``order`` the stable sort of the T·k expanded rows by expert,
    ``slot`` each sorted row's place in the flattened (E·C) buffer (E·C
    for a dropped row) and ``keep`` the sorted rows within capacity C.
    """
    T = xf.shape[0]
    E, k = cfg.num_experts, cfg.experts_per_token
    logits = xf.float() @ p["router"]["w"].float()
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = _top_k(probs, k)
    top_p = top_p / top_p.sum(-1, keepdim=True)
    C = _capacity(T, cfg)
    flat_e = top_i.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    # a scatter-add, as the JAX package counts: torch.bincount would
    # wait for the device to size its output
    counts = torch.zeros(E, dtype=flat_e.dtype, device=xf.device
                         ).scatter_add_(0, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, 0) - counts
    pos_in_e = torch.arange(T * k, device=xf.device) - starts[sorted_e]
    keep = pos_in_e < C
    slot = torch.where(keep, sorted_e * C + pos_in_e,
                       torch.full_like(pos_in_e, E * C))
    return dict(logits=logits, probs=probs, top_p=top_p, counts=counts,
                order=order, slot=slot, keep=keep)


def _experts(we, buf, act: str):
    """The grouped expert FFN: (E, C, d) rows through each expert's MLP."""
    cdt = buf.dtype
    if act in ("swiglu", "geglu"):
        fn = F.silu if act == "swiglu" else L._gelu
        h = fn(torch.bmm(buf, we["gate"].to(cdt)))
        h = h * torch.bmm(buf, we["up"].to(cdt))
    else:
        h = L._gelu(torch.bmm(buf, we["up"].to(cdt)))
    return torch.bmm(h, we["down"].to(cdt))


def _moe_shard(p, xf, cfg):
    """Dispatch, expert GEMMs and combine for (T, d) tokens; returns
    ``(out (T, d), metrics)``."""
    T, d = xf.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    cdt = xf.dtype
    r = route(p, xf, cfg)
    C = _capacity(T, cfg)

    # switch-style load balance and router z-loss
    frac_tokens = r["counts"].float() / (T * k)
    aux_loss = E * torch.sum(frac_tokens * r["probs"].mean(0))
    z_loss = torch.mean(torch.logsumexp(r["logits"], dim=-1) ** 2)

    order, slot, keep = r["order"], r["slot"], r["keep"]
    x_sorted = xf[order // k]                                   # (T·k, d)
    buf = xf.new_zeros((E * C + 1, d))
    buf[slot] = torch.where(keep[:, None], x_sorted,
                            torch.zeros_like(x_sorted))
    buf = buf[:-1].reshape(E, C, d)

    y = _experts(p["experts"], buf, cfg.mlp_act)

    y_flat = torch.cat([y.reshape(E * C, d), y.new_zeros((1, d))])
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.numel(), device=order.device)
    flat_p = r["top_p"].reshape(-1).to(cdt)
    out_rows = y_flat[slot][inv] * flat_p[:, None]
    out = out_rows.reshape(T, k, d).sum(1)
    metrics = {"moe_aux_loss": aux_loss, "moe_z_loss": z_loss,
               "moe_dropped_frac": 1.0 - keep.float().mean()}
    return out, metrics


def _moe_shard_chunked(p, xf, cfg):
    """``_moe_shard`` over chunks of ``_DISPATCH_CHUNK`` tokens when the
    call is longer and divisible by it; metrics are the chunks' means."""
    T = xf.shape[0]
    if T <= _DISPATCH_CHUNK or T % _DISPATCH_CHUNK:
        return _moe_shard(p, xf, cfg)
    outs, metrics = zip(*(_moe_shard(p, xc, cfg)
                          for xc in torch.split(xf, _DISPATCH_CHUNK)))
    return torch.cat(outs), {name: torch.stack([m[name] for m in metrics])
                             .mean() for name in metrics[0]}


def moe_apply(p, x, cfg):
    """x: (B, S, d) -> (out (B, S, d), metrics dict with the aux losses
    and the dropped fraction)."""
    B, S, d = x.shape
    xf = x.reshape(B * S, d)
    out, metrics = _moe_shard_chunked(p, xf, cfg)
    if "shared" in p:
        out = out + L.mlp(p["shared"], xf, act=cfg.mlp_act)
    return out.reshape(B, S, d), metrics
