"""Decoder-only LM over attention, MLA and SSM blocks: prefill and decode.

Port of the serving half of the JAX package's ``models/transformer.py``
for the ``attn``, ``mla`` (``models/mla.py``) and ``ssm`` mixers with a
dense, MoE (``models/moe.py``) or no FFN, and for VLM prefix embeddings
(``prefix_embeds``, concatenated before the tokens).  As in the JAX
package, an encoder-decoder config (seamless-m4t-medium) builds here as
a decoder-only stack of its ``num_layers`` (attention, dense) blocks,
which is what the JAX ``Server`` serves; its real route, encoder and
cross-attention, is ``models/encdec.py`` through the step builders of
``launch/steps.py``.  deepseek-v3's
multi-token-prediction head (``params["mtp"]``) is built as the JAX
package builds it; serving never reads it, and the training loss that
does (with the MoE auxiliary losses) waits for the LM-training slice.

Parameters are a dict like the JAX package's, except that the layers are
a list in layer order (``params["layers"][i]`` is layer i's block dict)
where the JAX package stacks each segment on a leading ``repeats`` axis
for ``lax.scan``: a Python loop over the layers takes the scan's place.
Caches are a list too, one dict per layer, each leaf with the request
**slot** on axis 0.  Attention and MLA caches are written in place
(``models/attention.py``, ``models/mla.py``).
"""

from __future__ import annotations

import torch

from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import mamba as M
from repro_torch.models import mla as MLA
from repro_torch.models import moe as MOE


# -- layer plan ---------------------------------------------------------------

def layer_types(cfg):
    """Per-layer (mixer, ffn) type tags."""
    out = []
    for i in range(cfg.num_layers):
        if cfg.is_attn_layer(i):
            mixer = "mla" if cfg.use_mla else "attn"
        else:
            mixer = "ssm"
        if cfg.d_ff == 0 and not cfg.is_moe_layer(i):
            ffn = "none"
        else:
            ffn = "moe" if cfg.is_moe_layer(i) else "dense"
        out.append((mixer, ffn))
    return out


def build_plan(cfg):
    """Segments: list of (repeats, period_types tuple), as the JAX package
    groups its layers (the order of :func:`lm_params_from_jax`)."""
    types = layer_types(cfg)
    segments = []
    i = 0
    fd = cfg.first_dense_layers
    if fd:
        assert all(t == types[0] for t in types[:fd])
        segments.append((fd, (types[0],)))
        i = fd
    rest = types[i:]
    if not rest:
        return segments
    period = 1
    while period <= len(rest):
        if len(rest) % period == 0:
            pat = rest[:period]
            if all(rest[j] == pat[j % period] for j in range(len(rest))):
                break
        period += 1
    segments.append((len(rest) // period, tuple(rest[:period])))
    return segments


# -- blocks -------------------------------------------------------------------

def _block_init(gen, cfg, mixer, ffn, device):
    p = {"mixer_norm": L.rmsnorm_init(cfg.d_model, dtype=cfg.param_dtype,
                                      device=device)}
    if mixer == "attn":
        p["attn"] = A.attn_init(gen, cfg, device=device)
    elif mixer == "mla":
        p["mla"] = MLA.mla_init(gen, cfg, device=device)
    else:
        p["ssm"] = M.mamba_init(gen, cfg, device=device)
    if ffn == "dense":
        p["ffn_norm"] = L.rmsnorm_init(cfg.d_model, dtype=cfg.param_dtype,
                                       device=device)
        p["ffn"] = L.mlp_init(gen, cfg.d_model, cfg.d_ff, act=cfg.mlp_act,
                              dtype=cfg.param_dtype, device=device)
    elif ffn == "moe":
        p["ffn_norm"] = L.rmsnorm_init(cfg.d_model, dtype=cfg.param_dtype,
                                       device=device)
        p["moe"] = MOE.moe_init(gen, cfg, device=device)
    return p


def _block_cache(cfg, mixer, batch, max_seq, dtype, device):
    if mixer == "attn":
        return A.init_kv_cache(cfg, batch, max_seq, dtype, device=device)
    if mixer == "mla":
        return MLA.init_mla_cache(cfg, batch, max_seq, dtype, device=device)
    return M.init_mamba_cache(cfg, batch, dtype, device=device)


def _block_apply(p, cfg, h, mixer, ffn, *, positions, window, cache=None,
                 cache_pos=None):
    hn = L.rmsnorm(p["mixer_norm"], h, cfg.norm_eps)
    if mixer == "attn":
        out, new_cache = A.attention(p["attn"], hn, cfg, positions=positions,
                                     window=window, cache=cache,
                                     cache_pos=cache_pos)
    elif mixer == "mla":
        out, new_cache = MLA.mla_attention(p["mla"], hn, cfg,
                                           positions=positions, window=window,
                                           cache=cache, cache_pos=cache_pos)
    else:
        out, new_cache = M.mamba_apply(p["ssm"], hn, cfg, cache=cache)
    h = h + out.to(h.dtype)
    if ffn == "dense":
        hn = L.rmsnorm(p["ffn_norm"], h, cfg.norm_eps)
        h = h + L.mlp(p["ffn"], hn, act=cfg.mlp_act).to(h.dtype)
    elif ffn == "moe":
        hn = L.rmsnorm(p["ffn_norm"], h, cfg.norm_eps)
        out, _ = MOE.moe_apply(p["moe"], hn, cfg)    # serving: no aux loss
        h = h + out.to(h.dtype)
    return h, new_cache


# -- model init / forward -----------------------------------------------------

def init_lm(gen, cfg, *, device=None):
    """Random LM parameters drawn from ``gen`` (a generator on ``device``).

    bf16 configs are drawn in f32 one tensor at a time and cast (an MoE
    layer's experts one (E, ·, ·) tensor at a time), so the peak is the
    parameters plus the largest tensor in f32: at moonshot-v1-16b-a3b the
    (163840, 2048) embedding, 1.34 GB.
    """
    params = {"embed": L.embed_init(gen, cfg.vocab_size, cfg.d_model,
                                    dtype=cfg.param_dtype, device=device),
              "final_norm": L.rmsnorm_init(cfg.d_model,
                                           dtype=cfg.param_dtype,
                                           device=device)}
    if not cfg.tie_embeddings:
        params["lm_head"] = L.dense_init(gen, cfg.d_model, cfg.vocab_size,
                                         dtype=cfg.param_dtype,
                                         device=device)
    params["layers"] = [_block_init(gen, cfg, mixer, ffn, device)
                        for mixer, ffn in layer_types(cfg)]
    if cfg.mtp_depth > 0:
        # deepseek-v3's depth-1 multi-token-prediction head, as the JAX
        # package builds it; serving never reads it
        params["mtp"] = {
            "proj": L.dense_init(gen, 2 * cfg.d_model, cfg.d_model,
                                 dtype=cfg.param_dtype, device=device),
            "norm": L.rmsnorm_init(cfg.d_model, dtype=cfg.param_dtype,
                                   device=device),
            "block": _block_init(gen, cfg, "mla" if cfg.use_mla else "attn",
                                 "dense" if cfg.d_ff else "none", device),
        }
    return params


def params_to(params, device):
    """The parameter (or cache) tree with every tensor moved to ``device``."""
    if isinstance(params, dict):
        return {k: params_to(v, device) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(params_to(v, device) for v in params)
    return params.to(device)


def init_lm_cache(cfg, batch: int, max_seq: int, dtype=None, device=None):
    """Decode caches for ``batch`` independent request **slots**: one dict
    per layer, every leaf (batch, ...), so axis 0 is the slot table."""
    return [_block_cache(cfg, mixer, batch, max_seq, dtype, device)
            for mixer, _ in layer_types(cfg)]


def cache_slot(caches, slot: int):
    """Views of slot ``slot``: a standalone width-1 cache."""
    return [{k: t[slot: slot + 1] for k, t in layer.items()}
            for layer in caches]


def write_cache_slot(caches, slot_caches, slot: int):
    """Copy a width-w cache into slots ``[slot, slot + w)``, in place."""
    for layer, part in zip(caches, slot_caches):
        for k, t in layer.items():
            t[slot: slot + part[k].shape[0]] = part[k].to(t.dtype)
    return caches


def lm_hidden(params, cfg, h, *, positions, window=None, caches=None,
              cache_pos=None):
    """Run every block.  h: (B,S,d) embedded input.  Returns (normed
    hidden, new caches or None)."""
    new_caches = [] if caches is not None else None
    for i, (mixer, ffn) in enumerate(layer_types(cfg)):
        c = caches[i] if caches is not None else None
        h, nc = _block_apply(params["layers"][i], cfg, h, mixer, ffn,
                             positions=positions, window=window, cache=c,
                             cache_pos=cache_pos)
        if caches is not None:
            new_caches.append(nc)
    h = L.rmsnorm(params["final_norm"], h, cfg.norm_eps)
    return h, new_caches


def embed_inputs(params, cfg, tokens=None, prefix_embeds=None):
    """Token (and optional VLM prefix) embedding -> (B, S, d) in the
    compute dtype; the prefix comes first."""
    cdt = L.dtype_of(cfg.compute_dtype)
    parts = []
    if prefix_embeds is not None:
        parts.append(prefix_embeds.to(cdt))
    if tokens is not None:
        parts.append(L.embed(params["embed"], tokens).to(cdt))
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)


def lm_logits(params, cfg, h):
    """Full logits (f32) — only for small S (decode / last position)."""
    if cfg.tie_embeddings:
        logits = L.unembed(params["embed"], h)
    else:
        logits = L.dense(params["lm_head"], h)
    if cfg.logit_softcap:
        logits = torch.tanh(logits / cfg.logit_softcap) * cfg.logit_softcap
    return logits.float()


def lm_prefill(params, cfg, batch, caches, *, window=None, last_pos=None):
    """Prefill: fill the caches with the prompt, return last-position
    logits (B, V) and the caches.

    ``last_pos`` — optional (B,) of each sequence's final *prompt*
    position; logits are read there instead of at the padded end.  With
    ``batch["prefix_embeds"]`` (B, P, d) the prompt is the prefix and then
    the tokens: positions and ``last_pos`` count the prefix.
    """
    h = embed_inputs(params, cfg, batch.get("tokens"),
                     batch.get("prefix_embeds"))
    positions = torch.arange(h.shape[1], device=h.device)
    h, caches = lm_hidden(params, cfg, h, positions=positions, window=window,
                          caches=caches, cache_pos=0)
    if last_pos is None:
        sel = h[:, -1:]
    else:
        rows = torch.arange(h.shape[0], device=h.device)
        sel = h[rows, torch.as_tensor(last_pos, device=h.device)][:, None]
    return lm_logits(params, cfg, sel)[:, 0], caches


def lm_prefill_slot(params, cfg, batch, caches, slot: int, *, window=None,
                    last_pos=None):
    """Prefill ONE slot of a slotted cache; the others are untouched.

    The prompt runs against a **zeroed** width-1 cache (a slot's previous
    tenant must not seed the new recurrence), written back into ``slot``.
    Returns ``(logits (1, V), caches)``.
    """
    sub = [{k: torch.zeros_like(t) for k, t in layer.items()}
           for layer in cache_slot(caches, slot)]
    logits, sub = lm_prefill(params, cfg, batch, sub, window=window,
                             last_pos=last_pos)
    return logits, write_cache_slot(caches, sub, slot)


def lm_decode_step(params, cfg, token, caches, pos, *, window=None):
    """One decode step.  token: (B,1); pos: an int (every row reads and
    writes one cache position) or a (B,) tensor (row i writes at
    ``pos[i]`` and attends only ``[0, pos[i]]``).  Returns (logits (B,V),
    new caches)."""
    h = embed_inputs(params, cfg, token)
    if torch.is_tensor(pos) and pos.dim() == 1:
        pos = pos.to(h.device)
        positions = pos[:, None]                           # (B, 1) per row
    else:
        pos = int(pos)
        positions = pos + torch.arange(1, device=h.device)
    h, caches = lm_hidden(params, cfg, h, positions=positions, window=window,
                          caches=caches, cache_pos=pos)
    return lm_logits(params, cfg, h)[:, 0], caches
