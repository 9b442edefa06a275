"""Encoder-decoder transformer for the audio family (Seamless-M4T medium).

Port of the JAX package's ``models/encdec.py``.  The modality frontend
(mel-spectrogram and conv feature extractor) is a stub there and here:
callers supply precomputed frame embeddings ``src_embeds`` (B, T_src,
d_model).  The backbone is a bidirectional encoder over the frames and a
causal text decoder with cross-attention, with cached decode.

Parameters are the JAX package's tree, except that the encoder's and the
decoder's blocks are lists in layer order where the JAX package stacks
them on a leading layer axis for ``lax.scan``
(:func:`repro_torch.convert.encdec_params_from_jax` unstacks them).
``params["decoder"]["norm"]`` is built and converted as there, and read
by nothing: the decoder normalizes with ``params["final_norm"]``.

Cache layout for decode: ``{"self": [...], "cross": [...]}``, one
``{"k", "v"}`` dict per decoder layer.  The self caches (B, max_seq, K,
hd) are written in place; the cross caches (B, T_src, K, hd) hold the
encoder memory's K/V and are only read.

The training loss (:func:`encdec_train_loss`) runs the encoder over the
frames and the decoder over the tokens with cross-attention to the
encoder's output (no caches), then the chunked cross-entropy of
``models/transformer.py``.  With ``remat`` each encoder and decoder
block runs under ``torch.utils.checkpoint``, where the JAX package wraps
its scan bodies in ``jax.checkpoint``.  :func:`encdec_train_loss_tp` is
that loss over the ``model`` ranks of a
:class:`repro_torch.models.parallel.Group` (``models/transformer.py``'s
tensor-parallel layers; cross-attention applies ``wk``/``wv`` to each
rank's copy of the memory).  :func:`encdec_prefill_mesh` and
:func:`encdec_decode_step_mesh` serve over a data x model mesh, the
self and cross caches cut as ``models/sharding.py::cache_pspecs`` lays
them out.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models.transformer import (cache_views, checkpoint_tp,
                                            chunked_ce_loss,
                                            chunked_ce_loss_tp, lm_logits,
                                            logits_mesh, maybe_checkpoint)


# -- init ---------------------------------------------------------------------

def _enc_block_init(gen, cfg, device):
    kw = dict(dtype=cfg.param_dtype, device=device)
    return {"attn_norm": L.rmsnorm_init(cfg.d_model, **kw),
            "attn": A.attn_init(gen, cfg, device=device),
            "ffn_norm": L.rmsnorm_init(cfg.d_model, **kw),
            "ffn": L.mlp_init(gen, cfg.d_model, cfg.d_ff, act=cfg.mlp_act,
                              **kw)}


def _dec_block_init(gen, cfg, device):
    kw = dict(dtype=cfg.param_dtype, device=device)
    return {"self_norm": L.rmsnorm_init(cfg.d_model, **kw),
            "self_attn": A.attn_init(gen, cfg, device=device),
            "cross_norm": L.rmsnorm_init(cfg.d_model, **kw),
            "cross_attn": A.attn_init(gen, cfg, device=device),
            "ffn_norm": L.rmsnorm_init(cfg.d_model, **kw),
            "ffn": L.mlp_init(gen, cfg.d_model, cfg.d_ff, act=cfg.mlp_act,
                              **kw)}


def init_encdec(gen, cfg, *, device=None):
    """Random encoder-decoder parameters drawn from ``gen`` (a generator
    on ``device``).  bf16 configs are drawn in f32 one tensor at a time
    and cast, as :func:`repro_torch.models.transformer.init_lm` does."""
    kw = dict(dtype=cfg.param_dtype, device=device)
    params = {
        "encoder": {
            "blocks": [_enc_block_init(gen, cfg, device)
                       for _ in range(cfg.num_encoder_layers)],
            "norm": L.rmsnorm_init(cfg.d_model, **kw),
        },
        "decoder": {
            "blocks": [_dec_block_init(gen, cfg, device)
                       for _ in range(cfg.num_layers)],
            "norm": L.rmsnorm_init(cfg.d_model, **kw),
        },
        "embed": L.embed_init(gen, cfg.vocab_size, cfg.d_model, **kw),
        "final_norm": L.rmsnorm_init(cfg.d_model, **kw),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = L.dense_init(gen, cfg.d_model, cfg.vocab_size,
                                         **kw)
    return params


def init_encdec_cache(cfg, batch: int, max_seq: int, dtype=None,
                      device=None):
    """Zeroed decode caches: a (batch, max_seq) self cache per decoder
    layer, and cross caches of ``cfg.encoder_seq_len`` rows, one zero
    pair shared by every layer as the JAX package broadcasts one
    (:func:`encdec_prefill` replaces them; nothing writes them)."""
    cross = A.init_kv_cache(cfg, batch, cfg.encoder_seq_len, dtype,
                            device=device)
    return {"self": [A.init_kv_cache(cfg, batch, max_seq, dtype,
                                     device=device)
                     for _ in range(cfg.num_layers)],
            "cross": [dict(cross) for _ in range(cfg.num_layers)]}


# -- forward ------------------------------------------------------------------

def _enc_block(blk, cfg, h, positions):
    hn = L.rmsnorm(blk["attn_norm"], h, cfg.norm_eps)
    out, _ = A.attention(blk["attn"], hn, cfg, positions=positions,
                         causal=False)
    h = h + out.to(h.dtype)
    hn = L.rmsnorm(blk["ffn_norm"], h, cfg.norm_eps)
    return h + L.mlp(blk["ffn"], hn, act=cfg.mlp_act).to(h.dtype)


def encode(params, cfg, src_embeds, *, remat=False):
    """Bidirectional encoder over stub frame embeddings (B, T, d)."""
    h = src_embeds.to(L.dtype_of(cfg.compute_dtype))
    positions = torch.arange(h.shape[1], device=h.device)
    block = maybe_checkpoint(_enc_block, remat)
    for blk in params["encoder"]["blocks"]:
        h = block(blk, cfg, h, positions)
    return L.rmsnorm(params["encoder"]["norm"], h, cfg.norm_eps)


def _dec_block(blk, cfg, h, memory, positions, self_c, cross_c, cache_pos,
               window):
    hn = L.rmsnorm(blk["self_norm"], h, cfg.norm_eps)
    out, _ = A.attention(blk["self_attn"], hn, cfg, positions=positions,
                         window=window, cache=self_c, cache_pos=cache_pos)
    h = h + out.to(h.dtype)
    hn = L.rmsnorm(blk["cross_norm"], h, cfg.norm_eps)
    out, _ = A.attention(blk["cross_attn"], hn, cfg, positions=positions,
                         memory=memory, cross=True, cache=cross_c)
    h = h + out.to(h.dtype)
    hn = L.rmsnorm(blk["ffn_norm"], h, cfg.norm_eps)
    return h + L.mlp(blk["ffn"], hn, act=cfg.mlp_act).to(h.dtype)


def _decoder(params, cfg, h, memory, *, positions, caches=None,
             cache_pos=None, window=None, remat=False):
    """Decoder stack.  ``memory`` may be None when cross caches are given.
    Returns (normed hidden, caches or None)."""
    block = maybe_checkpoint(_dec_block, remat)
    for i, blk in enumerate(params["decoder"]["blocks"]):
        self_c = caches["self"][i] if caches is not None else None
        cross_c = caches["cross"][i] if caches is not None else None
        h = block(blk, cfg, h, memory, positions, self_c, cross_c,
                  cache_pos, window)
    return L.rmsnorm(params["final_norm"], h, cfg.norm_eps), caches


def build_cross_cache(params, cfg, memory):
    """Per-layer cross-attention K/V of the encoder output: the raw
    memory through ``wk``/``wv`` (no ``k_norm``, as in the JAX package)."""
    cache = []
    for blk in params["decoder"]["blocks"]:
        k = L.dense(blk["cross_attn"]["wk"], memory)
        v = L.dense(blk["cross_attn"]["wv"], memory)
        shape = (*k.shape[:-1], cfg.num_kv_heads, cfg.head_dim)
        cache.append({"k": k.reshape(shape), "v": v.reshape(shape)})
    return cache


def encdec_train_loss(params, cfg, batch, *, remat=True):
    """batch: {src_embeds (B,T,d), tokens (B,S), labels (B,S), [mask]}.
    Returns (loss, metrics): the decoder's chunked cross-entropy, as
    ``loss`` and ``ce``."""
    memory = encode(params, cfg, batch["src_embeds"], remat=remat)
    h = L.embed(params["embed"], batch["tokens"]).to(
        L.dtype_of(cfg.compute_dtype))
    positions = torch.arange(h.shape[1], device=h.device)
    h, _ = _decoder(params, cfg, h, memory, positions=positions, remat=remat)
    ce = chunked_ce_loss(params, cfg, h, batch["labels"], batch.get("mask"))
    return ce, {"loss": ce, "ce": ce}


def _norms(ps, key, hs, cfg):
    return [L.rmsnorm(p[key], h, cfg.norm_eps) for p, h in zip(ps, hs)]


def _residual(hs, out):
    return [h + o.to(h.dtype) for h, o in zip(hs, out)]


def _enc_block_tp(ps, hs, *, cfg, group):
    hs = _residual(hs, A.attention_tp(
        group, [p["attn"] for p in ps], _norms(ps, "attn_norm", hs, cfg),
        cfg, causal=False))
    return _residual(hs, L.mlp_tp(
        group, [p["ffn"] for p in ps], _norms(ps, "ffn_norm", hs, cfg),
        cfg.d_ff, cfg.mlp_act))


def _dec_block_tp(ps, hs, memory, *, cfg, group):
    hs = _residual(hs, A.attention_tp(
        group, [p["self_attn"] for p in ps],
        _norms(ps, "self_norm", hs, cfg), cfg))
    hs = _residual(hs, A.attention_tp(
        group, [p["cross_attn"] for p in ps],
        _norms(ps, "cross_norm", hs, cfg), cfg, memory=memory))
    return _residual(hs, L.mlp_tp(
        group, [p["ffn"] for p in ps], _norms(ps, "ffn_norm", hs, cfg),
        cfg.d_ff, cfg.mlp_act))


def encdec_train_loss_tp(group, ps, cfg, batches, *, remat=True):
    """:func:`encdec_train_loss` over a group's ranks: ``ps`` their
    parameter slices, ``batches`` their copies of the batch.  Returns
    (loss, metrics) on rank 0's device."""
    cdt = L.dtype_of(cfg.compute_dtype)
    hs = [b["src_embeds"].to(cdt) for b in batches]
    block = functools.partial(_enc_block_tp, cfg=cfg, group=group)
    for i in range(cfg.num_encoder_layers):
        hs = checkpoint_tp(block, remat,
                           [p["encoder"]["blocks"][i] for p in ps], hs)
    memory = _norms([p["encoder"] for p in ps], "norm", hs, cfg)
    hs = [h.to(cdt) for h in L.embed_tp(
        group, [p["embed"] for p in ps], [b["tokens"] for b in batches],
        cfg.vocab_size)]
    block = functools.partial(_dec_block_tp, cfg=cfg, group=group)
    for i in range(cfg.num_layers):
        hs = checkpoint_tp(block, remat,
                           [p["decoder"]["blocks"][i] for p in ps], hs,
                           memory)
    hs = _norms(ps, "final_norm", hs, cfg)
    ce = chunked_ce_loss_tp(group, ps, cfg, hs,
                            [b["labels"] for b in batches],
                            batches[0].get("mask"))
    return ce, {"loss": ce, "ce": ce}


def encdec_prefill(params, cfg, batch, caches, *, window=None):
    """Encode ``batch["src_embeds"]``, build cross caches of the source's
    length, and prefill the self caches (in place, from position 0) with
    ``batch["tokens"]``.  Returns (last-position logits (B, V), caches)."""
    memory = encode(params, cfg, batch["src_embeds"])
    caches = {"self": caches["self"],
              "cross": build_cross_cache(params, cfg, memory)}
    h = L.embed(params["embed"], batch["tokens"]).to(
        L.dtype_of(cfg.compute_dtype))
    positions = torch.arange(h.shape[1], device=h.device)
    h, caches = _decoder(params, cfg, h, None, positions=positions,
                         caches=caches, cache_pos=0, window=window)
    return lm_logits(params, cfg, h[:, -1:])[:, 0], caches


def encdec_decode_step(params, cfg, token, caches, pos: int, *,
                       window=None):
    """One decode step against prefilled self and cross caches.  token:
    (B, 1); ``pos``, the position every row writes and reads up to (the
    batch steps in lockstep), is a Python int, so a step needs no host
    sync.  Returns (logits (B, V), caches)."""
    h = L.embed(params["embed"], token).to(L.dtype_of(cfg.compute_dtype))
    pos = int(pos)
    positions = pos + torch.arange(1, device=h.device)
    h, caches = _decoder(params, cfg, h, None, positions=positions,
                         caches=caches, cache_pos=pos, window=window)
    return lm_logits(params, cfg, h)[:, 0], caches


# -- prefill and decode over a data x model mesh ------------------------------

def _replicas(groups):
    M = groups[0].size
    return [(group, slice(r * M, (r + 1) * M))
            for r, group in enumerate(groups)]


def _embed_mesh(groups, ps, cfg, tokens):
    cdt = L.dtype_of(cfg.compute_dtype)
    return [h.to(cdt) for group, sl in _replicas(groups)
            for h in L.embed_tp(group, [p["embed"] for p in ps[sl]],
                                tokens[sl], cfg.vocab_size)]


def _mlp_mesh(groups, ps, hs, cfg):
    out = []
    for group, sl in _replicas(groups):
        out += L.mlp_tp(group, [p["ffn"] for p in ps[sl]],
                        _norms(ps[sl], "ffn_norm", hs[sl], cfg), cfg.d_ff,
                        cfg.mlp_act)
    return _residual(hs, out)


def encdec_prefill_mesh(groups, ps, cfg, batches, caches):
    """:func:`encdec_prefill` over a data x model mesh, layer by layer
    across every replica (as ``transformer.lm_prefill_mesh``).

    ``groups``: the replicas' groups of ranks; ``ps`` and ``batches``:
    every device's parameters and its replica's rows of ``src_embeds``
    (B_r, T_src, d) and ``tokens`` (B_r, S), replica after replica
    (every replica's the whole batch where the caches' layout says so,
    ``sharding.replicated``); ``caches``: ``{"self": [...], "cross":
    [...]}`` of ``sharding.Sharded`` leaves laid out by
    ``cache_pspecs``, written in place.  The encoder is tensor-parallel, its self-attention
    non-causal (B9 per rank); the decoder's self-attention writes its
    cache from position 0 (B9 causal per rank), and its cross-attention
    projects each rank's heads' K/V from its copy of the memory, attends
    the prompt to them (B9 non-causal) and moves them to the cross
    cache's slices.  T_src must be the cross cache's length.  Returns
    the last position's logits (B, V) float32 on the first device, from
    the vocab-parallel head."""
    cdt = L.dtype_of(cfg.compute_dtype)
    T_src = caches["cross"][0]["k"].shape[1]
    if batches[0]["src_embeds"].shape[1] != T_src:
        raise ValueError(f"a source of {batches[0]['src_embeds'].shape[1]} "
                         f"frames for a cross cache of {T_src} rows")
    hs = [b["src_embeds"].to(cdt) for b in batches]
    for i in range(cfg.num_encoder_layers):
        hs = [h for group, sl in _replicas(groups)
              for h in _enc_block_tp([p["encoder"]["blocks"][i]
                                      for p in ps[sl]], hs[sl], cfg=cfg,
                                     group=group)]
    memory = _norms([p["encoder"] for p in ps], "norm", hs, cfg)
    hs = _embed_mesh(groups, ps, cfg, [b["tokens"] for b in batches])
    D = len(ps)
    for i in range(cfg.num_layers):
        blks = [p["decoder"]["blocks"][i] for p in ps]
        self_c, self_s = cache_views(caches["self"][i], D)
        cross_c, cross_s = cache_views(caches["cross"][i], D)
        out = []
        for group, sl in _replicas(groups):
            out += A.attention_tp(
                group, [b["self_attn"] for b in blks[sl]],
                _norms(blks[sl], "self_norm", hs[sl], cfg), cfg,
                caches=self_c[sl], spans=self_s[sl])
        hs = _residual(hs, out)
        out = []
        for group, sl in _replicas(groups):
            out += A.attention_tp(
                group, [b["cross_attn"] for b in blks[sl]],
                _norms(blks[sl], "cross_norm", hs[sl], cfg), cfg,
                memory=memory[sl], caches=cross_c[sl], spans=cross_s[sl])
        hs = _residual(hs, out)
        hs = _mlp_mesh(groups, blks, hs, cfg)
    hs = _norms(ps, "final_norm", hs, cfg)
    return logits_mesh(groups, ps, cfg, [h[:, -1:] for h in hs], caches)


def encdec_decode_step_mesh(groups, ps, cfg, tokens, caches, pos, *,
                            window=None):
    """:func:`encdec_decode_step` over a data x model mesh: ``tokens``
    each device's copy of its replica's rows of the (B, 1) token,
    ``pos`` each device's position (one int for every row: the batch
    steps in lockstep); the rest as :func:`encdec_prefill_mesh`.  The
    self-attention writes the step's K/V and attends by flash-decode
    over its cache's slices; cross-attention is a flash-decode over the
    cross cache's slices, which it only reads
    (``attention.attention_decode_mesh``).  Returns the logits (B, V)
    float32 on the first device."""
    hs = _embed_mesh(groups, ps, cfg, tokens)
    for i in range(cfg.num_layers):
        blks = [p["decoder"]["blocks"][i] for p in ps]
        hs = _residual(hs, A.attention_decode_mesh(
            groups, [b["self_attn"] for b in blks],
            _norms(blks, "self_norm", hs, cfg), cfg, caches["self"][i],
            list(pos), window=window))
        hs = _residual(hs, A.attention_decode_mesh(
            groups, [b["cross_attn"] for b in blks],
            _norms(blks, "cross_norm", hs, cfg), cfg, caches["cross"][i],
            list(pos), cross=True))
        hs = _mlp_mesh(groups, blks, hs, cfg)
    hs = _norms(ps, "final_norm", hs, cfg)
    return logits_mesh(groups, ps, cfg, hs, caches)
