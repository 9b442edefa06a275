"""Grouped-query attention with a KV cache: prefill, per-row decode, window,
bidirectional and cross-attention.

Port of the JAX package's ``models/attention.py``: GQA and MQA, qk-norm,
QKV bias, sliding windows, the scalar and per-request ``cache_pos``
cache writes, the windowed long-context decode slice, and the
encoder-decoder's attentions (``models/encdec.py``): the encoder's
bidirectional self-attention (``causal=False``) and cross-attention
(``memory=``, or ``cross=True`` with a precomputed cross ``cache``).

Modes
-----
* full   : (B, S, d) -> (B, S, d), causal (or bidirectional) mask.
* cache  : ``cache`` {k, v: (B, S_max, K, hd)} and ``cache_pos``, a
           scalar (every row writes at one position: a prefill block) or
           a per-request (B,) vector (decode, S == 1: row i writes at
           ``cache_pos[i]`` and attends only ``[0, cache_pos[i]]``).
* cross  : K/V from ``memory`` (B, T, d) through ``wk``/``wv`` (qk-norm on
           q and k), or read from a cross ``cache`` when no memory is
           given (qk-norm on q only); no RoPE, no causal mask, and the
           cache is returned as given.

The port writes the cache in place (the JAX package returns new arrays):
a decode step touches one row per request instead of copying every
layer's cache.  The returned cache is the dict it was given.

With ``ops.use_pallas()`` on, the attention of a prompt (S > 1, no
logit softcap) runs the flash-attention kernel
(:func:`repro_torch.kernels.ops.flash_attention`, B9) in two cases:
causal self-attention with q positions ``0..S-1`` when a cache is given
(k/v are then the whole ``max_seq`` cache, and the kernel's causal mask
and block skip keep the entries past the prompt out of reach), and
every non-causal call: the encoder's self-attention and both cross
routes, Sq = S against T = the source's length.  A non-causal call with
a window raises there: the JAX package drops the window on its einsum
path and keeps it on its blocked path.  Everything else is the plain
path: the einsum below ``BLOCKED_ATTN_THRESHOLD`` and
:func:`blocked_attention` at or above it, as in the JAX package, whose
own decode is an einsum too.  A differentiated call (the training loss)
takes the plain path too: the kernel has no backward.

:func:`attention_tp` is the tensor-parallel form over the ``model`` ranks
of a :class:`repro_torch.models.parallel.Group`: the training loss's,
the serving encoder's and, with a cache (rank j's shard of a cache laid
out by ``models/sharding.py::cache_pspecs``), the serving mesh's prefill
of a self or cross cache, B9 per rank where :func:`_flash_route` sends
the call.  :func:`attention_decode_mesh` is the serving mesh's decode
step over every replica at once: flash-decode, each device's partial
softmax over its slice of the cache combined over a replica's ranks, or
over the whole mesh where every replica holds the whole batch (a batch
the data axes do not divide: its cache's sequence is cut over data
too).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.kernels._common import differentiated, is_fake
from repro_torch.models import layers as L
from repro_torch.models import parallel as PL
from repro_torch.models import sharding as SH
from repro_torch.models.parallel import work
from repro_torch.roofline.counting import counted_call

NEG_INF = -1e30
# sequence length at/above which the plain full-attention path switches
# from the einsum to the memory-bounded blocked path
BLOCKED_ATTN_THRESHOLD = 2048


def attn_init(gen, cfg, *, device=None):
    dt = cfg.param_dtype
    d = cfg.d_model
    kw = dict(dtype=dt, device=device)
    p = {"wq": L.dense_init(gen, d, cfg.q_dim, bias=cfg.qkv_bias, **kw),
         "wk": L.dense_init(gen, d, cfg.kv_dim, bias=cfg.qkv_bias, **kw),
         "wv": L.dense_init(gen, d, cfg.kv_dim, bias=cfg.qkv_bias, **kw),
         "wo": L.dense_init(gen, cfg.q_dim, d, **kw)}
    if cfg.qk_norm:
        p["q_norm"] = L.rmsnorm_init(cfg.head_dim, **kw)
        p["k_norm"] = L.rmsnorm_init(cfg.head_dim, **kw)
    return p


def init_kv_cache(cfg, batch: int, max_seq: int, dtype=None, device=None):
    dtype = L.dtype_of(dtype or cfg.compute_dtype)
    shape = (batch, max_seq, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _split_heads(x, n, hd):
    return x.reshape(*x.shape[:-1], n, hd)


def _gqa_scores(q, k):
    """(B,S,H,hd) x (B,T,K,hd) -> (B,K,H/K,S,T) grouped scores, f32."""
    B, S, H, hd = q.shape
    K = k.shape[2]
    q = q.reshape(B, S, K, H // K, hd)
    return torch.einsum("bskgd,btkd->bkgst", q.float(), k.float())


def _gqa_out(w, v):
    """(B,K,H/K,S,T) x (B,T,K,hd) -> (B,S,H,hd) in v's dtype."""
    B, K, G, S, T = w.shape
    out = torch.einsum("bkgst,btkd->bskgd", w.to(v.dtype), v)
    return out.reshape(B, S, K * G, v.shape[-1])


def make_mask(q_positions, k_positions, *, causal: bool, window=None):
    """Boolean mask broadcastable to (..., S_q, S_k); True = attend."""
    qp = q_positions[..., :, None]
    kp = k_positions[..., None, :]
    mask = torch.ones(torch.broadcast_shapes(qp.shape, kp.shape),
                      dtype=torch.bool, device=qp.device)
    if causal:
        mask &= kp <= qp
    if window is not None:
        mask &= kp > qp - window
    return mask


def blocked_attention(q, k, v, *, causal=True, window=None, softcap=None,
                      q_positions=None, k_positions=None, scale=None,
                      q_chunk=256, kv_chunk=512):
    """Online-softmax attention over (q_chunk, kv_chunk) blocks, plain
    PyTorch: the JAX package's memory-bounded path for long prompts.

    q: (B, Sq, H, d); k/v: (B, T, K, dv) with H = K * G.  Returns
    (B, Sq, H, dv) in v's dtype.  ``scale`` defaults to 1/sqrt(d).

    Fake tensors (the dry run's) take a shape-only route
    (``roofline/counting.py::counted_call``): the op-by-op count of this
    function, forward and backward, is taken once per signature on meta
    tensors and replayed by one autograd node, so a call costs the dry
    run a few dispatches instead of every op of every block.  Real
    tensors never take it.
    """
    def plain(q, k, v, q_positions, k_positions):
        return _blocked_attention(
            q, k, v, causal=causal, window=window, softcap=softcap,
            q_positions=q_positions, k_positions=k_positions, scale=scale,
            q_chunk=q_chunk, kv_chunk=kv_chunk)

    if is_fake(q):
        return counted_call(
            "blocked_attention", plain, (q, k, v, q_positions, k_positions),
            key=(causal, window, softcap, scale, q_chunk, kv_chunk))
    return plain(q, k, v, q_positions, k_positions)


def _blocked_attention(q, k, v, *, causal, window, softcap, q_positions,
                       k_positions, scale, q_chunk, kv_chunk):
    """:func:`blocked_attention`'s plain path, op by op."""
    B, Sq, H, dh = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    dv = v.shape[-1]
    dev = q.device
    scale = 1.0 / np.sqrt(dh) if scale is None else scale
    if q_positions is None:
        q_positions = torch.arange(Sq, device=dev)
    if k_positions is None:
        k_positions = torch.arange(T, device=dev)
    q_chunk = min(q_chunk, Sq)
    kv_chunk = min(kv_chunk, T)
    pq = (-Sq) % q_chunk
    pk = (-T) % kv_chunk
    qp = torch.nn.functional.pad(q_positions, (0, pq), value=-1)
    kp = torch.nn.functional.pad(k_positions, (0, pk), value=2 ** 30)
    qq = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, pq))
    kk = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pk))
    vv = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pk))
    nq, nk = (Sq + pq) // q_chunk, (T + pk) // kv_chunk
    qq = qq.reshape(B, nq, q_chunk, K, G, dh)
    kk = kk.reshape(B, nk, kv_chunk, K, dh)
    vv = vv.reshape(B, nk, kv_chunk, K, dv)
    qp = qp.reshape(nq, q_chunk)
    kp = kp.reshape(nk, kv_chunk)

    outs = []
    for qi in range(nq):
        q_blk, qpos = qq[:, qi], qp[qi]
        m = torch.full((B, K, G, q_chunk), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((B, K, G, q_chunk), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, K, G, q_chunk, dv), dtype=torch.float32,
                          device=dev)
        for kj in range(nk):
            k_blk, v_blk, kpos = kk[:, kj], vv[:, kj], kp[kj]
            s = torch.einsum("bqkgd,btkd->bkgqt", q_blk.float(),
                             k_blk.float()) * scale
            if softcap:
                s = torch.tanh(s / softcap) * softcap
            msk = kpos[None, :] < T
            if causal:
                msk = msk & (kpos[None, :] <= qpos[:, None])
            if window is not None:
                msk = msk & (kpos[None, :] > qpos[:, None] - window)
            s = torch.where(msk, s, torch.full_like(s, NEG_INF))
            m_new = torch.maximum(m, s.amax(-1))
            p_ = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p_.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkgqt,btkd->bkgqd", p_.to(v_blk.dtype).float(),
                v_blk.float())
            m = m_new
        out = acc / torch.clamp_min(l, 1e-30)[..., None]   # (B,K,G,Qc,dv)
        outs.append(out.permute(0, 3, 1, 2, 4))             # (B,Qc,K,G,dv)
    out = torch.stack(outs, 1).reshape(B, Sq + pq, H, dv)
    return out[:, :Sq].to(v.dtype)


def _write_cache(cache, k, v, cache_pos, per_row):
    """Write this step's k/v into the cache in place."""
    if per_row:
        rows = torch.arange(k.shape[0], device=k.device)
        pos = torch.as_tensor(cache_pos, device=k.device)
        cache["k"][rows, pos] = k[:, 0].to(cache["k"].dtype)
        cache["v"][rows, pos] = v[:, 0].to(cache["v"].dtype)
    else:
        # the JAX dynamic_update_slice clamps the start so the block fits
        S = k.shape[1]
        start = max(0, min(int(cache_pos), cache["k"].shape[1] - S))
        cache["k"][:, start:start + S] = k.to(cache["k"].dtype)
        cache["v"][:, start:start + S] = v.to(cache["v"].dtype)


def _flash_route(S, cfg, positions, cache, cache_pos, causal=True,
                 inputs=()) -> bool:
    """Whether this call's attention runs the flash-attention kernel.
    ``causal`` is the call's mask after the cache rules (a self-attention
    cache forces it on, cross-attention off).  ``inputs`` are the
    kernel's would-be operands: a call that autograd records on them
    (``kernels._common.differentiated``) takes the plain path, because
    the kernel has no backward and the JAX package's training loss
    never reaches its Pallas kernel; that is the reference's route, not
    a fallback.  Serving (no grad mode, or weights that need no grad)
    keeps the kernel."""
    if not ops.use_pallas() or S <= 1 or cfg.logit_softcap \
            or differentiated(*inputs):
        return False
    if not causal:
        # the q positions do not enter a non-causal mask
        return True
    if positions.dim() != 1:
        return False
    # with a cache, the kernel's q positions 0..S-1 are the prompt's
    return cache is None or (isinstance(cache_pos, int) and cache_pos == 0)


def _attend(q, k, v, cfg, positions, k_positions, causal, window):
    """The plain path: q (B, S, H, hd) against k/v (B, T, K, hd), H a
    multiple of K -> (B, S, H, hd).  The einsum below
    ``BLOCKED_ATTN_THRESHOLD`` query rows, :func:`blocked_attention` at
    or above it."""
    S = q.shape[1]
    q_pos1d = positions if positions.dim() == 1 else positions[0]
    k_pos1d = k_positions if k_positions.dim() == 1 else k_positions[0]
    # per-request positions keep their (B, S) shape, so every row
    # masks against its own write position
    q_pos2d = positions if positions.dim() == 2 else q_pos1d[None]
    if S >= BLOCKED_ATTN_THRESHOLD:
        # as in the JAX package, the window reaches the blocked path
        # even when the call is not causal
        return blocked_attention(
            q, k, v, causal=causal, window=window,
            softcap=cfg.logit_softcap, q_positions=q_pos1d,
            k_positions=k_pos1d)
    mask = make_mask(q_pos2d, k_pos1d[None], causal=causal,
                     window=window if causal else None)
    scores = _gqa_scores(q, k) / np.sqrt(cfg.head_dim)
    if cfg.logit_softcap:
        cap = cfg.logit_softcap
        scores = torch.tanh(scores / cap) * cap
    scores = torch.where(mask[:, None, None], scores,
                         torch.full_like(scores, NEG_INF))
    w = torch.softmax(scores, dim=-1)
    return _gqa_out(w, v)


def attention(p, x, cfg, *, positions, causal=True, window=None,
              memory=None, cross=False, cache=None, cache_pos=None):
    """Unified attention entry point.

    Args:
      p: params from :func:`attn_init`.
      x: (B, S, d) queries' residual stream.
      positions: (S,) or (B, S) absolute positions for RoPE and masking.
      causal / window: mask controls (cross-attention is never causal).
      memory: (B, T, d) cross-attention memory (the encoder output).
      cross: cross-attention; with ``cache`` given and no ``memory``, K/V
        are read from that precomputed cross cache.
      cache / cache_pos: KV cache; a self-attention cache is written in
        place at ``cache_pos`` (an int, or a (B,) tensor for per-row
        decode), a cross cache only read.

    Returns (out, cache) — cache is None unless one was given.
    """
    B, S, _ = x.shape
    cross = cross or memory is not None
    cdt = L.dtype_of(cfg.compute_dtype)
    x = x.to(cdt)
    q = _split_heads(L.dense(p["wq"], x), cfg.num_heads, cfg.head_dim)
    if cross and memory is None:
        k = v = None                       # read from the cross cache below
    else:
        kv_src = x if memory is None else memory.to(cdt)
        k = _split_heads(L.dense(p["wk"], kv_src), cfg.num_kv_heads,
                         cfg.head_dim)
        v = _split_heads(L.dense(p["wv"], kv_src), cfg.num_kv_heads,
                         cfg.head_dim)
    if "q_norm" in p:
        q = L.rmsnorm(p["q_norm"], q, cfg.norm_eps)
        if k is not None:
            k = L.rmsnorm(p["k_norm"], k, cfg.norm_eps)
    if not cross:
        q = L.apply_rope(q, positions, cfg.rope_theta)
        k = L.apply_rope(k, positions, cfg.rope_theta)

    if cache is not None and not cross:
        per_row = torch.is_tensor(cache_pos) and cache_pos.dim() == 1
        if per_row and S != 1:
            raise ValueError(
                "per-request cache_pos requires S == 1 (decode); "
                "slot-targeted prefill goes through lm_prefill_slot")
        _write_cache(cache, k, v, cache_pos, per_row)
        k, v = cache["k"], cache["v"]
        k_positions = torch.arange(k.shape[1], device=x.device)
        causal = True
        if window is not None and S == 1 and not per_row \
                and k.shape[1] > 2 * window:
            # windowed long-context decode reads only the live window of
            # the cache instead of masking all of it
            start = max(0, min(int(cache_pos) - window + 1,
                               k.shape[1] - window))
            k = k[:, start:start + window]
            v = v[:, start:start + window]
            k_positions = start + torch.arange(window, device=x.device)
    else:
        if cache is not None:
            # cross-attention against the precomputed memory cache
            k, v = cache["k"], cache["v"]
        if cross:
            k_positions = torch.arange(k.shape[1], device=x.device)
            causal = False
        else:
            k_positions = positions

    if _flash_route(S, cfg, positions, cache, cache_pos, causal,
                    inputs=(q, k, v)):
        if window is not None and not causal:
            raise ValueError(
                "a non-causal attention with a window has no flash route: "
                "the reference drops the window below "
                f"{BLOCKED_ATTN_THRESHOLD} query rows and keeps it above")
        out = ops.flash_attention(q, k, v, causal=causal, window=window)
    else:
        out = _attend(q, k, v, cfg, positions, k_positions, causal, window)
    out = L.dense(p["wo"], out.reshape(B, S, cfg.q_dim))
    return out, cache


def _project_tp(group, ps, xs, cfg, kv_src, positions, *, rope=True,
                k_norm=True):
    """The ranks' projections for :func:`attention_tp`: (spans, heads,
    kv_heads, q, k, v).  ``spans[j]`` is the span of ``wo``'s rows rank j
    holds (None: no work), ``heads[j]``/``kv_heads[j]`` the q and KV
    heads it computes, and q/k/v its (B, S, h, hd) tensors after the
    qk-norm (``k_norm=False``: on q only, as a cross cache holds K) and,
    with ``rope``, RoPE at ``positions[j]`` (None: ``0..S-1``).  K/V
    are projected from ``kv_src`` (per-rank copies of the input or of
    the cross-attention memory); ``kv_src`` None: no K/V (None)."""
    M, hd = group.size, cfg.head_dim
    per_kv = cfg.num_heads // cfg.num_kv_heads
    cdt = L.dtype_of(cfg.compute_dtype)
    xs = [x.to(cdt) for x in xs]
    spans = [work(j, M, p["wo"]["w"].shape[0], cfg.q_dim)
             for j, p in enumerate(ps)]
    heads = [s and (s[0] // hd, -(-s[1] // hd)) for s in spans]
    kv_heads = [h and (h[0] // per_kv, (h[1] - 1) // per_kv + 1)
                for h in heads]

    def cols(hs):
        return [h and (h[0] * hd, h[1] * hd) for h in hs]

    q = L.dense_col(group, [p["wq"] for p in ps], xs, cfg.q_dim, cols(heads))
    k = v = [None] * M
    if kv_src is not None:
        src = [m.to(cdt) for m in kv_src]
        k = L.dense_col(group, [p["wk"] for p in ps], src, cfg.kv_dim,
                        cols(kv_heads))
        v = L.dense_col(group, [p["wv"] for p in ps], src, cfg.kv_dim,
                        cols(kv_heads))
    qs, ks, vs = [], [], []
    for j, p in enumerate(ps):
        if spans[j] is None:
            qs.append(None)
            ks.append(None)
            vs.append(None)
            continue
        (h0, h1), (g0, g1) = heads[j], kv_heads[j]
        qj = _split_heads(q[j], h1 - h0, hd)
        kj = vj = None
        if kv_src is not None:
            kj = _split_heads(k[j], g1 - g0, hd)
            vj = _split_heads(v[j], g1 - g0, hd)
        if "q_norm" in p:
            qj = L.rmsnorm(p["q_norm"], qj, cfg.norm_eps)
            if kj is not None and k_norm:
                kj = L.rmsnorm(p["k_norm"], kj, cfg.norm_eps)
        if rope:
            pos = (torch.arange(qj.shape[1], device=qj.device)
                   if positions is None else positions[j])
            qj = L.apply_rope(qj, pos, cfg.rope_theta)
            if kj is not None:
                kj = L.apply_rope(kj, pos, cfg.rope_theta)
        qs.append(qj)
        ks.append(kj)
        vs.append(vj)
    return spans, heads, kv_heads, qs, ks, vs


def _local_kv(kj, vj, heads, kv_heads, per_kv):
    """A rank's K/V for its q heads: as they are where the q heads take
    whole KV groups, else one KV head per q head."""
    (h0, h1), (g0, g1) = heads, kv_heads
    if g1 - g0 == 1 or (h0 % per_kv == 0 and h1 % per_kv == 0):
        return kj, vj
    # the local q heads cut a KV group: one KV head per q head
    idx = torch.arange(h0, h1, device=kj.device) // per_kv - g0
    return kj[:, :, idx], vj[:, :, idx]


def attention_tp(group, ps, xs, cfg, *, causal=True, window=None,
                 memory=None, caches=None, spans=None):
    """Attention over a group's ranks: ``wq``/``wk``/``wv``
    column-parallel, ``wo`` row-parallel.

    Rank j computes the heads that its rows of ``wo`` read.  Where its
    own columns of ``wq``/``wk``/``wv`` are whole heads (every family
    whose heads split evenly), it projects and attends locally; where a
    cut splits a head (gemma-2b's one KV head), the activation block is
    gathered over the group before the head split.  ``q_norm``/``k_norm``,
    RoPE, the softcap and the window apply per head, as in
    :func:`attention`.  ``memory``: per-rank copies of the
    cross-attention memory (K/V through ``wk``/``wv``; no RoPE, not
    causal).  ``xs``: per-rank copies of the input (B, S, d), positions
    ``0..S-1``; returns per-rank copies of the output.  Each rank
    attends through the flash-attention kernel where
    :func:`_flash_route` sends the call (the route of :func:`attention`:
    a prompt, causal or not; never the training loss, whose call is
    differentiated), else through :func:`_attend`.

    ``caches`` (rank j's shard of the layer's cache, laid out by
    ``models/sharding.py::cache_pspecs``, and ``spans[j]`` the spans of
    the whole cache it holds, ``Sharded.spans``) make it a serving
    prefill from position 0: the K/V this call attends to (the prompt's,
    or with ``memory`` the memory's, which a cross cache holds without
    ``k_norm`` as ``encdec.build_cross_cache`` builds it) move to the
    ranks whose slices of the cache hold them (``Group.heads_to_seq``)
    and are written there in place.  A decode step is
    :func:`attention_decode_mesh`.
    """
    per_kv = cfg.num_heads // cfg.num_kv_heads
    cross = memory is not None
    spans_wo, heads, kv_heads, qs, ks, vs = _project_tp(
        group, ps, xs, cfg, memory if cross else xs, None, rope=not cross,
        k_norm=not (cross and caches is not None))
    outs = []
    for j in range(group.size):
        if spans_wo[j] is None:
            outs.append(None)
            continue
        qj = qs[j]
        kj, vj = _local_kv(ks[j], vs[j], heads[j], kv_heads[j], per_kv)
        S = qj.shape[1]
        positions = torch.arange(S, device=qj.device)
        if cross:
            k_positions, c = torch.arange(kj.shape[1], device=qj.device), \
                False
        else:
            k_positions, c = positions, causal
        if _flash_route(S, cfg, positions, None, None, c,
                        inputs=(qj, kj, vj)):
            if window is not None and not c:
                raise ValueError("a non-causal attention with a window has "
                                 "no flash route")
            # per-rank slices of a fused projection: the bf16 body wants
            # 8-element strides, so lay them out afresh
            out = ops.flash_attention(qj.contiguous(), kj.contiguous(),
                                      vj.contiguous(), causal=c,
                                      window=window)
        else:
            out = _attend(qj, kj, vj, cfg, positions, k_positions, c, window)
        out = out.reshape(*out.shape[:2], -1)
        outs.append(out.narrow(-1, spans_wo[j][0] - heads[j][0]
                               * cfg.head_dim,
                               spans_wo[j][1] - spans_wo[j][0]))
    if caches is not None:
        n = next(k.shape[1] for k in ks if k is not None)
        # each shard's rows of this call's K/V (from its first row: a
        # prefill starts at 0) and its heads
        rows = [(sp["k"][1][0], min(sp["k"][1][1], n)) for sp in spans]
        hs = [sp["k"][2] for sp in spans]
        for key, new in (("k", ks), ("v", vs)):
            blocks = group.heads_to_seq(new, kv_heads, rows, hs)
            for c, blk in zip(caches, blocks):
                if blk is not None:
                    c[key][:, :blk.shape[1]] = blk.to(c[key].dtype)
    return L.dense_row(group, [p["wo"] for p in ps], outs)


def cache_regions(blocks):
    """Which block of a cache each device computes a decode step's
    partial softmax over: ``blocks[d]`` is the block device d holds (a
    tuple of spans, say its rows and its KV heads), and its region is
    that block where no earlier device holds the same one, else None.
    The blocks of a layout tile the cache (its sequence cut over the
    devices, its heads, or neither: whole copies), so the regions tile
    it once, each computed by the block's first holder."""
    seen = set()
    out = []
    for b in blocks:
        out.append(None if b in seen else b)
        seen.add(b)
    return out


def live_rows(cache_pos, window, rows, cross=False):
    """The rows of a cache slice ``rows`` (lo, hi) that a decode step
    reads, ``(lo, hi)`` with ``hi >= lo``: for a scalar ``cache_pos`` p,
    those in ``[0, p]``, or within a window ``[p - window + 1, p]`` (the
    keys of the one-device path's slice ``[start, start + window)``,
    ``start`` clamped to ``[0, T - window]``, that its mask keeps); all
    of them for per-row positions (the mask then keeps each row's own)
    and for cross-attention (no mask)."""
    if cross or torch.is_tensor(cache_pos):
        return rows
    p = int(cache_pos)
    lo = max(rows[0], 0 if window is None else p - window + 1)
    return lo, max(lo, min(rows[1], p + 1))


def decode_scopes(groups, replicated):
    """The sets of devices whose partial softmaxes a decode step
    combines, each a list of device indices: a replica's ranks where the
    batch is cut over the replicas (each replica's rows are its own);
    every device of the mesh where each replica holds the whole batch
    (``replicated``: the cache's sequence may then be cut over data
    too, and the replicas' copies are equal)."""
    M = groups[0].size
    if replicated:
        return [list(range(len(groups) * M))]
    return [list(range(r * M, (r + 1) * M)) for r in range(len(groups))]


def write_row(c, key, new, pos, rows):
    """Write a decode step's (B, ...) ``new`` into the shard ``c[key]``
    that holds rows ``rows`` of the cache: row b at its position
    ``pos[b]`` where that falls in the shard, nothing elsewhere."""
    r0, r1 = rows
    B = new.shape[0]
    if not torch.is_tensor(pos):
        if r0 <= pos < r1:
            c[key][:, pos - r0] = new.to(c[key].dtype)
        return
    rows_b = torch.arange(B, device=pos.device)
    inside = (pos >= r0) & (pos < r1)
    at = torch.clamp(pos - r0, 0, r1 - r0 - 1)
    cur = c[key][rows_b, at]
    shape = (B,) + (1,) * (new.dim() - 1)
    c[key][rows_b, at] = torch.where(inside.reshape(shape),
                                     new.to(c[key].dtype), cur)


def combine_partials(groups, replicated, blocks, partial):
    """Flash-decode's combine: for each scope (:func:`decode_scopes`),
    ``partial(d, region)`` of each device d with a region (the block
    ``blocks[d]`` it holds, where no earlier device of the scope holds
    the same, :func:`cache_regions`) gives (max, sum, unnormalized output)
    over it, and :meth:`Group.lse_combine` combines them in device
    order.  Returns each device's copy of the combined output."""
    devices = [dev for g in groups for dev in g.devices]
    out = [None] * len(devices)
    for scope in decode_scopes(groups, replicated):
        regions = cache_regions([blocks[d] for d in scope])
        parts = [partial(d, reg) if reg is not None
                 else (None, None, None) for d, reg in zip(scope, regions)]
        att = PL.Group([devices[d] for d in scope]).lse_combine(
            *map(list, zip(*parts)))
        for d, a in zip(scope, att):
            out[d] = a
    return out


def dense_row_mesh(groups, ws, outs):
    """:func:`layers.dense_row` over each replica's ranks: ``ws`` and
    ``outs`` are every device's weight and input, replica after
    replica."""
    M = groups[0].size
    out = []
    for r, group in enumerate(groups):
        sl = slice(r * M, (r + 1) * M)
        out += L.dense_row(group, ws[sl], outs[sl])
    return out


def softmax_partial(s, valid):
    """(max, sum, weights) of scores ``s`` (..., t) in f32 over the keys
    ``valid`` keeps; a row that keeps none gives max -inf, sum 0 and
    weights 0."""
    s = torch.where(valid, s, torch.full_like(s, -float("inf")))
    if s.shape[-1] == 0:
        m = torch.full(s.shape[:-1], -float("inf"), device=s.device)
        return m, torch.zeros_like(m), s
    m = s.amax(-1)
    p = torch.exp(s - torch.where(torch.isneginf(m), 0.0, m)[..., None])
    return m, p.sum(-1), p


def attention_decode_mesh(groups, ps, xs, cfg, caches, cache_pos, *,
                          window=None, cross=False):
    """One decode step (S = 1) of the cached attention over every
    replica of a mesh: flash-decode over the cache's slices.

    ``groups``: the replicas' groups of ranks; ``ps``, ``xs`` and
    ``cache_pos``: each device's parameters, copy of its replica's input
    (B, 1, d) and position(s) (an int for every row, or a (B,) tensor),
    replica after replica; ``caches``: the layer's cache {k, v} of
    ``sharding.Sharded`` leaves (device d writes and reads its shard).  Each replica projects its ranks' heads and gathers the
    step's q (and K/V) over its group; each device writes the K/V where
    a row's position falls in its slice (not for ``cross``: a cross
    cache, written at the prefill, is only read), computes the partial
    softmax of every head over its region of the cache (its first
    holder's block, :func:`cache_regions`) in f32, plain PyTorch as the
    one-device decode, and the partials are combined in device order
    over each replica, or over the whole mesh where every replica holds
    the whole batch (``sharding.replicated``, :func:`decode_scopes`).  A device
    reads only :func:`live_rows` of its slice; one that sees no key
    weighs exactly 0.  Cross-attention (no RoPE, q-norm only) reads
    every key.  Returns per-device copies of the output (the
    row-parallel ``wo`` of each replica)."""
    M, hd, K, H = groups[0].size, cfg.head_dim, cfg.num_kv_heads, \
        cfg.num_heads
    per_kv = H // K
    poss = [_row_positions(c, x) for c, x in zip(cache_pos, xs)]
    wo_spans, q, k, v = [], [], [], []
    for r, group in enumerate(groups):
        sl = slice(r * M, (r + 1) * M)
        sp, heads, kv_heads, qs, ks, vs = _project_tp(
            group, ps[sl], xs[sl], cfg, None if cross else xs[sl],
            [p[:, None] for p in poss[sl]], rope=not cross)
        wo_spans += sp
        q += group.redistribute(qs, heads, [(0, H)] * M, dim=2)
        if not cross:
            k += group.redistribute(ks, kv_heads, [(0, K)] * M, dim=2)
            v += group.redistribute(vs, kv_heads, [(0, K)] * M, dim=2)
    views = [SH.device_views(caches, d) for d in range(len(xs))]
    blocks = [caches["k"].spans(d)[1:3] for d in range(len(xs))]
    if not cross:
        for d, (c, ((r0, r1), (k0, k1))) in enumerate(zip(views, blocks)):
            for key, new in (("k", k[d]), ("v", v[d])):
                write_row(c, key, new[:, 0, k0:k1], cache_pos[d], (r0, r1))

    def partial(d, region):
        ((t0, t1), (g0, g1)), ((r0, _), (k0, _)) = region, blocks[d]
        pos = poss[d]
        B = pos.shape[0]
        lo, hi = live_rows(cache_pos[d], window, (t0, t1), cross)
        kj = views[d]["k"][:, lo - r0:hi - r0, g0 - k0:g1 - k0]
        vj = views[d]["v"][:, lo - r0:hi - r0, g0 - k0:g1 - k0]
        qj = q[d][:, 0, g0 * per_kv:g1 * per_kv].reshape(B, g1 - g0, per_kv,
                                                         hd)
        s = torch.einsum("bkgd,btkd->bkgt", qj.float(),
                         kj.float()) / np.sqrt(hd)
        if cfg.logit_softcap:
            s = torch.tanh(s / cfg.logit_softcap) * cfg.logit_softcap
        t = torch.arange(lo, hi, device=pos.device)
        valid = torch.ones((B, hi - lo), dtype=torch.bool,
                           device=pos.device)
        if not cross:
            valid &= t[None] <= pos[:, None]
            if window is not None:
                valid &= t[None] > pos[:, None] - window
        m, l_, p_ = softmax_partial(s, valid[:, None, None])
        o = torch.einsum("bkgt,btkd->bkgd", p_, vj.float())
        m_all = torch.full((B, H), -float("inf"), device=pos.device)
        l_all = torch.zeros((B, H), device=pos.device)
        o_all = torch.zeros((B, H, hd), device=pos.device)
        sl = slice(g0 * per_kv, g1 * per_kv)
        m_all[:, sl] = m.reshape(B, -1)
        l_all[:, sl] = l_.reshape(B, -1)
        o_all[:, sl] = o.reshape(B, -1, hd)
        return m_all, l_all, o_all

    att = combine_partials(groups, SH.replicated(caches), blocks, partial)
    cdt = L.dtype_of(cfg.compute_dtype)
    outs = [None if sp is None else
            a.to(cdt).reshape(a.shape[0], 1, H * hd).narrow(
                -1, sp[0], sp[1] - sp[0])
            for a, sp in zip(att, wo_spans)]
    return dense_row_mesh(groups, [p["wo"] for p in ps], outs)


def _row_positions(cache_pos, x):
    """A decode step's positions as a (B,) tensor on ``x``'s device."""
    if torch.is_tensor(cache_pos) and cache_pos.dim() == 1:
        return cache_pos.to(x.device)
    return torch.full((x.shape[0],), int(cache_pos), dtype=torch.long,
                      device=x.device)
