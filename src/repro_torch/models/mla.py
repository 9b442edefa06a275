"""Multi-head Latent Attention (DeepSeek-V2/V3, arXiv:2412.19437).

Port of the JAX package's ``models/mla.py``.  Queries and keys/values
are projected through low-rank latents; only the compressed KV latent
(``kv_lora_rank`` wide) and a small RoPE key shared by every head are
cached: at deepseek-v3's widths, 512 + 64 entries a token a layer.

Two execution paths, as in the JAX package:

* **expanded** (prefill): the latents are up-projected to per-head keys
  and values, and attention runs over this call's own projections (not
  over the cache, which the call only writes).  With
  ``ops.use_pallas()`` on, it takes the route of the ``attn`` prefill
  (``attention._flash_route``: not on a differentiated call) and runs
  the flash-attention kernel (B9) with ``scale=1/sqrt(qk_nope +
  qk_rope)``: at (dh, dv) = (192, 128) at full width.  The JAX expanded prefill never reaches its Pallas kernel
  (it runs the einsum, or ``blocked_attention`` at long prompts); B9
  computes the same function, as the port's ``attn`` prefill already
  does.  Otherwise the JAX split: the masked einsum below
  ``BLOCKED_ATTN_THRESHOLD`` and :func:`attention.blocked_attention`
  at or above it.
* **absorbed** (decode, S == 1 with a cache): the up-projections are
  absorbed into the query and output sides, so attention reads the
  compressed cache directly.  Plain PyTorch, as in the JAX package.

Cache writes are in place, as in ``models/attention.py``: the returned
cache is the dict that was given.

:func:`mla_attention_tp` is the expanded path over the ``model`` ranks
of a :class:`repro_torch.models.parallel.Group`, by
``models/sharding.py``'s rules: the latent projections ``wq_a`` and
``wkv_a`` (and their norms) whole on every rank, ``wq_b`` and ``wkv_b``
column-parallel with whole heads a rank, ``wo_mla`` row-parallel.  It
is the training loss's, and with a cache the serving mesh's prefill
(B9 per rank).  :func:`mla_decode_mesh` is the serving mesh's decode
step: the absorbed path as a flash-decode over the latent cache's
slices.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import sharding as SH
from repro_torch.models.attention import write_row
from repro_torch.models.parallel import held, work

NEG_INF = -1e30


def mla_init(gen, cfg, *, device=None):
    m = cfg.mla
    d = cfg.d_model
    H = cfg.num_heads
    kw = dict(dtype=cfg.param_dtype, device=device)
    qk_head = m.qk_nope_head_dim + m.qk_rope_head_dim
    return {
        "wq_a": L.dense_init(gen, d, m.q_lora_rank, **kw),
        "q_norm": L.rmsnorm_init(m.q_lora_rank, **kw),
        "wq_b": L.dense_init(gen, m.q_lora_rank, H * qk_head, **kw),
        "wkv_a": L.dense_init(gen, d, m.kv_lora_rank + m.qk_rope_head_dim,
                              **kw),
        "kv_norm": L.rmsnorm_init(m.kv_lora_rank, **kw),
        "wkv_b": L.dense_init(gen, m.kv_lora_rank,
                              H * (m.qk_nope_head_dim + m.v_head_dim), **kw),
        "wo_mla": L.dense_init(gen, H * m.v_head_dim, d, **kw),
    }


def init_mla_cache(cfg, batch: int, max_seq: int, dtype=None, device=None):
    """The compressed cache: ``ckv`` (batch, max_seq, kv_lora_rank) and
    ``krope`` (batch, max_seq, qk_rope_head_dim), the slot on axis 0."""
    m = cfg.mla
    dtype = L.dtype_of(dtype or cfg.compute_dtype)
    return {
        "ckv": torch.zeros((batch, max_seq, m.kv_lora_rank), dtype=dtype,
                           device=device),
        "krope": torch.zeros((batch, max_seq, m.qk_rope_head_dim),
                             dtype=dtype, device=device),
    }


def _project_q(p, x, cfg, positions):
    m = cfg.mla
    cq = L.rmsnorm(p["q_norm"], L.dense(p["wq_a"], x), cfg.norm_eps)
    q = L.dense(p["wq_b"], cq)
    q = q.reshape(*q.shape[:-1], cfg.num_heads,
                  m.qk_nope_head_dim + m.qk_rope_head_dim)
    q_nope = q[..., : m.qk_nope_head_dim]
    q_rope = L.apply_rope(q[..., m.qk_nope_head_dim:], positions,
                          cfg.rope_theta)
    return q_nope, q_rope


def _project_kv_latent(p, x, cfg, positions):
    m = cfg.mla
    ckv_full = L.dense(p["wkv_a"], x)
    ckv = L.rmsnorm(p["kv_norm"], ckv_full[..., : m.kv_lora_rank],
                    cfg.norm_eps)
    # the RoPE key is shared by every head: RoPE over a head axis of 1
    k_rope = L.apply_rope(ckv_full[..., None, m.kv_lora_rank:], positions,
                          cfg.rope_theta)[..., 0, :]
    return ckv, k_rope


def _split_wkv_b(p, cfg):
    """(W_uk (r, H, dn), W_uv (r, H, dv)): views of ``wkv_b``."""
    m = cfg.mla
    w = p["wkv_b"]["w"].reshape(m.kv_lora_rank, cfg.num_heads,
                                m.qk_nope_head_dim + m.v_head_dim)
    return w[..., : m.qk_nope_head_dim], w[..., m.qk_nope_head_dim:]


def _write_cache(cache, ckv, k_rope, cache_pos, per_row):
    """Write this call's latents into the cache in place."""
    if per_row:
        rows = torch.arange(ckv.shape[0], device=ckv.device)
        pos = torch.as_tensor(cache_pos, device=ckv.device)
        cache["ckv"][rows, pos] = ckv[:, 0].to(cache["ckv"].dtype)
        cache["krope"][rows, pos] = k_rope[:, 0].to(cache["krope"].dtype)
    else:
        # the JAX dynamic_update_slice clamps the start so the block fits
        S = ckv.shape[1]
        start = max(0, min(int(cache_pos), cache["ckv"].shape[1] - S))
        cache["ckv"][:, start:start + S] = ckv.to(cache["ckv"].dtype)
        cache["krope"][:, start:start + S] = k_rope.to(
            cache["krope"].dtype)


def _absorbed(q_nope, q_rope, ckv, krope, w_uk, w_uv, *, scale, positions,
              k_positions, window, cdt):
    """Decode against the compressed cache: scores q_nope·(W_uk c) +
    q_rope·k_rope in f32, then (softmax · c)·W_uv.  (B, S, H, dv)."""
    ckv = ckv.to(cdt)
    q_abs = torch.einsum("bshd,rhd->bshr", q_nope, w_uk.to(cdt))
    s_nope = torch.einsum("bshr,btr->bhst", q_abs.float(), ckv.float())
    s_rope = torch.einsum("bshd,btd->bhst", q_rope.float(),
                          krope.to(cdt).float())
    scores = (s_nope + s_rope) * scale
    qp = positions[None] if positions.dim() == 1 else positions
    mask = A.make_mask(qp, k_positions[None], causal=True, window=window)
    scores = torch.where(mask[:, None], scores,
                         torch.full_like(scores, NEG_INF))
    w = torch.softmax(scores, dim=-1)
    o_lat = torch.einsum("bhst,btr->bshr", w.to(cdt), ckv)
    return torch.einsum("bshr,rhd->bshd", o_lat, w_uv.to(cdt))


def _expanded(p, q_nope, q_rope, ckv, k_rope, cfg, *, scale, positions,
              window, flash):
    """Prefill over this call's own keys and values.  (B, S, H, dv)."""
    m = cfg.mla
    B, S, H = q_nope.shape[:3]
    kv = L.dense(p["wkv_b"], ckv).reshape(
        B, S, H, m.qk_nope_head_dim + m.v_head_dim)
    return _attend_expanded(q_nope, q_rope, kv, k_rope, cfg, scale=scale,
                            positions=positions, window=window, flash=flash)


def _attend_expanded(q_nope, q_rope, kv, k_rope, cfg, *, scale, positions,
                     window, flash):
    """Attention of the expanded path: ``kv`` (B, S, H, dn + dv) the
    heads' up-projected keys and values, ``k_rope`` (B, S, dr) the
    shared RoPE key.  (B, S, H, dv)."""
    m = cfg.mla
    B, S, H = q_nope.shape[:3]
    k_nope, v = kv[..., : m.qk_nope_head_dim], kv[..., m.qk_nope_head_dim:]
    k_rope_h = k_rope[:, :, None, :].expand(B, S, H, m.qk_rope_head_dim)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope_h], dim=-1)
    if flash:
        # v is a slice of the up-projection: the bf16 body wants
        # 8-element strides, so lay it out afresh
        return ops.flash_attention(q, k, v.contiguous(), causal=True,
                                   window=window, scale=scale)
    qpos = positions if positions.dim() == 1 else positions[0]
    if S >= A.BLOCKED_ATTN_THRESHOLD:
        return A.blocked_attention(q, k, v, causal=True, window=window,
                                   q_positions=qpos, k_positions=qpos,
                                   scale=scale)
    scores = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) * scale
    qp = positions[None] if positions.dim() == 1 else positions
    mask = A.make_mask(qp, qp, causal=True, window=window)
    scores = torch.where(mask[:, None], scores,
                         torch.full_like(scores, NEG_INF))
    w = torch.softmax(scores, dim=-1)
    return torch.einsum("bhst,bthd->bshd", w.to(v.dtype), v)


def mla_attention(p, x, cfg, *, positions, window=None, cache=None,
                  cache_pos=None):
    """MLA forward.  Same contract as ``attention.attention``: returns
    (out (B, S, d), cache), the cache None unless one was given."""
    m = cfg.mla
    B, S, _ = x.shape
    cdt = L.dtype_of(cfg.compute_dtype)
    x = x.to(cdt)
    scale = 1.0 / np.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim)

    q_nope, q_rope = _project_q(p, x, cfg, positions)
    ckv, k_rope = _project_kv_latent(p, x, cfg, positions)
    flash = A._flash_route(S, cfg, positions, cache, cache_pos,
                           inputs=(q_nope, q_rope, ckv, k_rope))

    if cache is not None:
        per_row = torch.is_tensor(cache_pos) and cache_pos.dim() == 1
        if per_row and S != 1:
            raise ValueError(
                "per-request cache_pos requires S == 1 (decode); "
                "slot-targeted prefill goes through lm_prefill_slot")
        _write_cache(cache, ckv, k_rope, cache_pos, per_row)
        ckv_used, kr_used = cache["ckv"], cache["krope"]
        T = ckv_used.shape[1]
        k_positions = torch.arange(T, device=x.device)
        if window is not None and S == 1 and not per_row and T > 2 * window:
            # windowed decode reads only the live window of the cache
            start = max(0, min(int(cache_pos) - window + 1, T - window))
            ckv_used = ckv_used[:, start:start + window]
            kr_used = kr_used[:, start:start + window]
            k_positions = start + torch.arange(window, device=x.device)

    if cache is not None and S == 1:
        w_uk, w_uv = _split_wkv_b(p, cfg)
        out = _absorbed(q_nope, q_rope, ckv_used, kr_used, w_uk, w_uv,
                        scale=scale, positions=positions,
                        k_positions=k_positions, window=window, cdt=cdt)
    else:
        out = _expanded(p, q_nope, q_rope, ckv, k_rope, cfg, scale=scale,
                        positions=positions, window=window, flash=flash)
    out = out.reshape(B, S, cfg.num_heads * m.v_head_dim)
    return L.dense(p["wo_mla"], out), cache


def _heads_tp(ps, cfg, M):
    """Each rank's span of ``wo_mla``'s rows (None: no work) and the
    heads they read."""
    m = cfg.mla
    spans = [work(j, M, p["wo_mla"]["w"].shape[0],
                  cfg.num_heads * m.v_head_dim) for j, p in enumerate(ps)]
    heads = [s and (s[0] // m.v_head_dim, -(-s[1] // m.v_head_dim))
             for s in spans]
    return spans, heads


def _q_tp(group, ps, xs, cfg, heads):
    """Each rank's (B, S, h, qk) queries of its heads, before RoPE:
    ``wq_b``'s columns of those heads (gathered where a cut splits a
    head) over its whole query latent."""
    m = cfg.mla
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    cq = [L.rmsnorm(p["q_norm"], L.dense(p["wq_a"], x), cfg.norm_eps)
          for p, x in zip(ps, xs)]
    q = L.dense_col(group, [p["wq_b"] for p in ps], cq, cfg.num_heads * qk,
                    [h and (h[0] * qk, h[1] * qk) for h in heads])
    return [None if h is None else
            qj.reshape(*qj.shape[:2], h[1] - h[0], qk)
            for qj, h in zip(q, heads)]


def mla_attention_tp(group, ps, xs, cfg, *, window=None, caches=None,
                     spans=None):
    """MLA over a group's ranks: the expanded path of
    :func:`mla_attention`, positions ``0..S-1``.

    Each rank computes the query and KV latents from its whole copies of
    ``wq_a``/``q_norm`` and ``wkv_a``/``kv_norm`` (and the shared RoPE
    key), and the heads that its rows of ``wo_mla`` read: its columns of
    ``wq_b`` and ``wkv_b`` where they are those heads (whole heads a
    rank wherever the heads split evenly), else the columns gathered
    over the group.  RoPE, ``scale`` and the window as in
    :func:`mla_attention`; the attention of its heads through the
    flash-attention kernel where ``attention._flash_route`` sends the
    call (a serving prefill, not the training loss); ``wo_mla``
    row-parallel, one sum over the group.  ``xs``: per-rank copies of
    the input (B, S, d); returns per-rank copies of the output.

    ``caches`` (rank j's shard {ckv, krope} of the layer's latent cache,
    ``spans[j]`` the spans of it that it holds) make it a serving
    prefill from position 0: each rank writes its rows of the latent
    from its own (whole) copy.  A decode step is :func:`mla_decode_mesh`.
    """
    m = cfg.mla
    M, H = group.size, cfg.num_heads
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    kvw = m.qk_nope_head_dim + m.v_head_dim
    cdt = L.dtype_of(cfg.compute_dtype)
    xs = [x.to(cdt) for x in xs]
    scale = 1.0 / np.sqrt(qk)
    B, S = xs[0].shape[:2]
    spans_wo, heads = _heads_tp(ps, cfg, M)
    positions = torch.arange(S, device=xs[0].device)
    latents = [_project_kv_latent(p, x, cfg, positions.to(x.device))
               for p, x in zip(ps, xs)]
    if caches is not None:
        for c, sp, (ckv, k_rope) in zip(caches, spans, latents):
            r0, r1 = sp["ckv"][1]
            n = min(r1, S) - r0
            if n > 0:
                c["ckv"][:, :n] = ckv[:, r0:r0 + n].to(c["ckv"].dtype)
                c["krope"][:, :n] = k_rope[:, r0:r0 + n].to(
                    c["krope"].dtype)
    q = _q_tp(group, ps, xs, cfg, heads)
    kv = L.dense_col(group, [p["wkv_b"] for p in ps],
                     [ckv for ckv, _ in latents], H * kvw,
                     [h and (h[0] * kvw, h[1] * kvw) for h in heads])
    outs = []
    for j in range(M):
        if spans_wo[j] is None:
            outs.append(None)
            continue
        h0, h1 = heads[j]
        pos = positions.to(q[j].device)
        q_nope = q[j][..., : m.qk_nope_head_dim]
        q_rope = L.apply_rope(q[j][..., m.qk_nope_head_dim:], pos,
                              cfg.rope_theta)
        kvj = kv[j].reshape(B, S, h1 - h0, kvw)
        flash = A._flash_route(S, cfg, pos, None, None, True,
                               inputs=(q_nope, q_rope, kvj))
        out = _attend_expanded(q_nope, q_rope, kvj, latents[j][1], cfg,
                               scale=scale, positions=pos, window=window,
                               flash=flash)
        out = out.reshape(B, S, -1)
        outs.append(out.narrow(-1, spans_wo[j][0] - h0 * m.v_head_dim,
                               spans_wo[j][1] - spans_wo[j][0]))
    return L.dense_row(group, [p["wo_mla"] for p in ps], outs)


def mla_decode_mesh(groups, ps, xs, cfg, caches, cache_pos, *, window=None):
    """One decode step (S = 1) of MLA over every replica of a mesh: the
    absorbed path of :func:`mla_attention` as a flash-decode over the
    latent cache's slices.

    Arguments as ``attention.attention_decode_mesh``'s, ``caches`` the
    layer's latent cache {ckv, krope} (no head dimension: cut by
    sequence, or whole).  Each rank forms ``q_abs``
    for its own heads through its columns of ``wkv_b`` (W_uk; the
    columns gathered where a cut splits a head), and the group gathers
    ``q_abs`` (B, 1, H, r) and the RoPE query (B, 1, H, dr); every rank
    projects the step's latent from its whole copy of ``wkv_a``, and the
    devices whose slices hold a row's position write it.  Each device
    computes, in f32, the partial (max, sum, unnormalized ``o_lat`` (B,
    H, r)) over its region of the cache (causal, and the window where
    one is given), the partials are combined in device order
    (``attention.combine_partials``), and each rank applies its own
    W_uv columns to its heads (``o_lat`` rounded to the compute dtype
    first, as the one-device path rounds the softmax weights), then the
    row-parallel ``wo_mla``.  Returns per-device copies of the output.
    """
    m = cfg.mla
    M, H = groups[0].size, cfg.num_heads
    dn, dr, dv, r = (m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim,
                     m.kv_lora_rank)
    kvw = dn + dv
    cdt = L.dtype_of(cfg.compute_dtype)
    scale = 1.0 / np.sqrt(dn + dr)
    xs = [x.to(cdt) for x in xs]
    poss = [A._row_positions(c, x) for c, x in zip(cache_pos, xs)]
    wo_spans, q_abs, q_rope, w_uv, latents = [], [], [], [], []
    for g, group in enumerate(groups):
        sl = slice(g * M, (g + 1) * M)
        rp, rx, rpos = ps[sl], xs[sl], poss[sl]
        sp, heads = _heads_tp(rp, cfg, M)
        wo_spans += sp
        q = _q_tp(group, rp, rx, cfg, heads)
        w = group.redistribute(
            [p["wkv_b"]["w"] for p in rp],
            [held(j, M, p["wkv_b"]["w"].shape[1], H * kvw)
             for j, p in enumerate(rp)],
            [h and (h[0] * kvw, h[1] * kvw) for h in heads], dim=1)
        qa, qr = [], []
        for j in range(M):
            if heads[j] is None:
                qa.append(None)
                qr.append(None)
                w_uv.append(None)
                continue
            wj = w[j].reshape(r, heads[j][1] - heads[j][0], kvw)
            qa.append(torch.einsum("bshd,rhd->bshr", q[j][..., :dn],
                                   wj[..., :dn].to(cdt)))
            qr.append(L.apply_rope(q[j][..., dn:], rpos[j][:, None],
                                   cfg.rope_theta))
            w_uv.append(wj[..., dn:])
        q_abs += group.redistribute(qa, heads, [(0, H)] * M, dim=2)
        q_rope += group.redistribute(qr, heads, [(0, H)] * M, dim=2)
        latents += [_project_kv_latent(p, x, cfg, pos[:, None])
                    for p, x, pos in zip(rp, rx, rpos)]
    views = [SH.device_views(caches, d) for d in range(len(xs))]
    blocks = [caches["ckv"].spans(d)[1:2] for d in range(len(xs))]
    for d, (c, (ckv, k_rope)) in enumerate(zip(views, latents)):
        write_row(c, "ckv", ckv[:, 0], cache_pos[d], blocks[d][0])
        write_row(c, "krope", k_rope[:, 0], cache_pos[d], blocks[d][0])

    def partial(d, region):
        ((t0, t1),), r0 = region, blocks[d][0][0]
        pos = poss[d]
        lo, hi = A.live_rows(cache_pos[d], window, (t0, t1))
        ckv = views[d]["ckv"][:, lo - r0:hi - r0].to(cdt).float()
        krope = views[d]["krope"][:, lo - r0:hi - r0].to(cdt).float()
        s = (torch.einsum("bhr,btr->bht", q_abs[d][:, 0].float(), ckv)
             + torch.einsum("bhd,btd->bht", q_rope[d][:, 0].float(), krope)
             ) * scale
        t = torch.arange(lo, hi, device=pos.device)
        valid = t[None] <= pos[:, None]
        if window is not None:
            valid &= t[None] > pos[:, None] - window
        mx, total, p_ = A.softmax_partial(s, valid[:, None])
        return mx, total, torch.einsum("bht,btr->bhr", p_, ckv)

    o_lat = A.combine_partials(groups, SH.replicated(caches), blocks,
                               partial)
    outs = []
    for d, (o, sp) in enumerate(zip(o_lat, wo_spans)):
        if sp is None:
            outs.append(None)
            continue
        h0, h1 = sp[0] // dv, -(-sp[1] // dv)
        out = torch.einsum("bhr,rhd->bhd", o[:, h0:h1].to(cdt),
                           w_uv[d].to(cdt))
        outs.append(out.reshape(out.shape[0], 1, -1).narrow(
            -1, sp[0] - h0 * dv, sp[1] - sp[0]))
    return A.dense_row_mesh(groups, [p["wo_mla"] for p in ps], outs)
