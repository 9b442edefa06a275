"""Analytic roofline calculator — executed FLOPs / HBM bytes / collective
bytes per (arch × shape × mesh), component by component.

Port of the JAX package's ``roofline/calculator.py``: the same analytic
model of the executed implementation (the masked full rectangle of the
plain blocked attention, MoE capacity padding, remat recompute), with
``decode_window`` from the port's ``launch/steps.py`` and the card's
rates from :data:`repro_torch.roofline.analysis.HW` (an H100).

All byte/FLOP counts are GLOBAL per step; ``roofline_terms`` divides by
chip count / per-chip bandwidths at the end.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.launch.steps import decode_window
from repro_torch.roofline.analysis import HW


@dataclasses.dataclass
class MeshShape:
    dp: int          # data-parallel ways (pod*data)
    tp: int          # model/tensor ways

    @property
    def chips(self) -> int:
        return self.dp * self.tp


def mesh_shape_of(mesh) -> MeshShape:
    """A mesh's data-parallel and tensor-parallel ways (a
    ``launch/mesh.py::NamedMesh``, or anything with ``axis_names`` and a
    ``shape`` mapping)."""
    dp = 1
    for a in ("pod", "data"):
        if a in mesh.axis_names:
            dp *= mesh.shape[a]
    return MeshShape(dp=dp, tp=mesh.shape.get("model", 1))


# ---------------------------------------------------------------------------
# Per-component FLOP model (executed, forward pass, global)
# ---------------------------------------------------------------------------


def _attn_flops(cfg, tokens, ctx, *, executed_ctx=None):
    """GQA attention: projections + scores/AV over context ``ctx``.
    ``executed_ctx`` = keys actually computed against (masked-full blocks)."""
    d, H, K, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    ec = executed_ctx if executed_ctx is not None else ctx
    proj = 2 * tokens * d * (H * hd + 2 * K * hd + H * hd)
    scores = 2 * tokens * ec * H * hd * 2          # QK^T + PV
    return proj + scores


def _mla_flops(cfg, tokens, ctx, *, decode=False, executed_ctx=None):
    m = cfg.mla
    d, H = cfg.d_model, cfg.num_heads
    ec = executed_ctx if executed_ctx is not None else ctx
    qk_head = m.qk_nope_head_dim + m.qk_rope_head_dim
    q = 2 * tokens * (d * m.q_lora_rank + m.q_lora_rank * H * qk_head)
    kv_a = 2 * tokens * d * (m.kv_lora_rank + m.qk_rope_head_dim)
    o = 2 * tokens * H * m.v_head_dim * d
    if decode:
        # absorbed path: q_abs + latent scores + latent AV + uv expand
        absorb = 2 * tokens * H * m.qk_nope_head_dim * m.kv_lora_rank \
            + 2 * tokens * ec * H * (m.kv_lora_rank + m.qk_rope_head_dim) \
            + 2 * tokens * ec * H * m.kv_lora_rank \
            + 2 * tokens * H * m.kv_lora_rank * m.v_head_dim
        return q + kv_a + o + absorb
    kv_b = 2 * ctx * m.kv_lora_rank * H * (m.qk_nope_head_dim
                                           + m.v_head_dim)
    scores = 2 * tokens * ec * H * (qk_head + m.v_head_dim)
    return q + kv_a + kv_b + o + scores


def _ffn_flops(cfg, tokens, ff):
    nmat = 3 if cfg.mlp_act in ("swiglu", "geglu") else 2
    return 2 * nmat * tokens * cfg.d_model * ff


def _moe_flops(cfg, tokens):
    """Executed: capacity-padded expert GEMMs + router + shared expert."""
    expanded = tokens * cfg.experts_per_token
    if expanded > 4096:                      # matches moe._capacity
        expanded *= cfg.capacity_factor
    router = 2 * tokens * cfg.d_model * cfg.num_experts
    nmat = 3 if cfg.mlp_act in ("swiglu", "geglu") else 2
    experts = 2 * nmat * expanded * cfg.d_model * cfg.moe_d_ff
    shared = (_ffn_flops(cfg, tokens, cfg.moe_d_ff * cfg.num_shared_experts)
              if cfg.num_shared_experts else 0)
    return router + experts + shared


def _ssd_flops(cfg, tokens, *, decode=False):
    s = cfg.ssm
    d = cfg.d_model
    di = s.d_inner(d)
    H = s.num_heads(d)
    P, G, N = s.head_dim, s.num_groups, s.d_state
    gn = G * N
    proj = 2 * tokens * d * (2 * di + 2 * gn + H) + 2 * tokens * di * d
    conv = 2 * tokens * (di + 2 * gn) * s.conv_width
    if decode:
        state = 2 * tokens * H * P * N * 2           # update + output
        return proj + conv + state
    Q = s.chunk_size
    intra = 2 * tokens * Q * G * N + 2 * tokens * Q * H * P * 2
    inter = 2 * tokens * H * P * N * 2               # states + y_off
    return proj + conv + intra + inter


def _layer_forward_flops(cfg, i, tokens, ctx, *, decode=False,
                         executed_ctx=None):
    if cfg.is_attn_layer(i):
        if cfg.use_mla:
            f = _mla_flops(cfg, tokens, ctx, decode=decode,
                           executed_ctx=executed_ctx)
        else:
            f = _attn_flops(cfg, tokens, ctx, executed_ctx=executed_ctx)
    else:
        f = _ssd_flops(cfg, tokens, decode=decode)
    if cfg.is_moe_layer(i):
        f += _moe_flops(cfg, tokens)
    elif cfg.d_ff:
        f += _ffn_flops(cfg, tokens, cfg.d_ff)
    return f


def forward_flops(cfg: ModelConfig, shape: ShapeConfig, *,
                  executed_attention: str = "full") -> Dict[str, float]:
    """Global forward FLOPs by component.

    executed_attention: 'full' = masked full rectangle (jnp blocked path),
    'causal' = triangular (Pallas block-skip), relevant to train/prefill.
    """
    B, S = shape.global_batch, shape.seq_len
    decode = shape.kind == "decode"
    tokens = B * (1 if decode else S)
    ctx = S
    if decode:
        w = decode_window(cfg, shape)
        # H3: windowed decode slices the live cache window instead of
        # masking the full cache (before-state: executed_ctx = ctx).
        executed_ctx = min(w, ctx) if (w and ctx > 2 * w) else ctx
        useful_ctx = min(w, ctx) if w else ctx
    else:
        executed_ctx = ctx if executed_attention == "full" else (ctx + 1) / 2
        useful_ctx = (ctx + 1) / 2

    layers = 0.0
    for i in range(cfg.num_layers):
        layers += _layer_forward_flops(cfg, i, tokens, ctx, decode=decode,
                                       executed_ctx=executed_ctx)
    enc = 0.0
    if cfg.is_encoder_decoder:
        enc_tokens = 0 if decode else tokens
        for _ in range(cfg.num_encoder_layers):
            if enc_tokens:
                enc += _attn_flops(cfg, enc_tokens, S, executed_ctx=S)
                enc += _ffn_flops(cfg, enc_tokens, cfg.d_ff)
        # cross-attention inside decoder layers
        mem = cfg.encoder_seq_len if decode else S
        enc += cfg.num_layers * _attn_flops(cfg, tokens, mem,
                                            executed_ctx=mem)
    loss_tokens = tokens if shape.kind == "train" else B
    head = 2 * loss_tokens * cfg.d_model * cfg.vocab_size
    if cfg.mtp_depth and shape.kind == "train":
        head += 2 * tokens * cfg.d_model * cfg.vocab_size
        head += _layer_forward_flops(cfg, 0, tokens, ctx,
                                     executed_ctx=executed_ctx)
    return {"layers": layers, "encoder": enc, "head": head,
            "total": layers + enc + head}


def step_flops(cfg, shape, *, executed_attention="full") -> Dict[str, float]:
    """Executed FLOPs for the whole step (train = fwd+bwd+remat)."""
    fwd = forward_flops(cfg, shape, executed_attention=executed_attention)
    if shape.kind != "train":
        return dict(fwd, multiplier=1.0)
    # bwd = 2x fwd; full remat recomputes fwd once more
    mult = 4.0
    n_params = cfg.param_count()
    opt = 12.0 * n_params                 # adam elementwise update
    total = fwd["total"] * mult + opt
    return {"layers": fwd["layers"] * mult, "encoder": fwd["encoder"] * mult,
            "head": fwd["head"] * 3.0, "optimizer": opt,
            "multiplier": mult, "total": total}


# ---------------------------------------------------------------------------
# HBM byte model (global per step)
# ---------------------------------------------------------------------------


def _bytes_of(cfg):
    return 2 if cfg.param_dtype == "bfloat16" else 4


def cache_bytes(cfg, shape) -> float:
    B, S = shape.global_batch, shape.seq_len
    bts = 2 if cfg.compute_dtype == "bfloat16" else 4
    total = 0.0
    for i in range(cfg.num_layers):
        if cfg.is_attn_layer(i):
            if cfg.use_mla:
                m = cfg.mla
                total += B * S * (m.kv_lora_rank + m.qk_rope_head_dim) * bts
            else:
                total += 2 * B * S * cfg.num_kv_heads * cfg.head_dim * bts
        elif cfg.ssm is not None:
            s = cfg.ssm
            d = cfg.d_model
            total += B * s.num_heads(d) * s.head_dim * s.d_state * 4
            total += B * (s.conv_width - 1) * (s.d_inner(d)
                                               + 2 * s.num_groups * s.d_state) * bts
    if cfg.is_encoder_decoder:
        total += 2 * B * cfg.encoder_seq_len * cfg.kv_dim * 2 * bts
    return total


def step_bytes(cfg, shape, mesh: MeshShape, num_microbatches: int = 1
               ) -> Dict[str, float]:
    """Global HBM traffic model.  Terms documented inline."""
    B, S = shape.global_batch, shape.seq_len
    decode = shape.kind == "decode"
    tokens = B * (1 if decode else S)
    pbytes = cfg.param_count() * _bytes_of(cfg)
    abytes = 2 if cfg.compute_dtype == "bfloat16" else 4
    G = num_microbatches

    terms: Dict[str, float] = {}
    if shape.kind == "train":
        # weights: read fwd + remat + bwd per microbatch (FSDP regathers)
        terms["weights"] = 3.0 * G * pbytes
        # optimizer: read m,v + write m,v,p + grads read/write (f32)
        terms["optimizer"] = 9.0 * cfg.param_count() * 4.0
        # activations: residual stream in/out per layer x 3 passes
        terms["activations"] = (cfg.num_layers
                                * 4.0 * tokens * cfg.d_model * abytes * 3.0)
    else:
        terms["weights"] = (cfg.active_param_count() if decode
                            else cfg.param_count()) * _bytes_of(cfg)
        terms["activations"] = (cfg.num_layers
                                * 4.0 * tokens * cfg.d_model * abytes)
    if shape.kind != "train":
        cb = cache_bytes(cfg, shape)
        if decode:
            # H3: windowed decode reads only the live window of the
            # attention caches (SSM caches are O(1) regardless).
            w = decode_window(cfg, shape)
            if w and S > 2 * w:
                cb = cb * (w / S)
        terms["kv_cache"] = cb
    # attention score traffic is kept on-chip by the blocked path (VMEM) —
    # only block-boundary spills modelled via activations term.
    terms["total"] = sum(v for k, v in terms.items() if k != "total")
    return terms


# ---------------------------------------------------------------------------
# Collective byte model (global per step)
# ---------------------------------------------------------------------------


def step_collective_bytes(cfg, shape, mesh: MeshShape,
                          num_microbatches: int = 1) -> Dict[str, float]:
    B, S = shape.global_batch, shape.seq_len
    decode = shape.kind == "decode"
    tokens = B * (1 if decode else S)
    abytes = 2 if cfg.compute_dtype == "bfloat16" else 4
    pbytes = cfg.param_count() * _bytes_of(cfg)
    G = num_microbatches
    dp, tp = mesh.dp, mesh.tp
    terms: Dict[str, float] = {}

    # H2: routed-expert params are EP-sharded over 'data' — they never
    # FSDP-gather or grad-reduce over that axis (tokens move instead).
    n_fsdp_params = cfg.param_count() - cfg.routed_expert_param_count()
    fsdp_bytes = n_fsdp_params * _bytes_of(cfg)
    if shape.kind == "train":
        # FSDP param all-gather: fwd + remat + bwd, per microbatch.
        terms["fsdp_allgather"] = 3.0 * G * fsdp_bytes * (dp - 1) / dp
        # gradient reduction over data axis (f32)
        terms["grad_reduce"] = 2.0 * n_fsdp_params * 4.0 * (dp - 1) / dp
    else:
        terms["weight_allgather"] = fsdp_bytes * (dp - 1) / dp  # serve read

    # tensor-parallel activation reductions: ~2 per layer per pass.
    # NOTE: each token makes 3 passes (fwd/remat/bwd) regardless of G —
    # microbatching moves tokens between passes, it doesn't add any.
    passes = 3.0 if shape.kind == "train" else 1.0
    n_tp_layers = cfg.num_layers
    terms["tp_allreduce"] = (2.0 * n_tp_layers * passes * tokens
                             * cfg.d_model * abytes * (tp - 1) / tp)

    # MoE all-to-all: expanded tokens out + back, per pass, over the
    # expert-parallel (data) axis per H2.
    n_moe = sum(cfg.is_moe_layer(i) for i in range(cfg.num_layers))
    if n_moe:
        expanded = tokens * cfg.experts_per_token
        terms["moe_all_to_all"] = (2.0 * n_moe * passes * expanded
                                   * cfg.d_model * abytes * (dp - 1) / dp)

    # loss/logit reductions (vocab sharded over tp)
    loss_tokens = tokens if shape.kind == "train" else B
    terms["logit_reduce"] = 3.0 * loss_tokens * 4.0 * (tp - 1) / tp * (
        2.0 if shape.kind == "train" else 1.0)
    if decode:
        # flash-decode partial-softmax combine per attention layer
        n_attn = sum(cfg.is_attn_layer(i) for i in range(cfg.num_layers))
        heads = cfg.num_heads
        dv = (cfg.mla.v_head_dim if cfg.use_mla else cfg.head_dim)
        terms["decode_softmax_combine"] = (n_attn * B * heads
                                           * (dv + 2) * 4.0 * (tp - 1) / tp)
        # token logits all-gather to host
        terms["logit_gather"] = B * cfg.vocab_size * 4.0 * (tp - 1) / tp

    terms["total"] = sum(v for k, v in terms.items() if k != "total")
    return terms


# ---------------------------------------------------------------------------
# Assembled roofline
# ---------------------------------------------------------------------------


def roofline_terms(cfg: ModelConfig, shape: ShapeConfig, mesh,
                   num_microbatches: int = 1,
                   executed_attention: str = "full") -> Dict:
    ms = mesh_shape_of(mesh) if not isinstance(mesh, MeshShape) else mesh
    fl = step_flops(cfg, shape, executed_attention=executed_attention)
    by = step_bytes(cfg, shape, ms, num_microbatches)
    co = step_collective_bytes(cfg, shape, ms, num_microbatches)
    chips = ms.chips
    compute_s = fl["total"] / (chips * HW.peak_flops)
    memory_s = by["total"] / (chips * HW.hbm_bw)
    collective_s = co["total"] / (chips * HW.ici_bw)
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    bottleneck = max(terms, key=terms.get)
    n_active = cfg.active_param_count()
    tokens = shape.global_batch * (shape.seq_len
                                   if shape.kind != "decode" else 1)
    model_fl = (6.0 if shape.kind == "train" else 2.0) * n_active * tokens
    return {
        "compute_s": compute_s, "memory_s": memory_s,
        "collective_s": collective_s, "bottleneck": bottleneck,
        "step_s_bound": max(terms.values()),
        "model_flops": model_fl,
        "executed_flops": fl["total"],
        "useful_flop_ratio": model_fl / fl["total"] if fl["total"] else None,
        "flops_breakdown": fl, "bytes_breakdown": by,
        "collective_breakdown": co, "chips": chips,
    }
