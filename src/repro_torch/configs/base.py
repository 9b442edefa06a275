"""Configuration dataclasses for the repro framework.

``ModelConfig`` is the single source of truth for a model architecture.  It
covers every architecture family assigned to this paper (dense / MoE / SSM /
hybrid / encoder-decoder audio / VLM) through optional fields; the per-arch
modules consume only the fields relevant to them.

``ShapeConfig`` describes an input workload (the four assigned shapes).

Both are frozen dataclasses, copied from the JAX package's
``configs/base.py`` field for field.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional


# ---------------------------------------------------------------------------
# Model configuration
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-style Multi-head Latent Attention hyper-parameters."""

    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 (SSD) hyper-parameters."""

    d_state: int = 128           # N
    head_dim: int = 64           # P
    num_groups: int = 1          # G (B/C groups)
    conv_width: int = 4
    chunk_size: int = 256        # Q for the chunked SSD algorithm
    expand: int = 2              # d_inner = expand * d_model

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def num_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass(frozen=True)
class ModelConfig:
    """Architecture description.

    Layer-type pattern
    ------------------
    ``attn_period``/``attn_offset`` define which layers are attention in a
    hybrid model: layer ``i`` is attention iff ``i % attn_period ==
    attn_offset``.  A pure-attention model uses ``attn_period=1,
    attn_offset=0``; a pure-SSM model uses ``attn_period=0``.

    ``moe_period``/``moe_offset`` likewise select MoE FFN layers, with the
    first ``first_dense_layers`` layers forced dense (DeepSeek-V3 style).
    """

    name: str
    arch_type: str               # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128

    # --- attention options ----------------------------------------------
    qk_norm: bool = False
    qkv_bias: bool = False
    attn_window: Optional[int] = None      # sliding-window size, None = full
    long_context_window: int = 8192        # window used for long_500k decode
    rope_theta: float = 10_000.0
    use_mla: bool = False
    mla: MLAConfig = field(default_factory=MLAConfig)

    # --- layer pattern -----------------------------------------------------
    attn_period: int = 1
    attn_offset: int = 0

    # --- norms / MLP -------------------------------------------------------
    norm_eps: float = 1e-6
    mlp_act: str = "swiglu"                # swiglu | geglu | gelu | relu
    tie_embeddings: bool = False
    logit_softcap: Optional[float] = None

    # --- MoE ---------------------------------------------------------------
    num_experts: int = 0                   # 0 => dense FFN everywhere
    experts_per_token: int = 0
    num_shared_experts: int = 0
    moe_d_ff: int = 0                      # per-expert hidden dim
    first_dense_layers: int = 0
    moe_period: int = 1
    moe_offset: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    router_z_weight: float = 0.0

    # --- SSM (mamba2 / hybrid) ----------------------------------------------
    ssm: Optional[SSMConfig] = None

    # --- encoder-decoder -----------------------------------------------------
    is_encoder_decoder: bool = False
    num_encoder_layers: int = 0
    encoder_seq_len: int = 1024            # stub frontend memory length

    # --- modality frontend (stub by assignment) ------------------------------
    modality: str = "text"                 # text | audio | vision
    num_prefix_embeds: int = 0             # vision patches prepended to text

    # --- multi-token prediction (DeepSeek-V3) --------------------------------
    mtp_depth: int = 0

    # --- numerics ------------------------------------------------------------
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"

    # --- citation -------------------------------------------------------------
    source: str = ""

    # ------------------------------------------------------------------
    # Derived helpers
    # ------------------------------------------------------------------

    def is_attn_layer(self, i: int) -> bool:
        if self.attn_period == 0:
            return False
        return i % self.attn_period == self.attn_offset

    def is_moe_layer(self, i: int) -> bool:
        if self.num_experts == 0 or i < self.first_dense_layers:
            return False
        return i % self.moe_period == self.moe_offset

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    def param_count(self) -> int:
        """Approximate total parameter count (embedding + blocks + head)."""
        d = self.d_model
        n = 0
        n += self.vocab_size * d                      # embed
        if not self.tie_embeddings:
            n += self.vocab_size * d                  # lm head
        layers = range(self.num_layers)
        for i in layers:
            if self.is_attn_layer(i):
                if self.use_mla:
                    m = self.mla
                    qk_head = m.qk_nope_head_dim + m.qk_rope_head_dim
                    n += d * m.q_lora_rank + m.q_lora_rank * self.num_heads * qk_head
                    n += d * (m.kv_lora_rank + m.qk_rope_head_dim)
                    n += m.kv_lora_rank * self.num_heads * (m.qk_nope_head_dim + m.v_head_dim)
                    n += self.num_heads * m.v_head_dim * d
                else:
                    n += d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
            elif self.ssm is not None:
                di = self.ssm.d_inner(d)
                gn = self.ssm.num_groups * self.ssm.d_state
                h = self.ssm.num_heads(d)
                n += d * (2 * di + 2 * gn + h)        # in_proj
                n += di * d                           # out_proj
                n += (di + 2 * gn) * self.ssm.conv_width
            # FFN
            mult = 2 if self.mlp_act in ("swiglu", "geglu") else 1
            if self.is_moe_layer(i):
                n += d * self.num_experts             # router
                n += self.num_experts * (mult + 1) * d * self.moe_d_ff
                n += self.num_shared_experts * (mult + 1) * d * self.moe_d_ff
            else:
                if self.d_ff > 0:
                    n += (mult + 1) * d * self.d_ff
        if self.is_encoder_decoder:
            # encoder layers: self-attn + ffn; decoder already counted above.
            for _ in range(self.num_encoder_layers):
                n += d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
                mult = 2 if self.mlp_act in ("swiglu", "geglu") else 1
                n += (mult + 1) * d * self.d_ff
            # cross-attention in every decoder layer
            n += self.num_layers * (d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d)
        return n

    def routed_expert_param_count(self) -> int:
        """Parameters living in the routed-expert tensors (EP-sharded over
        the data axis per §Perf H2 — excluded from FSDP gather/reduce)."""
        if self.num_experts == 0:
            return 0
        mult = 2 if self.mlp_act in ("swiglu", "geglu") else 1
        per_expert = (mult + 1) * self.d_model * self.moe_d_ff
        n_moe = sum(self.is_moe_layer(i) for i in range(self.num_layers))
        return n_moe * self.num_experts * per_expert

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: only routed-to experts)."""
        if self.num_experts == 0:
            return self.param_count()
        full = self.param_count()
        mult = 2 if self.mlp_act in ("swiglu", "geglu") else 1
        per_expert = (mult + 1) * self.d_model * self.moe_d_ff
        num_moe_layers = sum(self.is_moe_layer(i) for i in range(self.num_layers))
        inactive = num_moe_layers * (self.num_experts - self.experts_per_token) * per_expert
        return full - inactive

    def reduced(self) -> "ModelConfig":
        """Smoke-test variant: <=2 layers, d_model<=256, <=4 experts.

        Keeps every structural feature (layer pattern, MoE, MLA, SSM,
        enc-dec) so smoke tests exercise the same code paths as the full
        config.
        """
        d = min(self.d_model, 256)
        heads = max(2, min(self.num_heads, 4))
        kv = max(1, min(self.num_kv_heads, heads))
        head_dim = max(16, min(self.head_dim, 32))
        nl = min(self.num_layers, 2)
        attn_period, attn_offset = self.attn_period, self.attn_offset
        if self.arch_type == "hybrid":
            # keep one mamba + one attn layer
            nl, attn_period, attn_offset = 2, 2, 1
        kw = dict(
            num_layers=nl,
            d_model=d,
            num_heads=heads,
            num_kv_heads=kv,
            head_dim=head_dim,
            d_ff=min(self.d_ff, 4 * d) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            attn_period=attn_period,
            attn_offset=attn_offset,
            first_dense_layers=min(self.first_dense_layers, 1),
            num_encoder_layers=min(self.num_encoder_layers, 2),
            encoder_seq_len=min(self.encoder_seq_len, 16),
            num_prefix_embeds=min(self.num_prefix_embeds, 4),
            mtp_depth=min(self.mtp_depth, 1),
            param_dtype="float32",
            compute_dtype="float32",
        )
        if self.num_experts:
            kw.update(
                num_experts=min(self.num_experts, 4),
                experts_per_token=min(self.experts_per_token, 2),
                moe_d_ff=min(self.moe_d_ff, 2 * d),
                num_shared_experts=min(self.num_shared_experts, 1),
            )
        if self.ssm is not None:
            kw["ssm"] = dataclasses.replace(
                self.ssm, d_state=16, head_dim=16, chunk_size=8)
        if self.use_mla:
            kw["mla"] = MLAConfig(
                q_lora_rank=64, kv_lora_rank=32,
                qk_nope_head_dim=head_dim, qk_rope_head_dim=16,
                v_head_dim=head_dim)
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Workload shapes
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeConfig:
    """One of the four assigned input workloads."""

    name: str
    seq_len: int
    global_batch: int
    kind: str                    # train | prefill | decode
    num_microbatches: int = 1    # gradient-accumulation factor (train only)


TRAIN_4K = ShapeConfig("train_4k", 4_096, 256, "train", num_microbatches=1)
PREFILL_32K = ShapeConfig("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32_768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524_288, 1, "decode")

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}
