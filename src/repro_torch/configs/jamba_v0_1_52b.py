"""Jamba v0.1 52B — hybrid Mamba+attention 1:7 interleave with MoE.

[arXiv:2403.19887]  32 layers, d_model 4096, 32 heads (GQA kv=8),
d_ff 14336, vocab 65536, MoE 16 experts top-2 on every other layer,
attention on 1 of every 8 layers (offset 4).
"""

from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    arch_type="hybrid",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=65536,
    attn_period=8,
    attn_offset=4,
    num_experts=16,
    experts_per_token=2,
    moe_d_ff=14336,
    moe_period=2,
    moe_offset=1,
    ssm=SSMConfig(d_state=16, head_dim=64, num_groups=1, conv_width=4,
                  chunk_size=256, expand=2),
    mlp_act="swiglu",
    source="arXiv:2403.19887 (Jamba: A Hybrid Transformer-Mamba Language Model)",
)
