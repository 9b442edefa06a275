"""Moonlight (Kimi) 16B-A3B — MoE LM, 64 experts top-6.

[hf:moonshotai/Moonlight-16B-A3B]  Assignment spec: 48 layers, d_model
2048, 16 heads (kv=16, i.e. MHA), expert d_ff 1408, vocab 163840, MoE 64
experts top-6.  Following the Moonlight card we add 2 shared experts and
keep the first layer dense (dense d_ff = 8x expert width = 11264).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    arch_type="dense",               # assignment bracket
    num_layers=48,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=11264,                      # first dense layer
    vocab_size=163840,
    num_experts=64,
    experts_per_token=6,
    num_shared_experts=2,
    moe_d_ff=1408,
    first_dense_layers=1,
    mlp_act="swiglu",
    source="hf:moonshotai/Moonlight-16B-A3B",
)
