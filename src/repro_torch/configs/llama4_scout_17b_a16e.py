"""Llama-4 Scout 17B-A16E — MoE with top-1 routing + shared expert.

[hf:meta-llama/Llama-4-Scout-17B-16E]  48 layers, d_model 5120, 40 heads
(GQA kv=8), expert d_ff 8192, vocab 202048, 16 routed experts top-1 plus
one always-on shared expert on every layer (interleave step 1).  The
vision early-fusion frontend is a stub by assignment.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    arch_type="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202048,
    num_experts=16,
    experts_per_token=1,
    num_shared_experts=1,
    moe_d_ff=8192,
    mlp_act="swiglu",
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
)
