"""Qwen3 14B — dense GQA LM with qk-norm.

[hf:Qwen/Qwen3-8B family]  Assignment spec: 40 layers, d_model 5120,
40 heads (GQA kv=8, head_dim 128), d_ff 17408, vocab 151936, per-head
RMS qk-norm (the Qwen3 signature), no QKV bias.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-14b",
    arch_type="dense",
    num_layers=40,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=17408,
    vocab_size=151936,
    qk_norm=True,
    mlp_act="swiglu",
    rope_theta=1_000_000.0,
    source="hf:Qwen/Qwen3-8B (Qwen3 family card)",
)
