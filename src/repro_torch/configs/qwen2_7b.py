"""Qwen2 7B — dense GQA LM with QKV bias.

[arXiv:2407.10671]  28 layers, d_model 3584, 28 heads (GQA kv=4,
head_dim 128), d_ff 18944, vocab 152064, bias on the QKV projections
(the Qwen2 signature).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-7b",
    arch_type="dense",
    num_layers=28,
    d_model=3584,
    num_heads=28,
    num_kv_heads=4,
    head_dim=128,
    d_ff=18944,
    vocab_size=152064,
    qkv_bias=True,
    mlp_act="swiglu",
    rope_theta=1_000_000.0,
    source="arXiv:2407.10671 (Qwen2 Technical Report)",
)
