"""Gemma 2B — dense LM with MQA (kv=1), GeGLU, head_dim 256.

[arXiv:2403.08295]  18 layers, d_model 2048, 8 heads with a single shared
KV head (MQA), head_dim 256, d_ff 16384, GeGLU activation, vocab 256000,
tied embeddings.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma-2b",
    arch_type="dense",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=256000,
    mlp_act="geglu",
    tie_embeddings=True,
    source="arXiv:2403.08295 (Gemma)",
)
