"""Mamba2 2.7B — attention-free SSM via SSD (state-space duality).

[arXiv:2405.21060]  64 layers, d_model 2560 (d_inner 5120, 80 heads of
P=64), state N=128, no FFN (d_ff=0), vocab 50280, tied embeddings.
"""

from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    arch_type="ssm",
    num_layers=64,
    d_model=2560,
    num_heads=0,
    num_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab_size=50280,
    attn_period=0,                   # attention-free
    ssm=SSMConfig(d_state=128, head_dim=64, num_groups=1, conv_width=4,
                  chunk_size=256, expand=2),
    tie_embeddings=True,
    source="arXiv:2405.21060 (Transformers are SSMs / Mamba-2)",
)
