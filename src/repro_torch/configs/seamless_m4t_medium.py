"""SeamlessM4T-medium — speech encoder-decoder transformer backbone.

[arXiv:2308.11596]  12 encoder + 12 decoder layers, d_model 1024, 16 heads
(kv=16, head_dim 64), d_ff 4096, vocab 256206.  The mel-spectrogram +
conv feature extractor frontend is a stub by assignment: ``input_specs``
supplies precomputed frame embeddings (B, T_src, d_model).  Norms are
RMSNorm (adaptation from the original LayerNorm; DESIGN.md §8).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    arch_type="audio",
    num_layers=12,                   # decoder layers
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=256206,
    is_encoder_decoder=True,
    num_encoder_layers=12,
    encoder_seq_len=1024,
    modality="audio",
    mlp_act="gelu",
    source="arXiv:2308.11596 (SeamlessM4T)",
)
