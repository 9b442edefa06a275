"""InternVL2-26B — VLM; InternLM2-20B language backbone + ViT stub.

[arXiv:2404.16821]  Language model: 48 layers, d_model 6144, 48 heads
(GQA kv=8), d_ff 16384, vocab 92553.  The InternViT-6B vision encoder +
MLP projector is a stub by assignment: ``input_specs`` supplies 256
projected patch embeddings (B, 256, d_model) prepended to the text
sequence; no LM loss on patch positions.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b",
    arch_type="vlm",
    num_layers=48,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=92553,
    modality="vision",
    num_prefix_embeds=256,
    mlp_act="swiglu",
    source="arXiv:2404.16821 (InternVL 1.5/2 family)",
)
