"""DeepSeek-V3 671B — MLA + fine-grained MoE (1 shared + 256 routed top-8).

[arXiv:2412.19437]  61 layers (first 3 dense, d_ff 18432), d_model 7168,
128 MLA heads (q_lora 1536 / kv_lora 512 / nope 128 / rope 64 / v 128),
256 routed experts top-8 with expert d_ff 2048 (= the assignment's
"d_ff=2048"), 1 shared expert, vocab 129280, depth-1 MTP head.
"""

from repro_torch.configs.base import MLAConfig, ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    arch_type="moe",
    num_layers=61,
    d_model=7168,
    num_heads=128,
    num_kv_heads=128,
    head_dim=128,
    d_ff=18432,                      # dense layers (first 3)
    vocab_size=129280,
    use_mla=True,
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                  qk_nope_head_dim=128, qk_rope_head_dim=64,
                  v_head_dim=128),
    num_experts=256,
    experts_per_token=8,
    num_shared_experts=1,
    moe_d_ff=2048,
    first_dense_layers=3,
    mtp_depth=1,
    mlp_act="swiglu",
    source="arXiv:2412.19437 (DeepSeek-V3 Technical Report)",
)
