"""deepseek-v2-lite-16b [moe] — MLA (kv_lora=512) + MoE top-6.

[arXiv:2405.04434]  Assignment line says "MoE 64e top-6" while its bracket
note says "160 routed"; we follow the primary spec: 64 routed experts,
top-6, + 2 shared experts, per-expert d_ff=1408 (see DESIGN.md §6).
All layers MoE (the real model's single dense first layer is folded into
the MoE stack so the scan stays homogeneous; noted deviation).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    arch_type="moe",
    source="arXiv:2405.04434",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab_size=102400,
    attention_kind="mla",
    kv_lora_rank=512,
    qk_rope_dim=64,
    qk_nope_dim=128,
    v_head_dim=128,
    moe=True,
    num_experts=64,
    num_shared_experts=2,
    top_k=6,
).with_updates(sharding_profile="moe")
