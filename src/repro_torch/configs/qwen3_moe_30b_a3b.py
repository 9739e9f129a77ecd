"""qwen3-moe-30b-a3b [moe] — 128 experts, top-8, GQA kv=4, qk-norm.

[hf:Qwen/Qwen3-30B-A3B]  d_ff=768 is the *per-expert* intermediate size.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    arch_type="moe",
    source="hf:Qwen/Qwen3-30B-A3B",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=768,
    vocab_size=151936,
    qk_norm=True,
    moe=True,
    num_experts=128,
    top_k=8,
    rope_theta=1e6,
).with_updates(sharding_profile="moe")
