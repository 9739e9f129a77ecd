"""qwen3-32b [dense] — 64L, GQA kv=8, qk-norm. [hf:Qwen/Qwen3-8B scaled]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-32b",
    arch_type="dense",
    source="hf:Qwen/Qwen3-8B",
    num_layers=64,
    d_model=5120,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=25600,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1e6,
    tie_embeddings=False,
).with_updates(sharding_profile="fsdp")
