"""phi3-mini-3.8b [dense] — RoPE, SwiGLU, GQA kv=32. [arXiv:2404.14219]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi3-mini-3.8b",
    arch_type="dense",
    source="arXiv:2404.14219",
    num_layers=32,
    d_model=3072,
    num_heads=32,
    num_kv_heads=32,
    head_dim=96,
    d_ff=8192,
    vocab_size=32064,
).with_updates(sharding_profile="fsdp")
