"""yi-9b [dense] — llama-architecture GQA kv=4. [arXiv:2403.04652]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="yi-9b",
    arch_type="dense",
    source="arXiv:2403.04652",
    num_layers=48,
    d_model=4096,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=11008,
    vocab_size=64000,
    tie_embeddings=False,
).with_updates(sharding_profile="fsdp")
