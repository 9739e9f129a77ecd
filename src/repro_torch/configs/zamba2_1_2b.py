"""zamba2-1.2b [hybrid] — Mamba2 backbone + one shared attention block.

[arXiv:2411.15242]  38 Mamba2 layers; a single shared attention+MLP block
(32H, d_ff=8192) is invoked every 6 Mamba layers. ssm_state=64.
Sub-quadratic: runs the long_500k decode shape.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    arch_type="hybrid",
    source="arXiv:2411.15242",
    num_layers=38,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=32000,
    block_pattern=("mamba",) * 38,
    shared_attn_every=6,
    ssm_state=64,
    ssm_head_dim=64,
    mamba_expand=2,
).with_updates(sharding_profile="fsdp")
