"""phi-3-vision-4.2b [vlm] — phi3-mini backbone + CLIP vision frontend.

[hf:microsoft/Phi-3-vision-128k-instruct]
Backbone transformer only; the ViT/projector is the stubbed modality
frontend — `input_specs()` supplies 576 precomputed patch embeddings at
d_model, prepended to the token sequence.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b",
    arch_type="vlm",
    source="hf:microsoft/Phi-3-vision-128k-instruct",
    num_layers=32,
    d_model=3072,
    num_heads=32,
    num_kv_heads=32,
    head_dim=96,
    d_ff=8192,
    vocab_size=32064,
    modality="vision",
    num_patches=576,
    rope_theta=1e4,
).with_updates(sharding_profile="fsdp")
