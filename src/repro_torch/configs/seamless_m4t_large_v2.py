"""seamless-m4t-large-v2 [audio] — encoder-decoder, multimodal.

[arXiv:2308.11596]  24 encoder + 24 decoder layers at d_model=1024
(the model card's speech-encoder / text-decoder split; see DESIGN.md §6).
The mel-spectrogram + conformer-conv feature extractor is the stubbed
modality frontend — `input_specs()` supplies precomputed frame embeddings.
LayerNorm + GeLU FFN (fairseq lineage); RoPE used for decoder self-attn
as a TPU-idiomatic adaptation.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    arch_type="audio",
    source="arXiv:2308.11596",
    num_layers=24,
    encoder_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=8192,
    vocab_size=256206,
    modality="audio",
    num_frames=1024,
    norm_type="layernorm",
    tie_embeddings=False,
).with_updates(sharding_profile="fsdp")
