"""gemma3-4b [dense] — 5:1 local:global attention, 128k context.

[hf:google/gemma-3-1b-pt scaled to 4b]  Local layers: sliding window 1024.
Every 6th layer is global (full attention). Runs long_500k: decode cost is
dominated by the windowed layers (O(W) KV); the 1-in-6 global layers keep
a full cache sharded over the model axis.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-4b",
    arch_type="dense",
    source="hf:google/gemma-3-1b-pt",
    num_layers=34,
    d_model=2560,
    num_heads=8,
    num_kv_heads=4,
    head_dim=256,
    d_ff=10240,
    vocab_size=262144,
    sliding_window=1024,
    global_every=6,
    rope_theta=1e6,
    qk_norm=True,
).with_updates(sharding_profile="fsdp")
