"""xlstm-125m [ssm] — mLSTM blocks with sLSTM at positions 3, 7, 11.

[arXiv:2405.04517]  d_ff=0: blocks carry their own projections
(mLSTM proj_factor=2). Sub-quadratic decode: runs long_500k.
"""
from repro_torch.configs.base import ModelConfig

_PATTERN = tuple(
    "slstm" if i in (3, 7, 11) else "mlstm" for i in range(12))

CONFIG = ModelConfig(
    name="xlstm-125m",
    arch_type="ssm",
    source="arXiv:2405.04517",
    num_layers=12,
    d_model=768,
    num_heads=4,
    num_kv_heads=4,
    head_dim=192,
    d_ff=0,
    vocab_size=50304,
    block_pattern=_PATTERN,
    xlstm_proj_factor=2.0,
    scan_layers=False,
).with_updates(sharding_profile="dp")
