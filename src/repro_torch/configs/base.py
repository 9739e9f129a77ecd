"""Unified model configuration for every architecture of the model zoo
(port of `repro.configs.base`: the same fields, defaults, `reduced()`,
`layer_kinds()` and `with_updates()`; `activation_dtype` and
`parameter_dtype` return torch dtypes)."""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    arch_type: str = "dense"      # dense|moe|ssm|hybrid|vlm|audio|cnn
    source: str = ""              # citation: paper / model card
    num_layers: int = 2
    d_model: int = 256
    num_heads: int = 4
    num_kv_heads: int = 4
    head_dim: int = 64
    d_ff: int = 512
    vocab_size: int = 1024

    # attention
    attn_impl: str = "einsum"      # einsum | chunked (online-softmax) | flash
    attn_chunk: int = 512          # KV chunk for the chunked impl
    attention_kind: str = "gqa"    # gqa | mla
    qk_norm: bool = False
    use_rope: bool = True
    rope_theta: float = 1e4
    sliding_window: int = 0        # >0: window size for local layers
    global_every: int = 0          # gemma3: every Nth layer is global (1-indexed)
    # MLA (deepseek)
    kv_lora_rank: int = 0
    qk_rope_dim: int = 64
    qk_nope_dim: int = 128
    v_head_dim: int = 128

    # MoE
    moe: bool = False
    num_experts: int = 0
    num_shared_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    moe_group_size: int = 512
    aux_loss_weight: float = 0.01

    # SSM / hybrid / xLSTM
    block_pattern: Tuple[str, ...] = ()   # per-layer: attn|mamba|slstm|mlstm
    shared_attn_every: int = 0            # zamba2: shared attn block cadence
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_chunk: int = 128
    mamba_expand: int = 2
    conv_dim: int = 4
    xlstm_proj_factor: float = 2.0
    mlstm_impl: str = "parallel"   # parallel | chunked
    mlstm_chunk: int = 256

    # encoder-decoder
    encoder_layers: int = 0

    # modality frontend stubs
    modality: str = "text"        # text | vision | audio
    num_patches: int = 0          # vision: patch embeddings prepended
    num_frames: int = 0           # audio: encoder input frames

    # distribution
    sharding_profile: str = "tp"  # tp | dp | fsdp | moe (see sharding/specs)
    grad_accum: int = 1           # microbatches per optimizer step

    # numerics / compilation
    norm_type: str = "rmsnorm"    # rmsnorm | layernorm
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    remat: bool = True
    scan_layers: bool = True
    tie_embeddings: bool = True
    logits_softcap: float = 0.0

    def with_updates(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    @property
    def activation_dtype(self):
        return {"bfloat16": torch.bfloat16, "float32": torch.float32,
                "float16": torch.float16}[self.dtype]

    @property
    def parameter_dtype(self):
        return {"bfloat16": torch.bfloat16,
                "float32": torch.float32}[self.param_dtype]

    def layer_kinds(self) -> Tuple[str, ...]:
        """Resolve the per-layer block pattern."""
        if self.block_pattern:
            return self.block_pattern
        return ("attn",) * self.num_layers

    def reduced(self, **kw) -> "ModelConfig":
        """Smoke-test-sized variant of the same family (2 layers, tiny dims)."""
        upd = dict(
            num_layers=2,
            d_model=min(self.d_model, 256),
            num_heads=min(self.num_heads, 4),
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            head_dim=min(self.head_dim, 64),
            moe_group_size=64,
        )
        upd["num_kv_heads"] = min(self.num_kv_heads, upd["num_heads"])
        if self.num_experts:
            upd["num_experts"] = min(self.num_experts, 4)
            upd["top_k"] = min(self.top_k, 2)
        if self.kv_lora_rank:
            upd["kv_lora_rank"] = 64
            upd["qk_nope_dim"] = 32
            upd["qk_rope_dim"] = 16
            upd["v_head_dim"] = 32
        if self.encoder_layers:
            upd["encoder_layers"] = 2
        if self.block_pattern:
            upd["block_pattern"] = self.block_pattern[:2]
        if self.num_patches:
            upd["num_patches"] = 8
        if self.num_frames:
            upd["num_frames"] = 16
        if self.shared_attn_every:
            upd["shared_attn_every"] = 2
            upd["block_pattern"] = ("mamba", "mamba")
        if self.ssm_state:
            upd["ssm_state"] = min(self.ssm_state, 16)
            upd["ssm_head_dim"] = 32
        upd.update(kw)
        return self.with_updates(**upd)


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str              # train | prefill | decode


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}
