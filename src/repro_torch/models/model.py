"""Public model API: build, init, prefill, loss and decode entry points
for every config of the zoo, and the dry-run input specs (port of
`repro.models.model`).

The specs are tensors on the "meta" device, the port's
`jax.ShapeDtypeStruct`: shapes and dtypes, no storage. They carry the
reference's shapes and dtypes but one: its int32 tokens and labels are
int64 here, the type the port's embedding gather and loss take.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.device import resolve_device
from repro_torch.models import decode as decode_mod
from repro_torch.models import transformer
from repro_torch.tree import tree_leaves, tree_map


class Model:
    """Thin functional wrapper around the unified transformer."""

    def __init__(self, cfg):
        self.cfg = cfg

    def init(self, generator, device="cuda"):
        """Random parameters drawn from `generator` and moved to `device`:
        a CPU torch.Generator draws on the host (one seed, the same
        tensors on every device), a CUDA one on its card."""
        dev = resolve_device(device)
        with torch.device(generator.device):
            params = transformer.init_transformer(generator, self.cfg)
        return tree_map(lambda a: a.to(dev), params)

    def apply(self, params, batch):
        return transformer.forward(params, self.cfg, batch)

    def loss(self, params, batch, token_mean=None):
        return transformer.loss_fn(params, self.cfg, batch, token_mean)

    def init_decode_state(self, batch, capacity, prefill_len=0,
                          device="cuda"):
        return decode_mod.init_decode_state(self.cfg, batch, capacity,
                                            prefill_len,
                                            device=resolve_device(device))

    def decode_step(self, params, state, tokens):
        return decode_mod.decode_step(params, self.cfg, state, tokens)

    def param_count(self, params) -> int:
        return sum(p.numel() for p in tree_leaves(params))

    # -- dry-run input specs (no allocation) ---------------------------------

    def param_specs(self) -> Dict[str, Any]:
        """The parameter tree on the meta device: shapes and dtypes of
        `init`, no storage and no draw (the reference's
        `jax.eval_shape(model.init, key)`)."""
        with _META:
            return transformer.init_transformer(torch.Generator(), self.cfg)

    def train_batch_specs(self, global_batch, seq_len) -> Dict[str, Any]:
        cfg = self.cfg
        specs = {"tokens": _spec((global_batch, seq_len), torch.int64),
                 "labels": _spec((global_batch, seq_len), torch.int64)}
        if cfg.modality == "vision":
            specs["vision_embeds"] = _spec(
                (global_batch, cfg.num_patches, cfg.d_model), torch.bfloat16)
        if cfg.encoder_layers:
            specs["audio_frames"] = _spec(
                (global_batch, cfg.num_frames, cfg.d_model), torch.bfloat16)
        return specs

    def decode_state_specs(self, batch, capacity) -> Any:
        """The decode state as `init_decode_state` builds it with
        `prefill_len = capacity - 1`, its tensors on the meta device (its
        "index" a 0-d int32 tensor there, as the reference's is a scalar
        int32 spec)."""
        return decode_mod.init_decode_state(
            self.cfg, batch, capacity, prefill_len=capacity - 1,
            device=_META)

    def decode_token_specs(self, batch):
        return _spec((batch, 1), torch.int64)


_META = torch.device("meta")


def _spec(shape, dtype):
    return torch.empty(shape, dtype=dtype, device=_META)


def build_model(cfg) -> Model:
    return Model(cfg)


def synthetic_train_batch(generator, cfg, batch, seq_len,
                          device="cuda") -> Dict[str, Any]:
    """A random token batch drawn from `generator` (a CPU
    torch.Generator) on `device`; labels are the tokens shifted left, -1
    at the end. The vision frontend adds "vision_embeds" (batch,
    num_patches, d_model) and the encoder "audio_frames" (batch,
    num_frames, d_model), bfloat16 standard normals."""
    dev = resolve_device(device)
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq_len),
                           generator=generator, dtype=torch.int64)
    labels = torch.cat([tokens[:, 1:],
                        torch.full((batch, 1), -1, dtype=torch.int64)], 1)
    b = {"tokens": tokens.to(dev), "labels": labels.to(dev)}
    if cfg.modality == "vision":
        b["vision_embeds"] = torch.randn(
            (batch, cfg.num_patches, cfg.d_model),
            generator=generator).to(dev, torch.bfloat16)
    if cfg.encoder_layers:
        b["audio_frames"] = torch.randn(
            (batch, cfg.num_frames, cfg.d_model),
            generator=generator).to(dev, torch.bfloat16)
    return b
