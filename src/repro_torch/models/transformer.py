"""The unified transformer stack for the `attn` and `mamba` layer kinds
(port of `repro.models.transformer`).

Layer kinds (per position, from `cfg.layer_kinds()`):
  attn   — GQA attention + dense FFN (swiglu, or gelu under layernorm)
  mamba  — Mamba2 SSD block (zamba2)
plus zamba2's *shared* attention block (one parameter set run before
every `shared_attn_every`-th mamba layer) and gemma3's local/global
attention pattern.

Homogeneous stacks keep their parameters stacked with a leading layer
axis under "layers", as the reference does for `lax.scan`; here a Python
loop walks the layers, and a Python `if` takes the place of the
reference's `lax.cond` for the shared block. Other stacks are the
"blocks" list. MoE and MLA attention, the xLSTM kinds, the
encoder-decoder and the vision frontend are not ported yet (ROADMAP
A.17): building such a model raises NotImplementedError.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.models import attention as attn_mod
from repro_torch.models import layers, ssm
from repro_torch.models.layers import (apply_norm, dense, embed, init_dense,
                                       init_embedding, init_norm, unembed)
from repro_torch.tree import tree_map

PORTED_KINDS = ("attn", "mamba")


def check_supported(cfg) -> None:
    """Raise NotImplementedError for what this port does not build yet."""
    missing = []
    if cfg.moe:
        missing.append("MoE FFN")
    if cfg.attention_kind != "gqa":
        missing.append(f"{cfg.attention_kind} attention")
    kinds = sorted(set(cfg.layer_kinds()) - set(PORTED_KINDS))
    if kinds:
        missing.append(f"layer kinds {kinds}")
    if cfg.encoder_layers:
        missing.append("the encoder-decoder")
    if cfg.modality != "text":
        missing.append(f"the {cfg.modality} frontend")
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(missing)} not ported yet "
            f"(ROADMAP A.17)")


# -- per-layer init ----------------------------------------------------------------

def _init_attn_layer(generator, cfg, dtype=torch.float32):
    p = {
        "attn_norm": init_norm(cfg.norm_type, cfg.d_model, dtype),
        "mlp_norm": init_norm(cfg.norm_type, cfg.d_model, dtype),
        "attn": attn_mod.init_attention(generator, cfg, dtype),
    }
    if cfg.d_ff > 0:
        if cfg.norm_type == "layernorm":   # seamless-style gelu FFN
            p["mlp"] = layers.init_gelu_mlp(generator, cfg.d_model, cfg.d_ff,
                                            dtype)
        else:
            p["mlp"] = layers.init_swiglu_mlp(generator, cfg.d_model,
                                              cfg.d_ff, dtype)
    return p


def _init_layer_of_kind(generator, cfg, kind, dtype=torch.float32):
    if kind == "attn":
        return _init_attn_layer(generator, cfg, dtype=dtype)
    if kind == "mamba":
        return {"norm": init_norm(cfg.norm_type, cfg.d_model, dtype),
                "mamba": ssm.init_mamba2(generator, cfg, dtype)}
    raise ValueError(kind)


def is_homogeneous(cfg) -> bool:
    kinds = set(cfg.layer_kinds())
    return kinds == {"attn"} or kinds == {"mamba"}


def init_transformer(generator, cfg) -> Dict[str, Any]:
    """Random parameters drawn from `generator` (a CPU torch.Generator),
    with the reference's keys, layouts and distributions (not its
    draws)."""
    check_supported(cfg)
    dtype = cfg.parameter_dtype
    p: Dict[str, Any] = {"embed": init_embedding(generator, cfg.vocab_size,
                                                 cfg.d_model, dtype)}
    kinds = cfg.layer_kinds()
    if is_homogeneous(cfg) and cfg.scan_layers:
        per_layer = [_init_layer_of_kind(generator, cfg, kinds[0], dtype)
                     for _ in range(cfg.num_layers)]
        p["layers"] = tree_map(lambda *ls: torch.stack(ls), *per_layer)
    else:
        p["blocks"] = [_init_layer_of_kind(generator, cfg, kind, dtype)
                       for kind in kinds]
    if cfg.shared_attn_every:       # zamba2's shared block
        p["shared_attn"] = _init_attn_layer(generator, cfg, dtype=dtype)
    p["final_norm"] = init_norm(cfg.norm_type, cfg.d_model, dtype)
    if not cfg.tie_embeddings:
        p["unembed"] = init_dense(generator, cfg.d_model, cfg.vocab_size,
                                  dtype=dtype)
    return p


# -- layer application (prefill) ---------------------------------------------------

def _layer_window(cfg, layer_idx):
    """Static window size for a layer (gemma3 local/global pattern)."""
    if cfg.sliding_window and cfg.global_every:
        is_global = (layer_idx + 1) % cfg.global_every == 0
        return 0 if is_global else cfg.sliding_window
    return cfg.sliding_window


def _apply_attn_layer(lp, cfg, x, *, positions, mask, window=0):
    h = apply_norm(cfg.norm_type, lp["attn_norm"], x, cfg.norm_eps)
    x = x + attn_mod.attention(lp["attn"], cfg, h, positions=positions,
                               mask=mask, window=window)
    if "mlp" in lp:
        h = apply_norm(cfg.norm_type, lp["mlp_norm"], x, cfg.norm_eps)
        if cfg.norm_type == "layernorm":
            y = layers.gelu_mlp(lp["mlp"], h)
        else:
            y = layers.swiglu_mlp(lp["mlp"], h)
        x = x + y
    return x


def _apply_kind(lp, cfg, kind, x, *, positions, mask, window=0):
    if kind == "attn":
        return _apply_attn_layer(lp, cfg, x, positions=positions, mask=mask,
                                 window=window)
    h = apply_norm(cfg.norm_type, lp["norm"], x, cfg.norm_eps)
    if kind == "mamba":
        return x + ssm.mamba2_forward(lp["mamba"], cfg, h)
    raise ValueError(kind)


def layer_params(params, i):
    """Parameters of layer i: an entry of "blocks", or a view of slice i
    of the stacked "layers"."""
    if params.get("blocks") is not None:
        return params["blocks"][i]
    return tree_map(lambda a: a[i], params["layers"])


def uses_shared(cfg, i):
    """Whether zamba2's shared block runs before layer i."""
    return bool(cfg.shared_attn_every and i > 0
                and i % cfg.shared_attn_every == 0)


def forward(params, cfg, batch):
    """batch: {"tokens": (B,S) integer}. Returns (logits (B, S, V) float32,
    aux_loss scalar). Mamba layers run the reference's prefill
    (`ssd_chunked`); the scan kernel is reached, as in the reference,
    through `ssm.mamba2_forward(..., use_kernel=True)`."""
    check_supported(cfg)
    adt = cfg.activation_dtype
    tokens = batch["tokens"]
    x = embed(params["embed"], tokens, adt)
    B, S = x.shape[:2]
    dev = x.device
    positions = torch.arange(S, dtype=torch.int32, device=dev)[None].expand(
        B, S)

    kinds = cfg.layer_kinds()
    if cfg.attn_impl == "chunked":
        # online-softmax path: no (S,S) mask tensors; windows are scalars
        masks = {"default": None, "global": None, "local": None}
    else:
        causal = attn_mod.make_attention_mask(S, S, causal=True, device=dev)
        masks = {"default": causal, "global": causal}
        if cfg.sliding_window:
            masks["local"] = attn_mod.make_attention_mask(
                S, S, causal=True, window=cfg.sliding_window, device=dev)
            if not cfg.global_every:
                masks["default"] = masks["local"]

    if params.get("layers") is not None:
        # the reference's scanned stack: the window rides on the mask, and
        # the window argument is 0 whenever a mask is given
        kind = kinds[0]
        for i in range(cfg.num_layers):
            lp = layer_params(params, i)
            if cfg.sliding_window and cfg.global_every:
                is_global = (i + 1) % cfg.global_every == 0
                if masks.get("local") is not None:
                    mask = masks["global"] if is_global else masks["local"]
                    window = 0
                else:
                    mask = None
                    window = 0 if is_global else cfg.sliding_window
            else:
                mask = masks["default"]
                window = 0 if mask is not None else cfg.sliding_window
            if uses_shared(cfg, i):
                x = _apply_attn_layer(params["shared_attn"], cfg, x,
                                      positions=positions,
                                      mask=masks["default"])
            x = _apply_kind(lp, cfg, kind, x, positions=positions, mask=mask,
                            window=window)
    else:
        for i, (lp, kind) in enumerate(zip(params["blocks"], kinds)):
            if uses_shared(cfg, i):
                x = _apply_attn_layer(params["shared_attn"], cfg, x,
                                      positions=positions,
                                      mask=masks["default"])
            w = _layer_window(cfg, i)
            mask = (masks["local"] if (w and masks.get("local") is not None)
                    else masks["default"])
            x = _apply_kind(lp, cfg, kind, x, positions=positions, mask=mask,
                            window=w)

    x = apply_norm(cfg.norm_type, params["final_norm"], x, cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = unembed(params["embed"], x)
    else:
        logits = dense(params["unembed"], x).float()
    if cfg.logits_softcap:
        logits = cfg.logits_softcap * torch.tanh(logits / cfg.logits_softcap)
    return logits, torch.zeros((), dtype=torch.float32, device=dev)


def loss_fn(params, cfg, batch):
    """Causal LM loss. labels: (B, S) with -1 = ignore. Returns
    (loss, {"nll", "aux"})."""
    logits, aux = forward(params, cfg, batch)
    labels = batch["labels"]
    logits = logits[:, -labels.shape[1]:, :]
    valid = labels >= 0
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    lse = torch.logsumexp(logits, dim=-1)                        # (B,S)
    label_logit = torch.gather(logits, -1, safe[..., None])[..., 0]
    nll = lse - label_logit
    nll = (nll * valid).sum() / torch.clamp(valid.sum(), min=1)
    return nll + cfg.aux_loss_weight * aux, {"nll": nll, "aux": aux}
