"""Autoregressive decode for the `attn` and `mamba` layer kinds: per-layer
state and the one-token step (port of `repro.models.decode`).

Decode is an unrolled loop over layers, so per-layer state shapes may
differ: full KV, sliding-window ring KV, or Mamba2 recurrent state, plus
zamba2's shared-block caches under "shared". The state is a dict of
lists of dicts of tensors; its "index" (tokens so far) is a Python int.
"""
from __future__ import annotations

from typing import Any, Dict, List

import torch

from repro_torch.models import attention as attn_mod
from repro_torch.models import layers, ssm
from repro_torch.models.layers import apply_norm, dense, embed, unembed
from repro_torch.models.transformer import (check_supported, layer_params,
                                            uses_shared)


def _layer_state(cfg, kind, batch, capacity, window, dtype, device):
    Hk, dh = cfg.num_kv_heads, cfg.head_dim
    if kind == "attn":
        cap = min(window, capacity) if window else capacity
        return {"k": torch.zeros((batch, cap, Hk, dh), dtype=dtype,
                                 device=device),
                "v": torch.zeros((batch, cap, Hk, dh), dtype=dtype,
                                 device=device)}
    if kind == "mamba":
        H = ssm.ssm_heads(cfg)
        return {"conv": torch.zeros((batch, cfg.conv_dim - 1,
                                     ssm.conv_channels(cfg)), dtype=dtype,
                                    device=device),
                "ssm": torch.zeros((batch, H, cfg.ssm_head_dim,
                                    cfg.ssm_state), dtype=torch.float32,
                                   device=device)}
    raise ValueError(kind)


def _decode_window(cfg, layer_idx):
    if cfg.sliding_window and cfg.global_every:
        is_global = (layer_idx + 1) % cfg.global_every == 0
        return 0 if is_global else cfg.sliding_window
    return cfg.sliding_window


def init_decode_state(cfg, batch, capacity, prefill_len=0,
                      device="cuda") -> Dict[str, Any]:
    """The empty (or stand-in) decode state on `device`."""
    check_supported(cfg)
    dtype = cfg.activation_dtype
    state: Dict[str, Any] = {
        "index": int(prefill_len),
        "layers": [_layer_state(cfg, kind, batch, capacity,
                                _decode_window(cfg, i), dtype, device)
                   for i, kind in enumerate(cfg.layer_kinds())],
    }
    if cfg.shared_attn_every:
        n_inv = sum(1 for i in range(cfg.num_layers)
                    if i > 0 and i % cfg.shared_attn_every == 0)
        state["shared"] = [_layer_state(cfg, "attn", batch, capacity, 0,
                                        dtype, device)
                           for _ in range(n_inv)]
    return state


def _attn_decode(lp, cfg, x, st, index, window):
    positions = torch.full((x.shape[0], 1), index, dtype=torch.int32,
                           device=x.device)
    h = apply_norm(cfg.norm_type, lp["attn_norm"], x, cfg.norm_eps)
    a, (ck, cv) = attn_mod.attention(
        lp["attn"], cfg, h, positions=positions,
        cache_kv=(st["k"], st["v"]), cache_index=index, window=window)
    x = x + a
    if "mlp" in lp:
        h = apply_norm(cfg.norm_type, lp["mlp_norm"], x, cfg.norm_eps)
        if cfg.norm_type == "layernorm":
            y = layers.gelu_mlp(lp["mlp"], h)
        else:
            y = layers.swiglu_mlp(lp["mlp"], h)
        x = x + y
    return x, {"k": ck, "v": cv}


def decode_step(params, cfg, state, tokens):
    """tokens: (B, 1) -> (logits (B, 1, V) float32, new_state). The step
    writes the new token's keys and values into the KV caches of `state`
    in place (`kvcache.update_layer`)."""
    adt = cfg.activation_dtype
    index = state["index"]
    x = embed(params["embed"], tokens, adt)
    new_layer_states: List[Any] = []
    new_shared = list(state.get("shared", []))
    shared_i = 0

    for i, kind in enumerate(cfg.layer_kinds()):
        lp = layer_params(params, i)
        st = state["layers"][i]
        if uses_shared(cfg, i):
            x, new_shared[shared_i] = _attn_decode(
                params["shared_attn"], cfg, x, state["shared"][shared_i],
                index, 0)
            shared_i += 1
        if kind == "attn":
            x, st = _attn_decode(lp, cfg, x, st, index,
                                 _decode_window(cfg, i))
        elif kind == "mamba":
            h = apply_norm(cfg.norm_type, lp["norm"], x, cfg.norm_eps)
            y, conv, s = ssm.mamba2_step(lp["mamba"], cfg, h,
                                         st["conv"], st["ssm"])
            x, st = x + y, {"conv": conv, "ssm": s}
        else:
            raise ValueError(kind)
        new_layer_states.append(st)

    x = apply_norm(cfg.norm_type, params["final_norm"], x, cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = unembed(params["embed"], x)
    else:
        logits = dense(params["unembed"], x).float()

    new_state = dict(state)
    new_state["index"] = index + 1
    new_state["layers"] = new_layer_states
    if cfg.shared_attn_every:
        new_state["shared"] = new_shared
    return logits, new_state


def greedy_generate(params, cfg, prompt_tokens, num_steps, capacity=None):
    """Token-by-token prefill of the prompt, then `num_steps` greedy
    tokens. prompt: (B, S0) -> (B, S0 + num_steps)."""
    B, S0 = prompt_tokens.shape
    capacity = capacity or (S0 + num_steps)
    state = init_decode_state(cfg, B, capacity, device=prompt_tokens.device)
    tok = prompt_tokens[:, :1]
    out = [tok]
    for t in range(S0 + num_steps - 1):
        logits, state = decode_step(params, cfg, state, tok)
        if t + 1 < S0:
            tok = prompt_tokens[:, t + 1:t + 2]
        else:
            tok = torch.argmax(logits[:, -1:, :], dim=-1).to(
                prompt_tokens.dtype)
        out.append(tok)
    return torch.cat(out, dim=1)
