"""Autoregressive decode: per-layer state and the one-token step (port of
`repro.models.decode`).

Decode is an unrolled loop over layers, so per-layer state shapes may
differ: full KV, sliding-window ring KV, the MLA latent cache, Mamba2
recurrent state or xLSTM (C, n, m) / (c, n, h, m), plus zamba2's
shared-block caches under "shared" and seamless' cross-attention K/V
under "cross". The state is a dict of lists of dicts of tensors; its
"index" (tokens so far) is the reference's 0-d int32 tensor, on the
state's device, so a step reads nothing back to the host and can be
captured as one CUDA graph (`launch.serve.make_graphed_serve_step`).

As in the reference, nothing fills "cross" from the encoder (it stays
zeros), and `decode_step` takes tokens only (no vision prefix).

On a mesh (`models.parallel.current()`) the step takes each layer's
compute slices as `transformer.forward` does: attention computes where
the rank's block of its KV cache lies (`Parallel.cache`: its kv heads, or
a block of positions whose partial softmaxes are joined over the ranks;
`models.attention`), the MLP and MoE on the rank's columns and experts,
Mamba2 whole (its state is not cut by heads), and the logits are the
rank's vocabulary columns. A stationary block (`Parallel.stationary`:
its products compute where their weights are stored) takes every row of
the batch (`Parallel.enter`), and its output holds every row too, so the
residual stream stays whole over the batch from one stationary block to
the next; any other block takes the rank's token rows.
"""
from __future__ import annotations

from typing import Any, Dict, List

import torch

from repro_torch.models import attention as attn_mod
from repro_torch.models import layers, mla, moe, parallel, ssm, xlstm
from repro_torch.models.layers import apply_norm, embed
from repro_torch.models.transformer import (_layers, _logits, _taker, _tp,
                                            uses_shared)


def _kv_state(batch, cap, Hk, dh, dtype, device):
    return {"k": torch.zeros((batch, cap, Hk, dh), dtype=dtype,
                             device=device),
            "v": torch.zeros((batch, cap, Hk, dh), dtype=dtype,
                             device=device)}


def _layer_state(cfg, kind, batch, capacity, window, dtype, device):
    Hk, dh = cfg.num_kv_heads, cfg.head_dim
    if kind == "attn":
        if cfg.attention_kind == "mla":
            return {
                "ckv": torch.zeros((batch, capacity, 1, cfg.kv_lora_rank),
                                   dtype=dtype, device=device),
                "kpe": torch.zeros((batch, capacity, 1, cfg.qk_rope_dim),
                                   dtype=dtype, device=device)}
        cap = min(window, capacity) if window else capacity
        return _kv_state(batch, cap, Hk, dh, dtype, device)
    if kind == "mamba":
        H = ssm.ssm_heads(cfg)
        return {"conv": torch.zeros((batch, cfg.conv_dim - 1,
                                     ssm.conv_channels(cfg)), dtype=dtype,
                                    device=device),
                "ssm": torch.zeros((batch, H, cfg.ssm_head_dim,
                                    cfg.ssm_state), dtype=torch.float32,
                                   device=device)}
    if kind == "mlstm":
        return xlstm.init_mlstm_state(cfg, batch, device=device)
    if kind == "slstm":
        return xlstm.init_slstm_state(cfg, batch, device=device)
    raise ValueError(kind)


def _decode_window(cfg, layer_idx):
    if cfg.sliding_window and cfg.global_every:
        is_global = (layer_idx + 1) % cfg.global_every == 0
        return 0 if is_global else cfg.sliding_window
    return cfg.sliding_window


def init_decode_state(cfg, batch, capacity, prefill_len=0,
                      device="cuda") -> Dict[str, Any]:
    """The empty (or stand-in) decode state on `device`."""
    dtype = cfg.activation_dtype
    state: Dict[str, Any] = {
        "index": torch.tensor(prefill_len, dtype=torch.int32,
                              device=device),
        "layers": [_layer_state(cfg, kind, batch, capacity,
                                _decode_window(cfg, i), dtype, device)
                   for i, kind in enumerate(cfg.layer_kinds())],
    }
    if cfg.shared_attn_every:
        n_inv = sum(1 for i in range(cfg.num_layers)
                    if i > 0 and i % cfg.shared_attn_every == 0)
        state["shared"] = [_kv_state(batch, capacity, cfg.num_kv_heads,
                                     cfg.head_dim, dtype, device)
                           for _ in range(n_inv)]
    if cfg.encoder_layers:
        # the cross-attention K/V, computed once from the encoder at
        # prefill in the reference's design; zeros here as there
        F = cfg.num_frames or 128
        state["cross"] = [_kv_state(batch, F, cfg.num_kv_heads, cfg.head_dim,
                                    dtype, device)
                          for _ in range(cfg.num_layers)]
    return state


def _still(par, at, name):
    return None if par is None else par.stationary(at, name)


def _enter(par, x, still):
    return x if par is None else par.enter(x, still)


def _attn_decode(lp, cfg, x, st, index, window, cross_kv=None, par=None,
                 key="", at=""):
    """One attention layer's decode step; `key` the path of its state
    ("layers/3", "shared/0": `Parallel.cache`), `at` the path of its
    parameters ("layers", "blocks/3", "shared_attn")."""
    still = _still(par, at, "attn")
    x = _enter(par, x, still)
    positions = index.reshape(1, 1).expand(x.shape[0], 1)
    h = apply_norm(cfg.norm_type, lp["attn_norm"], x, cfg.norm_eps)
    if cfg.attention_kind == "mla":
        a, ckv, kpe = mla.mla_decode(lp["attn"], cfg, h, positions=positions,
                                     c_kv_cache=st["ckv"],
                                     k_pe_cache=st["kpe"], cache_index=index,
                                     tp=_tp(par, "mla"))
        st = {"ckv": ckv, "kpe": kpe}
    else:
        a, (ck, cv) = attn_mod.attention(
            lp["attn"], cfg, h, positions=positions,
            cache_kv=(st["k"], st["v"]), cache_index=index, window=window,
            tp=_tp(par, "attn") if still is None else None,
            kv=None if par is None else par.cache(key), still=still)
        st = {"k": ck, "v": cv}
    x = x + a
    if cross_kv is not None:
        x = _enter(par, x, None)
        h = apply_norm(cfg.norm_type, lp["cross_norm"], x, cfg.norm_eps)
        x = x + attn_mod.attention(lp["cross_attn"], cfg, h,
                                   positions=positions[:x.shape[0]],
                                   mask=None, causal=False,
                                   kv_override=(cross_kv["k"],
                                                cross_kv["v"]))
    if "mlp" in lp:
        still = _still(par, at, "mlp")
        x = _enter(par, x, still)
        h = apply_norm(cfg.norm_type, lp["mlp_norm"], x, cfg.norm_eps)
        if cfg.moe:
            y, _ = moe.moe_ffn(lp["mlp"], cfg, h, tp=_tp(par, "moe"))
        elif cfg.norm_type == "layernorm":
            y = layers.gelu_mlp(lp["mlp"], h, _tp(par, "mlp"), still)
        else:
            y = layers.swiglu_mlp(lp["mlp"], h, _tp(par, "mlp"), still)
        x = x + y
    return x, st


def decode_step(params, cfg, state, tokens):
    """tokens: (B, 1) -> (logits (B, 1, V) float32, new_state). The step
    writes the new token's keys and values (MLA: its latent and rotary
    key) into the caches of `state` in place (`kvcache.update_layer`);
    the new state's "index" is a new tensor, `index + 1`, as the
    reference's."""
    par = parallel.current()
    take = _taker(par)
    adt = cfg.activation_dtype
    index = state["index"]
    x = embed(take(params["embed"], "embed"), tokens, adt, _tp(par, "vocab"))
    new_layer_states: List[Any] = []
    new_shared = list(state.get("shared", []))
    shared_i = 0
    stacked = params.get("blocks") is None
    stack = _layers(params, par) if stacked else None

    for i, kind in enumerate(cfg.layer_kinds()):
        lp = (take(stack(i), "layers") if stacked
              else take(params["blocks"][i], "blocks", i))
        at = "layers" if stacked else f"blocks/{i}"
        st = state["layers"][i]
        if uses_shared(cfg, i):
            x, new_shared[shared_i] = _attn_decode(
                take(params["shared_attn"], "shared_attn"), cfg, x,
                state["shared"][shared_i], index, 0, par=par,
                key=f"shared/{shared_i}", at="shared_attn")
            shared_i += 1
        if kind == "attn":
            cross_kv = state["cross"][i] if cfg.encoder_layers else None
            x, st = _attn_decode(lp, cfg, x, st, index,
                                 _decode_window(cfg, i), cross_kv, par,
                                 f"layers/{i}", at)
        else:
            still = _still(par, at, kind)
            x = _enter(par, x, still)
            h = apply_norm(cfg.norm_type, lp["norm"], x, cfg.norm_eps)
            if kind == "mamba":
                y, conv, s = ssm.mamba2_step(lp["mamba"], cfg, h,
                                             st["conv"], st["ssm"], still)
                st = {"conv": conv, "ssm": s}
            elif kind == "mlstm":
                y, st = xlstm.mlstm_step(lp["mlstm"], cfg, h, st)
            elif kind == "slstm":
                y, st = xlstm.slstm_step(lp["slstm"], cfg, h, st)
            else:
                raise ValueError(kind)
            x = x + y
        new_layer_states.append(st)

    logits = _logits(params, cfg, _enter(par, x, None), par, softcap=False)

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
