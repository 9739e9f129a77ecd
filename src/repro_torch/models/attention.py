"""Grouped-query attention with causal / sliding-window masks, qk-norm and
RoPE (port of `repro.models.attention`).

Weights are stored fused 2-D, as in the reference: wq (d, H*dh), wk and
wv (d, Hk*dh), wo (H*dh, d); the head split follows the projection.

Three execution paths, chosen by `cfg.attn_impl` as in the reference:
* "einsum"  — the plain masked softmax (`gqa_attention`);
* "chunked" — online softmax over key chunks (`chunked_attention`);
* "flash"   — the flash kernel (`kernels.ops.flash_attention`) when the
  shapes tile (`_maybe_flash`), the einsum path otherwise.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models import layers
from repro_torch.models.layers import apply_rope, dense, init_dense

NEG_INF = -2.0e38


def init_attention(generator, cfg, dtype=torch.float32):
    d, H, Hk, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    p = {
        "wq": init_dense(generator, d, H * dh, dtype=dtype),
        "wk": init_dense(generator, d, Hk * dh, dtype=dtype),
        "wv": init_dense(generator, d, Hk * dh, dtype=dtype),
        "wo": init_dense(generator, H * dh, d, dtype=dtype),
    }
    if cfg.qk_norm:
        p["q_norm"] = layers.init_rmsnorm(dh, dtype)
        p["k_norm"] = layers.init_rmsnorm(dh, dtype)
    return p


def _split_heads(x, n_heads, head_dim):
    return x.reshape(*x.shape[:-1], n_heads, head_dim)


def _merge_heads(x):
    return x.reshape(*x.shape[:-2], x.shape[-2] * x.shape[-1])


def make_attention_mask(q_len, kv_len, *, causal=True, window=0,
                        q_offset=0, dtype=torch.float32, device="cpu"):
    """(q_len, kv_len) additive mask. `q_offset` = absolute position of
    q[0]."""
    qpos = torch.arange(q_len, device=device)[:, None] + q_offset
    kpos = torch.arange(kv_len, device=device)[None, :]
    ok = torch.ones((q_len, kv_len), dtype=torch.bool, device=device)
    if causal:
        ok = ok & (kpos <= qpos)
    if window and window > 0:
        ok = ok & (kpos > qpos - window)
    zero = torch.zeros((), dtype=torch.float32, device=device)
    neg = torch.full((), NEG_INF, dtype=torch.float32, device=device)
    return torch.where(ok, zero, neg).to(dtype)


def gqa_attention(q, k, v, mask=None, *, scale=None):
    """q: (B,S,H,dh)  k,v: (B,T,Hk,dh)  mask: (S,T) or (B,1,S,T) additive."""
    B, S, H, dh = q.shape
    Hk = k.shape[2]
    G = H // Hk
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    qg = q.reshape(B, S, Hk, G, dh)
    logits = torch.einsum("bskgd,btkd->bkgst", qg.float(), k.float()) * scale
    if mask is not None:
        m = mask if mask.dim() == 2 else mask.reshape(B, 1, 1,
                                                      *mask.shape[-2:])
        logits = logits + m
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", w, v.float())
    return out.reshape(B, S, H, dh).to(q.dtype)


def chunked_attention(q, k, v, *, causal=True, window=0, chunk=512,
                      scale=None):
    """Online-softmax attention over key chunks, a Python loop where the
    reference runs `lax.scan`. Never materialises the (S, T) score matrix.

    q: (B,S,H,dh); k,v: (B,T,Hk,dh). Exact (not an approximation)."""
    B, S, H, dh = q.shape
    T, Hk = k.shape[1], k.shape[2]
    G = H // Hk
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    chunk = min(chunk, T)
    while T % chunk:
        chunk -= 1
    nk = T // chunk

    dv = v.shape[-1]
    dev = q.device
    qg = q.reshape(B, S, Hk, G, dh).float()
    qpos = torch.arange(S, device=dev)
    m = torch.full((B, Hk, G, S), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, Hk, G, S), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, Hk, G, S, dv), dtype=torch.float32, device=dev)
    neg = torch.full((), NEG_INF, dtype=torch.float32, device=dev)
    for ci in range(nk):
        kt = k[:, ci * chunk:(ci + 1) * chunk].float()
        vt = v[:, ci * chunk:(ci + 1) * chunk].float()
        kpos = ci * chunk + torch.arange(chunk, device=dev)
        s = torch.einsum("bskgd,btkd->bkgst", qg, kt) * scale
        ok = torch.ones((S, chunk), dtype=torch.bool, device=dev)
        if causal:
            ok = ok & (kpos[None, :] <= qpos[:, None])
        if window and window > 0:
            ok = ok & (kpos[None, :] > qpos[:, None] - window)
        s = torch.where(ok, s, neg)
        m_cur = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_cur[..., None])
        alpha = torch.exp(m - m_cur)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bkgst,btkd->bkgsd",
                                                    p, vt)
        m = m_cur
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    out = out.permute(0, 3, 1, 2, 4).reshape(B, S, H, dv)
    return out.to(q.dtype)


def _maybe_flash(cfg, q, k, v, *, causal, window, q_offset):
    """The flash kernel when enabled and the shapes tile (the reference's
    conditions: S, T >= 128 and multiples of 128, dh % 8 == 0, no query
    offset); None sends the caller to the einsum path."""
    if cfg.attn_impl != "flash":
        return None
    from repro_torch.kernels import ops as kops
    S, T, dh = q.shape[1], k.shape[1], q.shape[-1]
    if S < 128 or T < 128 or S % 128 or T % 128 or dh % 8 or q_offset:
        return None
    return kops.flash_attention(q.contiguous(), k.contiguous(),
                                v.contiguous(), causal=causal, window=window)


def attention(params, cfg, x, *, positions, mask=None, cache_kv=None,
              cache_index=None, window=0, causal=True, rope_theta=None,
              kv_override=None):
    """Full attention block (projections + SDPA + output projection).

    Train/prefill: cache_kv=None, x: (B,S,D).
    Decode: x: (B,1,D), cache_kv=(ck, cv) with ck: (B,cap,Hk,dh),
            cache_index = number of tokens already in the cache (the
            decode state's 0-d int32 "index" tensor; the mask and the
            write position are computed from it on the device).
            Returns (out, (new_ck, new_cv)).
    Cross-attention: kv_override=(k, v) precomputed from encoder output.
    """
    H, Hk, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    theta = rope_theta if rope_theta is not None else cfg.rope_theta

    q = _split_heads(dense(params["wq"], x), H, dh)
    if kv_override is None:
        k = _split_heads(dense(params["wk"], x), Hk, dh)
        v = _split_heads(dense(params["wv"], x), Hk, dh)
    else:
        k, v = kv_override

    if cfg.qk_norm:
        q = layers.rmsnorm(params["q_norm"], q, cfg.norm_eps)
        if kv_override is None:
            k = layers.rmsnorm(params["k_norm"], k, cfg.norm_eps)

    if cfg.use_rope and kv_override is None:
        q = apply_rope(q, positions, theta)
        k = apply_rope(k, positions, theta)

    new_cache = None
    if cache_kv is not None:
        from repro_torch.models import kvcache as kvc
        ck, cv = cache_kv
        cap = ck.shape[1]
        ck, cv = kvc.update_layer(ck, cv, cache_index, k, v, window=window)
        new_cache = (ck, cv)
        valid = kvc.valid_mask(cache_index, cap, window=window,
                               device=x.device)
        amask = torch.where(valid[None, :],
                            torch.zeros((), device=x.device),
                            torch.full((), NEG_INF, device=x.device))
        amask = amask[None, None].expand(x.shape[0], 1, q.shape[1], cap)
        out = gqa_attention(q, ck, cv, amask)
    elif kv_override is not None:
        if cfg.attn_impl == "chunked":
            out = chunked_attention(q, k, v, causal=False,
                                    chunk=cfg.attn_chunk)
        else:
            out = gqa_attention(q, k, v, mask)
    elif cfg.attn_impl == "chunked":
        out = chunked_attention(q, k, v, causal=causal, window=window,
                                chunk=cfg.attn_chunk)
    else:
        f = _maybe_flash(cfg, q, k, v, causal=causal, window=window,
                         q_offset=0)
        if f is not None:
            out = f
        else:
            if mask is None:
                mask = make_attention_mask(q.shape[1], k.shape[1],
                                           causal=causal, window=window,
                                           device=x.device)
            out = gqa_attention(q, k, v, mask)

    out = dense(params["wo"], _merge_heads(out))
    return (out, new_cache) if cache_kv is not None else out
