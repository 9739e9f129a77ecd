"""Multi-head Latent Attention (DeepSeek-V2) — compressed KV cache (port of
`repro.models.mla`).

The KV path is low-rank: tokens are projected to a `kv_lora_rank`-dim
latent `c_kv` (plus a small shared rotary key `k_pe`); per-head keys and
values are expanded from the latent. Only (c_kv, k_pe) is cached at
decode.

Decode uses the *absorbed* form: w_uk is folded into the query
(q_lat = q_nope @ w_uk) so scores are taken directly against the latent
cache, and the attention output stays in latent space until w_uv.

MLA has no flash path, in the reference or here: under
`attn_impl="flash"` it takes the einsum path.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models import kvcache as kvc
from repro_torch.models.attention import chunked_attention, make_attention_mask
from repro_torch.models.layers import apply_rope, dense, init_dense

NEG_INF = -2.0e38


def init_mla(generator, cfg, dtype=torch.float32):
    d, H = cfg.d_model, cfg.num_heads
    r, rope, nope, vdim = (cfg.kv_lora_rank, cfg.qk_rope_dim,
                           cfg.qk_nope_dim, cfg.v_head_dim)
    return {
        "wq": init_dense(generator, d, H * (nope + rope), dtype=dtype),
        "w_dkv": init_dense(generator, d, r, dtype=dtype),
        "w_kpe": init_dense(generator, d, rope, dtype=dtype),
        "w_uk": init_dense(generator, r, H * nope, dtype=dtype),
        "w_uv": init_dense(generator, r, H * vdim, dtype=dtype),
        "wo": init_dense(generator, H * vdim, d, dtype=dtype),
    }


def _q_proj(params, cfg, x, positions):
    H = cfg.num_heads
    nope, rope = cfg.qk_nope_dim, cfg.qk_rope_dim
    q = dense(params["wq"], x).reshape(*x.shape[:-1], H, nope + rope)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    return q_nope, q_rope


def mla_attention(params, cfg, x, *, positions, mask=None):
    """Train/prefill path (expanded K/V). x: (B,S,D).

    Under attn_impl="chunked" the scores concat(q_nope, q_rope) ·
    concat(k_nope, k_pe) go through the shared `chunked_attention`."""
    B, S, _ = x.shape
    H = cfg.num_heads
    nope, vdim, rope = cfg.qk_nope_dim, cfg.v_head_dim, cfg.qk_rope_dim

    q_nope, q_rope = _q_proj(params, cfg, x, positions)
    c_kv = dense(params["w_dkv"], x)                                # (B,S,r)
    k_pe = apply_rope(dense(params["w_kpe"], x)[..., None, :],
                      positions, cfg.rope_theta)                    # (B,S,1,rope)
    k_nope = dense(params["w_uk"], c_kv).reshape(B, S, H, nope)
    v = dense(params["w_uv"], c_kv).reshape(B, S, H, vdim)

    if cfg.attn_impl == "chunked":
        q_cat = torch.cat([q_nope, q_rope], dim=-1)
        k_cat = torch.cat([k_nope, k_pe.expand(B, S, H, rope)], dim=-1)
        out = chunked_attention(q_cat, k_cat, v, causal=True,
                                chunk=cfg.attn_chunk)
        return dense(params["wo"], out.reshape(B, S, H * vdim))

    scale = 1.0 / math.sqrt(nope + rope)
    logits = (torch.einsum("bshd,bthd->bhst", q_nope.float(), k_nope.float())
              + torch.einsum("bshd,btxd->bhst", q_rope.float(),
                             k_pe.float())) * scale
    if mask is None:
        mask = make_attention_mask(S, S, causal=True, device=x.device)
    w = torch.softmax(logits + mask, dim=-1)
    out = torch.einsum("bhst,bthd->bshd", w, v.float())
    out = out.reshape(B, S, H * vdim).to(x.dtype)
    return dense(params["wo"], out)


def mla_decode(params, cfg, x, *, positions, c_kv_cache, k_pe_cache,
               cache_index):
    """Absorbed decode. x: (B,1,D); caches: (B,cap,1,r)/(B,cap,1,rope),
    written in place (`kvcache.update_layer`); cache_index is the decode
    state's 0-d int32 "index" tensor (tokens already cached), read on the
    device.

    Returns (out, c_kv_cache, k_pe_cache)."""
    B = x.shape[0]
    H = cfg.num_heads
    r, nope, vdim = cfg.kv_lora_rank, cfg.qk_nope_dim, cfg.v_head_dim
    cap = c_kv_cache.shape[1]

    q_nope, q_rope = _q_proj(params, cfg, x, positions)        # (B,1,H,·)
    c_kv = dense(params["w_dkv"], x)[..., None, :]             # (B,1,1,r)
    k_pe = apply_rope(dense(params["w_kpe"], x)[..., None, :],
                      positions, cfg.rope_theta)               # (B,1,1,rope)

    c_kv_cache, k_pe_cache = kvc.update_layer(
        c_kv_cache, k_pe_cache, cache_index, c_kv, k_pe)
    valid = kvc.valid_mask(cache_index, cap, device=x.device)

    # absorb w_uk into the query: (B,1,H,nope) x (r -> H,nope) => (B,1,H,r)
    w_uk = params["w_uk"]["kernel"].reshape(r, H, nope)
    q_lat = torch.einsum("bshd,rhd->bshr", q_nope.float(), w_uk.float())

    scale = 1.0 / math.sqrt(nope + cfg.qk_rope_dim)
    lat = c_kv_cache[:, :, 0, :].float()                       # (B,cap,r)
    pe = k_pe_cache[:, :, 0, :].float()                        # (B,cap,rope)
    logits = (torch.einsum("bshr,btr->bhst", q_lat, lat)
              + torch.einsum("bshd,btd->bhst", q_rope.float(), pe))
    amask = torch.where(valid, torch.zeros((), device=x.device),
                        torch.full((), NEG_INF, device=x.device))
    w = torch.softmax(logits * scale + amask, dim=-1)
    o_lat = torch.einsum("bhst,btr->bshr", w, lat)             # (B,1,H,r)

    w_uv = params["w_uv"]["kernel"].reshape(r, H, vdim)
    out = torch.einsum("bshr,rhd->bshd", o_lat, w_uv.float())
    out = out.reshape(B, 1, H * vdim).to(x.dtype)
    return dense(params["wo"], out), c_kv_cache, k_pe_cache
