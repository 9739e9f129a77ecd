"""Foundational layers on tensors (port of `repro.models.layers`).

Every layer is a pair of plain functions:
    init_<layer>(generator, ...) -> params (nested dict of tensors)
    <layer>(params, x, ...) -> output

Parameters keep the reference's keys and layouts (a dense kernel is
(in, out); an embedding table (vocab, d)), so the reference's parameters
carry across leaf for leaf (`repro_torch.convert.params_from_jax`).
Initializers draw from a CPU `torch.Generator`; the draws are not
`jax.random`'s. The reference's `shard_activation` has no counterpart on
one card.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


# -- initializers --------------------------------------------------------------

def normal_init(generator, shape, stddev=0.02, dtype=torch.float32):
    return torch.randn(shape, generator=generator).mul_(stddev).to(dtype)


def lecun_init(generator, shape, fan_in=None, dtype=torch.float32):
    fan_in = fan_in if fan_in is not None else shape[0]
    return torch.randn(shape, generator=generator).div_(
        math.sqrt(max(1, fan_in))).to(dtype)


# -- norms -----------------------------------------------------------------------

def init_rmsnorm(d, dtype=torch.float32):
    return {"scale": torch.ones((d,), dtype=dtype)}


def rmsnorm(params, x, eps=1e-6):
    dt = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * params["scale"].float()).to(dt)


def init_layernorm(d, dtype=torch.float32):
    return {"scale": torch.ones((d,), dtype=dtype),
            "bias": torch.zeros((d,), dtype=dtype)}


def layernorm(params, x, eps=1e-6):
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, unbiased=False)
    x = (x - mu) * torch.rsqrt(var + eps)
    out = x * params["scale"].float() + params["bias"].float()
    return out.to(dt)


def init_norm(kind, d, dtype=torch.float32):
    return (init_layernorm(d, dtype) if kind == "layernorm"
            else init_rmsnorm(d, dtype))


def apply_norm(kind, params, x, eps=1e-6):
    return (layernorm(params, x, eps) if kind == "layernorm"
            else rmsnorm(params, x, eps))


# -- embeddings ------------------------------------------------------------------

def init_embedding(generator, vocab, d, dtype=torch.float32):
    return {"embed": normal_init(generator, (vocab, d),
                                 stddev=1.0 / math.sqrt(d), dtype=dtype)}


def embed(params, tokens, dtype=torch.bfloat16):
    """Gather then cast: the same values as the reference's cast of the
    whole table then gather, without copying the table."""
    return params["embed"][tokens].to(dtype)


def unembed(params, x):
    """Logits in float32 for a stable softmax cross-entropy."""
    return x.float() @ params["embed"].float().t()


# -- RoPE --------------------------------------------------------------------------

def rope_freqs(head_dim, theta=1e4, device=None):
    d2 = head_dim // 2
    return 1.0 / (theta ** (torch.arange(d2, dtype=torch.float32,
                                         device=device) / d2))


def apply_rope(x, positions, theta=1e4):
    """x: (..., S, H, dh); positions: (..., S) integer."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, device=x.device)          # (dh/2,)
    ang = positions[..., None].float() * freqs               # (..., S, dh/2)
    cos = torch.cos(ang)[..., None, :]                       # (..., S, 1, dh/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# -- dense / MLP -------------------------------------------------------------------

def init_dense(generator, d_in, d_out, use_bias=False, dtype=torch.float32):
    p = {"kernel": lecun_init(generator, (d_in, d_out), dtype=dtype)}
    if use_bias:
        p["bias"] = torch.zeros((d_out,), dtype=dtype)
    return p


def dense(params, x):
    y = x @ params["kernel"].to(x.dtype)
    if "bias" in params:
        y = y + params["bias"].to(x.dtype)
    return y


def init_swiglu_mlp(generator, d, d_ff, dtype=torch.float32):
    return {
        "wi_gate": lecun_init(generator, (d, d_ff), dtype=dtype),
        "wi_up": lecun_init(generator, (d, d_ff), dtype=dtype),
        "wo": lecun_init(generator, (d_ff, d), fan_in=d_ff, dtype=dtype),
    }


def swiglu_mlp(params, x):
    g = x @ params["wi_gate"].to(x.dtype)
    u = x @ params["wi_up"].to(x.dtype)
    return (F.silu(g) * u) @ params["wo"].to(x.dtype)


def init_gelu_mlp(generator, d, d_ff, dtype=torch.float32):
    return {
        "wi": init_dense(generator, d, d_ff, use_bias=True, dtype=dtype),
        "wo": init_dense(generator, d_ff, d, use_bias=True, dtype=dtype),
    }


def gelu_mlp(params, x):
    """`jax.nn.gelu`'s default is the tanh approximation."""
    return dense(params["wo"], F.gelu(dense(params["wi"], x),
                                      approximate="tanh"))
