"""The dense layer and its initializer (port of `repro.models.layers`
`lecun_init`, `init_dense` and `dense`). Parameters keep the reference
layout: a dense kernel is (in, out)."""
from __future__ import annotations

import math

import torch


def lecun_init(generator, shape, fan_in=None, dtype=torch.float32):
    fan_in = fan_in if fan_in is not None else shape[0]
    return (torch.randn(shape, generator=generator)
            / math.sqrt(max(1, fan_in))).to(dtype)


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
