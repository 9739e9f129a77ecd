"""Foundational layers on tensors (port of `repro.models.layers`).

Every layer is a pair of plain functions:
    init_<layer>(generator, ...) -> params (nested dict of tensors)
    <layer>(params, x, ...) -> output

Parameters keep the reference's keys and layouts (a dense kernel is
(in, out); an embedding table (vocab, d)), so the reference's parameters
carry across leaf for leaf (`repro_torch.convert.params_from_jax`).
Initializers draw from a CPU `torch.Generator`; the draws are not
`jax.random`'s. On a mesh the reference's `shard_activation` lets GSPMD
cut a layer over "model"; here a layer given `tp` (a
`models.parallel.Parallel`) computes Megatron's cut on its slices of the
weights: `embed` and `unembed` over the vocabulary, `column` / `row`
products and `swiglu_mlp` / `gelu_mlp` over their hidden columns. A
decode step's stationary block (`still`, a `models.parallel.Stationary`)
computes each product where its weight is stored instead: its input holds
every row of the batch, and the rank multiplies its share of the rows by
its stored block (`still_part`): a partial sum of every output column
where the block cuts the product's input ("rows"), summed over every mesh
axis, or the block's output columns where it cuts the output ("cols"),
all-gathered (`still_dense`). An MLP's input products and its output
product share their block of hidden columns, so the block costs one sum.
With `tp=None` and `still=None` every layer runs as on one device.
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


def embed(params, tokens, dtype=torch.bfloat16, tp=None):
    """Gather then cast: the same values as the reference's cast of the
    whole table then gather, without copying the table. Under `tp` the
    table is the rank's rows of the vocabulary: a token outside them
    looks up zeros, and one sum over "model" (the reference's one-hot
    psum) gives every rank the whole embedding."""
    table = params["embed"]
    if tp is None:
        return table[tokens].to(dtype)
    n = table.shape[0]
    local = tokens - tp.index * n
    inside = (local >= 0) & (local < n)
    rows = table[torch.where(inside, local, torch.zeros_like(local))]
    rows = torch.where(inside[..., None], rows.to(dtype),
                       torch.zeros((), dtype=dtype, device=rows.device))
    return tp.g(rows)


def unembed(params, x, tp=None):
    """Logits in float32 for a stable softmax cross-entropy; under `tp`
    the rank's vocabulary columns of them."""
    if tp is not None:
        x = tp.f(x)
    return x.float() @ params["embed"].float().t()


class _VocabParallelNLL(torch.autograd.Function):
    """Each token's nll from the rank's vocabulary columns of its logits,
    `x @ w` (float32), without a second copy of them: the logits' max,
    then one sum over "model" of the exponentials' sums and the label's
    logit; the logits buffer becomes the softmax in place, the one tensor
    of the vocabulary's size kept for the backward pass (Megatron's
    vocabulary-parallel cross-entropy, its product fused in)."""

    @staticmethod
    def forward(ctx, x, w, labels, tp):
        logits = x.float() @ w.float()
        n = logits.shape[-1]
        m = tp.max(logits.amax(dim=-1))
        local = labels - tp.index * n
        inside = (local >= 0) & (local < n)
        safe = torch.where(inside, local, torch.zeros_like(local))
        mine = torch.gather(logits, -1, safe[..., None])[..., 0]
        logits.sub_(m[..., None]).exp_()
        parts = torch.stack([logits.sum(-1), torch.where(
            inside, mine, torch.zeros_like(mine))], -1)
        sums, label_logit = tp.g(parts).unbind(-1)
        logits.div_(sums[..., None])
        ctx.save_for_backward(x, w, logits, safe, inside)
        return m + torch.log(sums) - label_logit

    @staticmethod
    def backward(ctx, g):
        x, w, p, safe, inside = ctx.saved_tensors
        # d nll / d logits = softmax - one-hot of the label (where it is one
        # of the rank's columns), in the saved buffer
        p.scatter_add_(-1, safe[..., None], -inside[..., None].float())
        p.mul_(g[..., None])
        dx = (p @ w.float().t()).to(x.dtype)
        dw = (x.float().reshape(-1, x.shape[-1]).t()
              @ p.reshape(-1, p.shape[-1])).to(w.dtype)
        return dx, dw, None, None


def vocab_parallel_nll(x, w, labels, tp):
    """x: (..., d) entering through `tp.f`; w: (d, V / M), the rank's
    vocabulary columns; labels: (...) token ids (>= 0) -> each token's nll
    (float32)."""
    return _VocabParallelNLL.apply(tp.f(x), w, labels, tp)


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


def column(params, x, tp=None):
    """`dense` on the rank's output columns under `tp`: its input enters
    through Megatron's f."""
    return dense(params, x if tp is None else tp.f(x))


def row(params, x, tp=None):
    """`dense` on the rank's input rows under `tp`: the partial products
    summed over "model" (Megatron's g), the bias added after the sum."""
    if tp is None:
        return dense(params, x)
    y = tp.g(x @ params["kernel"].to(x.dtype))
    if "bias" in params:
        y = y + params["bias"].to(x.dtype)
    return y


def still_part(params, x, st):
    """The rank's part of `dense(params, x)` (or of `x @ params` for a bare
    weight) with its stored block, `x` holding every row of the batch:
    its rows `st.rows` of `x` times the block, a partial product of every
    output column (the block's input columns of `x`, "rows") or every
    input column times the block's output columns ("cols", its slice of a
    whole bias added)."""
    w = params["kernel"] if isinstance(params, dict) else params
    x = x[st.rows[0]:st.rows[0] + st.rows[1]]
    if st.form == "rows":
        return x[..., st.lo:st.hi] @ w.to(x.dtype)
    y = x @ w.to(x.dtype)
    if isinstance(params, dict) and "bias" in params:
        y = y + params["bias"][st.lo:st.hi].to(x.dtype)
    return y


def still_dense(named, x, still):
    """`dense(params, x)` of each (params, leaf) of `named`, the products
    of one stationary block on `x` (every row of the batch), each whole:
    the partial products summed in one sum (a bias added after it), the
    columns all-gathered."""
    parts = [still_part(p, x, still[leaf]) for p, leaf in named]
    rows = [(y, still[leaf]) for y, (_, leaf) in zip(parts, named)
            if still[leaf].form == "rows"]
    sums = iter(still.total(rows) if rows else ())
    out = []
    for y, (p, leaf) in zip(parts, named):
        st = still[leaf]
        if st.form == "rows":
            y = next(sums)
            if "bias" in p:
                y = y + p["bias"].to(y.dtype)
        else:
            y = still.join(y, st.split, st.axis)
        out.append(y)
    return out


def init_swiglu_mlp(generator, d, d_ff, dtype=torch.float32):
    return {
        "wi_gate": lecun_init(generator, (d, d_ff), dtype=dtype),
        "wi_up": lecun_init(generator, (d, d_ff), dtype=dtype),
        "wo": lecun_init(generator, (d_ff, d), fan_in=d_ff, dtype=dtype),
    }


def swiglu_mlp(params, x, tp=None, still=None):
    """Under `tp`, column-parallel `wi_gate` / `wi_up` and row-parallel
    `wo` over the rank's hidden columns; under `still` their stored
    blocks, one block of hidden columns (module docstring)."""
    if still is not None:
        h = F.silu(still_part(params["wi_gate"], x, still["wi_gate"])) \
            * still_part(params["wi_up"], x, still["wi_up"])
        return still.total([(h @ params["wo"].to(h.dtype),
                             still["wo"])])[0]
    if tp is not None:
        x = tp.f(x)
    g = x @ params["wi_gate"].to(x.dtype)
    u = x @ params["wi_up"].to(x.dtype)
    y = (F.silu(g) * u) @ params["wo"].to(x.dtype)
    return y if tp is None else tp.g(y)


def init_gelu_mlp(generator, d, d_ff, dtype=torch.float32):
    return {
        "wi": init_dense(generator, d, d_ff, use_bias=True, dtype=dtype),
        "wo": init_dense(generator, d_ff, d, use_bias=True, dtype=dtype),
    }


def gelu_mlp(params, x, tp=None, still=None):
    """`jax.nn.gelu`'s default is the tanh approximation. Under `tp`,
    `wi` column- and `wo` row-parallel; under `still` their stored
    blocks."""
    if still is not None:
        h = F.gelu(still_part(params["wi"], x, still["wi/kernel"]),
                   approximate="tanh")
        y = still.total([(h @ params["wo"]["kernel"].to(h.dtype),
                          still["wo/kernel"])])[0]
        return y + params["wo"]["bias"].to(y.dtype)
    return row(params["wo"], F.gelu(column(params["wi"], x, tp),
                                    approximate="tanh"), tp)
