"""Mixture-of-Experts layer — GShard-style grouped dispatch/combine (port of
`repro.models.moe`).

Tokens are reshaped into groups of `moe_group_size`; each group routes its
tokens into per-expert capacity buffers. Top-k routing on a float32
router with renormalized gates, capacity-factor token dropping with
k-major, s-minor priority, and the standard load-balance auxiliary loss
(primary expert only). Optional always-on shared experts (DeepSeek-V2
style).

The dispatch and combine products stay dense one-hot einsums, as in the
reference (where XLA runs them). The (G, S, E, C) combine tensor is built
by scattering each kept assignment's gate into its (expert, slot): the
values of the reference's three-operand einsum, whose other terms are
exact zeros, without its (G, S, K, C) one-hot intermediate.

Under `tp` (a `models.parallel.Parallel` cutting experts over "model":
the tp profile and the multi-pod moe profile) the router, its capacity
and drops and the aux loss stay whole on every rank; the rank's E/M
experts run on its tokens, the combine takes their slots, the shared
experts run on the rank's columns, and one sum over "model" follows, the
row-parallel form of the reference's expert-parallel dispatch (also the
single-pod moe profile's decode step, whose ranks along "model" hold the
same rows).

Under `ep` (the single-pod moe profile's train step and prefill: the
ranks along "model" hold other rows, `specs.ep_axis`) the rank routes its
own groups with the whole router, builds (E, G_r, C, D) and sends each
rank along "model" the block of its E/M experts, one all-to-all; it runs
its experts on the (E/M, M G_r, C, D) it receives, sends the results back
by the inverse all-to-all and combines its own tokens: the reference's
dispatch across its expert-parallel boundary (`repro.models.moe`, the
`shard_activation` of `xe` over "model"). The shared experts run on the
rank's rows.

The aux loss's token means (f_e, p_e) are over the tokens of the call.
`moe_ffn(..., token_mean=fn)` takes them through `fn` instead, which maps
the (G, S, E) per-token values to their (E,) mean: a data-parallel step
whose rank holds a slice of the batch's rows
(`launch.train.make_sharded_train_step`) passes one that returns the mean
over every rank's rows, so its aux loss is the global batch's, as
GSPMD's is.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models import layers
from repro_torch.models.layers import dense, init_dense, lecun_init


def init_moe(generator, cfg, dtype=torch.float32):
    d, f, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    p = {
        "router": init_dense(generator, d, E, dtype=torch.float32),  # fp32
        "experts_gate": lecun_init(generator, (E, d, f), fan_in=d,
                                   dtype=dtype),
        "experts_up": lecun_init(generator, (E, d, f), fan_in=d, dtype=dtype),
        "experts_down": lecun_init(generator, (E, f, d), fan_in=f,
                                   dtype=dtype),
    }
    if cfg.num_shared_experts:
        p["shared"] = layers.init_swiglu_mlp(
            generator, d, cfg.num_shared_experts * f, dtype=dtype)
    return p


def _capacity(tokens_per_group, top_k, num_experts, capacity_factor):
    c = int(math.ceil(tokens_per_group * top_k / num_experts
                      * capacity_factor))
    return max(8, ((c + 7) // 8) * 8)


def route(router_params, x_groups, num_experts, top_k):
    """x_groups: (G, S, D) -> gates (G,S,K), experts (G,S,K), raw gates
    (G,S,E)."""
    logits = dense(router_params, x_groups.float())
    gates = torch.softmax(logits, dim=-1)
    top_vals, top_idx = torch.topk(gates, top_k, dim=-1)
    top_vals = top_vals / (top_vals.sum(-1, keepdim=True) + 1e-9)
    return top_vals, top_idx, gates


def dispatch_combine_masks(top_vals, top_idx, num_experts, capacity):
    """The (G,S,E,C) float32 combine tensor.

    Priority is k-major (all primary assignments beat secondary ones),
    s-minor, matching GShard. Overflowing tokens are dropped.
    """
    G, S, K = top_idx.shape
    oh = F.one_hot(top_idx, num_experts).float()                   # (G,S,K,E)
    ohk = oh.transpose(1, 2).reshape(G, K * S, num_experts)        # k-major
    pos = torch.cumsum(ohk, dim=1) - ohk                           # pos in expert
    keep = (pos < capacity).float() * ohk
    pos_k = (pos * keep).sum(-1).reshape(G, K, S).transpose(1, 2)  # (G,S,K)
    kept_k = keep.sum(-1).reshape(G, K, S).transpose(1, 2)
    # a token's K experts are distinct, so each (expert, slot) of a token
    # takes at most one gate; a dropped assignment adds 0 at slot 0
    slot = top_idx * capacity + pos_k.long()
    combine = torch.zeros((G, S, num_experts * capacity),
                          dtype=torch.float32, device=top_vals.device)
    combine.scatter_add_(-1, slot, top_vals.float() * kept_k)
    return combine.reshape(G, S, num_experts, capacity)


def _token_mean(x):
    return x.mean(dim=(0, 1))


def load_balance_loss(gates, top_idx, num_experts, token_mean=None):
    """Switch/GShard aux loss: E * sum_e f_e * p_e, the token means taken
    by `token_mean` ((G, S, E) -> (E,); None: over these tokens)."""
    mean = token_mean or _token_mean
    oh = F.one_hot(top_idx[..., 0], num_experts).float()
    f_e = mean(oh)                      # fraction routed (primary)
    p_e = mean(gates)                   # mean router prob
    return num_experts * torch.sum(f_e * p_e)


def moe_ffn(params, cfg, x, token_mean=None, tp=None, ep=None):
    """x: (B, S, D) -> (out, aux_loss); `token_mean` as in
    `load_balance_loss`; `tp` runs the rank's experts on its rows, `ep` on
    every rank's tokens routed to them (module docstring)."""
    B, S, D = x.shape
    E, K = cfg.num_experts, cfg.top_k
    tokens = B * S
    gsz = min(cfg.moe_group_size, tokens)
    while tokens % gsz:
        gsz -= 1
    G = tokens // gsz
    xg = x.reshape(G, gsz, D)

    top_vals, top_idx, gates = route(params["router"], xg, E, K)
    C = _capacity(gsz, K, E, cfg.capacity_factor)
    xin = xg
    if tp is not None:
        # the router's path stays whole; the experts' enters through f
        top_vals, xin = tp.f(top_vals), tp.f(xg)
    combine = dispatch_combine_masks(top_vals, top_idx, E, C)
    if tp is not None:
        n = params["experts_gate"].shape[0]
        combine = combine[:, :, tp.index * n:(tp.index + 1) * n]
    dispatch = (combine > 0).to(x.dtype)

    xe = torch.einsum("gsec,gsd->egcd", dispatch, xin)
    if ep is not None:
        # the rank's experts' slots of every rank's groups along "model"
        xe = ep.all_to_all(xe, 0, 1)
    g = torch.einsum("egcd,edf->egcf", xe,
                     params["experts_gate"].to(x.dtype))
    u = torch.einsum("egcd,edf->egcf", xe, params["experts_up"].to(x.dtype))
    h = F.silu(g) * u
    ye = torch.einsum("egcf,efd->egcd", h,
                      params["experts_down"].to(x.dtype))
    if ep is not None:
        ye = ep.all_to_all(ye, 1, 0)

    out = torch.einsum("gsec,egcd->gsd", combine.to(x.dtype), ye)
    out = out.reshape(B, S, D)

    # the shared experts on the rank's columns (all of them off a mesh,
    # or when their width does not divide over "model": after the sum)
    shared = params.get("shared")
    cut = shared is not None and (
        tp is None or shared["wo"].shape[0] < cfg.num_shared_experts
        * cfg.d_ff)
    if cut:
        out = out + layers.swiglu_mlp(shared, xin.reshape(B, S, D))
    if tp is not None:
        out = tp.g(out)
    if shared is not None and not cut:
        out = out + layers.swiglu_mlp(shared, x)

    aux = load_balance_loss(gates, top_idx, E, token_mean)
    return out, aux
