"""The unified transformer stack covering every architecture family of the
model zoo (port of `repro.models.transformer`).

Layer kinds (per position, from `cfg.layer_kinds()`):
  attn   — GQA or MLA attention + (dense | MoE) FFN
  mamba  — Mamba2 SSD block (zamba2)
  mlstm / slstm — xLSTM blocks (xlstm-125m)
plus zamba2's *shared* attention block (one parameter set run before
every `shared_attn_every`-th mamba layer), gemma3's local/global
attention pattern, seamless' encoder-decoder with cross-attention and
phi-3-vision's patch-embedding prefix.

Homogeneous stacks keep their parameters stacked with a leading layer
axis under "layers", as the reference does for `lax.scan`; here a Python
loop walks the layers, and a Python `if` takes the place of the
reference's `lax.cond` for the shared block. `cfg.remat` checkpoints the
reference's units when a backward pass can run: one step of the scanned
stack (the shared block included where it runs), one block of the
per-block loop (the shared block not). Other stacks are the
"blocks" list; seamless keeps its decoder under "layers" with
"blocks": None, as the reference does.

On a mesh (`models.parallel.current()`, set by the sharded steps) the
parameters are the rank's stored shards: each layer takes its compute
slices (`Parallel.take`) inside its checkpoint, so remat gathers them
again in the backward pass, and the shared block, the embedding, the
final norm and the unembedding are taken around their use. Blocks cut
over "model" run Megatron's layout (`layers`, `attention`, `ssm`, `moe`),
and the logits stay cut by the vocabulary: `loss_fn` takes their
log-sum-exp and the label's logit with sums over "model". Under the
view's context parallelism (`Parallel.seq`) the batch is the rank's block
of positions: RoPE and the masks take their absolute positions, attention
gathers every rank's keys and values, and everything else (norms, MLPs,
the embedding, logits and loss) is row-local. A vision prefix's rank
holds its block of patches followed by its block of tokens
(`parallel.SeqBlock`: the layout the batch arrives in, at the
reference's absolute positions); seamless' encoder runs the rank's block
of frames, and cross-attention gathers the encoder's keys and values.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as attn_mod
from repro_torch.models import layers, mla, moe, parallel, ssm, xlstm
from repro_torch.models.layers import (apply_norm, dense, embed, init_dense,
                                       init_embedding, init_norm, unembed)
from repro_torch.tree import tree_leaves, tree_map


# -- per-layer init ----------------------------------------------------------------

def _init_attn_layer(generator, cfg, cross=False, dtype=torch.float32):
    p = {
        "attn_norm": init_norm(cfg.norm_type, cfg.d_model, dtype),
        "mlp_norm": init_norm(cfg.norm_type, cfg.d_model, dtype),
    }
    if cfg.attention_kind == "mla":
        p["attn"] = mla.init_mla(generator, cfg, dtype)
    else:
        p["attn"] = attn_mod.init_attention(generator, cfg, dtype)
    if cross:
        p["cross_norm"] = init_norm(cfg.norm_type, cfg.d_model, dtype)
        p["cross_attn"] = attn_mod.init_attention(generator, cfg, dtype)
    if cfg.moe:
        p["mlp"] = moe.init_moe(generator, cfg, dtype)
    elif cfg.d_ff > 0:
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
    norm = init_norm(cfg.norm_type, cfg.d_model, dtype)
    if kind == "mamba":
        return {"norm": norm, "mamba": ssm.init_mamba2(generator, cfg, dtype)}
    if kind == "mlstm":
        return {"norm": norm, "mlstm": xlstm.init_mlstm(generator, cfg, dtype)}
    if kind == "slstm":
        return {"norm": norm, "slstm": xlstm.init_slstm(generator, cfg, dtype)}
    raise ValueError(kind)


def _stack_init(init_one, n):
    """n layers' parameters stacked on a leading layer axis."""
    return tree_map(lambda *ls: torch.stack(ls), *[init_one()
                                                   for _ in range(n)])


def is_homogeneous(cfg) -> bool:
    kinds = set(cfg.layer_kinds())
    return kinds == {"attn"} or kinds == {"mamba"}


def init_transformer(generator, cfg) -> Dict[str, Any]:
    """Random parameters drawn from `generator` on the default device
    (`Model.init` sets it to the generator's), with the reference's keys,
    layouts and distributions (not its draws)."""
    dtype = cfg.parameter_dtype
    p: Dict[str, Any] = {"embed": init_embedding(generator, cfg.vocab_size,
                                                 cfg.d_model, dtype)}
    kinds = cfg.layer_kinds()
    if cfg.encoder_layers:          # encoder-decoder (seamless)
        enc_cfg = cfg.with_updates(moe=False)
        p["encoder"] = {
            "input_proj": init_dense(generator, cfg.d_model, cfg.d_model,
                                     use_bias=True, dtype=dtype),
            "layers": _stack_init(
                lambda: _init_attn_layer(generator, enc_cfg, dtype=dtype),
                cfg.encoder_layers),
            "final_norm": init_norm(cfg.norm_type, cfg.d_model, dtype),
        }
        # decoder layers get cross-attention
        p["blocks"] = None
        p["layers"] = _stack_init(
            lambda: _init_attn_layer(generator, cfg, cross=True, dtype=dtype),
            cfg.num_layers)
    elif is_homogeneous(cfg) and cfg.scan_layers:
        p["layers"] = _stack_init(
            lambda: _init_layer_of_kind(generator, cfg, kinds[0], dtype),
            cfg.num_layers)
    else:
        p["blocks"] = [_init_layer_of_kind(generator, cfg, kind, dtype)
                       for kind in kinds]
    if cfg.shared_attn_every:       # zamba2's shared block
        p["shared_attn"] = _init_attn_layer(
            generator, cfg.with_updates(moe=False), dtype=dtype)
    p["final_norm"] = init_norm(cfg.norm_type, cfg.d_model, dtype)
    if not cfg.tie_embeddings:
        p["unembed"] = init_dense(generator, cfg.d_model, cfg.vocab_size,
                                  dtype=dtype)
    if cfg.modality == "vision":
        p["vision_proj"] = init_dense(generator, cfg.d_model, cfg.d_model,
                                      dtype=dtype)
    return p


# -- layer application (prefill) ---------------------------------------------------

def _layer_window(cfg, layer_idx):
    """Static window size for a layer (gemma3 local/global pattern)."""
    if cfg.sliding_window and cfg.global_every:
        is_global = (layer_idx + 1) % cfg.global_every == 0
        return 0 if is_global else cfg.sliding_window
    return cfg.sliding_window


def _tp(par, kind):
    return None if par is None else par.tp(kind)


def _apply_attn_layer(lp, cfg, x, *, positions, mask, enc_out=None,
                      window=0, token_mean=None, par=None, seq=None):
    """One attention layer -> (x, MoE aux loss or 0); `token_mean` as in
    `moe.load_balance_loss`; `par` the rank's view on a mesh (its blocks
    cut over "model" where `par.tp` says so), `seq` its block of
    positions under context parallelism (`parallel.SeqBlock`; then
    `enc_out` is the rank's block of frames too)."""
    h = apply_norm(cfg.norm_type, lp["attn_norm"], x, cfg.norm_eps)
    if cfg.attention_kind == "mla":
        a = mla.mla_attention(lp["attn"], cfg, h, positions=positions,
                              mask=mask, tp=_tp(par, "mla"))
    else:
        a = attn_mod.attention(lp["attn"], cfg, h, positions=positions,
                               mask=mask, window=window,
                               tp=_tp(par, "attn"), seq=seq)
    x = x + a
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if enc_out is not None:
        h = apply_norm(cfg.norm_type, lp["cross_norm"], x, cfg.norm_eps)
        Hk, dh = cfg.num_kv_heads, cfg.head_dim
        k = dense(lp["cross_attn"]["wk"], enc_out)
        v = dense(lp["cross_attn"]["wv"], enc_out)
        k = k.reshape(*k.shape[:-1], Hk, dh)
        v = v.reshape(*v.shape[:-1], Hk, dh)
        x = x + attn_mod.attention(lp["cross_attn"], cfg, h,
                                   positions=positions, mask=None,
                                   causal=False, kv_override=(k, v),
                                   seq=seq)
    if "mlp" in lp:
        h = apply_norm(cfg.norm_type, lp["mlp_norm"], x, cfg.norm_eps)
        if cfg.moe:
            y, aux = moe.moe_ffn(lp["mlp"], cfg, h, token_mean,
                                 tp=_tp(par, "moe"),
                                 ep=None if par is None else par.ep("moe"))
        elif cfg.norm_type == "layernorm":
            y = layers.gelu_mlp(lp["mlp"], h, _tp(par, "mlp"))
        else:
            y = layers.swiglu_mlp(lp["mlp"], h, _tp(par, "mlp"))
        x = x + y
    return x, aux


def _apply_kind(lp, cfg, kind, x, *, positions, mask, enc_out=None,
                window=0, token_mean=None, par=None, seq=None):
    if kind == "attn":
        return _apply_attn_layer(lp, cfg, x, positions=positions, mask=mask,
                                 enc_out=enc_out, window=window,
                                 token_mean=token_mean, par=par, seq=seq)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = apply_norm(cfg.norm_type, lp["norm"], x, cfg.norm_eps)
    if kind == "mamba":
        return x + ssm.mamba2_forward(lp["mamba"], cfg, h,
                                      tp=_tp(par, "mamba")), aux
    if kind == "mlstm":
        return x + xlstm.mlstm_block(lp["mlstm"], cfg, h), aux
    if kind == "slstm":
        y, _ = xlstm.slstm_forward(lp["slstm"], cfg, h)
        return x + y, aux
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


def _encode(params, cfg, frames, remat, par=None):
    """seamless' encoder over (B, F, d) frame embeddings: the reference's
    scanned stack with a bidirectional zero mask (which only the einsum
    path reads: flash and chunked attention run it causally, as in the
    reference), each layer checkpointed under `remat`; on a mesh computed
    whole, its leaves taken a layer at a time. Under context parallelism
    `frames` are the rank's block: its queries attend to every rank's
    keys at their absolute positions (bidirectional on the einsum path;
    where one device would take the flash kernel, which the block's
    query offset refuses, the einsum path runs it under the causal mask
    the kernel applies)."""
    enc_cfg = cfg.with_updates(moe=False)
    take = _taker(par)
    e = dense(take(params["input_proj"], "encoder", "input_proj"), frames)
    B, F = e.shape[:2]
    sq = None if par is None else par.seq()
    blk = None if sq is None else sq.block([F], e.device)
    pos = (torch.arange(F, device=e.device) if blk is None
           else blk.q_pos)
    epos = pos.to(torch.int32)[None].expand(B, F)
    T = F if blk is None else blk.k_pos.numel()
    emask = torch.zeros((F, T), dtype=torch.float32, device=e.device)
    if blk is not None and attn_mod.flash_tiles(enc_cfg, T, T,
                                                enc_cfg.head_dim):
        emask = attn_mod.make_attention_mask(F, T, causal=True,
                                             q_pos=blk.q_pos,
                                             k_pos=blk.k_pos,
                                             device=e.device)

    def layer(lp, e):
        lp = take(lp, "encoder", "layers")
        return _apply_attn_layer(lp, enc_cfg, e, positions=epos, mask=emask,
                                 seq=blk)

    stack = _layers(params, par)
    for i in range(cfg.encoder_layers):
        e, _ = _call(remat, layer, stack(i), e)
    return apply_norm(cfg.norm_type,
                      take(params["final_norm"], "encoder", "final_norm"),
                      e, cfg.norm_eps)


def _taker(par):
    """`Parallel.take` on a mesh; off it the stored leaves are the
    whole ones."""
    if par is None:
        return lambda sub, *key: sub
    return par.take


def _layers(params, par):
    """i -> layer i's stored leaves of the stacked "layers" subtree."""
    if par is None:
        return lambda i: layer_params(params, i)
    stacked = par.unstack(params["layers"])
    return lambda i: par.layer(stacked, i)


def _remat(cfg, params):
    """Whether to recompute each layer in the backward pass (`cfg.remat`,
    the reference's `jax.checkpoint`): only when a backward pass can run,
    i.e. grad mode is on and a parameter requires grad, so the prefill
    and decode paths run as without it."""
    return bool(cfg.remat and torch.is_grad_enabled()
                and any(t.requires_grad for t in tree_leaves(params)))


def _call(remat, fn, *args):
    """fn(*args), checkpointed when `remat`: its activations are dropped
    after the forward pass and recomputed in the backward pass. The values
    are the same. The zoo's layers draw no random numbers, so the
    recompute needs no saved RNG state (`preserve_rng_state=False`): the
    CUDA RNG state is not read, a read that the capture of a step as a
    CUDA graph (`launch.train.make_graphed_train_step`) may refuse."""
    if remat:
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False)
    return fn(*args)


def forward(params, cfg, batch, token_mean=None):
    """batch: {"tokens": (B,S) integer, ["vision_embeds" (B, P, d) |
    "audio_frames" (B, F, d)]}. Returns (logits (B, S_total, V) float32,
    aux_loss scalar), S_total = P + S under the vision frontend; the MoE
    aux loss takes its token means through `token_mean` (None: over the
    batch's tokens; `moe.load_balance_loss`). Mamba
    layers run the reference's prefill (`ssd_chunked`); the scan kernel is
    reached, as in the reference, through
    `ssm.mamba2_forward(..., use_kernel=True)`. On a mesh `params` are the
    rank's stored shards and the logits its vocabulary columns where the
    vocabulary is cut over "model" (module docstring)."""
    par = parallel.current()
    with _regathering(par, cfg, params):
        x, aux = _forward(params, cfg, batch, token_mean, par)
        return _logits(params, cfg, x, par), aux


def _regathering(par, cfg, params):
    """On a mesh without remat: the backward pass gathers each layer again
    (`Parallel.regathering`)."""
    if (par is not None and not _remat(cfg, params)
            and torch.is_grad_enabled()
            and any(t.requires_grad for t in tree_leaves(params))):
        return par.regathering()
    return contextlib.nullcontext()


def _forward(params, cfg, batch, token_mean, par):
    take = _taker(par)
    adt = cfg.activation_dtype
    x = embed(take(params["embed"], "embed"), batch["tokens"], adt,
              _tp(par, "vocab"))
    segments = [x.shape[1]]
    if cfg.modality == "vision":
        vis = dense(take(params["vision_proj"], "vision_proj"),
                    batch["vision_embeds"].to(adt))
        x = torch.cat([vis, x], dim=1)
        segments = [vis.shape[1]] + segments
    B, S = x.shape[:2]
    dev = x.device
    # under context parallelism the rank's block of positions: its queries
    # at their absolute positions, against every rank's T keys
    sq = None if par is None else par.seq()
    blk = None if sq is None else sq.block(segments, dev)
    qpos = None if blk is None else blk.q_pos
    kpos = None if blk is None else blk.k_pos
    T = S if blk is None else kpos.numel()
    positions = (torch.arange(S, device=dev) if blk is None
                 else qpos).to(torch.int32)[None].expand(B, S)

    remat = _remat(cfg, params)
    enc_out = None
    if cfg.encoder_layers:
        enc_out = _encode(params["encoder"], cfg,
                          batch["audio_frames"].to(adt), remat, par)

    kinds = cfg.layer_kinds()
    aux_total = torch.zeros((), dtype=torch.float32, device=dev)
    if cfg.attn_impl == "chunked":
        # online-softmax path: no (S,S) mask tensors; windows are scalars
        masks = {"default": None, "global": None, "local": None}
    else:
        causal = attn_mod.make_attention_mask(S, T, causal=True,
                                              q_pos=qpos, k_pos=kpos,
                                              device=dev)
        masks = {"default": causal, "global": causal}
        if cfg.sliding_window:
            masks["local"] = attn_mod.make_attention_mask(
                S, T, causal=True, window=cfg.sliding_window, q_pos=qpos,
                k_pos=kpos, device=dev)
            if not cfg.global_every:
                masks["default"] = masks["local"]

    if params.get("layers") is not None:
        # the reference's scanned stack: the window rides on the mask, and
        # the window argument is 0 whenever a mask is given
        kind = kinds[0] if is_homogeneous(cfg) else "attn"

        def body(lp, x, shared, mask, window):
            # one step of the reference's scan body: the shared block (where
            # it runs) and the layer
            lp = take(lp, "layers")
            if shared is not None:
                x, _ = _apply_attn_layer(take(shared, "shared_attn"), cfg, x,
                                         positions=positions,
                                         mask=masks["default"],
                                         token_mean=token_mean, par=par,
                                         seq=blk)
            return _apply_kind(lp, cfg, kind, x, positions=positions,
                               mask=mask, enc_out=enc_out, window=window,
                               token_mean=token_mean, par=par, seq=blk)

        stack = _layers(params, par)
        for i in range(cfg.num_layers):
            lp = stack(i)
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
            shared = params["shared_attn"] if uses_shared(cfg, i) else None
            x, aux = _call(remat, body, lp, x, shared, mask, window)
            aux_total = aux_total + aux
    else:
        def one_block(lp, x, kind, mask, window, i):
            return _apply_kind(take(lp, "blocks", i), cfg, kind, x,
                               positions=positions, mask=mask,
                               enc_out=enc_out, window=window,
                               token_mean=token_mean, par=par, seq=blk)

        for i, (lp, kind) in enumerate(zip(params["blocks"], kinds)):
            if uses_shared(cfg, i):
                x, _ = _apply_attn_layer(
                    take(params["shared_attn"], "shared_attn"), cfg, x,
                    positions=positions, mask=masks["default"],
                    token_mean=token_mean, par=par, seq=blk)
            w = _layer_window(cfg, i)
            mask = (masks["local"] if (w and masks.get("local") is not None)
                    else masks["default"])
            x, aux = _call(remat, one_block, lp, x, kind, mask, w, i)
            aux_total = aux_total + aux
    return x, aux_total


def _logits(params, cfg, x, par, softcap=True):
    """The final norm and the unembedding: float32 logits, under a cut
    vocabulary the rank's columns of them (the decode step applies no
    softcap, as the reference's)."""
    take = _taker(par)
    x = apply_norm(cfg.norm_type, take(params["final_norm"], "final_norm"),
                   x, cfg.norm_eps)
    tp = _tp(par, "vocab")
    if cfg.tie_embeddings:
        logits = unembed(take(params["embed"], "embed"), x, tp)
    else:
        logits = layers.column(take(params["unembed"], "unembed"), x,
                               tp).float()
    if softcap and cfg.logits_softcap:
        logits = cfg.logits_softcap * torch.tanh(logits / cfg.logits_softcap)
    return logits


def loss_fn(params, cfg, batch, token_mean=None):
    """Causal LM loss plus `aux_loss_weight` x the MoE aux loss (its token
    means through `token_mean`, as in `forward`). labels: (B, S) with -1 =
    ignore. Returns (loss, {"nll", "aux"}). On a mesh whose vocabulary is
    cut over "model", the log-sum-exp and the label's logit come from the
    rank's logit columns: their max, then one sum over "model" of the
    exponentials' sums and the label's logit (no rank builds whole-vocab
    logits), fused with the unembedding (`layers.vocab_parallel_nll`)
    where no softcap applies."""
    labels = batch["labels"]
    valid = labels >= 0
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    par = parallel.current()
    tp = _tp(par, "vocab")
    if tp is not None and not cfg.logits_softcap:
        with _regathering(par, cfg, params):
            x, aux = _forward(params, cfg, batch, token_mean, par)
            take = _taker(par)
            # token positions only (the vision prefix predicts nothing)
            x = apply_norm(cfg.norm_type,
                           take(params["final_norm"], "final_norm"),
                           x[:, -labels.shape[1]:], cfg.norm_eps)
            w = (take(params["embed"], "embed")["embed"].t()
                 if cfg.tie_embeddings
                 else take(params["unembed"], "unembed")["kernel"])
            nll = layers.vocab_parallel_nll(x, w, safe, tp)
        nll = (nll * valid).sum() / torch.clamp(valid.sum(), min=1)
        return nll + cfg.aux_loss_weight * aux, {"nll": nll, "aux": aux}
    logits, aux = forward(params, cfg, batch, token_mean)
    # logits for token positions only (the vision prefix predicts nothing)
    logits = logits[:, -labels.shape[1]:, :]
    if tp is None:
        lse = torch.logsumexp(logits, dim=-1)                    # (B,S)
        label_logit = torch.gather(logits, -1, safe[..., None])[..., 0]
    else:
        n = logits.shape[-1]
        m = tp.max(logits.detach().amax(dim=-1))
        local = safe - tp.index * n
        inside = (local >= 0) & (local < n)
        mine = torch.gather(logits, -1, torch.where(
            inside, local, torch.zeros_like(local))[..., None])[..., 0]
        parts = torch.stack([torch.exp(logits - m[..., None]).sum(-1),
                             torch.where(inside, mine,
                                         torch.zeros_like(mine))], -1)
        sums, label_logit = tp.g(parts).unbind(-1)
        lse = m + torch.log(sums)
    nll = lse - label_logit
    nll = (nll * valid).sum() / torch.clamp(valid.sum(), min=1)
    return nll + cfg.aux_loss_weight * aux, {"nll": nll, "aux": aux}
