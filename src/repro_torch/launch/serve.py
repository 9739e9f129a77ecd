"""Serving: prefill, single-token decode steps (eager, and captured as
one CUDA graph), the token-model dispatch for the serving engine, and
the decode state's sharding rules (port of `repro.launch.serve`).

On a mesh (`make_sharded_prefill_step`, `make_sharded_serve_step`) each
rank keeps its shards of the parameters (`specs.tree_shardings`), of the
batch (`train.batch_shardings`) and of the decode state
(`decode_state_shardings`, `token_shardings`). A step runs the model on
the rank's batch rows and its stored shards (`models.parallel`): each
layer takes its compute slices when it runs, and under the tp profile
(and in every decode step, whose ranks along "model" hold the same rows)
a rank computes its "model" shard of each layer, so its logits are its
vocabulary columns (`gather_logits` joins them); a decode step computes
each dense product whose weight is stored with one dim cut where the
weight lies (`Parallel.stationary`). The decode state's KV
caches stay cut as they are stored, by kv heads or by position, and the
rank computes where its block lies (`Parallel.cache`); the rest of the
state is gathered over its non-batch axes for the step and cut again
after it. With `attn_impl="flash"` or the kernel prefill, the flash and
scan kernels launch in every rank, on its rows and its heads.
"""
from __future__ import annotations

import re

import numpy as np
import torch

from repro_torch.launch.graph import capture
from repro_torch.sharding import specs as sh
from repro_torch.tree import tree_leaves, tree_map


def make_prefill_step(model):
    def prefill(params, batch):
        logits, _ = model.apply(params, batch)
        return logits
    return prefill


def make_serve_step(model):
    def serve_step(params, state, tokens):
        return model.decode_step(params, state, tokens)
    return serve_step


def _write_back(state, new) -> None:
    """Make `state` the state after the step that returned `new`, in its
    own buffers: the caches `decode_step` wrote in place are already
    there, every other leaf (Mamba2 conv / ssm, mLSTM and sLSTM states)
    is copied back, and the index advances by one."""
    for key, sub in state.items():
        if key == "index":
            sub.add_(1)
            continue
        for old, now in zip(tree_leaves(sub), tree_leaves(new[key])):
            if now is not old:
                old.copy_(now)


def make_graphed_serve_step(model, params, state, tokens):
    """The serve step bound to `params` and `state` and, on the card,
    captured as one CUDA graph: the port's form of the reference's
    `jax.jit(model.decode_step)` with its state donated.

    `tokens` is a (B, 1) example of the step's input. Returns
    `step(params, state, tokens) -> (logits, state)`, which copies
    `tokens` into the graph's static token buffer, replays the captured
    `decode_step` and its write-back (`_write_back`), and returns the
    graph's static (B, 1, V) logits (overwritten by the next call: clone
    them to keep them) and `state`, advanced in place. It accepts only
    the `params` and `state` it was made with.

    The capture is `launch.graph.capture`'s: two warm-up steps on a side
    stream on a throwaway clone of the state, then one captured step;
    capturing runs nothing, so `state` is as it was given. A capture that
    fails raises RuntimeError: there is no eager fallback on the card. On
    a CPU state the same in-place body runs eagerly."""
    tok = tokens.clone()

    def body(st):
        logits, new = model.decode_step(params, st, tok)
        _write_back(st, new)
        return logits

    def check(p, st):
        if p is not params or st is not state:
            raise ValueError("a graphed serve step runs only on the params "
                             "and the state it was made with")

    dev = tok.device
    if dev.type != "cuda":
        def step(p, st, tokens):
            check(p, st)
            tok.copy_(tokens)
            return body(state), state
        return step

    graph, logits = capture(body, state, "the decode step")

    def step(p, st, tokens):
        check(p, st)
        tok.copy_(tokens)
        graph.replay()
        return logits, state

    return step


def make_decode_dispatch(cfg, prompts, next_tokens):
    """The micro-batch dispatch for token models: prefill each request's
    prompt through `models.decode.decode_step` and score the greedy
    next-token prediction against `next_tokens`. `prompts` is the
    (n_examples, S) request corpus the traffic generator indexes into;
    returns per-request correctness (a numpy bool array). The requests
    run on the device that holds `params`."""
    from repro_torch.models import decode as decode_mod
    prompts = np.asarray(prompts)
    next_tokens = np.asarray(next_tokens)

    def dispatch(params, example_idx):
        ei = np.asarray(example_idx, np.int64)
        dev = params["embed"]["embed"].device
        toks = torch.as_tensor(prompts[ei], device=dev)
        out = decode_mod.greedy_generate(params, cfg, toks, num_steps=1)
        return out[:, -1].cpu().numpy() == next_tokens[ei]

    return dispatch


def decode_state_shardings(state_shape, mesh, cfg):
    """Sharding rules for decode-state leaves (the reference's).

    (B, cap, Hk, dh) per-layer KV caches: batch over the FSDP axis when
    divisible; heads over "model" when divisible, else the cache
    sequence over "model" when it is longer than 1024. (L, B, cap, Hk,
    dh) layer-stacked caches: the same rule shifted by one, the layer dim
    whole. Recurrent states: batch over FSDP, channels over "model" when
    divisible. Meshes without a "model" axis shard the batch dim only. A
    scalar (the 0-d int32 "index") is replicated."""
    fa = sh.fsdp_axes(mesh)
    ba = fa if len(fa) > 1 else fa[0]
    msize = dict(mesh.shape).get("model", 0)
    bsize = sh.axis_size(mesh, ba)

    def kv_spec(shape, b, seq, heads):
        spec = [None] * len(shape)
        if shape[b] % bsize == 0:
            spec[b] = ba
        if msize and shape[heads] % msize == 0:
            spec[heads] = "model"
        elif msize and shape[seq] % msize == 0 and shape[seq] > 1024:
            spec[seq] = "model"
        return spec

    def rule(leaf):
        ndim = leaf.ndim if isinstance(leaf, torch.Tensor) else 0
        if ndim == 0:
            return sh.NamedSharding(mesh, sh.P())
        shape = tuple(leaf.shape)
        if ndim == 5:
            spec = kv_spec(shape, 1, 2, 3)
        elif ndim == 4:
            spec = kv_spec(shape, 0, 1, 2)
        elif ndim == 3:
            spec = [None] * 3
            if shape[0] % bsize == 0:
                spec[0] = ba
            if msize and shape[2] % msize == 0:
                spec[2] = "model"
        else:
            spec = [None] * ndim
            if shape[0] % bsize == 0:
                spec[0] = ba
        return sh.NamedSharding(mesh, sh.fit_spec(shape, sh.P(*spec), mesh))

    return tree_map(rule, state_shape)


def token_shardings(token_spec, mesh):
    fa = sh.fsdp_axes(mesh)
    ba = fa if len(fa) > 1 else fa[0]
    return sh.NamedSharding(mesh, sh.fit_spec(token_spec.shape, sh.P(ba),
                                              mesh))


def _lead_axes(sharding):
    return sh.entry_axes(sharding.spec[0] if len(sharding.spec) else None)


def make_sharded_prefill_step(model, rank_mesh, batch_specs):
    """`make_prefill_step` on a rank of `rank_mesh`: (param shards, batch
    shards) -> the logits of the rank's batch rows (its vocabulary columns
    where the vocabulary is cut over "model": `gather_logits`; its block
    of positions under the multi-pod fsdp profile's context parallelism,
    `specs.context_parallel`). The shards are cut by
    `specs.tree_shardings` and `train.batch_shardings` of the global
    shapes (`batch_specs`, e.g. `model.train_batch_specs(B, S)` without
    "labels") under the config's rules; `.shardings` holds both,
    `.parallel` the rank's `models.parallel.Parallel`. Under the single-pod
    moe profile the ranks along "model" hold other rows, and each runs its
    experts on their tokens too (the all-to-all of `models.moe`)."""
    from repro_torch.launch.mesh import gather_tree
    from repro_torch.launch.train import batch_shardings
    from repro_torch.models import parallel
    mesh = rank_mesh.shape
    with sh.config_rules(model.cfg):
        p_specs = model.param_specs()
        p_sh = sh.tree_shardings(p_specs, mesh)
        b_sh = batch_shardings(batch_specs, mesh)
        rows = _lead_axes(b_sh["tokens"])
        spec = b_sh["tokens"].spec
        seq = (sh.entry_axes(spec[1]) if len(spec) > 1
               and sh.context_parallel(model.cfg, mesh) else ())
        view = parallel.Parallel(model.cfg, rank_mesh, p_sh, p_specs,
                                 row_axes=rows, seq=seq)
    keep = rows + seq
    body = make_prefill_step(model)

    def prefill(params, batch):
        with parallel.use(view):
            return body(params, gather_tree(batch, b_sh, rank_mesh,
                                            keep=keep))

    prefill.shardings = (p_sh, b_sh)
    prefill.parallel = view
    return prefill


def gather_logits(logits, view):
    """The whole vocabulary of a sharded step's logits (the rank's rows):
    one all-gather over "model" where `view` (the step's `.parallel`)
    cuts the vocabulary."""
    if not view.cut["vocab"]:
        return logits
    from repro_torch.launch.mesh import all_gather
    return all_gather(logits.contiguous(), view.axis, dim=-1)


_KV_LEAF = re.compile(r"^(layers|shared)/\d+/(k|v)$")


def make_sharded_serve_step(model, rank_mesh, state_specs, token_spec):
    """`make_serve_step` on a rank of `rank_mesh`: (param shards, state
    shards, token shards) -> (the logits of the rank's rows, its
    vocabulary columns where the vocabulary is cut over "model"; its new
    state shards). The shards are cut by `specs.tree_shardings`,
    `decode_state_shardings` and `token_shardings` of the global shapes
    (`state_specs`, e.g. `model.decode_state_specs(B, cap)`, and
    `token_spec`); `.shardings` holds the three, `.parallel` the rank's
    view. The tokens are cut over the FSDP axes only, so the ranks along
    "model" hold the same rows under every profile and each computes its
    "model" shard of the layers (`models.parallel`, `decode=True`). A
    dense product whose weight is stored with one dim cut (GQA attention's
    projections, the dense MLPs and Mamba2's `in_proj` / `out_proj` under
    the fsdp and moe profiles) computes where the weight lies instead,
    and the step moves the tokens' activations to it, as the reference's
    compiled decode does (`Parallel.stationary`): the step gathers no
    byte of those weights. Each KV cache of a GQA layer stays as it is
    stored and is written in place: the rank computes with its kv heads,
    or over its block of positions with the partial softmaxes joined over
    the ranks (`Parallel.cache`). Every other state leaf is gathered over
    its non-batch axes for the step and cut again after it: Mamba2's state
    (the scan computed whole on the rank's rows), xLSTM's, the
    cross-attention caches, and MLA's latent and rotary caches, to which
    every rank writes the same new entry while its heads are cut over
    "model" (`models.mla`)."""
    from repro_torch.launch.mesh import cut_from, gather_tree
    from repro_torch.models import parallel
    mesh = rank_mesh.shape
    cfg = model.cfg
    st_sh = decode_state_shardings(state_specs, mesh, cfg)
    caches = {path.rsplit("/", 1)[0]: (tuple(x.shape), s)
              for (path, x), s in zip(tree_leaves(sh._paths(state_specs)),
                                      tree_leaves(st_sh))
              if _KV_LEAF.match(path) and path.endswith("/k")
              and cfg.attention_kind == "gqa"}
    with sh.config_rules(cfg):
        p_specs = model.param_specs()
        p_sh = sh.tree_shardings(p_specs, mesh)
        t_sh = token_shardings(token_spec, mesh)
        keep = _lead_axes(t_sh)
        view = parallel.Parallel(cfg, rank_mesh, p_sh, p_specs,
                                 row_axes=keep, whole=("mamba",),
                                 decode=True, caches=caches,
                                 batch=token_spec.shape[0])
    body = make_serve_step(model)

    # per leaf, the axes the step keeps cut: every stored axis of a kept
    # KV cache, the batch axes (the rank's rows) of the rest; every other
    # axis is gathered
    keeps = tree_map(lambda pair, s: s.axes() if pair[0].rsplit(
        "/", 1)[0] in caches else tuple(keep), sh._paths(state_specs), st_sh)

    def cut(x, s, k):
        if not isinstance(x, torch.Tensor) or set(s.axes()) <= set(k):
            return x
        return cut_from(x, s, rank_mesh, k)

    def serve_step(params, state, tokens):
        rows = gather_tree(state, st_sh, rank_mesh, keep=keeps)
        with parallel.use(view):
            logits, new = body(params, rows, tokens)
        return logits, tree_map(cut, new, st_sh, keeps)

    serve_step.shardings = (p_sh, st_sh, t_sh)
    serve_step.parallel = view
    return serve_step
