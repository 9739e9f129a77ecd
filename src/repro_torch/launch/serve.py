"""Serving: prefill, single-token decode steps (eager, and captured as
one CUDA graph), the token-model dispatch for the serving engine, and
the decode state's sharding rules (port of `repro.launch.serve`).

On a mesh (`make_sharded_prefill_step`, `make_sharded_serve_step`) each
rank keeps its shards of the parameters (`specs.tree_shardings`), of the
batch (`train.batch_shardings`) and of the decode state
(`decode_state_shardings`, `token_shardings`). A step gathers the
parameters, and the state over its non-batch axes, runs the
single-device step on the rank's batch rows, and keeps its shards of the
new state. With `attn_impl="flash"` or the kernel prefill, the flash and
scan kernels launch in every rank, on its rows.
"""
from __future__ import annotations

import numpy as np
import torch

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

    The capture follows the fused executor's (`core/simulation.py`): two
    warm-up steps on a side stream on a throwaway clone of the state,
    then one captured step; capturing runs nothing, so `state` is as it
    was given. A capture that fails raises RuntimeError: there is no
    eager fallback on the card. On a CPU state the same in-place body
    runs eagerly."""
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

    side = torch.cuda.Stream(device=dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        scratch = tree_map(torch.clone, state)
        for _ in range(2):
            body(scratch)
    torch.cuda.current_stream(dev).wait_stream(side)
    torch.cuda.synchronize(dev)
    del scratch
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph):
            logits = body(state)
    except Exception as e:
        raise RuntimeError(
            f"the decode step could not be captured as a CUDA graph "
            f"({type(e).__name__}: {e}); the serve step does not fall "
            f"back to eager decode") from e

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
    shards) -> the logits of the rank's batch rows. The shards are cut by
    `specs.tree_shardings` and `train.batch_shardings` of the global
    shapes (`batch_specs`, e.g. `model.train_batch_specs(B, S)` without
    "labels") under the config's rules; `.shardings` holds both."""
    from repro_torch.launch.mesh import gather_tree
    from repro_torch.launch.train import batch_shardings
    mesh = rank_mesh.shape
    with sh.config_rules(model.cfg):
        p_sh = sh.tree_shardings(model.param_specs(), mesh)
        b_sh = batch_shardings(batch_specs, mesh)
    keep = _lead_axes(b_sh["tokens"])
    body = make_prefill_step(model)

    def prefill(params, batch):
        return body(gather_tree(params, p_sh, rank_mesh),
                    gather_tree(batch, b_sh, rank_mesh, keep=keep))

    prefill.shardings = (p_sh, b_sh)
    return prefill


def make_sharded_serve_step(model, rank_mesh, state_specs, token_spec):
    """`make_serve_step` on a rank of `rank_mesh`: (param shards, state
    shards, token shards) -> (the logits of the rank's rows, its new
    state shards). The shards are cut by `specs.tree_shardings`,
    `decode_state_shardings` and `token_shardings` of the global shapes
    (`state_specs`, e.g. `model.decode_state_specs(B, cap)`, and
    `token_spec`); `.shardings` holds the three. The state is gathered
    over its non-batch axes for the step and cut again after it."""
    from repro_torch.launch.mesh import gather_tree, shard_tree
    mesh = rank_mesh.shape
    with sh.config_rules(model.cfg):
        p_sh = sh.tree_shardings(model.param_specs(), mesh)
    st_sh = decode_state_shardings(state_specs, mesh, model.cfg)
    t_sh = token_shardings(token_spec, mesh)
    keep = _lead_axes(t_sh)
    body = make_serve_step(model)

    def local(sharding):
        # the rank's rows: the batch axes cut, every other axis whole
        spec = [e if sh.entry_axes(e) and set(sh.entry_axes(e)) <= set(keep)
                else None for e in sharding.spec]
        return sh.NamedSharding(mesh, sh.P(*spec))

    rows_sh = tree_map(local, st_sh)

    def serve_step(params, state, tokens):
        full = gather_tree(params, p_sh, rank_mesh)
        rows = gather_tree(state, st_sh, rank_mesh, keep=keep)
        logits, new = body(full, rows, tokens)
        return logits, _reshard(new, rows_sh, st_sh, rank_mesh)

    serve_step.shardings = (p_sh, st_sh, t_sh)
    return serve_step


def _reshard(rows, rows_sh, st_sh, rank_mesh):
    """The rank's rows of the state (batch axes cut) -> its shards."""
    def one(x, r, s):
        if not isinstance(x, torch.Tensor) or r.spec == s.spec:
            return x
        index = s.index(_global_shape(x.shape, r), rank_mesh.coords)
        mine = r.index(_global_shape(x.shape, r), rank_mesh.coords)
        rel = tuple(slice(i.start - m.start, i.stop - m.start)
                    for i, m in zip(index, mine))
        return x[rel].clone(memory_format=torch.contiguous_format)
    return tree_map(one, rows, rows_sh, st_sh)


def _global_shape(shape, sharding):
    return tuple(d * sh.axis_size(sharding.mesh, e) for d, e in
                 zip(shape, list(sharding.spec)
                     + [None] * (len(shape) - len(sharding.spec))))
