"""The zoo's training step and a small training driver (port of
`repro.launch.train`: `make_train_step`, `train_loop`, `main`).

A step is functional, as in the reference: parameters and optimizer state
are trees of tensors (no `nn.Module`, no `torch.optim`); the gradient is
`torch.autograd.grad` of `model.loss` with respect to the parameter
leaves. `cfg.grad_accum > 1` splits the global batch into micro-batches
and accumulates their gradients in float32. Training runs the plain
attention and Mamba2 paths: the flash and scan kernels have no backward
pass and raise under autograd, as the reference's Pallas calls do.

    python -m repro_torch.launch.train --arch xlstm-125m --steps 30

trains a reduced config on `MarkovLM` batches on the card (`--device
cpu` on the CPU), its step captured as one CUDA graph
(`make_graphed_train_step`) as the reference jits it.

The mesh half: `batch_shardings` and `train_state_shardings` are the
reference's rules, and `make_sharded_train_step` runs the step on the
ranks of a `launch.mesh.World` laid out as a mesh. Each rank keeps only
its shard of every parameter, optimizer-state and batch leaf, cut by
those rules, so its memory for them is the reference's. A step runs the
loss on the rank's batch rows and its stored shards (`models.parallel`):
each layer gathers its leaves when it runs (and again in remat's
recompute), and under the tp profile a rank computes its "model" shard of
each layer, as GSPMD splits the reference's matmuls. The backward pass
hands each leaf's gradient back summed over the batch axes and cut to the
rank's shard (a reduce-scatter a layer); the step clips by the global
norm and updates its shards.
"""
from __future__ import annotations

import argparse
import functools
import itertools
import math
import re
import time

import numpy as np
import torch

from repro_torch.data.pipeline import MarkovLM
from repro_torch.device import generator, resolve_device
from repro_torch.launch.graph import capture
from repro_torch.optim import optimizers
from repro_torch.sharding import specs as sh
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


def value_and_grad(loss_fn, params, batch):
    """((loss, aux), grads) of `loss_fn(params, batch) -> (loss, aux)`,
    detached; a leaf the loss does not reach gets a zero gradient, as
    under `jax.grad`."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    with torch.enable_grad():
        loss, aux = loss_fn(tree_unflatten(params, leaves), batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return ((loss.detach(), tree_map(torch.Tensor.detach, aux)),
            tree_unflatten(params, grads))


def make_train_step(model, opt, clip_norm: float = 1.0):
    """One optimizer step: (params, opt_state, batch) -> (params,
    opt_state, {"loss", "grad_norm", **aux}), every metric a device
    tensor. cfg.grad_accum > 1 splits the global batch into that many
    micro-batches (the reference's reshape: micro-batch i is rows
    i*B/accum to (i+1)*B/accum), sums their gradients in float32 and
    divides by accum; the loss and aux are the means over micro-batches.
    Gradients are then clipped to `clip_norm` by their global norm
    (0 or None: not clipped, the norm still reported)."""
    accum = getattr(model.cfg, "grad_accum", 1)

    def train_step(params, opt_state, batch):
        if accum > 1:
            gsum = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                  device=p.device), params)
            lsum = torch.zeros((), dtype=torch.float32,
                               device=tree_leaves(params)[0].device)
            auxs = []
            for i in range(accum):
                mb = {k: v.reshape((accum, v.shape[0] // accum)
                                   + tuple(v.shape[1:]))[i]
                      for k, v in batch.items()}
                (loss, aux), g = value_and_grad(model.loss, params, mb)
                gsum = tree_map(lambda a, b: a + b.float(), gsum, g)
                lsum = lsum + loss
                auxs.append(aux)
            grads = tree_map(lambda g: g / accum, gsum)
            loss = lsum / accum
            aux = tree_map(lambda *a: torch.stack(a).mean(0), *auxs)
        else:
            (loss, aux), grads = value_and_grad(model.loss, params, batch)
        if clip_norm:
            grads, gnorm = optimizers.clip_by_global_norm(grads, clip_norm)
        else:
            gnorm = optimizers.global_norm(grads)
        updates, opt_state = opt.update(grads, opt_state, params)
        params = optimizers.apply_updates(params, updates)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm, **aux}
    return train_step


def _batch_key(batch):
    return tuple((k, tuple(v.shape), v.dtype) for k, v in sorted(
        batch.items()))


def make_graphed_train_step(model, opt, params, opt_state, batch,
                            clip_norm: float = 1.0, warmup: int = 2):
    """`make_train_step` bound to `params` and `opt_state` and, on the
    card, captured as one CUDA graph: the port's form of the reference's
    `jax.jit(make_train_step(...))` with its state donated.

    `batch` is an example of the step's input. Returns `step(params,
    opt_state, batch) -> (params, opt_state, metrics)`, which copies
    `batch` into the graph's static batch buffers, replays the captured
    step (the eager step's micro-batch loop, gradients, float32
    accumulation, clip and optimizer update, its results copied into the
    `params` and `opt_state` buffers, AdamW's step count included) and
    returns `params` and `opt_state`, updated in place, and the graph's
    static metric tensors (overwritten by the next call: clone them to
    keep them). It accepts only the `params` and `opt_state` it was made
    with.

    As `jax.jit` retraces for a new input shape, a batch whose shapes or
    dtypes differ from every earlier one is captured as a graph of its
    own, in the first graph's memory pool. Each capture is
    `launch.graph.capture`'s: `warmup` steps on a side stream on a
    throwaway clone of the params and optimizer state, then one captured
    step, which runs nothing. A capture that fails raises RuntimeError:
    there is no eager fallback on the card. On CPU params the same
    in-place body runs eagerly."""
    eager = make_train_step(model, opt, clip_norm)
    state = {"params": params, "opt": opt_state}

    def body(st, b):
        p, s, metrics = eager(st["params"], st["opt"], b)
        for old, new in zip(tree_leaves(st), tree_leaves(
                {"params": p, "opt": s})):
            if new is not old:
                old.copy_(new)
        return metrics

    def check(p, s):
        if p is not params or s is not opt_state:
            raise ValueError("a graphed train step runs only on the params "
                             "and the optimizer state it was made with")

    dev = tree_leaves(params)[0].device
    if dev.type != "cuda":
        def step(p, s, b):
            check(p, s)
            return params, opt_state, body(state, b)
        return step

    graphs = {}         # batch shapes and dtypes -> (buffers, graph, metrics)

    def graph_for(b):
        key = _batch_key(b)
        if key not in graphs:
            buf = {k: v.to(dev, copy=True) for k, v in b.items()}
            pool = next(iter(graphs.values()))[1].pool() if graphs else None
            graph, metrics = capture(lambda st: body(st, buf), state,
                                     "the train step", pool=pool,
                                     warmup=warmup)
            graphs[key] = (buf, graph, metrics)
        return graphs[key]

    graph_for(batch)

    def step(p, s, b):
        check(p, s)
        buf, graph, metrics = graph_for(b)
        for k, v in b.items():
            buf[k].copy_(v)
        graph.replay()
        return params, opt_state, metrics

    step.graphs = graphs
    return step


def batch_shardings(batch_specs, mesh):
    """Rows over the batch axes and, on the multi-pod fsdp mesh, the
    sequence over "model" (the reference's rule)."""
    ba = sh.batch_axes(mesh)
    ba = ba if len(ba) > 1 else ba[0]
    sa = sh.seq_axis(mesh)

    def one(s):
        spec = sh.P(ba, sa) if len(s.shape) >= 2 else sh.P(ba)
        return sh.NamedSharding(mesh, sh.fit_spec(s.shape, spec, mesh))
    return tree_map(one, batch_specs)


def train_state_shardings(params_shape, opt_shape, mesh):
    """(parameter shardings, optimizer-state shardings): the moments under
    m/, v/ and mu/ mirror their parameter's spec, scalars are
    replicated."""
    p_sh = sh.tree_shardings(params_shape, mesh)

    def one(pair):
        path, leaf = pair
        if leaf.ndim == 0:
            return sh.NamedSharding(mesh, sh.P())
        clean = re.sub(r"^(m|v|mu)/", "", path)
        if sh._STACKED_RE.search(clean) and leaf.ndim >= 2:
            inner = sh.spec_for_param(clean, leaf.shape[1:], mesh)
            spec = sh.fit_spec(leaf.shape, sh.P(None, *inner), mesh)
        else:
            spec = sh.spec_for_param(clean, leaf.shape, mesh)
        return sh.NamedSharding(mesh, spec)
    return p_sh, tree_map(one, sh._paths(opt_shape))


class _MicroBatchMean(torch.autograd.Function):
    """The mean over micro-batch `j` of the global batch (of `slots`
    micro-batches) of a token mean taken over this rank's piece of it,
    which is `share` of the micro-batch's rows: one sum all_reduce of an
    (slots, E) slot expansion. Its backward is the local share (grad x
    share), not a collective: each rank differentiates only through its
    own tokens, and the step's sum of the ranks' gradients adds the
    shares up."""

    @staticmethod
    def forward(ctx, x, share, j, slots, axis):
        from repro_torch.core.collectives import all_reduce_sum
        ctx.share = share
        buf = x.new_zeros((slots,) + tuple(x.shape))
        buf[j] = x.detach() * share
        return all_reduce_sum(buf, axis)[j].clone()

    @staticmethod
    def backward(ctx, g):
        return g * ctx.share, None, None, None, None


def _rounds(block, rows, accum, global_rows):
    """This rank's rows, block `block` of `rows` rows of the global batch,
    cut at the boundaries of the single-device step's micro-batches (rows
    j*m to (j+1)*m, m = global_rows / accum): one piece (start, stop, j)
    in local rows, or None, a round. Every rank runs as many rounds. The
    pieces of a micro-batch that several ranks hold share one round, so
    the token means taken over its ranks (`_MicroBatchMean`) meet in one
    collective; a rank's whole micro-batches take its rounds in order.
    Where rows and micro-batches nest (one divides the other) no round is
    None; where a rank's rows straddle micro-batches, a rank holding no
    row of a round's micro-batch gets None there."""
    if global_rows % accum:
        raise ValueError(f"{global_rows} rows do not split into "
                         f"grad_accum={accum} micro-batches")
    m = global_rows // accum
    free = [0] * (global_rows // rows)       # each block's next round
    mine = {}
    for j in range(accum):
        holders = range(j * m // rows, ((j + 1) * m - 1) // rows + 1)
        r = max(free[h] for h in holders)
        for h in holders:
            free[h] = r + 1
        if block in holders:
            lo = block * rows
            mine[r] = (max(j * m, lo) - lo, min((j + 1) * m, lo + rows) - lo,
                       j)
    return [mine.get(r) for r in range(max(free))]


def make_sharded_train_step(model, opt, rank_mesh, batch_specs,
                            clip_norm: float = 1.0):
    """`make_train_step` on a rank of `rank_mesh` (a `launch.mesh.RankMesh`):
    (param shards, opt-state shards, batch shards) -> (param shards,
    opt-state shards, metrics), every shard cut by `train_state_shardings`
    / `batch_shardings` of the global shapes (`batch_specs`: the global
    batch's, e.g. `model.train_batch_specs(B, S)`) under the config's
    rules (`specs.config_rules`); `.shardings` holds the three. The
    metrics are the global batch's and equal on every rank.

    The objective is the single-device step's: the mean over its
    grad_accum micro-batches (rows j*B/accum to (j+1)*B/accum of the
    global batch) of each micro-batch's loss. A rank runs its rows piece
    by piece, each piece within one micro-batch j, in rounds that every
    rank runs alike (`_rounds`), and weighs a piece's mean nll by its
    share n / N_j of micro-batch j's valid labels (N_j summed over the
    ranks), so the sum of the ranks' gradients is the single-device
    step's in exact arithmetic, padded labels included; MoE's aux loss
    takes its token means over micro-batch j's tokens on every rank
    (`_MicroBatchMean`, passed to `model.loss` as its `token_mean`). Any
    layout GSPMD runs is taken: a rank's rows may straddle micro-batches
    (12 rows on 4 ranks under grad_accum 3), and in a round whose
    micro-batch holds none of its rows a rank runs its first row weighted
    0, so that it joins the round's gathers, gradient sums and token
    means (with zeros), and adds the round's summed gradient.

    MoE routes groups of `moe_group_size` consecutive tokens with a
    capacity from the group size: a piece's tokens and a micro-batch's
    must both be a multiple of it for the drops to be the single-device
    step's. Every MoE config meets this at train_4k on 16x16 (1 x 4096
    tokens a rank, groups of 512) and the reduced ones at pieces of
    B x S >= 64. Under the single-pod moe profile, where "model" cuts the
    rows, a rank runs its experts on its "model" peers' tokens too
    (`models.moe`, one all-to-all each way a layer): the peers' pieces of
    a round must then route as many groups; a layout whose pieces differ
    along "model" raises.

    Under the multi-pod fsdp profile the batch stays cut by sequence over
    "model" (`specs.context_parallel`, dense token-only stacks): a rank
    runs its rows' block of positions (`models.parallel`'s `seq` view),
    and the label counts and the gradients are summed over the batch axes
    and that axis. `.local_shapes` holds the shapes of the last step's
    local batch.

    The step donates its parameter and optimizer-state shards, as the
    reference's dry-run lowers its step (`jax.jit(step,
    donate_argnums=(0, 1))`): it writes the new shards and moments into
    the tensors it was given, leaf by leaf
    (`optimizers.update_in_place`, the functional update's bits), and
    returns those same tensors, so a rank holds one leaf's update beside
    the gradients rather than old and new trees at once. A caller that
    needs the shards from before the step keeps a copy."""
    from repro_torch.core.collectives import all_reduce_sum
    from repro_torch.launch.mesh import gather_tree
    from repro_torch.models import parallel
    mesh = rank_mesh.shape
    cfg = model.cfg
    accum = getattr(cfg, "grad_accum", 1)
    p_specs = model.param_specs()
    with sh.config_rules(cfg):
        p_sh, o_sh = train_state_shardings(p_specs, opt.init(p_specs), mesh)
        b_sh = batch_shardings(batch_specs, mesh)
        spec = b_sh["labels"].spec
        batch_names = sh.entry_axes(spec[0] if len(spec) else None)
        # context parallelism: the rank keeps its block of positions
        seq_names = (sh.entry_axes(spec[1]) if len(spec) > 1
                     and sh.context_parallel(cfg, mesh) else ())
        sum_names = tuple(a for a in mesh.axis_names
                          if a in batch_names + seq_names)
        view = parallel.Parallel(cfg, rank_mesh, p_sh, p_specs,
                                 batch_axes=sum_names,
                                 row_axes=batch_names, seq=seq_names)
    baxis = rank_mesh.axis(sum_names) if sum_names else None
    world = rank_mesh.axis(mesh.axis_names)
    coords = rank_mesh.coords
    label_shape = tuple(batch_specs["labels"].shape)
    rows = b_sh["labels"].index(label_shape, coords)[0]
    n = rows.stop - rows.start
    rounds = _rounds(rows.start // n, n, accum, label_shape[0])
    micro_rows = label_shape[0] // accum
    if view.expert_parallel:
        # the all-to-all swaps equal blocks: the ranks along "model" must
        # route as many tokens a round (a round one holds no row of: one
        # row), on every rank of the mesh alike
        def lengths(c):
            r = b_sh["labels"].index(label_shape, c)[0]
            return tuple(1 if p is None else p[1] - p[0] for p in _rounds(
                r.start // n, n, accum, label_shape[0]))
        groups: dict = {}
        for c in itertools.product(*(range(k) for k in mesh.axis_sizes)):
            c = dict(zip(mesh.axis_names, c))
            key = tuple(v for a, v in c.items() if a != view.name)
            groups.setdefault(key, set()).add(lengths(c))
        bad = [g for g in groups.values() if len(g) > 1]
        if bad:
            raise ValueError(
                f"expert parallelism over {view.name!r}: the ranks' pieces "
                f"of {label_shape[0]} rows under grad_accum={accum} differ "
                f"along it ({sorted(bad[0])})")
    # ranks holding the same block of a leaf: its squared norm is summed
    # once a block over the world
    reps = [mesh.size // math.prod(mesh.shape[a] for a in s.axes())
            for s in tree_leaves(p_sh)]
    w_aux = cfg.aux_loss_weight

    def summed(x):
        return x if baxis is None else all_reduce_sum(x, baxis)

    def pad_mean(x):
        """A round that holds none of this rank's rows: the token means'
        collective with zeros."""
        m = x.mean(dim=(0, 1))
        all_reduce_sum(torch.zeros((accum,) + tuple(m.shape), dtype=m.dtype,
                                   device=m.device), baxis)
        return m

    def step(params, opt_state, batch):
        local = gather_tree(batch, b_sh, rank_mesh,
                            keep=batch_names + seq_names)
        step.local_shapes = {k: tuple(v.shape) for k, v in local.items()}
        dev = local["labels"].device
        counts = torch.zeros(accum, dtype=torch.float32, device=dev)
        for a, b, j in filter(None, rounds):
            counts[j] += (local["labels"][a:b] >= 0).sum()
        counts = torch.clamp(summed(counts), min=1.0)
        # per micro-batch: its nll and its aux loss, each rank adding its
        # share
        sums = torch.zeros((accum, 2), dtype=torch.float32, device=dev)
        gsum = None
        for piece in rounds:
            if piece is None:
                # none of this rank's rows: the round's collectives (the
                # layers' gathers and gradient sums, the token means) on
                # one row weighted 0
                mb = {k: v[:1] for k, v in local.items()}
                frac = aux_w = 0.0
                mean = pad_mean if cfg.moe else None
            else:
                a, b, j = piece
                mb = {k: v[a:b] for k, v in local.items()}
                frac = (mb["labels"] >= 0).sum().float() / counts[j]
                share = (b - a) / micro_rows
                aux_w = w_aux
                mean = None if baxis is None else functools.partial(
                    _token_mean, share=share, j=j, slots=accum, axis=baxis)

            def objective(p, mb):
                _, aux = model.loss(p, mb, token_mean=mean)
                return frac * aux["nll"] + aux_w * aux["aux"], aux

            # the gradients come back as this rank's shards of the round's
            # sums over the batch axes (`models.parallel`), a round this
            # rank holds no row of included
            with parallel.use(view):
                (_, aux), g = value_and_grad(objective, params, mb)
            if accum > 1:
                g = tree_map(lambda x: x.float(), g)
            gsum = g if gsum is None else tree_map(torch.add, gsum, g)
            if piece is not None:
                sums[j, 0] += frac * aux["nll"]
                sums[j, 1] += share * aux["aux"]
        # the step owns its gradients: each is dropped as soon as it is
        # used, and clipped in place (ranks sharing a card share its
        # memory; a full-width step's gradients are GBs a rank)
        out = tree_leaves(gsum)
        del gsum, g
        if accum > 1:
            out = [x / accum for x in out]
        nll, aux = summed(sums).mean(0).unbind()
        sq = sum(torch.sum(torch.square(x.float())) / r
                 for x, r in zip(out, reps))
        gnorm = torch.sqrt(all_reduce_sum(sq.reshape(1), world)[0])
        if clip_norm:
            scale = torch.clamp(clip_norm / (gnorm + 1e-9), max=1.0)
            out = [x.mul_(scale) for x in out]
        # donated: the new shards and moments are written into the
        # tensors given, leaf by leaf
        params, opt_state = optimizers.update_in_place(opt, out, opt_state,
                                                       params)
        del out
        return params, opt_state, {"loss": nll + w_aux * aux,
                                   "grad_norm": gnorm, "nll": nll,
                                   "aux": aux}

    step.parallel = view
    step.shardings = (p_sh, o_sh, b_sh)
    return step


def _token_mean(x, *, share, j, slots, axis):
    """`moe.load_balance_loss`'s token mean over micro-batch `j` of the
    global batch, from this rank's (G, S, E) tokens of it."""
    return _MicroBatchMean.apply(x.mean(dim=(0, 1)), share, j, slots, axis)


def device_batch(batch, device):
    """A numpy batch -> tensors on `device`: tokens and labels int64, the
    frontends' inputs as they are."""
    out = {k: torch.as_tensor(np.asarray(v)).to(device)
           for k, v in batch.items()}
    for k in ("tokens", "labels"):
        if k in out:
            out[k] = out[k].long()
    return out


def train_loop(model, steps=50, batch=8, seq_len=128, lr=3e-3, seed=0,
               log_every=10, data=None, *, params=None, device="cuda"):
    """AdamW (weight decay 0.01) on `MarkovLM` batches (or the batches of
    `data`), logging the loss every `log_every` steps and at the last.
    `params` (a tree, e.g. the reference's init through
    `convert.params_from_jax`) replaces the init drawn from `seed`. The
    step is `make_graphed_train_step`'s (one CUDA graph on the card, as
    the reference jits its step), made at the first batch. Returns
    (params, history: [(step, loss), ...])."""
    dev = resolve_device(device)
    cfg = model.cfg
    opt = optimizers.adamw(lr, weight_decay=0.01)
    if params is None:
        params = model.init(generator(seed), dev)
    else:
        # copied: the step updates its params in place
        params = tree_map(lambda p: p.to(dev, copy=True), params)
    opt_state = opt.init(params)
    step_fn = None

    lm = MarkovLM(cfg.vocab_size, seed=seed)
    it = data or lm.batches(batch, seq_len, steps, seed=seed)
    history = []
    t0 = time.perf_counter()
    for i, b in enumerate(it):
        b = device_batch(b, dev)
        if step_fn is None:
            step_fn = make_graphed_train_step(model, opt, params, opt_state,
                                              b)
        params, opt_state, m = step_fn(params, opt_state, b)
        if i % log_every == 0 or i == steps - 1:
            loss = float(m["loss"])
            history.append((i, loss))
            print(f"step {i:4d}  loss {loss:.4f}  "
                  f"({time.perf_counter() - t0:.1f}s)")
    return params, history


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="xlstm-125m")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    from repro_torch.configs.registry import get_config
    from repro_torch.models.model import build_model
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg)
    train_loop(model, steps=args.steps, batch=args.batch,
               seq_len=args.seq_len, device=args.device)


if __name__ == "__main__":
    main()
