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
cpu` on the CPU). The mesh half of the reference's module
(`batch_shardings`, `train_state_shardings`) is ROADMAP §A.16b; it builds
on the spec rules of `repro_torch.sharding.specs`.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.data.pipeline import MarkovLM
from repro_torch.device import generator, resolve_device
from repro_torch.optim import optimizers
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
    `convert.params_from_jax`) replaces the init drawn from `seed`.
    Returns (params, history: [(step, loss), ...])."""
    dev = resolve_device(device)
    cfg = model.cfg
    opt = optimizers.adamw(lr, weight_decay=0.01)
    if params is None:
        params = model.init(generator(seed), dev)
    else:
        params = tree_map(lambda p: p.to(dev), params)
    opt_state = opt.init(params)
    step_fn = make_train_step(model, opt)

    lm = MarkovLM(cfg.vocab_size, seed=seed)
    it = data or lm.batches(batch, seq_len, steps, seed=seed)
    history = []
    t0 = time.perf_counter()
    for i, b in enumerate(it):
        params, opt_state, m = step_fn(params, opt_state,
                                       device_batch(b, dev))
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
