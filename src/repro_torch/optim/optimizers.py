"""Functional optimizers on nested dicts of tensors (port of
`repro.optim.optimizers`: `sgd`, `adamw`, `adam`, `apply_updates`,
`global_norm`, `clip_by_global_norm` and `cosine_schedule`).

The optax-style convention of the reference:
    opt = sgd(lr, momentum)
    state = opt.init(params)
    updates, state = opt.update(grads, state, params)
    params = apply_updates(params, updates)

or, donating params and state, `update_in_place(opt, grads, state,
params)`. Momentum is `mu = momentum * mu + g`, the update `-lr * mu`. State is
created fresh for every local-training event, as in the reference; there
is no persistent `torch.optim` object. Adam (the FedAdam server
optimizer) keeps its step count in its state. `lr` may be a callable of
the step count, as in the reference (`cosine_schedule`; the zoo's
training, `launch/train.py`): SGD then keeps a count too, read before
the increment, Adam after it. (The reference's Nesterov variant serves
no caller of the port.)

Adam's step count is a float32 tensor on the parameters' device and its
bias corrections are computed there, so a round captured as a CUDA graph
reads each replay's own step.
"""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.tree import tree_leaves, tree_map


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[..., Any]


def apply_updates(params, updates):
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)


def update_in_place(opt, grads, state, params):
    """`opt.update` then `apply_updates`, written into the tensors of
    `params` and `state` leaf by leaf: the form of a step whose params
    and optimizer state are donated (the reference's
    `jax.jit(step, donate_argnums=(0, 1))`), which XLA updates in place.
    The arithmetic of each leaf is `opt.update`'s on that leaf, so the
    bits are the functional update's; at most one leaf's update is alive
    at a time. `grads` is the list of gradient leaves in `params`' leaf
    order; each is dropped (set to None) once used. A state entry that is
    a tensor (a step count) is shared by every leaf and written after the
    last. Returns (params, state), the tensors given."""
    p_leaves = tree_leaves(params)
    shared = {k: v for k, v in state.items() if isinstance(v, torch.Tensor)}
    per_leaf = {k: tree_leaves(v) for k, v in state.items()
                if k not in shared}
    new_shared = {}
    for i, p in enumerate(p_leaves):
        g, grads[i] = grads[i], None
        one = dict(shared, **{k: v[i] for k, v in per_leaf.items()})
        u, new = opt.update(g, one, p)
        del g
        p.copy_(apply_updates(p, u))
        del u
        for k, v in per_leaf.items():
            v[i].copy_(new[k])
        new_shared = {k: new[k] for k in shared}
    for k, v in new_shared.items():
        state[k].copy_(v)
    return params, state


def global_norm(tree):
    """sqrt of the sum of squares of every leaf, in float32, as a device
    tensor (no host read)."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree)))


def clip_by_global_norm(grads, max_norm):
    """(grads scaled by min(1, max_norm / (norm + 1e-9)), norm)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return tree_map(lambda g: g * scale, grads), norm


def _count(params):
    return torch.zeros((), dtype=torch.float32,
                       device=tree_leaves(params)[0].device)


def sgd(lr, momentum: float = 0.0):
    """SGD with heavy-ball momentum. A callable `lr` is read at the step
    count before this step (the reference's order); the state then keeps
    that count as a float32 device tensor."""
    scheduled = callable(lr)

    def init(params):
        state = {"mu": tree_map(torch.zeros_like, params)} if momentum else {}
        if scheduled:
            state["count"] = _count(params)
        return state

    def update(grads, state, params=None):
        new = {}
        if scheduled:
            lr_t = lr(state["count"])
            new["count"] = state["count"] + 1
        else:
            lr_t = lr
        if momentum:
            mu = tree_map(lambda m, g: momentum * m + g, state["mu"], grads)
            return tree_map(lambda m: -lr_t * m, mu), dict(new, mu=mu)
        return tree_map(lambda g: -lr_t * g, grads), new

    return Optimizer(init, update)


def _zeros_f32(p):
    return torch.zeros_like(p, dtype=torch.float32)


def adamw(lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.0):
    """Adam with decoupled weight decay; moments in float32, the bias
    corrections 1 - b**t computed in float32 as the reference does, from
    the step count on the device. A callable `lr` is read at the count
    after this step's increment."""
    def init(params):
        return {"m": tree_map(_zeros_f32, params),
                "v": tree_map(_zeros_f32, params),
                "count": _count(params)}

    def update(grads, state, params):
        c = state["count"] + 1
        lr_t = lr(c) if callable(lr) else lr
        m = tree_map(lambda m, g: b1 * m + (1 - b1) * g.float(),
                     state["m"], grads)
        v = tree_map(lambda v, g: b2 * v + (1 - b2) * torch.square(g.float()),
                     state["v"], grads)
        bc1, bc2 = 1 - b1 ** c, 1 - b2 ** c

        def upd(m, v, p):
            step = (m / bc1) / (torch.sqrt(v / bc2) + eps)
            if weight_decay:
                step = step + weight_decay * p.float()
            return (-lr_t * step).to(p.dtype)

        return (tree_map(upd, m, v, params),
                {"m": m, "v": v, "count": c})

    return Optimizer(init, update)


def adam(lr: float, **kw):
    return adamw(lr, weight_decay=0.0, **kw)


def cosine_schedule(peak_lr, warmup_steps, total_steps, floor=0.0):
    """Linear warmup to `peak_lr` over `warmup_steps`, then a cosine decay
    to `floor` at `total_steps`. The returned function takes the step
    count (a tensor or a number) and returns a float32 tensor on its
    device."""
    def lr(step):
        step = torch.as_tensor(step, dtype=torch.float32)
        warm = peak_lr * step / max(1, warmup_steps)
        t = torch.clamp((step - warmup_steps)
                        / max(1, total_steps - warmup_steps), 0.0, 1.0)
        cos = floor + (peak_lr - floor) * 0.5 * (1 + torch.cos(math.pi * t))
        return torch.where(step < warmup_steps, warm, cos)
    return lr
