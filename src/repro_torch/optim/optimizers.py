"""Functional optimizers on nested dicts of tensors (port of
`repro.optim.optimizers`: `sgd`, `adamw`, `adam`, `apply_updates`).

The optax-style convention of the reference:
    opt = sgd(lr, momentum)
    state = opt.init(params)
    updates, state = opt.update(grads, state, params)
    params = apply_updates(params, updates)

Momentum is `mu = momentum * mu + g`, the update `-lr * mu`. State is
created fresh for every local-training event, as in the reference; there
is no persistent `torch.optim` object. Adam (the FedAdam server
optimizer) keeps its step count in its state. (The reference's Nesterov
variant and learning-rate schedules serve no caller of the port.)

Adam's step count is a float32 tensor on the parameters' device and its
bias corrections are computed there, so a round captured as a CUDA graph
reads each replay's own step.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.tree import tree_leaves, tree_map


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[..., Any]


def apply_updates(params, updates):
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)


def sgd(lr: float, momentum: float = 0.0):
    def init(params):
        if momentum:
            return {"mu": tree_map(torch.zeros_like, params)}
        return {}

    def update(grads, state, params=None):
        if momentum:
            mu = tree_map(lambda m, g: momentum * m + g, state["mu"], grads)
            return tree_map(lambda m: -lr * m, mu), {"mu": mu}
        return tree_map(lambda g: -lr * g, grads), state

    return Optimizer(init, update)


def _zeros_f32(p):
    return torch.zeros_like(p, dtype=torch.float32)


def adamw(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.0):
    """Adam with decoupled weight decay; moments in float32, the bias
    corrections 1 - b**t computed in float32 as the reference does, from
    the step count on the device."""
    def init(params):
        device = tree_leaves(params)[0].device
        return {"m": tree_map(_zeros_f32, params),
                "v": tree_map(_zeros_f32, params),
                "count": torch.zeros((), dtype=torch.float32, device=device)}

    def update(grads, state, params):
        c = state["count"] + 1
        m = tree_map(lambda m, g: b1 * m + (1 - b1) * g.float(),
                     state["m"], grads)
        v = tree_map(lambda v, g: b2 * v + (1 - b2) * torch.square(g.float()),
                     state["v"], grads)
        bc1, bc2 = 1 - b1 ** c, 1 - b2 ** c

        def upd(m, v, p):
            step = (m / bc1) / (torch.sqrt(v / bc2) + eps)
            if weight_decay:
                step = step + weight_decay * p.float()
            return (-lr * step).to(p.dtype)

        return (tree_map(upd, m, v, params),
                {"m": m, "v": v, "count": c})

    return Optimizer(init, update)


def adam(lr: float, **kw):
    return adamw(lr, weight_decay=0.0, **kw)
