"""Functional optimizers on nested dicts of tensors (port of
`repro.optim.optimizers.sgd` and `apply_updates`).

The optax-style convention of the reference:
    opt = sgd(lr, momentum)
    state = opt.init(params)
    updates, state = opt.update(grads, state, params)
    params = apply_updates(params, updates)

Momentum is `mu = momentum * mu + g`, the update `-lr * mu`. State is
created fresh for every local-training event, as in the reference; there
is no persistent `torch.optim` object. (The reference's Nesterov variant,
learning-rate schedules and step count serve no caller of this slice.)
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.tree import tree_map


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
