"""Secure aggregation via pairwise additive masking (port of
`repro.core.secure_agg`; Bonawitz et al. 2017 style, single round,
honest-but-curious threat model).

Every client pair (i, j) derives a shared mask from a common seed;
client i adds it, client j subtracts it, so all masks cancel in the SUM
while every individual update the server sees looks like noise. The
masked aggregate equals plain FedAvg up to float rounding; weighting is
applied client-side before masking.

Masking composes with LINEAR aggregation only: the robust aggregators
(median, trimmed mean, Krum) select by order statistics or distances,
which the masks destroy (DESIGN.md §8).

Randomness: `jax.random` cannot be reproduced in torch. The masks come
from one seam, `mask_like`: one CPU `torch.Generator` per pair seed, a
standard normal draw per leaf in sorted-key order, moved to the leaf's
device. The parity tests replace it with the reference's draws.
"""
from __future__ import annotations

from typing import Any, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

Params = Any


def _pair_seed(base_seed: int, i: int, j: int) -> int:
    lo, hi = (i, j) if i < j else (j, i)
    return (base_seed * 1_000_003 + lo * 7919 + hi) % (2 ** 31)


def mask_like(tree: Params, seed: int, scale: float) -> Params:
    """Deterministic mask tree from a pair seed (both clients of the pair
    derive it without communication): scale * N(0, I) per leaf."""
    g = torch.Generator(device="cpu")
    g.manual_seed(int(seed))
    leaves = tree_leaves(tree)
    masks = [(scale * torch.randn(tuple(leaf.shape), generator=g,
                                  dtype=torch.float32)).to(leaf.device)
             for leaf in leaves]
    return tree_unflatten(tree, masks)


def mask_update(client_params: Params, client_id: int,
                participants: Sequence[int], base_seed: int,
                weight: float = 1.0, mask_scale: float = 10.0) -> Params:
    """What client `client_id` uploads: weight * params + sum of +-masks."""
    out = tree_map(lambda p: weight * p.float(), client_params)
    for other in participants:
        if other == client_id:
            continue
        m = mask_like(client_params, _pair_seed(base_seed, client_id, other),
                      mask_scale)
        sign = 1.0 if client_id < other else -1.0
        out = tree_map(lambda a, b: a + sign * b, out, m)
    return out


def secure_fedavg(client_params: List[Params],
                  weights: Optional[Sequence[float]] = None,
                  base_seed: int = 0, mask_scale: float = 10.0) -> Params:
    """FedAvg where the aggregator only ever sees masked updates."""
    n = len(client_params)
    w = np.ones(n) if weights is None else np.asarray(weights, np.float64)
    w = (w / w.sum()).astype(np.float32)
    participants = list(range(n))
    masked = [mask_update(p, i, participants, base_seed, float(w[i]),
                          mask_scale)
              for i, p in enumerate(client_params)]
    total = masked[0]
    for m in masked[1:]:
        total = tree_map(lambda a, b: a + b, total, m)
    return tree_map(lambda t, ref: t.to(ref.dtype), total, client_params[0])
