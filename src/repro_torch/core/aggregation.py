"""Aggregation operators (port of `repro.core.aggregation`: the host
operators and the undefended stacked operators).

All operators implement Eq. (5): theta_g = sum_c (n_c / N) theta_c,
generalized with per-client weights / participation masks.

* HOST level — operates on a *list* of client parameter trees.
* STACKED level — operates on ONE tree whose leaves carry a leading
  client axis (the vectorized engine and every strategy's aggregation
  event). Every weighted reduction lowers onto the `fedavg_agg` kernel
  through the ravel path in `kernels/ops.py`; gossip is a dense mixing
  matmul (each output row mixes several inputs), left to `torch.matmul`
  as the reference leaves it to XLA.

Robust defenses, the fault-injection `alive` masks, masked gossip and the
mesh operators belong to later slices of the port (ROADMAP §A.9, §A.12,
§A.16); asking for them raises NotImplementedError.
"""
from __future__ import annotations

from typing import Any, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.kernels import ops as kops
from repro_torch.tree import tree_leaves, tree_map

Params = Any


# ===========================================================================
# host-level (list-of-trees) operators
# ===========================================================================

def fedavg(client_params: List[Params],
           weights: Optional[Sequence[float]] = None,
           use_kernel: bool = False) -> Params:
    """Weighted parameter average over clients (Eq. 5)."""
    n = len(client_params)
    w = np.ones(n) if weights is None else np.asarray(weights, np.float64)
    w = (w / w.sum()).astype(np.float32)
    if use_kernel:
        dev = tree_leaves(client_params[0])[0].device
        return kops.fedavg_aggregate_tree(client_params,
                                          torch.as_tensor(w, device=dev))
    return tree_map(
        lambda *leaves: sum(float(wi) * leaf for wi, leaf in zip(w, leaves)),
        *client_params)


def hfl_aggregate(client_params: List[Params], groups: List[List[int]],
                  weights: Optional[Sequence[float]] = None) -> Params:
    """Two-tier FedAvg: per-group aggregate, then global over group models,
    weighted by group sample counts."""
    w = (np.ones(len(client_params)) if weights is None
         else np.asarray(weights, np.float64))
    group_models, group_w = [], []
    for g in groups:
        group_models.append(fedavg([client_params[c] for c in g],
                                   weights=[w[c] for c in g]))
        group_w.append(sum(w[c] for c in g))
    return fedavg(group_models, weights=group_w)


def afl_aggregate(client_params: List[Params], participants: Sequence[int],
                  weights: Optional[Sequence[float]] = None) -> Params:
    """FedAvg over the sampled participant subset (paper's AFL round)."""
    w = (np.ones(len(client_params)) if weights is None
         else np.asarray(weights, np.float64))
    return fedavg([client_params[c] for c in participants],
                  weights=[w[c] for c in participants])


def cfl_merge(global_params: Params, client_params: Params,
              alpha: float) -> Params:
    """Continual merge: theta_g <- (1-alpha) theta_g + alpha theta_c."""
    return tree_map(
        lambda g, c: ((1.0 - alpha) * g.float()
                      + alpha * c.float()).to(g.dtype),
        global_params, client_params)


# ===========================================================================
# stacked-array operators — every strategy's aggregation event
# ===========================================================================

def _require_undefended(defense) -> None:
    if defense not in ("none", None):
        raise NotImplementedError(
            f"defense={defense!r}: robust aggregation is the adversarial "
            f"slice of the port (ROADMAP §A.9, kernel B2)")


def _device(stacked):
    return tree_leaves(stacked)[0].device


def _as_f32(weights, device) -> torch.Tensor:
    if isinstance(weights, torch.Tensor):
        return weights.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(weights, np.float32), device=device)


def tree_where(flag, on_true: Params, on_false: Params) -> Params:
    """Per-leaf `torch.where` over two identically-shaped trees with a
    scalar boolean."""
    return tree_map(
        lambda a, b: torch.where(torch.as_tensor(flag, device=a.device),
                                 a, b),
        on_true, on_false)


def _stacked_weights(n: int, weights, device) -> torch.Tensor:
    w = (torch.ones((n,), dtype=torch.float32, device=device)
         if weights is None else _as_f32(weights, device))
    return _safe_normalize(w, n)


def _safe_normalize(w: torch.Tensor, n: int) -> torch.Tensor:
    """w / sum(w), guarded against a zero total: the degenerate case
    degrades to the uniform average instead of NaN-ing the weight sum.
    When sum(w) > 0 the selects resolve to exactly w / sum(w)."""
    s = w.sum()
    safe = torch.where(s > 0, w, torch.ones_like(w))
    return safe / torch.where(s > 0, s, torch.full_like(s, float(n)))


def fedavg_stacked(stacked: Params, weights=None) -> Params:
    """Kernel-backed Eq. (5) over a stacked federation -> single tree."""
    n = tree_leaves(stacked)[0].shape[0]
    return kops.fedavg_aggregate_stacked(
        stacked, _stacked_weights(n, weights, _device(stacked)))


def defended_aggregate_stacked(stacked: Params, weights=None, *,
                               defense: str = "none",
                               center=None) -> Params:
    """One aggregation event on the stack: plain kernel FedAvg. `center`
    is the norm_clip reference of the defended variants, unused here."""
    _require_undefended(defense)
    return fedavg_stacked(stacked, weights)


def hfl_tier1_stacked(stacked: Params, num_groups: int, weights=None):
    """Group-server aggregation over the contiguous equal-size groups of
    `topology.hierarchical_groups`: (C, ...) -> ((G, ...) group models,
    (G,) group sample-weight totals) — one kernel call per group."""
    mat = kops.stacked_ravel(stacked)
    C = mat.shape[0]
    if C % num_groups:
        raise ValueError(f"{C} clients not divisible into {num_groups} groups")
    per = C // num_groups
    w = (torch.ones((C,), dtype=torch.float32, device=mat.device)
         if weights is None else _as_f32(weights, mat.device))
    rows, totals = [], []
    for g in range(num_groups):
        wg = w[g * per:(g + 1) * per]
        rows.append(kops.fedavg_aggregate(mat[g * per:(g + 1) * per],
                                          _safe_normalize(wg, per)))
        totals.append(wg.sum())
    return (kops.stacked_unravel(stacked, torch.stack(rows)),
            torch.stack(totals))


def hfl_aggregate_stacked(stacked: Params, num_groups: int,
                          weights=None) -> Params:
    """Two-tier HFL on the stack: tier-1 group kernels, tier-2 kernel over
    the (G, ...) group models weighted by group totals."""
    groups, gw = hfl_tier1_stacked(stacked, num_groups, weights)
    return fedavg_stacked(groups, gw)


def afl_aggregate_stacked(stacked: Params, weights=None,
                          participate=None) -> Params:
    """Masked FedAvg over sampled participants: `participate` is a (C,)
    0/1 mask folded into the kernel weights (non-participants contribute
    zero; at least one participant required)."""
    n = tree_leaves(stacked)[0].shape[0]
    dev = _device(stacked)
    w = (torch.ones((n,), dtype=torch.float32, device=dev)
         if weights is None else _as_f32(weights, dev))
    if participate is not None:
        w = w * _as_f32(participate, dev)
    return fedavg_stacked(stacked, w)


def gossip_mix_matrix(neighbors: List[List[int]]) -> np.ndarray:
    """The (C, C) row-stochastic gossip mixing matrix: row c averages
    client c with its neighbors, uniformly."""
    C = len(neighbors)
    mix = np.zeros((C, C), np.float32)
    for c, nbrs in enumerate(neighbors):
        members = [c] + list(nbrs)
        mix[c, members] = 1.0 / len(members)
    return mix


def gossip_stacked(stacked: Params, neighbors: List[List[int]], *,
                   defense: str = "none") -> Params:
    """Synchronous ring gossip on the stack: the (C, C) row-stochastic
    mixing matrix (self + neighbors, uniform) applied to the raveled
    parameter matrix."""
    _require_undefended(defense)
    mat = kops.stacked_ravel(stacked)
    mix = torch.as_tensor(gossip_mix_matrix(neighbors), device=mat.device)
    return kops.stacked_unravel(stacked, mix @ mat)


def cfl_merge_stacked(global_params: Params, client_params: Params,
                      alpha) -> Params:
    """Continual merge as a C=2 kernel reduction with weights
    (1-alpha, alpha) — same math as host `cfl_merge`, kernel-routed."""
    stacked = tree_map(lambda g, c: torch.stack([g, c]),
                       global_params, client_params)
    a = np.float32(alpha)
    w = torch.as_tensor(np.array([np.float32(1.0) - a, a], np.float32),
                        device=_device(stacked))
    return fedavg_stacked(stacked, w)
