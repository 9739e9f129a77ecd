"""Aggregation operators (port of `repro.core.aggregation`: the host
operators and the stacked operators, defended and undefended).

All operators implement Eq. (5): theta_g = sum_c (n_c / N) theta_c,
generalized with per-client weights / participation masks, and — under a
defense (DESIGN.md §8) — with the robust operators of `core/robust.py`.

* HOST level — operates on a *list* of client parameter trees.
* STACKED level — operates on ONE tree whose leaves carry a leading
  client axis (the vectorized engine and every strategy's aggregation
  event). Every weighted reduction lowers onto the `fedavg_agg` kernel
  and every median / trimmed mean onto the `trimmed_mean_agg` kernel
  through the ravel path in `kernels/ops.py`; gossip is a dense mixing
  matmul (each output row mixes several inputs), left to `torch.matmul`
  as the reference leaves it to XLA, and defended gossip one batched
  `torch.sort` over the gathered neighborhoods, as the reference uses
  `jnp.sort` there.

The fault-injection `alive` masks, masked gossip and the mesh operators
belong to later slices of the port (ROADMAP §A.12, §A.16): the operators
here take no `alive` argument.
"""
from __future__ import annotations

from typing import Any, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import robust
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


def defended_fedavg(client_params: List[Params],
                    weights: Optional[Sequence[float]] = None, *,
                    defense: str = "none", f: int = 1, tau: float = 10.0,
                    center: Optional[Params] = None) -> Params:
    """Host-level robust FedAvg: stack the client list and dispatch
    through `core.robust` — the stacked operator, so both engines share
    one defense implementation."""
    if defense in ("none", None):
        return fedavg(client_params, weights)
    return robust.robust_aggregate_stacked(
        tree_map(lambda *leaves: torch.stack(leaves), *client_params),
        defense, weights=weights,
        f=f, tau=tau, center=center)


def hfl_aggregate(client_params: List[Params], groups: List[List[int]],
                  weights: Optional[Sequence[float]] = None, *,
                  defense: str = "none", f: int = 1, tau: float = 10.0,
                  centers: Optional[List[Params]] = None) -> Params:
    """Two-tier FedAvg: per-group aggregate, then global over group models,
    weighted by group sample counts. A defense applies at tier 1, the
    group server; tier 2 averages group server models, which the threat
    model trusts. `centers` (per-group round-start models) feed
    norm_clip; `f` is the per-group Byzantine allowance."""
    w = (np.ones(len(client_params)) if weights is None
         else np.asarray(weights, np.float64))
    group_models, group_w = [], []
    for gi, g in enumerate(groups):
        group_models.append(defended_fedavg(
            [client_params[c] for c in g], weights=[w[c] for c in g],
            defense=defense, f=f, tau=tau,
            center=None if centers is None else centers[gi]))
        group_w.append(sum(w[c] for c in g))
    return fedavg(group_models, weights=group_w)


def afl_aggregate(client_params: List[Params], participants: Sequence[int],
                  weights: Optional[Sequence[float]] = None) -> Params:
    """FedAvg over the sampled participant subset (paper's AFL round)."""
    w = (np.ones(len(client_params)) if weights is None
         else np.asarray(weights, np.float64))
    return fedavg([client_params[c] for c in participants],
                  weights=[w[c] for c in participants])


def gossip_round(client_params: List[Params],
                 neighbors: List[List[int]], *,
                 defense: str = "none", f: int = 1) -> List[Params]:
    """One synchronous gossip exchange: every client averages with its
    ring neighbors — or, defended, takes the coordinate-wise median /
    trimmed mean of its neighborhood. Returns the new model list."""
    out = []
    for c, nbrs in enumerate(neighbors):
        members = [client_params[c]] + [client_params[j] for j in nbrs]
        out.append(defended_fedavg(members, defense=defense, f=f))
    return out


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


def fedavg_stacked(stacked: Params, weights=None) -> Params:
    """Kernel-backed Eq. (5) over a stacked federation -> single tree."""
    n = tree_leaves(stacked)[0].shape[0]
    return kops.fedavg_aggregate_stacked(
        stacked, robust.normalized_weights(n, weights, _device(stacked)))


def defended_aggregate_stacked(stacked: Params, weights=None, *,
                               defense: str = "none", f: int = 1,
                               tau: float = 10.0, center=None) -> Params:
    """One defended aggregation event on the stack: plain kernel FedAvg
    when `defense` is "none", else the `core.robust` operator family
    (median / trimmed mean on the selection kernel, norm_clip against
    `center`, Krum)."""
    if defense in ("none", None):
        return fedavg_stacked(stacked, weights)
    return robust.robust_aggregate_stacked(
        stacked, defense, weights=weights, f=f, tau=tau, center=center)


def hfl_tier1_stacked(stacked: Params, num_groups: int, weights=None, *,
                      defense: str = "none", f: int = 1, tau: float = 10.0,
                      centers: Params = None):
    """Group-server aggregation over the contiguous equal-size groups of
    `topology.hierarchical_groups`: (C, ...) -> ((G, ...) group models,
    (G,) group sample-weight totals) — one kernel call per group.

    A defense applies here, at the first aggregation boundary Byzantine
    clients reach: each group server robust-aggregates its own slice.
    `centers` is the (G, ...) stacked round-start group models
    (norm_clip's reference); `f` is the per-group Byzantine allowance."""
    mat = kops.stacked_ravel(stacked)
    C = mat.shape[0]
    if C % num_groups:
        raise ValueError(f"{C} clients not divisible into {num_groups} groups")
    per = C // num_groups
    w = (torch.ones((C,), dtype=torch.float32, device=mat.device)
         if weights is None else _as_f32(weights, mat.device))
    # only norm_clip reads the centers: undefended events skip the ravel
    center_rows = (kops.stacked_ravel(centers)
                   if centers is not None and defense == "norm_clip"
                   else None)
    rows, totals = [], []
    for g in range(num_groups):
        wg = w[g * per:(g + 1) * per]
        gmat = mat[g * per:(g + 1) * per]
        if defense in ("none", None):
            rows.append(kops.fedavg_aggregate(
                gmat, robust.normalized_weights(per, wg, mat.device)))
        else:
            rows.append(robust.robust_aggregate(
                gmat, defense, weights=wg, f=f, tau=tau,
                center=None if center_rows is None else center_rows[g]))
        totals.append(wg.sum())
    return (kops.stacked_unravel(stacked, torch.stack(rows)),
            torch.stack(totals))


def hfl_aggregate_stacked(stacked: Params, num_groups: int, weights=None, *,
                          defense: str = "none", f: int = 1,
                          tau: float = 10.0, centers: Params = None
                          ) -> Params:
    """Two-tier HFL on the stack: tier-1 group kernels (optionally
    defended), tier-2 kernel over the (G, ...) group models weighted by
    group totals (group servers are trusted)."""
    groups, gw = hfl_tier1_stacked(stacked, num_groups, weights,
                                   defense=defense, f=f, tau=tau,
                                   centers=centers)
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
                   defense: str = "none", f: int = 1) -> Params:
    """Synchronous ring gossip on the stack. Undefended: the (C, C)
    row-stochastic mixing matrix (self + neighbors, uniform) applied to
    the raveled parameter matrix.

    Defended (median / trimmed_mean): each client takes the trimmed mean
    of its gathered neighborhood instead — one batched `torch.sort` over
    the (C, K, N) gathered tensor, as the reference sorts there with
    `jnp.sort` rather than its selection kernel (neighborhoods hold
    K = degree + 1 models)."""
    mat = kops.stacked_ravel(stacked)
    if defense in ("none", None):
        mix = torch.as_tensor(gossip_mix_matrix(neighbors), device=mat.device)
        return kops.stacked_unravel(stacked, mix @ mat)
    if defense not in ("median", "trimmed_mean"):
        raise ValueError(f"gossip mixing supports median/trimmed_mean "
                         f"defenses, not {defense!r} (DESIGN.md §8)")
    sizes = {len(n) for n in neighbors}
    if len(sizes) != 1:
        raise ValueError("defended gossip needs equal-size neighborhoods "
                         "(ring topology)")
    K = sizes.pop() + 1
    idx = torch.as_tensor(np.stack([np.asarray([c] + list(nbrs))
                                    for c, nbrs in enumerate(neighbors)]),
                          device=mat.device)                    # (C, K)
    gathered = torch.sort(mat[idx], dim=1).values               # (C, K, N)
    t = (K - 1) // 2 if defense == "median" else min(f, (K - 1) // 2)
    return kops.stacked_unravel(stacked, gathered[:, t:K - t].mean(dim=1))


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


def defended_cfl_merge(global_params: Params, client_params: Params,
                       alpha, tau: float) -> Params:
    """norm_clip-defended continual merge: the arriving update's delta is
    L2-clipped against the current global model before the merge — the
    only defense of a redundancy-1 merge event (DESIGN.md §8). The loop
    engine applies the same clip before its host `cfl_merge`."""
    clipped = robust.clip_deltas_stacked(
        global_params, tree_map(lambda leaf: leaf[None], client_params), tau)
    return cfl_merge_stacked(global_params,
                             tree_map(lambda leaf: leaf[0], clipped), alpha)
