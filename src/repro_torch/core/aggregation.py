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
  matmul (each output row mixes several inputs): on the static ring it
  is left to `torch.matmul`, as the reference leaves it to XLA, and
  under dynamic membership (`masked_gossip_stacked`, a fresh matrix every
  round) it runs on the `gossip_mix_agg` kernel. Defended gossip is one
  batched `torch.sort` over the gathered neighborhoods, as the reference
  uses `jnp.sort` there.

Fault injection (DESIGN.md §15): `alive=` on the stacked operators is a
(C,) 0/1 mask of the event's surviving uploads; `alive=None` is the exact
fault-free path. The async runtime's batched staleness merge
(`async_batch_merge`) is one weighted reduction on `fedavg_agg` over the
server model and the batch's arrivals.

* MESH level (DESIGN.md §11) — the same events with the client axis laid
  over the ranks of a `launch.mesh.World`: plain torch ops and one
  counted sum all_reduce of one flat buffer per event.
"""
from __future__ import annotations

from typing import Any, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import robust, topology
from repro_torch.core.collectives import all_reduce_sum, ppermute
from repro_torch.kernels import ops as kops
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

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
    scalar boolean (a device tensor in the fused executor; a host value
    is copied to the device)."""
    return tree_map(
        lambda a, b: torch.where(torch.as_tensor(flag, device=a.device),
                                 a, b),
        on_true, on_false)


def _row_mask(alive, leaf) -> torch.Tensor:
    """(C,) alive mask broadcast as a boolean against a (C, ...) leaf."""
    m = _as_f32(alive, leaf.device) > 0
    return m.reshape(tuple(m.shape) + (1,) * (leaf.dim() - 1))


def mask_rows(stacked: Params, alive, fallback: Params) -> Params:
    """Rows of the stacked tree where `alive` is 0 are replaced by the
    broadcast `fallback` tree (no leading client axis) — the upload-loss
    seam: a dead participant's slot carries "no update" (the event's
    center model) into order-statistic defenses (DESIGN.md §15)."""
    return tree_map(
        lambda p, f: torch.where(_row_mask(alive, p), p, f[None].to(p.dtype)),
        stacked, fallback)


def tree_where_rows(mask, on_true: Params, on_false: Params) -> Params:
    """Per-row `torch.where` between two identically-stacked trees with a
    (C,) boolean row mask (per-group quorum holds in HFL tier 1)."""
    return tree_map(lambda a, b: torch.where(_row_mask(mask, a), a, b),
                    on_true, on_false)


def _alive_weights(n: int, weights, alive, device) -> torch.Tensor:
    """(n,) float32 weights (ones when None) times the 0/1 `alive` mask."""
    w = (torch.ones((n,), dtype=torch.float32, device=device)
         if weights is None else _as_f32(weights, device))
    return w * _as_f32(alive, device)


def fedavg_stacked(stacked: Params, weights=None) -> Params:
    """Kernel-backed Eq. (5) over a stacked federation -> single tree."""
    n = tree_leaves(stacked)[0].shape[0]
    return kops.fedavg_aggregate_stacked(
        stacked, robust.normalized_weights(n, weights, _device(stacked)))


def defended_aggregate_stacked(stacked: Params, weights=None, *,
                               defense: str = "none", f: int = 1,
                               tau: float = 10.0, center=None,
                               alive=None) -> Params:
    """One defended aggregation event on the stack: plain kernel FedAvg
    when `defense` is "none", else the `core.robust` operator family
    (median / trimmed mean on the selection kernel, norm_clip against
    `center`, Krum).

    `alive` (fault injection) zeroes dead participants' weights (the
    survivors renormalize through the guarded normalizer; an all-dead
    event degrades to the uniform average) and, when a `center` is given,
    substitutes their rows by it, so order-statistic defenses see "no
    update" rather than a lost upload's parameters."""
    if alive is not None:
        weights = _alive_weights(tree_leaves(stacked)[0].shape[0], weights,
                                 alive, _device(stacked))
        if center is not None:
            stacked = mask_rows(stacked, alive, center)
    if defense in ("none", None):
        return fedavg_stacked(stacked, weights)
    return robust.robust_aggregate_stacked(
        stacked, defense, weights=weights, f=f, tau=tau, center=center)


def hfl_tier1_stacked(stacked: Params, num_groups: int, weights=None, *,
                      defense: str = "none", f: int = 1, tau: float = 10.0,
                      centers: Params = None, alive=None):
    """Group-server aggregation over the contiguous equal-size groups of
    `topology.hierarchical_groups`: (C, ...) -> ((G, ...) group models,
    (G,) group sample-weight totals) — one kernel call per group.

    A defense applies here, at the first aggregation boundary Byzantine
    clients reach: each group server robust-aggregates its own slice.
    `centers` is the (G, ...) stacked round-start group models
    (norm_clip's reference); `f` is the per-group Byzantine allowance.

    `alive` (fault injection) masks dead clients out of their group's
    weights (guarded renormalize; a fully dead group degrades to the
    uniform average of its rows) and, when `centers` are given, replaces
    their raveled rows by the group's center for every defense, so
    order-statistic defenses see "no update". Group TOTALS stay the full
    sample weights: a degraded group server still reports a model at tier
    2 with its full population weight."""
    mat = kops.stacked_ravel(stacked)
    C = mat.shape[0]
    if C % num_groups:
        raise ValueError(f"{C} clients not divisible into {num_groups} groups")
    per = C // num_groups
    w = (torch.ones((C,), dtype=torch.float32, device=mat.device)
         if weights is None else _as_f32(weights, mat.device))
    center_rows = (kops.stacked_ravel(centers) if centers is not None
                   else None)
    alive_f = None if alive is None else _as_f32(alive, mat.device)
    rows, totals = [], []
    for g in range(num_groups):
        wg = w[g * per:(g + 1) * per]
        gmat = mat[g * per:(g + 1) * per]
        wg_eff = wg
        if alive_f is not None:
            alive_g = alive_f[g * per:(g + 1) * per]
            wg_eff = wg * alive_g
            if center_rows is not None:
                gmat = torch.where(alive_g[:, None] > 0, gmat,
                                   center_rows[g][None])
        if defense in ("none", None):
            rows.append(kops.fedavg_aggregate(
                gmat, robust.normalized_weights(per, wg_eff, mat.device)))
        else:
            rows.append(robust.robust_aggregate(
                gmat, defense, weights=wg_eff, f=f, tau=tau,
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
                          participate=None, *, alive=None) -> Params:
    """Masked FedAvg over sampled participants: `participate` is a (C,)
    0/1 mask folded into the kernel weights (non-participants contribute
    zero; at least one participant required). `alive` (fault injection)
    folds in the same way: a dead participant's upload is lost on the
    wire and carries zero weight."""
    n = tree_leaves(stacked)[0].shape[0]
    dev = _device(stacked)
    w = (torch.ones((n,), dtype=torch.float32, device=dev)
         if weights is None else _as_f32(weights, dev))
    if participate is not None:
        w = w * _as_f32(participate, dev)
    if alive is not None:
        w = w * _as_f32(alive, dev)
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


def gossip_gather_indices(neighbors: List[List[int]]) -> np.ndarray:
    """(C, K) int64 neighborhood gather of defended ring gossip: row c
    lists client c, then its neighbors."""
    if len({len(n) for n in neighbors}) != 1:
        raise ValueError("defended gossip needs equal-size neighborhoods "
                         "(ring topology)")
    return np.stack([np.asarray([c] + list(nbrs), np.int64)
                     for c, nbrs in enumerate(neighbors)])


def gossip_stacked(stacked: Params, neighbors: List[List[int]], *,
                   defense: str = "none", f: int = 1, mix=None,
                   gather_idx=None) -> Params:
    """Synchronous ring gossip on the stack. Undefended: the (C, C)
    row-stochastic mixing matrix (self + neighbors, uniform) applied to
    the raveled parameter matrix.

    Defended (median / trimmed_mean): each client takes the trimmed mean
    of its gathered neighborhood instead — one batched `torch.sort` over
    the (C, K, N) gathered tensor, as the reference sorts there with
    `jnp.sort` rather than its selection kernel (neighborhoods hold
    K = degree + 1 models).

    `mix` / `gather_idx` are those arrays as device tensors built once
    per run (the fused executor); by default each call builds them from
    `neighbors`."""
    mat = kops.stacked_ravel(stacked)
    if defense in ("none", None):
        if mix is None:
            mix = torch.as_tensor(gossip_mix_matrix(neighbors),
                                  device=mat.device)
        return kops.stacked_unravel(stacked, mix @ mat)
    if defense not in ("median", "trimmed_mean"):
        raise ValueError(f"gossip mixing supports median/trimmed_mean "
                         f"defenses, not {defense!r} (DESIGN.md §8)")
    if gather_idx is None:
        gather_idx = torch.as_tensor(gossip_gather_indices(neighbors),
                                     device=mat.device)         # (C, K)
    return kops.stacked_unravel(stacked,
                                _defended_mix(mat, gather_idx, defense, f))


def _defended_mix(mat: torch.Tensor, idx: torch.Tensor, defense: str,
                  f: int) -> torch.Tensor:
    """Trimmed mean of each gathered neighborhood: (C, N) stack, (C, K)
    gather indices -> (C, N), one batched `torch.sort` over (C, K, N)."""
    if defense not in ("median", "trimmed_mean"):
        raise ValueError(f"gossip mixing supports median/trimmed_mean "
                         f"defenses, not {defense!r} (DESIGN.md §8)")
    K = idx.shape[1]
    gathered = torch.sort(mat[idx], dim=1).values               # (C, K, N)
    t = (K - 1) // 2 if defense == "median" else min(f, (K - 1) // 2)
    return gathered[:, t:K - t].mean(dim=1)


def masked_gossip_stacked(stacked: Params, *, mix=None, gather_idx=None,
                          defense: str = "none", f: int = 1) -> Params:
    """Gossip under dynamic membership (fault injection, DESIGN.md §15):
    the per-round twin of `gossip_stacked` whose graph is an array the
    fault schedule precomputes each round — the masked row-stochastic
    mixing matrix `mix` (undefended: dead rows identity, heartbeat-
    decayed supports, optionally the moving-target ring), applied by the
    `gossip_mix_agg` kernel, or the (C, K) `gather_idx` neighborhoods
    (defended: dead or detected neighbors replaced by self, so the sorted
    neighborhood keeps its static K). Either array may be a device tensor
    (the fused executor's per-round inputs)."""
    mat = kops.stacked_ravel(stacked)
    if defense in ("none", None):
        return kops.stacked_unravel(stacked, kops.masked_gossip_aggregate(
            mat, _as_f32(mix, mat.device).contiguous()))
    idx = (gather_idx.long() if isinstance(gather_idx, torch.Tensor)
           else torch.as_tensor(np.asarray(gather_idx, np.int64),
                                device=mat.device))
    return kops.stacked_unravel(stacked, _defended_mix(mat, idx, defense, f))


def cfl_merge_weights(alpha) -> np.ndarray:
    """The (2,) float32 continual-merge weights (1 - alpha, alpha)."""
    a = np.float32(alpha)
    return np.array([np.float32(1.0) - a, a], np.float32)


def cfl_merge_stacked(global_params: Params, client_params: Params,
                      alpha, weights=None) -> Params:
    """Continual merge as a C=2 kernel reduction with weights
    (1-alpha, alpha) — same math as host `cfl_merge`, kernel-routed.
    `weights` is `cfl_merge_weights(alpha)` as a device tensor built once
    per run (the fused executor); by default each merge builds it."""
    stacked = tree_map(lambda g, c: torch.stack([g, c]),
                       global_params, client_params)
    if weights is None:
        weights = torch.as_tensor(cfl_merge_weights(alpha),
                                  device=_device(stacked))
    return fedavg_stacked(stacked, weights)


def defended_cfl_merge(global_params: Params, client_params: Params,
                       alpha, tau: float, weights=None) -> Params:
    """norm_clip-defended continual merge: the arriving update's delta is
    L2-clipped against the current global model before the merge — the
    only defense of a redundancy-1 merge event (DESIGN.md §8). The loop
    engine applies the same clip before its host `cfl_merge`."""
    clipped = robust.clip_deltas_stacked(
        global_params, tree_map(lambda leaf: leaf[None], client_params), tau)
    return cfl_merge_stacked(global_params,
                             tree_map(lambda leaf: leaf[0], clipped), alpha,
                             weights=weights)


def staleness_batch_weights(alphas) -> torch.Tensor:
    """Weights that make ONE weighted reduction equal k SEQUENTIAL
    continual merges with rates alphas[0..k-1] (in that order):

        theta <- (1-a_i) theta + a_i theta_i   for i = 0..k-1

    composes to  theta * prod_j (1-a_j)
                 + sum_i theta_i * a_i * prod_{j>i} (1-a_j),

    so the (k+1,) float32 vector is [prod(1-a), a_0*suffix_0, ...,
    a_{k-1}*1] with suffix_i = prod_{j>i}(1-a_j). The entries telescope
    to sum exactly 1 (DESIGN.md §5)."""
    a = _as_f32(alphas, "cpu")
    keep = torch.flip(torch.cumprod(torch.flip(1.0 - a, (0,)), 0), (0,))
    suffix = torch.cat([keep[1:], torch.ones((1,), dtype=torch.float32)])
    return torch.cat([keep[:1], a * suffix])


def async_batch_merge(global_params: Params, stacked_updates: Params,
                      alphas) -> Params:
    """Batched staleness-aware merge: fold k same-tick arrivals (leading
    axis k, per-arrival rates `alphas`) into the server model in one
    `fedavg_agg` pass over the (k+1, N) matrix, equal to k sequential
    `cfl_merge` calls. k = 0 (a tick whose every arrival dropped) returns
    the server model unchanged."""
    k = alphas.shape[0] if hasattr(alphas, "shape") else len(alphas)
    if k == 0:
        return global_params
    w = staleness_batch_weights(alphas).to(_device(stacked_updates))
    return kops.merge_aggregate_stacked(global_params, stacked_updates, w)


# ===========================================================================
# mesh-sharded STACKED operators — the fused executor on a rank world
# (DESIGN.md §11)
# ===========================================================================
# These mirror the stacked operators above, but run in every rank of a
# `launch.mesh.World` with the leading client axis laid over a mesh axis:
# each rank holds a contiguous (C_loc, ...) sub-stack of clients, local
# math stays per rank, and each aggregation event is exactly its
# collective: ONE sum `all_reduce` of one flat buffer (the raveled
# parameters ⊕ the weight total), never one per leaf. `axis` is the
# rank's `launch.mesh.MeshAxis`. Plain torch ops and the counted
# collectives of `core/collectives.py` only, as the reference's mesh path is
# plain jnp and lax collectives: the hand kernels stay on the
# single-device side.

def _ravel(tree) -> torch.Tensor:
    """Single tree -> (N,) float32 vector (sorted-key leaf order)."""
    return torch.cat([leaf.reshape(-1).float() for leaf in tree_leaves(tree)])


def _unravel(template, vec) -> Params:
    """(N,) vector -> tree shaped and typed like the single tree
    `template`."""
    out, off = [], 0
    for leaf in tree_leaves(template):
        n = leaf.numel()
        out.append(vec[off:off + n].reshape(leaf.shape).to(leaf.dtype))
        off += n
    return tree_unflatten(template, out)


def _guarded(den: torch.Tensor) -> torch.Tensor:
    """A denominator with 0 replaced by 1 (bitwise inert when > 0)."""
    return torch.where(den > 0, den, torch.ones_like(den))


def mesh_fedavg_stacked(stacked: Params, weights, *, axis) -> Params:
    """Eq. (5) over the SHARDED client axis: each rank reduces its local
    sub-stack, one all_reduce of (sum_c w_c theta_c ⊕ sum_c w_c) gives the
    replicated global aggregate — the mesh twin of `fedavg_stacked` (AFL
    star, FedProx, server-optimizer events, HFL tier 2). The denominator
    is guarded against an all-masked federation (fault injection can zero
    every weight in a round; the quorum hold discards the degenerate
    value, but it must not be NaN — DESIGN.md §15)."""
    mat = kops.stacked_ravel(stacked)
    w = _as_f32(weights, mat.device)
    buf = torch.cat([(mat * w[:, None]).sum(dim=0), w.sum()[None]])
    all_reduce_sum(buf, axis)
    return kops.tree_unravel(stacked, buf[:-1] / _guarded(buf[-1]))


def hfl_tier1_local(stacked: Params, weights, num_groups_local: int, *,
                    alive=None):
    """HFL tier 1 over groups that nest INSIDE one rank's shard: (C_loc,
    ...) -> ((G_loc, ...) group models, (G_loc,) group weight totals),
    per-rank math with NO collective — the mesh executor's tier-1 event
    (groups align to shards, so no group crosses a rank; DESIGN.md §11).

    `alive` (fault injection, DESIGN.md §15) is the shard-local (C_loc,)
    0/1 mask: dead clients are zero-weighted in their group's reduction
    (guarded denominator; the caller's per-group quorum hold discards a
    fully dead group's value). Group TOTALS stay the full sample weights,
    as in `hfl_tier1_stacked`."""
    mat = kops.stacked_ravel(stacked)
    w = _as_f32(weights, mat.device)
    C_loc = w.shape[0]
    if C_loc % num_groups_local:
        raise ValueError(f"{C_loc} local clients not divisible into "
                         f"{num_groups_local} local groups")
    per = C_loc // num_groups_local
    wg = w.reshape(num_groups_local, per)
    gw = wg.sum(dim=1)
    if alive is not None:
        wg = wg * _as_f32(alive, mat.device).reshape(num_groups_local, per)
    den = _guarded(wg.sum(dim=1))
    num = (mat.reshape(num_groups_local, per, -1) * wg[..., None]).sum(dim=1)
    return kops.stacked_unravel(stacked, num / den[:, None]), gw


def mesh_hfl_stacked(stacked: Params, weights, num_groups: int, *, axis,
                     force_fallback: bool = False) -> Params:
    """Two-tier HFL over a SHARDED client stack, for group sizes below,
    equal to and above the shard size (the fused executor restricts to
    shard-aligned groups and calls `hfl_tier1_local` itself, keeping tier
    1 collective-free).

    * group size <= shard size (groups nest in shards): tier 1 is the
      local reshape (`hfl_tier1_local`), tier 2 one weighted all_reduce.
    * group size > shard size (groups span whole shards): tier 1 is an
      all_reduce over the group's ranks (a subgroup from `dist.new_group`)
      — or, with `force_fallback`, the one-hot-masked full all_reduce with
      the same math. Tier 2 then uses the tier-1 replication within each
      group: the gw-weighted full-axis sum overcounts numerator AND
      denominator by exactly the group's shard count, which cancels.

    Matches host `hfl_aggregate` on the gathered stack."""
    ndev = axis.size
    mat = kops.stacked_ravel(stacked)
    w = _as_f32(weights, mat.device)
    C_loc = w.shape[0]
    C = C_loc * ndev
    if C % num_groups:
        raise ValueError(f"{C} clients not divisible into {num_groups} "
                         f"groups")
    per = C // num_groups
    if per <= C_loc:
        groups, gw = hfl_tier1_local(stacked, w, C_loc // per)
        return mesh_fedavg_stacked(groups, gw, axis=axis)
    if per % C_loc:
        raise ValueError(f"group size {per} neither nests in nor spans "
                         f"whole shards of {C_loc} clients")
    m = per // C_loc                      # shards per group
    part = torch.cat([(mat * w[:, None]).sum(dim=0), w.sum()[None]])
    if force_fallback:
        # every rank writes its partial into its group's slot of a
        # (G, N+1) expansion; one full all_reduce yields every group's
        # sum, and each rank reads back its own group's row
        onehot = (torch.arange(num_groups, device=mat.device)
                  == axis.index // m).float()
        slots = all_reduce_sum(onehot[:, None] * part[None, :], axis)
        part = onehot @ slots
    else:
        sub = axis.split(topology.mesh_axis_groups(ndev, num_groups))
        all_reduce_sum(part, sub)
    gw = part[-1]
    top = torch.cat([part[:-1] / gw * gw, gw[None]])
    all_reduce_sum(top, axis)
    return kops.tree_unravel(stacked, top[:-1] / top[-1])


def mesh_hfl_by_group(stacked: Params, weights, num_groups: int,
                      first: int, *, axis) -> Params:
    """Two-tier HFL over a SHARDED client stack whose groups may straddle
    ranks: this rank holds clients first .. first + C_loc - 1 of C =
    C_loc x axis.size, group g holding clients g*C/G to (g+1)*C/G - 1.
    Each rank writes its clients' weighted sums and weights into a (G,
    N+1) buffer by group, zeros elsewhere (`mesh_hfl_stacked`'s one-hot
    form, one group a client); one all_reduce gives every group's sum,
    and tier 1 (each group's weighted mean) and tier 2 (the group models
    weighted by their totals) run in every rank. Returns the global model
    (a single tree), as host `hfl_aggregate` on the gathered stack."""
    mat = kops.stacked_ravel(stacked)
    w = _as_f32(weights, mat.device)
    C = w.shape[0] * axis.size
    if C % num_groups:
        raise ValueError(f"{C} clients not divisible into {num_groups} "
                         f"groups")
    group = (torch.arange(w.shape[0], device=mat.device) + first) // (
        C // num_groups)
    wg = (torch.arange(num_groups, device=mat.device)[:, None]
          == group[None, :]).float() * w[None, :]           # (G, C_loc)
    buf = torch.cat([wg @ mat, wg.sum(dim=1, keepdim=True)], dim=1)
    all_reduce_sum(buf, axis)
    gmodel = buf[:, :-1] / buf[:, -1:]                        # tier 1
    gw = buf[:, -1] / buf[:, -1].sum()
    return kops.tree_unravel(stacked, gw @ gmodel)           # tier 2


def mesh_gossip_stacked(stacked: Params, mix, *, axis) -> Params:
    """Synchronous gossip on a SHARDED client stack as a masked
    all-to-all: `mix` is the (C, C) row-stochastic mixing matrix of
    `gossip_stacked` (self + ring neighbours, uniform) or a fault
    schedule's masked one. Each rank multiplies the mixing COLUMNS it
    owns by its local sub-stack, one all_reduce of the (C, N) product
    assembles every mixed row, and the rank keeps its own row block."""
    mat = kops.stacked_ravel(stacked)
    mix = _as_f32(mix, mat.device)
    C_loc = mat.shape[0]
    lo = axis.index * C_loc
    full = all_reduce_sum(mix[:, lo:lo + C_loc] @ mat, axis)
    return kops.stacked_unravel(stacked, full[lo:lo + C_loc])


# ===========================================================================
# mesh-level operators — one model a rank (pod-scale FL)
# ===========================================================================

def _joint(a, b):
    """The axis over both `a` and `b` of one rank mesh."""
    return a.mesh.axis((a.name, b.name))


def _wavg_psum(params, weight, axis):
    """Weighted mean over a mesh axis: sum(w theta) / sum(w), one
    all_reduce of (w theta ⊕ w)."""
    vec = _ravel(params)
    w = _as_f32(weight, vec.device).reshape(())
    buf = all_reduce_sum(torch.cat([vec * w, w[None]]), axis)
    return _unravel(params, buf[:-1] / buf[-1])


def mesh_hfl(params, weight, *, client_axis, num_groups: int = 2,
             pod_axis=None, force_fallback: bool = False):
    """Two-tier hierarchical aggregation, one client a rank.

    Single-pod: tier 1 over `mesh_axis_groups` partitions of the client
    axis (subgroups; the one-hot-masked full all_reduce with
    `force_fallback`), tier 2 over the full client axis. Multi-pod: tier
    1 over the intra-pod client axis, tier 2 over the pod axis — the
    clients -> group server -> global server schedule of paper Fig. 1."""
    vec = _ravel(params)
    w = _as_f32(weight, vec.device).reshape(())
    part = torch.cat([vec * w, w[None]])
    if pod_axis is not None:
        all_reduce_sum(part, client_axis)                    # tier 1
        gw = part[-1]
        top = torch.cat([part[:-1] / gw * gw, gw[None]])
        all_reduce_sum(top, pod_axis)                        # tier 2
        return _unravel(params, top[:-1] / top[-1])
    n = client_axis.size
    groups = topology.mesh_axis_groups(n, num_groups)
    if force_fallback:
        onehot = (torch.arange(num_groups, device=vec.device)
                  == client_axis.index // (n // num_groups)).float()
        slots = all_reduce_sum(onehot[:, None] * part[None, :],
                               client_axis)
        part = onehot @ slots
    else:
        all_reduce_sum(part, client_axis.split(groups))
    gw = part[-1]
    # tier 2: each group model is replicated across its (equal-size)
    # group, so numerator and denominator both overcount by the group
    # size, which cancels
    top = torch.cat([part[:-1] / gw * gw, gw[None]])
    all_reduce_sum(top, client_axis)
    return _unravel(params, top[:-1] / top[-1])


def mesh_afl_fedavg(params, weight, participate, *, client_axis,
                    pod_axis=None):
    """Masked FedAvg over sampled participants; non-participants receive
    the aggregate too."""
    axis = client_axis if pod_axis is None else _joint(client_axis,
                                                       pod_axis)
    vec = _ravel(params)
    m = (_as_f32(participate, vec.device).reshape(())
         * _as_f32(weight, vec.device).reshape(()))
    return _wavg_psum(params, m, axis)


def mesh_afl_gossip(params, *, client_axis, steps: int = 1):
    """Ring gossip: each client averages with its +-1 ring neighbours.
    The reference's two `ppermute`s are one `ppermute` of both shifts:
    one all_reduce of an (n, N) slot expansion (gloo has no send/recv on
    CUDA tensors), counted as two collective-permutes."""
    for _ in range(steps):
        vec = _ravel(params)
        left, right = ppermute(vec, client_axis, (1, -1))
        params = _unravel(params, (vec + left + right) / 3.0)
    return params


def mesh_cfl(params, global_params, weight, alpha, *, client_axis,
             pod_axis=None):
    """Continual merge at pod scale: the federation mean is folded into
    the running global model with rate alpha, and the new global into
    each client's model likewise. Returns (new_client_params,
    new_global_params)."""
    axis = client_axis if pod_axis is None else _joint(client_axis,
                                                       pod_axis)
    mean = _wavg_psum(params, weight, axis)
    new_global = tree_map(
        lambda g, m: ((1 - alpha) * g.float() + alpha * m.float()).to(g.dtype),
        global_params, mean)
    new_client = tree_map(
        lambda c, g: ((1 - alpha) * c.float() + alpha * g.float()).to(c.dtype),
        params, new_global)
    return new_client, new_global
