"""Byzantine-robust aggregation — the defense half of the adversarial
axis (port of `repro.core.robust`; DESIGN.md §8; attacks live in
`core/attacks.py`).

Every defense works on the stacked (C, N) ravel layout of
`kernels/ops.py::stacked_ravel`:

  median        coordinate-wise median — the `trimmed_mean_agg` kernel
                (bitonic selection) at maximal trim. Ignores sample
                weights, as the reference does.
  trimmed_mean  coordinate-wise mean with the f smallest and f largest
                values per coordinate removed — the same kernel.
  norm_clip     weighted mean of update deltas against `center` (the
                model clients pulled at round start), each delta
                L2-clipped to `tau` — the `fedavg_agg` kernel.
  krum          Krum (Blanchard et al. 2017): the client whose summed
                squared distance to its C - f - 2 nearest peers is
                minimal; scores from one Gram matmul, selection through
                the `fedavg_agg` kernel with a one-hot weight vector.
  multi_krum    average of the m = C - f best-scored clients (uniform
                weights through `fedavg_agg`).

`robust_aggregate` dispatches on the defense name at the matrix level;
`robust_aggregate_stacked` is the tree-level entry of
`core/aggregation.py`.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.core.fl_types import DEFENSES
from repro_torch.kernels import ops as kops
from repro_torch.tree import tree_map

Params = Any

__all__ = ["DEFENSES", "normalized_weights", "pairwise_sq_dists",
           "krum_scores", "krum_select", "norm_clip_factors",
           "robust_aggregate",
           "robust_aggregate_stacked", "clip_deltas_stacked",
           "clip_update"]


def normalized_weights(C: int, weights, device) -> torch.Tensor:
    """(C,) float32 w / sum(w) on `device` (uniform when `weights` is
    None), guarded against a zero total: the degenerate case degrades to
    the uniform average instead of NaN-ing the weight sum. When sum(w) > 0
    the selects resolve to exactly w / sum(w)."""
    w = (torch.ones((C,), dtype=torch.float32, device=device)
         if weights is None
         else torch.as_tensor(weights, dtype=torch.float32, device=device))
    s = w.sum()
    safe = torch.where(s > 0, w, torch.ones_like(w))
    return safe / torch.where(s > 0, s, torch.full_like(s, float(C)))


# ---------------------------------------------------------------------------
# stacked operators (matrix level)
# ---------------------------------------------------------------------------

def pairwise_sq_dists(mat: torch.Tensor) -> torch.Tensor:
    """(C, N) -> (C, C) squared L2 distances through the Gram expansion
    ||x_i||^2 + ||x_j||^2 - 2 x_i . x_j (one matmul, left to torch as the
    reference leaves it to XLA)."""
    x = mat.float()
    sq = (x * x).sum(dim=1)
    d = sq[:, None] + sq[None, :] - 2.0 * (x @ x.T)
    return torch.clamp(d, min=0.0)


def krum_scores(mat: torch.Tensor, f: int) -> torch.Tensor:
    """(C,) Krum scores: the sum of each client's C - f - 2 smallest
    squared distances to OTHER clients (at least one neighbor counts)."""
    C = mat.shape[0]
    n_near = max(1, min(C - 2, C - f - 2)) if C > 2 else 1
    d = pairwise_sq_dists(mat)
    d = d.clone()
    d.fill_diagonal_(float("inf"))                       # exclude self
    return torch.sort(d, dim=1).values[:, :n_near].sum(dim=1)


def krum_select(mat: torch.Tensor, f: int, m: int = 1) -> torch.Tensor:
    """Indices of the m best-scored clients (m=1: classic Krum). The
    argsort is stable, as `jnp.argsort` is, so ties break alike."""
    return torch.argsort(krum_scores(mat, f), stable=True)[:m]


def norm_clip_factors(deltas: torch.Tensor, tau: float) -> torch.Tensor:
    """(C,) per-row scale factors min(1, tau / ||delta_c||)."""
    norms = torch.linalg.norm(deltas.float(), dim=1)
    return torch.clamp(tau / torch.clamp(norms, min=1e-12), max=1.0)


def robust_aggregate(mat: torch.Tensor, defense: str, *, weights=None,
                     f: int = 1, tau: float = 10.0,
                     center: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One aggregation event on the raveled (C, N) stack -> (N,). `f` is
    the assumed Byzantine count (median derives its own maximal trim);
    `center` is the (N,) round-start row that norm_clip needs."""
    C = mat.shape[0]
    if defense not in DEFENSES:
        raise ValueError(f"unknown defense {defense!r} "
                         f"(expected one of {DEFENSES})")
    if defense == "none":
        return kops.fedavg_aggregate(
            mat, normalized_weights(C, weights, mat.device))
    if defense == "median":
        return kops.median_aggregate(mat)
    if defense == "trimmed_mean":
        return kops.trimmed_mean_aggregate(mat, min(f, (C - 1) // 2))
    if defense == "norm_clip":
        if center is None:
            raise ValueError("norm_clip needs the round-start model "
                             "(center=...) to form update deltas")
        center = center.float()
        deltas = (mat.float() - center[None, :]).contiguous()
        w = (normalized_weights(C, weights, mat.device)
             * norm_clip_factors(deltas, tau))
        return (center + kops.fedavg_aggregate(deltas, w)).to(mat.dtype)
    # krum / multi_krum: scores on the stack, kernel-backed selection
    m = 1 if defense == "krum" else max(1, C - f)
    sel = krum_select(mat, f, m)
    w = torch.zeros((C,), dtype=torch.float32, device=mat.device)
    w[sel] = 1.0 / m
    return kops.fedavg_aggregate(mat, w)


# ---------------------------------------------------------------------------
# tree-level wrappers (what aggregation.py calls)
# ---------------------------------------------------------------------------

def _row(tree: Params) -> torch.Tensor:
    """A single (unstacked) tree -> its (N,) raveled row."""
    return kops.stacked_ravel(tree_map(lambda leaf: leaf[None], tree))[0]


def robust_aggregate_stacked(stacked: Params, defense: str, *, weights=None,
                             f: int = 1, tau: float = 10.0,
                             center: Optional[Params] = None) -> Params:
    """Defended aggregation of a stacked tree: ravel -> robust reduce ->
    unravel. `center` is a single (unstacked) tree."""
    mat = kops.stacked_ravel(stacked)
    vec = robust_aggregate(mat, defense, weights=weights, f=f, tau=tau,
                           center=None if center is None else _row(center))
    return kops.tree_unravel(stacked, vec)


def clip_update(base: Params, update: Params, tau: float) -> Params:
    """Single-update norm clip (the loop engine's pre-merge defense):
    `clip_deltas_stacked` at C=1."""
    clipped = clip_deltas_stacked(
        base, tree_map(lambda leaf: leaf[None], update), tau)
    return tree_map(lambda leaf: leaf[0], clipped)


def clip_deltas_stacked(base: Params, stacked: Params, tau: float) -> Params:
    """L2-clip every client's update delta against `base` to `tau` and
    return the re-based stacked tree — the pre-merge defense of the
    low-redundancy merge events (CFL's sequential pass)."""
    base_row = _row(base)[None]
    mat = kops.stacked_ravel(stacked)
    deltas = mat - base_row
    clipped = base_row + deltas * norm_clip_factors(deltas, tau)[:, None]
    return kops.stacked_unravel(stacked, clipped)
