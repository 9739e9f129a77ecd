"""Public wrappers around the kernels and the ravel path (port of
`repro.kernels.ops`, lines 32-195).

Every aggregation event funnels its stacked parameter tree through
`stacked_ravel` onto the kernel's (C, N) layout and back through
`tree_unravel` / `stacked_unravel`. The ravel order is the reference's
`jax.tree.leaves` order (sorted keys), so the matrices match the
reference's column for column.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import comm_agg as _ca
from repro_torch.kernels import fedavg_agg as _fa
from repro_torch.kernels import flash_attention as _fl
from repro_torch.kernels import gossip_mix as _gm
from repro_torch.kernels import robust_agg as _ra
from repro_torch.kernels import ssm_scan as _ss
from repro_torch.obs import telemetry
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


def fedavg_aggregate(stacked, weights):
    """(C, N) matrix, (C,) normalized weights -> (N,). CUDA tensors run
    the hand-written kernel, CPU tensors its plain version."""
    telemetry.count("kernel.fedavg_agg")
    return _fa.fedavg_agg(stacked, weights)


def dequant_aggregate(values, scales, weights):
    """(C, N) int8 uploads, (C,) float32 scales and normalized weights ->
    (N,) float32 aggregate of the dequantized uploads (the fused kernel on
    CUDA tensors, its plain version on CPU tensors). Off the round path,
    as in the reference: codec runs decode, then aggregate through
    `fedavg_aggregate`."""
    telemetry.count("kernel.dequant_agg")
    return _ca.dequant_agg(values, scales, weights)


def trimmed_mean_aggregate(stacked, trim):
    """(C, N) matrix -> (N,) mean of the per-column order statistics of
    rank trim..C-trim-1 (the robust selection kernel on CUDA tensors, its
    plain version on CPU tensors)."""
    telemetry.count("kernel.trimmed_mean")
    return _ra.trimmed_mean_agg(stacked, trim)


def median_aggregate(stacked):
    """Coordinate-wise median: `trimmed_mean_aggregate` at maximal trim."""
    return trimmed_mean_aggregate(stacked, (stacked.shape[0] - 1) // 2)


def masked_gossip_aggregate(stacked, mix):
    """(C, N) matrix, (C, C) row-stochastic mixing matrix -> (C, N) mixed
    stack: one gossip exchange under dynamic membership (the masked-mix
    kernel on CUDA tensors, its plain version on CPU tensors)."""
    telemetry.count("kernel.gossip_mix")
    return _gm.gossip_mix_agg(stacked, mix)


def stacked_ravel(stacked_tree) -> torch.Tensor:
    """Tree with leading client axis -> (C, N) float32 matrix (leaves
    flattened and concatenated in sorted-key order)."""
    leaves = tree_leaves(stacked_tree)
    C = leaves[0].shape[0]
    return torch.cat([leaf.reshape(C, -1).float() for leaf in leaves], dim=1)


def _leaf_size(leaf) -> int:
    return math.prod(leaf.shape[1:])


def stacked_unravel(template_stacked, mat):
    """(M, N) matrix -> tree with leading axis M, trailing shapes/dtypes
    taken from `template_stacked` (its own leading axis is ignored, so the
    template may have a different client count than M)."""
    leaves = tree_leaves(template_stacked)
    M = mat.shape[0]
    out, off = [], 0
    for leaf in leaves:
        sz = _leaf_size(leaf)
        out.append(mat[:, off:off + sz].reshape((M,) + tuple(leaf.shape[1:]))
                   .to(leaf.dtype))
        off += sz
    return tree_unflatten(template_stacked, out)


def tree_unravel(template, vec):
    """(N,) aggregated vector -> single tree shaped like `template` with
    its leading client axis dropped (pass a stacked tree as template)."""
    leaves = tree_leaves(template)
    out, off = [], 0
    for leaf in leaves:
        sz = _leaf_size(leaf)
        out.append(vec[off:off + sz].reshape(tuple(leaf.shape[1:]))
                   .to(leaf.dtype))
        off += sz
    return tree_unflatten(template, out)


def fedavg_aggregate_stacked(stacked_tree, weights):
    """Kernel-backed FedAvg of a stacked tree: ravel -> fused weighted
    reduction -> unravel. `weights` must already be normalized."""
    mat = stacked_ravel(stacked_tree)
    return tree_unravel(stacked_tree, fedavg_aggregate(mat, weights))


def fedavg_aggregate_tree(client_params, weights):
    """FedAvg a *list* of trees through the kernel (host-level callers);
    stacks then reuses the ravel path."""
    stacked = tree_map(lambda *ls: torch.stack(ls), *client_params)
    return fedavg_aggregate_stacked(stacked, weights)


def merge_aggregate_stacked(base_tree, stacked_tree, weights):
    """Weighted variant of the `fedavg_aggregate_stacked` ravel path with
    a distinguished base row: `base_tree` (no client axis) is row 0 of the
    (k+1, N) matrix, the k rows of `stacked_tree` follow, and `weights`
    is the (k+1,) already-normalized vector (the async engine's batched
    merge)."""
    base_row = stacked_ravel(tree_map(lambda leaf: leaf[None], base_tree))
    mat = torch.cat([base_row, stacked_ravel(stacked_tree)], dim=0)
    return tree_unravel(stacked_tree, fedavg_aggregate(mat, weights))


# -- flash attention -----------------------------------------------------------

def flash_attention(q, k, v, *, causal=True, window=0):
    """q: (B, S, H, d); k, v: (B, T, Hk, d) -> (B, S, H, d). Grouped-query
    attention is folded inside the kernel, which reads key/value head
    h // (H / Hk) for query head h: the same result as the reference's
    repeat of the key/value heads, without the copy."""
    telemetry.count("kernel.flash_attention")
    return _fl.flash_attention(q, k, v, causal=causal, window=window)


# -- ssm scan ------------------------------------------------------------------

def ssm_scan(xh, a_log, dt, Bm, Cm, *, chunk=128):
    """Chunked SSD scan -> (y, None), as the reference returns it."""
    telemetry.count("kernel.ssm_scan")
    return _ss.ssm_scan(xh, a_log, dt, Bm, Cm, chunk=chunk), None
