"""Dense KV caches for autoregressive decode (port of
`repro.models.kvcache`).

Two variants:
* full cache     — (B, S_max, Hk, dh) per layer; for full/global attention.
* window cache   — (B, W, Hk, dh) ring buffer; for sliding-window layers
                   (gemma3 local layers): O(W) memory regardless of context.

Unlike the reference's functional update, `update_layer` writes into the
caches it is given, so a decode step moves O(new tokens) bytes and not
O(capacity): a step owns the state it is passed, and a caller that needs
the old state clones it first. The write position is the reference's 0-d
int32 index, a tensor on the caches' device: the position is computed
there, so a step reads nothing back to the host and can be captured in a
CUDA graph (`launch.serve.make_graphed_serve_step`).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.device import resolve_device


class KVCache(NamedTuple):
    k: torch.Tensor         # (L, B, S_cap, Hk, dh)  stacked over layers
    v: torch.Tensor         # (L, B, S_cap, Hk, dh)
    index: torch.Tensor     # 0-d int32: next write position (== tokens so far)
    window: int = 0         # 0 => full cache; >0 => ring buffer of this size

    @property
    def capacity(self):
        return self.k.shape[2]


def init_cache(num_layers, batch, capacity, num_kv_heads, head_dim,
               dtype=torch.bfloat16, window=0, prefill_len=0, device="cuda"):
    device = resolve_device(device)
    shape = (num_layers, batch, capacity, num_kv_heads, head_dim)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device),
                   index=torch.tensor(prefill_len, dtype=torch.int32,
                                      device=device),
                   window=window)


def cache_layer(cache: KVCache, layer: int):
    return cache.k[layer], cache.v[layer]


def update_layer(cache_k, cache_v, index, new_k, new_v, window=0,
                 offset=0, capacity=None):
    """Write one decode step (new_k/new_v: (B, n, Hk, dh)) at `index` (a
    0-d integer tensor, or an int).

    Writes in place and returns (cache_k, cache_v). For window caches
    the write position wraps (ring buffer). As `lax.dynamic_update_slice`,
    a start that would run past the end is clamped to cap - n. The
    position stays on the device.

    `offset` / `capacity`: the caches hold positions [offset, offset +
    their length) of a cache of `capacity` (a rank's block cut by
    position). One token (n = 1) is written where its position falls in
    the block; elsewhere the block's slot keeps its entry, so the test
    stays on the device too.
    """
    blk, n = cache_k.shape[1], new_k.shape[1]
    cap = blk if capacity is None else capacity
    index = torch.as_tensor(index, device=cache_k.device)
    pos = torch.remainder(index, cap) if window > 0 else index
    pos = torch.clamp(pos, 0, cap - n).long()
    if offset == 0 and cap == blk:
        slots = pos + torch.arange(n, device=cache_k.device)
        cache_k.index_copy_(1, slots, new_k.to(cache_k.dtype))
        cache_v.index_copy_(1, slots, new_v.to(cache_v.dtype))
        return cache_k, cache_v
    if n != 1:
        raise ValueError(f"a block of a cache takes one token a write, "
                         f"not {n}")
    local = pos - offset
    owns = (local >= 0) & (local < blk)
    slot = torch.clamp(local, 0, blk - 1).reshape(1)
    for cache, new in ((cache_k, new_k), (cache_v, new_v)):
        kept = cache.index_select(1, slot)
        cache.index_copy_(1, slot, torch.where(owns, new.to(cache.dtype),
                                               kept))
    return cache_k, cache_v


def valid_mask(index, capacity, window=0, device="cuda", offset=0,
               length=None):
    """(capacity,) bool: which cache slots hold valid, attendable entries
    at `index` (a 0-d integer tensor, or an int). `offset` / `length`:
    only slots [offset, offset + length) of the `capacity`."""
    device = resolve_device(device)
    slots = torch.arange(capacity if length is None else length,
                         device=device)
    if offset:
        slots = slots + offset
    index = torch.as_tensor(index, device=device)
    if window > 0:
        n_valid = torch.clamp(index + 1, max=capacity)
        return slots < n_valid            # ring buffer: everything written
    return slots <= index                 # linear cache: prefix
