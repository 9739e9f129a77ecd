"""Dense KV caches for autoregressive decode (port of
`repro.models.kvcache`).

Two variants:
* full cache     — (B, S_max, Hk, dh) per layer; for full/global attention.
* window cache   — (B, W, Hk, dh) ring buffer; for sliding-window layers
                   (gemma3 local layers): O(W) memory regardless of context.

Unlike the reference's functional update, `update_layer` writes into the
caches it is given, so a decode step moves O(new tokens) bytes and not
O(capacity): a step owns the state it is passed, and a caller that needs
the old state clones it first. The write position is a Python int (the
reference's is a traced scalar).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.device import resolve_device


class KVCache(NamedTuple):
    k: torch.Tensor         # (L, B, S_cap, Hk, dh)  stacked over layers
    v: torch.Tensor         # (L, B, S_cap, Hk, dh)
    index: int              # next write position (== tokens so far)
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
                   index=int(prefill_len), window=window)


def cache_layer(cache: KVCache, layer: int):
    return cache.k[layer], cache.v[layer]


def update_layer(cache_k, cache_v, index, new_k, new_v, window=0):
    """Write one decode step (new_k/new_v: (B, n, Hk, dh)) at `index`.

    Writes in place and returns (cache_k, cache_v). For window caches
    the write position wraps (ring buffer). As `lax.dynamic_update_slice`,
    a start that would run past the end is clamped to cap - n.
    """
    cap, n = cache_k.shape[1], new_k.shape[1]
    pos = index % cap if window > 0 else index
    pos = min(max(int(pos), 0), cap - n)
    cache_k[:, pos:pos + n] = new_k.to(cache_k.dtype)
    cache_v[:, pos:pos + n] = new_v.to(cache_v.dtype)
    return cache_k, cache_v


def valid_mask(index, capacity, window=0, device="cuda"):
    """(capacity,) bool — which cache slots hold valid, attendable entries."""
    slots = torch.arange(capacity, device=resolve_device(device))
    if window > 0:
        n_valid = min(index + 1, capacity)
        return slots < n_valid            # ring buffer: everything written
    return slots <= index                 # linear cache: prefix
