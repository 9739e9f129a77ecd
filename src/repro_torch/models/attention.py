"""Grouped-query attention with causal / sliding-window masks, qk-norm and
RoPE (port of `repro.models.attention`).

Weights are stored fused 2-D, as in the reference: wq (d, H*dh), wk and
wv (d, Hk*dh), wo (H*dh, d); the head split follows the projection.

Three execution paths, chosen by `cfg.attn_impl` as in the reference:
* "einsum"  — the plain masked softmax (`gqa_attention`);
* "chunked" — online softmax over key chunks (`chunked_attention`);
* "flash"   — the flash kernel (`kernels.ops.flash_attention`) when the
  shapes tile (`_maybe_flash`), the einsum path otherwise.

Under `tp` (a `models.parallel.Parallel` cutting heads over "model") the
block runs on the rank's H/M query heads and the kv heads they read
(`specs.attn_heads`): the head counts come from the shapes of the rank's
`wq` / `wk` slices, and `wo` is row-parallel.

Under `seq` (the view's context parallelism, a `models.parallel.SeqBlock`:
the rank holds a block of positions) the block projects and rotates its
own positions, gathers every rank's keys and values over the sequence
axis (`SeqBlock.gather_seq`, whose backward reduce-scatters) and attends
with its own queries under the mask of their absolute positions
(`q_pos` against the gathered keys' `k_pos`, which need not be one
contiguous run: a vision prefix's block and a token block): causal,
sliding-window and GQA alike. It runs the einsum or chunked path, never
the flash kernel, as the reference's `_maybe_flash` refuses a query
offset.

Under `kv` (a decode step's `models.parallel.KVCut`: the rank's block of
a KV cache cut over "model", `_cut_decode`) the rank's columns of `wq`,
`wk` and `wv` project the new token; where its block holds positions
rather than its kv heads, q, k and v are gathered over "model". The
entry is written where the block holds its slot, and the rank attends
over its span of positions with its query heads: a float32 partial
softmax (row max m_r, sum l_r, unnormalised o_r), joined over the axes
that split the positions as o = sum_r e^(m_r - m) o_r / sum_r e^(m_r - m)
l_r (flash-decoding's split). The rank then takes its rows of `wo`.
With `still` (a `models.parallel.Stationary`: the projections compute
where their weights are stored) the block's input and output hold every
row of the batch: the four products are `layers.still_dense`'s, whole q,
k and v give the cache block's rows and kv heads and the rank's rows and
query heads, and the attention output is joined once over the ranks
holding other rows (and other heads) for `wo`.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core import collectives
from repro_torch.models import layers
from repro_torch.models.layers import apply_rope, dense, init_dense

NEG_INF = -2.0e38


def init_attention(generator, cfg, dtype=torch.float32):
    d, H, Hk, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    p = {
        "wq": init_dense(generator, d, H * dh, dtype=dtype),
        "wk": init_dense(generator, d, Hk * dh, dtype=dtype),
        "wv": init_dense(generator, d, Hk * dh, dtype=dtype),
        "wo": init_dense(generator, H * dh, d, dtype=dtype),
    }
    if cfg.qk_norm:
        p["q_norm"] = layers.init_rmsnorm(dh, dtype)
        p["k_norm"] = layers.init_rmsnorm(dh, dtype)
    return p


def _split_heads(x, n_heads, head_dim):
    return x.reshape(*x.shape[:-1], n_heads, head_dim)


def _merge_heads(x):
    return x.reshape(*x.shape[:-2], x.shape[-2] * x.shape[-1])


def make_attention_mask(q_len, kv_len, *, causal=True, window=0,
                        q_offset=0, dtype=torch.float32, device="cpu",
                        q_pos=None, k_pos=None):
    """(q_len, kv_len) additive mask. `q_offset` = absolute position of
    q[0]; `q_pos` / `k_pos` (1-D) the queries' and keys' absolute
    positions where they are not one contiguous run from 0 (q_offset)."""
    qpos = (torch.arange(q_len, device=device) + q_offset if q_pos is None
            else q_pos.to(device))[:, None]
    kpos = (torch.arange(kv_len, device=device) if k_pos is None
            else k_pos.to(device))[None, :]
    ok = torch.ones((q_len, kv_len), dtype=torch.bool, device=device)
    if causal:
        ok = ok & (kpos <= qpos)
    if window and window > 0:
        ok = ok & (kpos > qpos - window)
    zero = torch.zeros((), dtype=torch.float32, device=device)
    neg = torch.full((), NEG_INF, dtype=torch.float32, device=device)
    return torch.where(ok, zero, neg).to(dtype)


def gqa_attention(q, k, v, mask=None, *, scale=None):
    """q: (B,S,H,dh)  k,v: (B,T,Hk,dh)  mask: (S,T) or (B,1,S,T) additive."""
    B, S, H, dh = q.shape
    Hk = k.shape[2]
    G = H // Hk
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    qg = q.reshape(B, S, Hk, G, dh)
    logits = torch.einsum("bskgd,btkd->bkgst", qg.float(), k.float()) * scale
    if mask is not None:
        m = mask if mask.dim() == 2 else mask.reshape(B, 1, 1,
                                                      *mask.shape[-2:])
        logits = logits + m
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", w, v.float())
    return out.reshape(B, S, H, dh).to(q.dtype)


def chunked_attention(q, k, v, *, causal=True, window=0, chunk=512,
                      scale=None, q_offset=0, q_pos=None, k_pos=None):
    """Online-softmax attention over key chunks, a Python loop where the
    reference runs `lax.scan`. Never materialises the (S, T) score matrix.

    q: (B,S,H,dh); k,v: (B,T,Hk,dh); `q_offset` the absolute position of
    q[0]; `q_pos` / `k_pos` (1-D, S and T) the absolute positions where
    they are not one contiguous run (keys in any order: a chunk masked
    whole is rescaled away by the first visible key). Exact (not an
    approximation)."""
    B, S, H, dh = q.shape
    T, Hk = k.shape[1], k.shape[2]
    G = H // Hk
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    chunk = min(chunk, T)
    while T % chunk:
        chunk -= 1
    nk = T // chunk

    dv = v.shape[-1]
    dev = q.device
    qg = q.reshape(B, S, Hk, G, dh).float()
    qpos = (torch.arange(S, device=dev) + q_offset if q_pos is None
            else q_pos.to(dev))
    m = torch.full((B, Hk, G, S), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, Hk, G, S), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, Hk, G, S, dv), dtype=torch.float32, device=dev)
    neg = torch.full((), NEG_INF, dtype=torch.float32, device=dev)
    for ci in range(nk):
        kt = k[:, ci * chunk:(ci + 1) * chunk].float()
        vt = v[:, ci * chunk:(ci + 1) * chunk].float()
        kpos = (ci * chunk + torch.arange(chunk, device=dev)
                if k_pos is None
                else k_pos[ci * chunk:(ci + 1) * chunk].to(dev))
        s = torch.einsum("bskgd,btkd->bkgst", qg, kt) * scale
        ok = torch.ones((S, chunk), dtype=torch.bool, device=dev)
        if causal:
            ok = ok & (kpos[None, :] <= qpos[:, None])
        if window and window > 0:
            ok = ok & (kpos[None, :] > qpos[:, None] - window)
        s = torch.where(ok, s, neg)
        m_cur = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_cur[..., None])
        alpha = torch.exp(m - m_cur)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bkgst,btkd->bkgsd",
                                                    p, vt)
        m = m_cur
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    out = out.permute(0, 3, 1, 2, 4).reshape(B, S, H, dv)
    return out.to(q.dtype)


def flash_tiles(cfg, S, T, dh) -> bool:
    """Whether `_maybe_flash` takes the flash kernel for S queries against
    T keys of head dim dh with no query offset (the reference's
    conditions: enabled, S, T >= 128 and multiples of 128, dh % 8 == 0)."""
    return (cfg.attn_impl == "flash" and min(S, T) >= 128
            and not (S % 128 or T % 128 or dh % 8))


def _maybe_flash(cfg, q, k, v, *, causal, window, q_offset):
    """The flash kernel when `flash_tiles` and no query offset; None sends
    the caller to the einsum path."""
    if q_offset or not flash_tiles(cfg, q.shape[1], k.shape[1],
                                   q.shape[-1]):
        return None
    from repro_torch.kernels import ops as kops
    return kops.flash_attention(q.contiguous(), k.contiguous(),
                                v.contiguous(), causal=causal, window=window)


def _rank_kv(cfg, tp, q_heads, k, v):
    """The rank's kv heads for its `q_heads` query heads, laid out for
    `gqa_attention` (query head i reads kv head i // (q_heads / kv
    heads)): `k` / `v` hold the rank's kv heads; kv heads that straddle
    the rank's groups are repeated, one a query head."""
    q0, hl, k0, kl = _heads(cfg, tp)
    return _kv_for(cfg, q0, q_heads, k0, k, v)


def _kv_for(cfg, q0, hl, kv0, k, v):
    """The kv heads query heads [q0, q0 + hl) read, laid out for
    `gqa_attention`, from `k` / `v` holding kv heads from `kv0` on."""
    G = cfg.num_heads // cfg.num_kv_heads
    first, last = q0 // G, (q0 + hl - 1) // G
    kl = last - first + 1
    if first - kv0 or k.shape[2] != kl:
        k = k[:, :, first - kv0:last + 1 - kv0]
        v = v[:, :, first - kv0:last + 1 - kv0]
    want = [(q0 + i) // G - first for i in range(hl)]
    if hl % kl == 0 and want == [i // (hl // kl) for i in range(hl)]:
        return k, v
    idx = torch.tensor(want, device=k.device)
    return k.index_select(2, idx), v.index_select(2, idx)


def _partial_softmax(q, k, v, valid, scale):
    """One rank's share of single-query attention: q (B, 1, H, dh) against
    k, v (B, T, Hk, dh) at the `valid` (T,) slots -> (m, l, o) in float32,
    the row max (B, Hk, G, 1), the sum of e^(s - m) and the unnormalised
    output (B, Hk, G, 1, dh). A span with no valid slot gives l = o = 0
    and m = NEG_INF, whose weight e^(m - max) in `_join` is zero."""
    B, S, H, dh = q.shape
    Hk = k.shape[2]
    qg = q.reshape(B, S, Hk, H // Hk, dh).float()
    s = torch.einsum("bskgd,btkd->bkgst", qg, k.float()) * scale
    neg = torch.full((), NEG_INF, dtype=torch.float32, device=q.device)
    s = torch.where(valid, s, neg)
    m = s.amax(dim=-1)
    p = torch.where(valid, torch.exp(s - m[..., None]),
                    torch.zeros((), dtype=torch.float32, device=q.device))
    return m, p.sum(dim=-1), torch.einsum("bkgst,btkd->bkgsd", p,
                                          v.float())


def _join(m, l, o, axis):
    """The output (B, Hk, G, 1, dh) of the ranks' partial softmaxes joined
    over `axis` (None: this rank's alone): one max and one sum over it."""
    if axis is not None:
        top = collectives.max_over(m, axis)
        w = torch.exp(m - top)
        both = collectives.sum_over(
            torch.cat([o * w[..., None], (l * w)[..., None]], -1), axis)
        o, l = both[..., :-1], both[..., -1]
    return o / torch.clamp(l, min=1e-30)[..., None]


def _cut_decode(params, cfg, x, *, positions, cache_kv, cache_index,
                window, theta, tp, kv, still=None):
    """The decode attention of one rank's block of a KV cache (module
    docstring): -> (out, (new_ck, new_cv)), the block written in place.
    Under `still` (stationary projections) `x` and the output hold every
    row of the batch."""
    from repro_torch.models import kvcache as kvc
    dh, H = cfg.head_dim, cfg.num_heads
    q0, hl = kv.heads
    if still is not None:
        # q, k and v of every row and head; the block's rows and kv heads
        # of k and v, the rank's rows and heads of q
        q, k, v = layers.still_dense([(params[n], f"{n}/kernel")
                                      for n in ("wq", "wk", "wv")], x, still)
        b0, nb = kv.block
        r0 = b0 + kv.rows[0]
        nk = cache_kv[0].shape[2] * dh
        k = k[b0:b0 + nb, ..., kv.kv0 * dh:kv.kv0 * dh + nk]
        v = v[b0:b0 + nb, ..., kv.kv0 * dh:kv.kv0 * dh + nk]
        q = q[r0:r0 + kv.rows[1], ..., q0 * dh:(q0 + hl) * dh]
        positions = positions[:nb]
    elif tp is not None:
        x = tp.f(x)
    if still is None:
        q, k, v = (dense(params[n], x) for n in ("wq", "wk", "wv"))
    if still is None and tp is not None and kv.kind != "heads":
        # the rank's columns are not its heads: every rank gathers the
        # new token's k and v (its block may hold the slot) and, to attend
        # with every head, its q
        k, v = tp.gather(k), tp.gather(v)
        if hl == H:
            q = tp.gather(q)
    q = _split_heads(q, q.shape[-1] // dh, dh)
    k = _split_heads(k, k.shape[-1] // dh, dh)
    v = _split_heads(v, v.shape[-1] // dh, dh)
    if cfg.qk_norm:
        q = layers.rmsnorm(params["q_norm"], q, cfg.norm_eps)
        k = layers.rmsnorm(params["k_norm"], k, cfg.norm_eps)
    if cfg.use_rope:
        q = apply_rope(q, positions[:q.shape[0]], theta)
        k = apply_rope(k, positions[:k.shape[0]], theta)
    if kv.row_axis is not None and still is None:
        # the block holds other ranks' rows too: their new entries
        k = collectives.all_gather(k.contiguous(), kv.row_axis, dim=0)
        v = collectives.all_gather(v.contiguous(), kv.row_axis, dim=0)
    ck, cv = kvc.update_layer(*cache_kv, cache_index, k, v, window=window,
                              offset=kv.offset, capacity=kv.capacity)
    lo, n = kv.span
    r0, nr = kv.rows
    valid = kvc.valid_mask(cache_index, kv.capacity, window=window,
                           device=x.device, offset=kv.offset + lo, length=n)
    kk, vv = _kv_for(cfg, q0, hl, kv.kv0, ck[r0:r0 + nr, lo:lo + n],
                     cv[r0:r0 + nr, lo:lo + n])
    out = _join(*_partial_softmax(q, kk, vv, valid, 1.0 / math.sqrt(dh)),
                kv.axis)
    out = out.permute(0, 3, 1, 2, 4).reshape(q.shape[0], 1,
                                             hl * dh).to(q.dtype)
    if still is not None:
        # every row's output of every head: one all-gather over the ranks
        # holding other rows (and other heads), then `wo`'s block
        view = still.view
        out = still.join(out, view.row_axis, view.axis if hl < H else None)
        return layers.still_dense([(params["wo"], "wo/kernel")], out,
                                  still)[0], (ck, cv)
    if tp is not None and hl == H:
        # every head's output: the rank's rows of `wo` take their columns
        cols = H * dh // tp.size
        out = out[..., tp.index * cols:(tp.index + 1) * cols]
    return layers.row(params["wo"], out, tp), (ck, cv)


def _heads(cfg, tp):
    from repro_torch.sharding.specs import attn_heads
    return attn_heads(cfg, tp.size, tp.index)


def attention(params, cfg, x, *, positions, mask=None, cache_kv=None,
              cache_index=None, window=0, causal=True, rope_theta=None,
              kv_override=None, tp=None, seq=None, kv=None, still=None):
    """Full attention block (projections + SDPA + output projection).

    Train/prefill: cache_kv=None, x: (B,S,D).
    Decode: x: (B,1,D), cache_kv=(ck, cv) with ck: (B,cap,Hk,dh),
            cache_index = number of tokens already in the cache (the
            decode state's 0-d int32 "index" tensor; the mask and the
            write position are computed from it on the device).
            Returns (out, (new_ck, new_cv)).
    Cross-attention: kv_override=(k, v) precomputed from encoder output.
    `tp`: the rank's heads (module docstring); never with kv_override.
    `seq`: the rank's block of positions (module docstring; `positions`
    and `mask` are its own, the mask (S, T) against every rank's keys).
    With `kv_override` and `seq` the given keys and values are the rank's
    block, gathered here (cross-attention to an encoder cut by position;
    no mask). `kv`: a decode step's cut cache (module docstring), and
    `still` its stationary projections (`models.parallel.Stationary`).
    """
    dh = cfg.head_dim
    theta = rope_theta if rope_theta is not None else cfg.rope_theta
    if kv is not None:
        return _cut_decode(params, cfg, x, positions=positions,
                           cache_kv=cache_kv, cache_index=cache_index,
                           window=window, theta=theta, tp=tp, kv=kv,
                           still=still)
    if tp is not None:
        x = tp.f(x)
    # the head counts of the rank's slices (all of them off a mesh)
    H = params["wq"]["kernel"].shape[1] // dh

    q = _split_heads(dense(params["wq"], x), H, dh)
    if kv_override is None:
        Hk = params["wk"]["kernel"].shape[1] // dh
        k = _split_heads(dense(params["wk"], x), Hk, dh)
        v = _split_heads(dense(params["wv"], x), Hk, dh)
    else:
        k, v = kv_override

    if cfg.qk_norm:
        q = layers.rmsnorm(params["q_norm"], q, cfg.norm_eps)
        if kv_override is None:
            k = layers.rmsnorm(params["k_norm"], k, cfg.norm_eps)

    if cfg.use_rope and kv_override is None:
        q = apply_rope(q, positions, theta)
        k = apply_rope(k, positions, theta)

    new_cache = None
    q_pos = k_pos = None
    if seq is not None:
        k, v = seq.gather_seq(k, v)
        q_pos, k_pos = seq.q_pos, seq.k_pos
    if tp is not None and cache_kv is None:
        k, v = _rank_kv(cfg, tp, H, k, v)
    if cache_kv is not None:
        from repro_torch.models import kvcache as kvc
        if tp is not None:
            raise ValueError("a cut attention decodes through its cache's "
                             "KVCut (`kv`)")
        ck, cv = cache_kv
        cap = ck.shape[1]
        ck, cv = kvc.update_layer(ck, cv, cache_index, k, v, window=window)
        new_cache = (ck, cv)
        valid = kvc.valid_mask(cache_index, cap, window=window,
                               device=x.device)
        amask = torch.where(valid[None, :],
                            torch.zeros((), device=x.device),
                            torch.full((), NEG_INF, device=x.device))
        amask = amask[None, None].expand(x.shape[0], 1, q.shape[1], cap)
        out = gqa_attention(q, ck, cv, amask)
    elif kv_override is not None:
        if cfg.attn_impl == "chunked":
            out = chunked_attention(q, k, v, causal=False,
                                    chunk=cfg.attn_chunk)
        else:
            out = gqa_attention(q, k, v, mask)
    elif cfg.attn_impl == "chunked":
        out = chunked_attention(q, k, v, causal=causal, window=window,
                                chunk=cfg.attn_chunk, q_pos=q_pos,
                                k_pos=k_pos)
    else:
        f = None if seq is not None else _maybe_flash(
            cfg, q, k, v, causal=causal, window=window, q_offset=0)
        if f is not None:
            out = f
        else:
            if mask is None:
                mask = make_attention_mask(q.shape[1], k.shape[1],
                                           causal=causal, window=window,
                                           q_pos=q_pos, k_pos=k_pos,
                                           device=x.device)
            out = gqa_attention(q, k, v, mask)

    out = layers.row(params["wo"], _merge_heads(out), tp)
    return (out, new_cache) if cache_kv is not None else out
