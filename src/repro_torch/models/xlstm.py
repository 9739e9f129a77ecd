"""xLSTM blocks — mLSTM (matrix memory) and sLSTM (scalar memory) (port of
`repro.models.xlstm`).

mLSTM: exponential input gate + forget gate over a matrix memory
C_t = f C_{t-1} + i v k^T. Prefill uses the stabilized *parallel*
(attention-like) form from the xLSTM paper, or its chunked form; decode
carries (C, n, m), O(1) per token.

sLSTM: true recurrence (h_{t-1} feeds the gates) with scalar memory, the
max-stabilizer and float32 exponent gates; a Python loop over time where
the reference runs `lax.scan`.

Blocks carry their own up/down projections (xlstm-125m has d_ff=0: no
separate FFN block). mLSTM uses pre-up-projection (proj_factor 2), sLSTM
operates at model width.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.layers import (dense, init_dense, init_rmsnorm,
                                       lecun_init, rmsnorm)

NEG_INF = -2.0e38


# -- mLSTM ---------------------------------------------------------------------------

def _mlstm_dims(cfg):
    di = int(cfg.xlstm_proj_factor * cfg.d_model)
    H = cfg.num_heads
    return di, H, di // H


def init_mlstm(generator, cfg, dtype=torch.float32):
    d = cfg.d_model
    di, H, _ = _mlstm_dims(cfg)
    return {
        "up_proj": init_dense(generator, d, di, dtype=dtype),
        "gate_proj": init_dense(generator, d, di, dtype=dtype),
        "wq": init_dense(generator, di, di, dtype=dtype),
        "wk": init_dense(generator, di, di, dtype=dtype),
        "wv": init_dense(generator, di, di, dtype=dtype),
        "wi": init_dense(generator, di, H, use_bias=True, dtype=dtype),
        "wf": init_dense(generator, di, H, use_bias=True, dtype=dtype),
        "norm": init_rmsnorm(di, dtype),
        "down_proj": init_dense(generator, di, d, dtype=dtype),
    }


def _mlstm_qkvif(params, cfg, u):
    _, H, dh = _mlstm_dims(cfg)
    B, S = u.shape[:2]
    q = dense(params["wq"], u).reshape(B, S, H, dh)
    k = dense(params["wk"], u).reshape(B, S, H, dh) / math.sqrt(dh)
    v = dense(params["wv"], u).reshape(B, S, H, dh)
    i_raw = dense(params["wi"], u).float()                 # (B,S,H)
    f_raw = dense(params["wf"], u).float()
    return q, k, v, i_raw, f_raw


def _causal_log_weights(F_cum, i_raw):
    """D[t,j] = F_t - F_j + i_j for j <= t, NEG_INF above: (B,S,S,H)."""
    S = F_cum.shape[1]
    D = F_cum[:, :, None, :] - F_cum[:, None, :, :] + i_raw[:, None, :, :]
    idx = torch.arange(S, device=F_cum.device)
    causal = (idx[:, None] >= idx[None, :])[None, :, :, None]
    return torch.where(causal, D, torch.full((), NEG_INF, device=D.device))


def mlstm_parallel(q, k, v, i_raw, f_raw):
    """Stabilized parallel mLSTM. q,k,v: (B,S,H,dh); gates (B,S,H)."""
    D = _causal_log_weights(torch.cumsum(F.logsigmoid(f_raw), dim=1), i_raw)
    m = D.amax(dim=2, keepdim=True)                       # (B,S,1,H)
    Dp = torch.exp(D - m)
    logits = torch.einsum("bthd,bjhd->btjh", q.float(), k.float())
    W = logits * Dp
    norm = torch.maximum(W.sum(dim=2).abs(), torch.exp(-m[:, :, 0, :]))
    h = torch.einsum("btjh,bjhd->bthd", W, v.float()) / norm[..., None]
    return h.to(q.dtype)


def mlstm_chunked(q, k, v, i_raw, f_raw, chunk=256):
    """Chunked, stabilized mLSTM: O(S * chunk) memory instead of O(S^2).

    Carries (C: (B,H,dh,dh), n: (B,H,dh), m: (B,H)) across chunks with a
    running max-stabilizer, like the decode recurrence at chunk
    granularity; a Python loop where the reference runs `lax.scan`."""
    B, S, H, dh = q.shape
    Q = min(chunk, S)
    while S % Q:
        Q -= 1
    dev = q.device
    Cst = torch.zeros((B, H, dh, dh), dtype=torch.float32, device=dev)
    nst = torch.zeros((B, H, dh), dtype=torch.float32, device=dev)
    mst = torch.full((B, H), -1e30, dtype=torch.float32, device=dev)
    hs = []
    for c0 in range(0, S, Q):
        qt, kt, vt = (t[:, c0:c0 + Q].float() for t in (q, k, v))
        it, ft = i_raw[:, c0:c0 + Q], f_raw[:, c0:c0 + Q]
        Fc = torch.cumsum(F.logsigmoid(ft), dim=1)          # (B,Q,H)
        # intra-chunk log weights D[t,j] = F_t - F_j + i_j  (j <= t)
        D = _causal_log_weights(Fc, it)
        m_intra = D.amax(dim=2)                             # (B,Q,H)
        # inter-chunk: the state carries scale mst; decay to t is F_t
        m_inter = Fc + mst[:, None, :]
        m_t = torch.maximum(m_intra, m_inter)

        w_intra = torch.exp(D - m_t[:, :, None, :])
        s = torch.einsum("bthd,bjhd->btjh", qt, kt)
        num_intra = torch.einsum("btjh,btjh,bjhd->bthd", s, w_intra, vt)
        den_intra = torch.einsum("btjh,btjh->bth", s, w_intra)

        scale_inter = torch.exp(m_inter - m_t)              # (B,Q,H)
        # C[d,e] accumulates v_d k_e: contract q against the k index (e)
        num_inter = (torch.einsum("bthe,bhde->bthd", qt, Cst)
                     * scale_inter[..., None])
        den_inter = torch.einsum("bthd,bhd->bth", qt, nst) * scale_inter

        num = num_intra + num_inter
        den = torch.maximum((den_intra + den_inter).abs(), torch.exp(-m_t))
        hs.append(num / den[..., None])

        # state update to the chunk's end
        F_end = Fc[:, -1, :]                                # (B,H)
        m_new = torch.maximum(
            mst + F_end, (it + F_end[:, None, :] - Fc).amax(dim=1))
        w_upd = torch.exp(it + F_end[:, None, :] - Fc - m_new[:, None, :])
        decay = torch.exp(mst + F_end - m_new)
        Cst = (decay[:, :, None, None] * Cst
               + torch.einsum("bjh,bjhd,bjhe->bhde", w_upd, vt, kt))
        nst = (decay[:, :, None] * nst
               + torch.einsum("bjh,bjhd->bhd", w_upd, kt))
        mst = m_new
    return torch.cat(hs, dim=1).to(q.dtype)


def mlstm_block(params, cfg, x):
    u = dense(params["up_proj"], x)
    g = dense(params["gate_proj"], x)
    q, k, v, i_raw, f_raw = _mlstm_qkvif(params, cfg, u)
    if cfg.mlstm_impl == "chunked":
        h = mlstm_chunked(q, k, v, i_raw, f_raw, chunk=cfg.mlstm_chunk)
    else:
        h = mlstm_parallel(q, k, v, i_raw, f_raw)
    di, _, _ = _mlstm_dims(cfg)
    h = rmsnorm(params["norm"], h.reshape(*x.shape[:-1], di), cfg.norm_eps)
    h = h * F.silu(g)
    return dense(params["down_proj"], h)


def init_mlstm_state(cfg, batch, dtype=torch.float32, device="cuda"):
    _, H, dh = _mlstm_dims(cfg)
    return {
        "C": torch.zeros((batch, H, dh, dh), dtype=dtype, device=device),
        "n": torch.zeros((batch, H, dh), dtype=dtype, device=device),
        "m": torch.full((batch, H), -1e30, dtype=dtype, device=device),
    }


def mlstm_step(params, cfg, x, state):
    """Decode one token. x: (B,1,D)."""
    u = dense(params["up_proj"], x)
    g = dense(params["gate_proj"], x)
    q, k, v, i_raw, f_raw = _mlstm_qkvif(params, cfg, u)
    q, k, v = (t[:, 0].float() for t in (q, k, v))         # (B,H,dh)
    i_raw, f_raw = i_raw[:, 0], f_raw[:, 0]                 # (B,H)

    log_f = F.logsigmoid(f_raw)
    m_new = torch.maximum(log_f + state["m"], i_raw)
    f_s = torch.exp(log_f + state["m"] - m_new)
    i_s = torch.exp(i_raw - m_new)
    C = (f_s[..., None, None] * state["C"]
         + i_s[..., None, None] * torch.einsum("bhd,bhe->bhde", v, k))
    n = f_s[..., None] * state["n"] + i_s[..., None] * k
    num = torch.einsum("bhde,bhe->bhd", C, q)
    den = torch.maximum(torch.einsum("bhd,bhd->bh", n, q).abs(),
                        torch.exp(-m_new))[..., None]
    di, _, _ = _mlstm_dims(cfg)
    h = (num / den).reshape(x.shape[0], 1, di).to(x.dtype)
    h = rmsnorm(params["norm"], h, cfg.norm_eps) * F.silu(g)
    return dense(params["down_proj"], h), {"C": C, "n": n, "m": m_new}


# -- sLSTM ---------------------------------------------------------------------------

def init_slstm(generator, cfg, dtype=torch.float32):
    d = cfg.d_model
    H = cfg.num_heads
    dh = d // H
    return {
        # input-to-gates: z, i, f, o — each (d -> d) headwise
        "wz": init_dense(generator, d, d, use_bias=True, dtype=dtype),
        "wi": init_dense(generator, d, d, use_bias=True, dtype=dtype),
        "wf": init_dense(generator, d, d, use_bias=True, dtype=dtype),
        "wo_gate": init_dense(generator, d, d, use_bias=True, dtype=dtype),
        # block-diagonal recurrent weights: (H, dh, dh) per gate
        "rz": lecun_init(generator, (H, dh, dh), fan_in=dh, dtype=dtype),
        "ri": lecun_init(generator, (H, dh, dh), fan_in=dh, dtype=dtype),
        "rf": lecun_init(generator, (H, dh, dh), fan_in=dh, dtype=dtype),
        "norm": init_rmsnorm(d, dtype),
    }


def init_slstm_state(cfg, batch, dtype=torch.float32, device="cuda"):
    H = cfg.num_heads
    shape = (batch, H, cfg.d_model // H)
    state = {k: torch.zeros(shape, dtype=dtype, device=device)
             for k in ("c", "n", "h")}
    state["m"] = torch.full(shape, -1e30, dtype=dtype, device=device)
    return state


def _slstm_cell(rec_w, zt, it, ft, ot, state):
    """One sLSTM step; gate preactivations (B,H,dh) already include the
    input. `rec_w` (H, dh, 3 dh): the z, i and f recurrent weights side
    by side, one product a step (three a step made the loop's launches
    and autograd nodes the FL trainer's cost on the card)."""
    rz, ri, rf = torch.einsum("bhd,hde->bhe", state["h"].float(),
                              rec_w).chunk(3, dim=-1)
    zt = torch.tanh(zt + rz)
    it = it + ri
    ft = ft + rf
    log_f = F.logsigmoid(ft)
    m_new = torch.maximum(log_f + state["m"], it)
    i_s = torch.exp(it - m_new)
    f_s = torch.exp(log_f + state["m"] - m_new)
    c = f_s * state["c"] + i_s * zt
    n = torch.maximum(f_s * state["n"] + i_s, torch.exp(-m_new))
    h = torch.sigmoid(ot) * c / n
    return {"c": c, "n": n, "h": h, "m": m_new}


def slstm_forward(params, cfg, x, state=None):
    """x: (B,S,D), a sequential loop over time. Returns (y, state)."""
    B, S, D = x.shape
    H = cfg.num_heads
    dh = D // H
    z_pre, i_pre, f_pre, o_pre = (
        dense(params[w], x).reshape(B, S, H, dh).float()
        for w in ("wz", "wi", "wf", "wo_gate"))
    if state is None:
        state = init_slstm_state(cfg, B, device=x.device)
    rec_w = torch.cat([params[w].float() for w in ("rz", "ri", "rf")], -1)
    hs = []
    for t in range(S):
        state = _slstm_cell(rec_w, z_pre[:, t], i_pre[:, t], f_pre[:, t],
                            o_pre[:, t], state)
        hs.append(state["h"])
    y = torch.stack(hs, dim=1).reshape(B, S, D).to(x.dtype)
    return rmsnorm(params["norm"], y, cfg.norm_eps), state


def slstm_step(params, cfg, x, state):
    return slstm_forward(params, cfg, x, state)
