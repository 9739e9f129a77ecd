"""Mamba2 (SSD) block — chunked scan for prefill, O(1) state decode (port
of `repro.models.ssm`).

Scalar-per-head A (the SSD restriction), one group of B/C shared by the
heads. The prefill path is the chunked state-space-dual algorithm:
quadratic attention-like compute within chunks of length Q and the
(H, dh, N) state carried across chunks, a Python loop where the
reference runs `lax.scan`; `mamba2_forward(..., use_kernel=True)` runs
the chunked scan kernel instead (`kernels.ops.ssm_scan`), as the
reference offers it.

Decode keeps a recurrent state (B, H, dh, N) and a (W-1)-deep conv
window — O(1) memory per generated token.

Under `tp` (a `models.parallel.Parallel` cutting heads over "model") the
prefill runs on the rank's H/M heads: its slices of `in_proj` and
`conv1d` hold its heads' z, x and dt columns and all of B and C
(`specs.compute_layout`), the gated RMSNorm over d_inner sums its squares
over "model", and `out_proj` is row-parallel.

A decode step's stationary block (`still`, a `models.parallel.Stationary`)
keeps its state whole per rank over the rank's token rows and computes
`in_proj` and `out_proj` where they are stored: `in_proj` from every row
of the batch, its output regrouped to the rank's rows of every column
(`Stationary.own`: an all-to-all where its block is cut over the rows'
axes), and `out_proj` from every row of the scan's output (one all-gather
over the rows' axes), its partial products summed.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.layers import (dense, init_dense, init_rmsnorm,
                                       rmsnorm, row, still_dense, still_part)


def d_inner(cfg):
    return cfg.mamba_expand * cfg.d_model


def ssm_heads(cfg):
    return d_inner(cfg) // cfg.ssm_head_dim


def conv_channels(cfg):
    return d_inner(cfg) + 2 * cfg.ssm_state


def init_mamba2(generator, cfg, dtype=torch.float32):
    d = cfg.d_model
    di, N, H = d_inner(cfg), cfg.ssm_state, ssm_heads(cfg)
    W = cfg.conv_dim
    in_proj = init_dense(generator, d, 2 * di + 2 * N + H, dtype=dtype)
    conv = (torch.randn((W, conv_channels(cfg)), generator=generator)
            / math.sqrt(W)).to(dtype)
    lo, hi = math.log(1e-3), math.log(1e-1)
    u = lo + (hi - lo) * torch.rand((H,), generator=generator)
    return {
        # z (gate), x, B, C, dt
        "in_proj": in_proj,
        "conv1d": conv,
        "A_log": torch.log(torch.linspace(1.0, 16.0, H)).to(dtype),
        "D": torch.ones((H,), dtype=dtype),
        "dt_bias": torch.log(torch.expm1(torch.exp(u))).to(dtype),
        "norm": init_rmsnorm(di, dtype),
        "out_proj": init_dense(generator, di, d, dtype=dtype),
    }


def _causal_depthwise_conv(x, w):
    """x: (B,S,C), w: (W,C) — causal depthwise conv as W shifted
    multiply-adds (the reference's shift form), in float32."""
    W = w.shape[0]
    xf = x.float()
    wf = w.float()
    out = xf * wf[W - 1]
    for j in range(W - 1):
        shift = W - 1 - j                       # how far back in time
        shifted = F.pad(xf, (0, 0, shift, 0))[:, :-shift]
        out = out + shifted * wf[j]
    return out.to(x.dtype)


def _split_proj(cfg, proj, di=None):
    """z, x, B, C, dt of an `in_proj` product (`di`: the x width, the
    rank's under tp)."""
    di, N = di or d_inner(cfg), cfg.ssm_state
    z = proj[..., :di]
    xs = proj[..., di:2 * di]
    Bm = proj[..., 2 * di:2 * di + N]
    Cm = proj[..., 2 * di + N:2 * di + 2 * N]
    dt = proj[..., 2 * di + 2 * N:]
    return z, xs, Bm, Cm, dt


def ssd_chunked(xh, a_log, dt, Bm, Cm, chunk=128, h0=None):
    """Chunked SSD scan.

    xh: (B,S,H,dh)  a_log: (B,S,H) = A*dt (negative)  dt: (B,S,H)
    Bm, Cm: (B,S,N).  Returns y: (B,S,H,dh), final state (B,H,dh,N).
    """
    Bsz, S, H, dh = xh.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    while S % Q:
        Q -= 1
    nc = S // Q

    f32 = torch.float32
    dev = xh.device
    xc = xh.reshape(Bsz, nc, Q, H, dh).to(f32)
    ac = a_log.reshape(Bsz, nc, Q, H).to(f32)
    dc = dt.reshape(Bsz, nc, Q, H).to(f32)
    Bc = Bm.reshape(Bsz, nc, Q, N).to(f32)
    Cc = Cm.reshape(Bsz, nc, Q, N).to(f32)

    mask = (torch.arange(Q, device=dev)[:, None]
            >= torch.arange(Q, device=dev)[None, :])[None, :, :, None]
    zero = torch.zeros((), dtype=f32, device=dev)

    h = (torch.zeros((Bsz, H, dh, N), dtype=f32, device=dev) if h0 is None
         else h0.to(f32))
    ys = []
    for c in range(nc):
        x_c, a_c, d_c, B_c, C_c = (xc[:, c], ac[:, c], dc[:, c], Bc[:, c],
                                   Cc[:, c])
        cs = torch.cumsum(a_c, dim=1)                    # (B,Q,H)
        G = torch.einsum("bin,bjn->bij", C_c, B_c)       # (B,Q,Q)
        L = cs[:, :, None, :] - cs[:, None, :, :]        # (B,Q,Q,H)
        L = torch.where(mask, torch.exp(torch.where(mask, L, zero)), zero)
        W = G[..., None] * L * d_c[:, None, :, :]        # (B,Q,Q,H)
        y_intra = torch.einsum("bijh,bjhd->bihd", W, x_c)
        y_inter = torch.einsum("bqn,bqh,bhdn->bqhd", C_c, torch.exp(cs), h)
        decay_end = torch.exp(cs[:, -1:, :] - cs)        # (B,Q,H)
        S_c = torch.einsum("bqh,bqn,bqhd->bhdn", decay_end * d_c, B_c, x_c)
        h = torch.exp(cs[:, -1, :])[:, :, None, None] * h + S_c
        ys.append(y_intra + y_inter)
    y = torch.stack(ys, dim=1).reshape(Bsz, S, H, dh)
    return y.to(xh.dtype), h


def _rmsnorm_cut(params, x, eps, width, tp):
    """`rmsnorm` over a feature dim of `width` cut over "model": the sum
    of squares summed over the ranks."""
    dt = x.dtype
    x = x.float()
    var = tp.sum(torch.sum(torch.square(x), dim=-1, keepdim=True)) / width
    x = x * torch.rsqrt(var + eps)
    return (x * params["scale"].float()).to(dt)


def mamba2_forward(params, cfg, x, *, use_kernel=False, tp=None):
    """Prefill. x: (B,S,D) -> (B,S,D). `use_kernel` runs the chunked
    scan kernel (chunk 128, as the reference calls it) in place of
    `ssd_chunked`; `tp` runs the rank's heads (module docstring)."""
    B, S, D = x.shape
    N, dh = cfg.ssm_state, cfg.ssm_head_dim
    H = params["A_log"].shape[0]            # the rank's heads under tp
    di = H * dh

    if tp is not None:
        x = tp.f(x)
    proj = dense(params["in_proj"], x)
    z, xs, Bm, Cm, dt_raw = _split_proj(cfg, proj, di)
    xbc = _causal_depthwise_conv(torch.cat([xs, Bm, Cm], -1),
                                 params["conv1d"])
    xbc = F.silu(xbc)
    xs, Bm, Cm = xbc[..., :di], xbc[..., di:di + N], xbc[..., di + N:]

    dt = F.softplus(dt_raw.float() + params["dt_bias"].float())
    A = -torch.exp(params["A_log"].float())                       # (H,)
    a_log = A[None, None, :] * dt                                 # (B,S,H)

    xh = xs.reshape(B, S, H, dh)
    if use_kernel:
        from repro_torch.kernels import ops as kops
        y, _ = kops.ssm_scan(xh.contiguous(), a_log, dt, Bm.contiguous(),
                             Cm.contiguous())
    else:
        y, _ = ssd_chunked(xh, a_log, dt, Bm, Cm, chunk=cfg.ssm_chunk)
    y = y + params["D"].float()[None, None, :, None] * xh.float()
    y = y.reshape(B, S, di).to(x.dtype)

    y = y * F.silu(z)
    if tp is None:
        y = rmsnorm(params["norm"], y, cfg.norm_eps)
    else:
        y = _rmsnorm_cut(params["norm"], y, cfg.norm_eps, d_inner(cfg), tp)
    return row(params["out_proj"], y, tp)


def mamba2_step(params, cfg, x, conv_state, ssm_state, still=None):
    """Decode one token. x: (B,1,D); conv_state: (B,W-1,Cc);
    ssm_state: (B,H,dh,N). Returns (y, conv_state, ssm_state). Under
    `still` (module docstring) `x` and `y` hold every row of the batch,
    the states the rank's rows."""
    B = conv_state.shape[0]
    di, N, H = d_inner(cfg), cfg.ssm_state, ssm_heads(cfg)
    dh = cfg.ssm_head_dim

    if still is None:
        proj = dense(params["in_proj"], x)
    else:
        st = still["in_proj/kernel"]
        proj = still.own(still_part(params["in_proj"], x, st), st)
    z, xs, Bm, Cm, dt_raw = _split_proj(cfg, proj)
    xbc_new = torch.cat([xs, Bm, Cm], -1)                          # (B,1,Cc)
    window = torch.cat([conv_state.to(xbc_new.dtype), xbc_new], dim=1)
    conv_state = window[:, 1:]
    w = params["conv1d"].float()                                   # (W,Cc)
    xbc = torch.einsum("bwc,wc->bc", window.float(), w)[:, None, :]
    xbc = F.silu(xbc).to(x.dtype)
    xs, Bm, Cm = xbc[..., :di], xbc[..., di:di + N], xbc[..., di + N:]

    dt = F.softplus(dt_raw.float() + params["dt_bias"].float())[:, 0]
    A = -torch.exp(params["A_log"].float())
    a = torch.exp(A[None, :] * dt)                                 # (B,H)

    xh = xs[:, 0].reshape(B, H, dh).float()
    Bv = Bm[:, 0].float()                                          # (B,N)
    Cv = Cm[:, 0].float()
    upd = torch.einsum("bh,bn,bhd->bhdn", dt, Bv, xh)
    ssm_state = a[:, :, None, None] * ssm_state + upd
    y = torch.einsum("bn,bhdn->bhd", Cv, ssm_state)
    y = y + params["D"].float()[None, :, None] * xh
    y = y.reshape(B, 1, di).to(x.dtype)

    y = y * F.silu(z)
    y = rmsnorm(params["norm"], y, cfg.norm_eps)
    if still is not None:
        y = still_dense([(params["out_proj"], "out_proj/kernel")],
                        still.view.whole(y), still)[0]
        return y, conv_state, ssm_state
    return dense(params["out_proj"], y), conv_state, ssm_state
