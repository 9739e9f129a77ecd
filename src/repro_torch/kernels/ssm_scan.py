"""Chunked Mamba2 / SSD scan (zamba2's hot loop) on the card.

    h_t = exp(a_t) h_{t-1} + dt_t x_t B_t^T,   y_t = h_t C_t

computed chunk by chunk: within a chunk a masked quadratic form, across
chunks a (dh, N) float32 state per (batch, head).

The kernel is `csrc/ssm_scan.cu`, a hand-written CUDA C++ kernel for
Hopper (sm_90a) that replaces the TPU kernel
`repro/kernels/ssm_scan.py::_ssd_kernel`; its source notes say what
bounds it and how the design answers. `ssm_scan` is its wrapper: a CUDA
tensor launches the kernel (or the wrapper raises), a CPU tensor takes
the plain PyTorch version `ssm_scan_torch`, which repeats the kernel's
chunked arithmetic. A CPU tensor takes any head dim, state width and
chunk (the reference's kernel asserts only S % chunk == 0); a CUDA tensor
outside the kernel's envelope (dh in HEAD_DIMS, N and the chunk up to 128,
the shared memory a block may use) raises before any launch. There is no
fallback from the card to the plain version.

`launches` counts kernel launches in this process; it moves only where
the kernel is launched.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

launches = 0

HEAD_DIMS = (32, 64)
MAX_CHUNK = 128
MAX_STATE = 128
MAX_SMEM = 232448                  # bytes of shared memory a block may use
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def smem_bytes(dh, N, Q):
    """Dynamic shared memory of one block (as `csrc/ssm_scan.cu`)."""
    return 4 * (Q * (dh + 1) + 2 * Q * (N + 1) + Q * (Q + 1)
                + dh * (N + 1) + 3 * Q)


def _chunk(S, chunk):
    Q = min(chunk, S)
    if Q < 1 or S % Q:
        raise ValueError(f"sequence length {S} is not a multiple of the "
                         f"chunk {Q}")
    return Q


def ssm_scan_torch(xh, a_log, dt, Bm, Cm, *, chunk=128):
    """Plain PyTorch version of the chunked scan, in float32; y in xh's
    dtype. xh: (B, S, H, dh); a_log, dt: (B, S, H); Bm, Cm: (B, S, N)."""
    B, S, H, dh = xh.shape
    N = Bm.shape[-1]
    Q = _chunk(S, chunk)
    f32 = torch.float32
    state = torch.zeros((B, H, dh, N), dtype=f32, device=xh.device)
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                 device=xh.device))
    ys = []
    for c0 in range(0, S, Q):
        x = xh[:, c0:c0 + Q].to(f32)                          # (B,Q,H,dh)
        a = a_log[:, c0:c0 + Q].to(f32)                       # (B,Q,H)
        d = dt[:, c0:c0 + Q].to(f32)
        Bc = Bm[:, c0:c0 + Q].to(f32)                         # (B,Q,N)
        Cc = Cm[:, c0:c0 + Q].to(f32)
        cs = torch.cumsum(a, dim=1)                           # (B,Q,H)
        G = torch.einsum("bin,bjn->bij", Cc, Bc)              # (B,Q,Q)
        L = cs[:, :, None, :] - cs[:, None, :, :]             # (B,Q,Q,H)
        L = torch.where(mask[None, :, :, None],
                        torch.exp(torch.where(mask[None, :, :, None], L,
                                              torch.zeros_like(L))),
                        torch.zeros_like(L))
        W = G[..., None] * L * d[:, None, :, :]               # (B,Q,Q,H)
        y_intra = torch.einsum("bijh,bjhd->bihd", W, x)
        y_inter = torch.exp(cs)[..., None] * torch.einsum(
            "bqn,bhdn->bqhd", Cc, state)
        ys.append(y_intra + y_inter)
        u = torch.exp(cs[:, -1:, :] - cs) * d                 # (B,Q,H)
        contrib = torch.einsum("bqhd,bqn->bhdn", x * u[..., None], Bc)
        state = torch.exp(cs[:, -1, :])[:, :, None, None] * state + contrib
    return torch.cat(ys, dim=1).to(xh.dtype)


def _check(xh, a_log, dt, Bm, Cm):
    """What every device takes: the plain version's contract."""
    if xh.dim() != 4:
        raise ValueError(f"xh must be (B, S, H, dh), got {tuple(xh.shape)}")
    B, S, H, dh = xh.shape
    for name, t in (("a_log", a_log), ("dt", dt)):
        if tuple(t.shape) != (B, S, H):
            raise ValueError(f"{name} shape {tuple(t.shape)} != "
                             f"{(B, S, H)}")
    if Bm.dim() != 3 or tuple(Bm.shape[:2]) != (B, S) \
            or tuple(Cm.shape) != tuple(Bm.shape):
        raise ValueError(f"Bm, Cm must be (B, S, N) = ({B}, {S}, N), got "
                         f"{tuple(Bm.shape)}, {tuple(Cm.shape)}")
    if xh.dtype not in _DTYPES or Bm.dtype != xh.dtype \
            or Cm.dtype != xh.dtype:
        raise TypeError(f"xh, Bm, Cm must all be float32 or bfloat16, got "
                        f"{xh.dtype}, {Bm.dtype}, {Cm.dtype}")
    if not (a_log.is_floating_point() and dt.is_floating_point()):
        raise TypeError("a_log and dt must be floating point")
    if len({t.device for t in (xh, a_log, dt, Bm, Cm)}) != 1:
        raise ValueError("xh, a_log, dt, Bm, Cm must be on one device")
    if not all(t.is_contiguous() for t in (xh, Bm, Cm)):
        raise ValueError("xh, Bm and Cm must be contiguous")


def _check_kernel(xh, Bm, Q):
    """The CUDA kernel's envelope, checked before any launch."""
    B, _, H, dh = xh.shape
    N = Bm.shape[-1]
    if dh not in HEAD_DIMS:
        raise ValueError(f"the CUDA kernel takes head dims {HEAD_DIMS}, "
                         f"got {dh}")
    if not 1 <= N <= MAX_STATE or Q > MAX_CHUNK or B < 1 or H < 1:
        raise ValueError(f"the CUDA kernel takes a state width and chunk "
                         f"up to {MAX_STATE} / {MAX_CHUNK}, got {N} / {Q}")
    if smem_bytes(dh, N, Q) > MAX_SMEM:
        raise ValueError(f"the CUDA kernel at (dh, N, chunk) = ({dh}, {N}, "
                         f"{Q}) needs {smem_bytes(dh, N, Q)} bytes of "
                         f"shared memory, above {MAX_SMEM}")


def _bind():
    fn = build.load("ssm_scan").ssm_scan
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def ssm_scan(xh, a_log, dt, Bm, Cm, *, chunk=128):
    """xh: (B, S, H, dh) float32 or bfloat16; a_log, dt: (B, S, H) (read
    as float32); Bm, Cm: (B, S, N) in xh's dtype, shared by the heads.
    S must be a multiple of min(chunk, S). Returns y: (B, S, H, dh) in
    xh's dtype. A CPU tensor takes any dh, N and chunk; a CUDA tensor
    must fit `_check_kernel`."""
    global launches
    _check(xh, a_log, dt, Bm, Cm)
    B, S = xh.shape[:2]
    Q = _chunk(S, chunk)
    if xh.device.type == "cpu":
        return ssm_scan_torch(xh, a_log, dt, Bm, Cm, chunk=Q)
    if xh.device.type != "cuda":
        raise ValueError(f"unsupported device {xh.device}")
    _check_kernel(xh, Bm, Q)
    H, dh = xh.shape[2:]
    N = Bm.shape[-1]
    a32 = a_log.to(torch.float32).contiguous()     # exact from bf16
    dt32 = dt.to(torch.float32).contiguous()
    y = torch.empty_like(xh)
    stream = torch.cuda.current_stream(xh.device).cuda_stream
    err = _bind()(xh.data_ptr(), a32.data_ptr(), dt32.data_ptr(),
                  Bm.data_ptr(), Cm.data_ptr(), y.data_ptr(),
                  B, S, H, dh, N, Q, _DTYPES[xh.dtype], stream)
    if err != 0:
        raise RuntimeError(f"ssm_scan launch failed: cudaError {err} "
                           f"(B={B}, S={S}, H={H}, dh={dh}, N={N}, Q={Q}, "
                           f"dtype={xh.dtype})")
    launches += 1
    return y
