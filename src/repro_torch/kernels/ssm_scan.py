"""Chunked Mamba2 / SSD scan (zamba2's hot loop) on the card.

    h_t = exp(a_t) h_{t-1} + dt_t x_t B_t^T,   y_t = h_t C_t

computed chunk by chunk: within a chunk a masked quadratic form, across
chunks a (dh, N) float32 state per (batch, head).

The kernels are `csrc/ssm_scan.cu`, hand-written CUDA C++ for Hopper
(sm_90a) that replaces the TPU kernel
`repro/kernels/ssm_scan.py::_ssd_kernel`: three passes (each chunk's own
state, the states passed from chunk to chunk, each chunk's output), the
products on the tensor cores; its source notes say what bounds it and how
the design answers. `ssm_scan` is its wrapper: a CUDA tensor launches the
kernels (or the wrapper raises), a CPU tensor takes the plain PyTorch
version `ssm_scan_torch`, which repeats the TPU kernel's chunked
arithmetic. `ssm_scan_passes_torch` is a plain rendering of the three
passes, for the tests and the card's checks; no model path calls it. A CPU
tensor takes any head dim, state width and chunk (the reference's kernel
asserts only S % chunk == 0); a CUDA tensor outside the kernels' envelope
(dh in HEAD_DIMS, N and the chunk up to 128, `smem_bytes` within
MAX_SMEM) raises before any launch. There is no fallback from the card to
the plain version.

The kernels have no backward pass, as the reference's Pallas call has
none (`jax.grad` through it raises for every input): `ssm_scan` and
`ssm_chunk_states` raise on every device when grad mode is on and an
input requires grad. The plain versions stay differentiable.

`launches` counts calls that launch on the card, one per `ssm_scan` (or
`ssm_chunk_states`) call whatever passes it runs; it moves only where the
kernels are launched.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import refuse_autograd

launches = 0

HEAD_DIMS = (32, 64)
MAX_CHUNK = 128
MAX_STATE = 128
MAX_SMEM = 232448                  # bytes of shared memory a block may use
_GRID_MAX = 2 ** 31 - 1
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _round(v, m):
    return (v + m - 1) // m * m


def smem_bytes(dh, N, Q, dtype=torch.float32):
    """Dynamic shared memory of one block of the larger chunk pass
    (`ssd_chunk_state`, `ssd_chunk_scan` in `csrc/ssm_scan.cu`), in bytes:
    operand tiles in the input's type, the chunk and the state width padded
    to 16 and every row padded by 8 elements (4 for float32 tiles stored
    with the depth as rows), C staged in bfloat16 only, plus two float32
    rows of the chunk."""
    bf16 = dtype == torch.bfloat16
    item, pad = (2, 8) if bf16 else (4, 4)
    Qp, Np = _round(Q, 16), _round(N, 16)
    state = item * Qp * (dh + pad + Np + pad) + 8 * Qp
    scan = item * ((2 * Qp if bf16 else Qp) * (Np + 8) + Qp * (dh + pad)
                   + dh * (Np + 8)) + 8 * Qp
    return max(state, scan)


def scratch_bytes(B, S, H, dh, N, Q, dtype=torch.float32):
    """Device scratch of one card call, in bytes: per (batch, head, chunk)
    a float32 (dh, N) state, a float32 decay and, for bfloat16 inputs, the
    (dh, N) state entering the chunk in bfloat16 (float32 inputs keep it
    in place of the first)."""
    extra = 2 * dh * N if dtype == torch.bfloat16 else 0
    return B * H * (S // Q) * (4 * dh * N + 4 + extra)


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


def ssm_scan_passes_torch(xh, a_log, dt, Bm, Cm, *, chunk=128):
    """Plain rendering of the card's three passes, in float32: (1) each
    chunk's own state S_c = (x o u)^T B with u = exp(cs_last - cs) dt, (2)
    the states entering each chunk, h_in[0] = 0 and h_in[c + 1] =
    exp(cs_last[c]) h_in[c] + S_c, (3) y = (C B^T o L o dt) x +
    exp(cs) o (C h_in^T). Returns (y in xh's dtype, h_in: (B, H, nc, dh, N)
    float32). For the tests and the card's checks; the model path does not
    call it."""
    B, S, H, dh = xh.shape
    N = Bm.shape[-1]
    Q = _chunk(S, chunk)
    nc = S // Q
    f32 = torch.float32
    x = xh.to(f32).reshape(B, nc, Q, H, dh)
    a = a_log.to(f32).reshape(B, nc, Q, H)
    d = dt.to(f32).reshape(B, nc, Q, H)
    Bc = Bm.to(f32).reshape(B, nc, Q, N)
    Cc = Cm.to(f32).reshape(B, nc, Q, N)
    cs = torch.cumsum(a, dim=2)                               # (B,nc,Q,H)
    # pass 1: each chunk's own state, and its decay to the chunk's end
    u = torch.exp(cs[:, :, -1:] - cs) * d
    own = torch.einsum("bcqhd,bcqn->bhcdn", x * u[..., None], Bc)
    decay = torch.exp(cs[:, :, -1]).permute(0, 2, 1)          # (B,H,nc)
    # pass 2: the state entering each chunk, in order over the chunks
    h_in = torch.empty_like(own)
    h = torch.zeros_like(own[:, :, 0])
    for c in range(nc):
        h_in[:, :, c] = h
        h = decay[:, :, c, None, None] * h + own[:, :, c]
    # pass 3: each chunk's output
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                 device=xh.device))[..., None]
    G = torch.einsum("bcin,bcjn->bcij", Cc, Bc)
    L = cs[:, :, :, None, :] - cs[:, :, None, :, :]           # (B,nc,Q,Q,H)
    L = torch.where(mask, torch.exp(torch.where(mask, L, torch.zeros_like(L))),
                    torch.zeros_like(L))
    W = G[..., None] * L * d[:, :, None, :, :]
    y = torch.einsum("bcijh,bcjhd->bcihd", W, x) + torch.exp(cs)[..., None] \
        * torch.einsum("bcin,bhcdn->bcihd", Cc, h_in)
    return y.reshape(B, S, H, dh).to(xh.dtype), h_in


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
    """The CUDA kernels' envelope, checked before any launch."""
    B, S, H, dh = xh.shape
    N = Bm.shape[-1]
    if dh not in HEAD_DIMS:
        raise ValueError(f"the CUDA kernel takes head dims {HEAD_DIMS}, "
                         f"got {dh}")
    if not 1 <= N <= MAX_STATE or Q > MAX_CHUNK or B < 1 or H < 1:
        raise ValueError(f"the CUDA kernel takes a state width and chunk "
                         f"up to {MAX_STATE} / {MAX_CHUNK}, got {N} / {Q}")
    if smem_bytes(dh, N, Q, xh.dtype) > MAX_SMEM:
        raise ValueError(f"the CUDA kernel at (dh, N, chunk) = ({dh}, {N}, "
                         f"{Q}) needs {smem_bytes(dh, N, Q, xh.dtype)} bytes "
                         f"of shared memory, above {MAX_SMEM}")
    if B * (S // Q) * H > _GRID_MAX or B * H * dh * N // 4 > _GRID_MAX:
        raise ValueError(f"the CUDA kernel's grids take B * (S / chunk) * H "
                         f"<= {_GRID_MAX}, got {B * (S // Q) * H}")


def _bind():
    fn = build.load("ssm_scan").ssm_scan
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _aligned(t):
    """t itself, or a copy where its data is not 16-byte aligned (the
    kernels load 16 bytes at a time)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(xh, a_log, dt, Bm, Cm, Q, passes):
    """Run the card's passes 1-2 (passes = 2) or 1-3 (passes = 3); returns
    (y or None, h_in: (B, H, nc, dh, N) in xh's dtype)."""
    global launches
    _check_kernel(xh, Bm, Q)
    B, S, H, dh = xh.shape
    N = Bm.shape[-1]
    nc = S // Q
    a32 = a_log.to(torch.float32).contiguous()     # exact from bf16
    dt32 = dt.to(torch.float32).contiguous()
    xh, Bm, Cm = _aligned(xh), _aligned(Bm), _aligned(Cm)
    y = torch.empty_like(xh) if passes == 3 else xh
    f32 = dict(dtype=torch.float32, device=xh.device)
    state = torch.empty((B, H, nc, dh, N), **f32)
    # the states entering each chunk, in x's type (float32: in place)
    h_in = state if xh.dtype == torch.float32 else torch.empty_like(
        state, dtype=xh.dtype)
    decay = torch.empty((B, H, nc), **f32)
    stream = torch.cuda.current_stream(xh.device).cuda_stream
    err = _bind()(xh.data_ptr(), a32.data_ptr(), dt32.data_ptr(),
                  Bm.data_ptr(), Cm.data_ptr(), y.data_ptr(),
                  state.data_ptr(), h_in.data_ptr(), decay.data_ptr(),
                  B, S, H, dh, N, Q, _DTYPES[xh.dtype], passes, stream)
    if err != 0:
        raise RuntimeError(f"ssm_scan launch failed: cudaError {err} "
                           f"(B={B}, S={S}, H={H}, dh={dh}, N={N}, Q={Q}, "
                           f"dtype={xh.dtype})")
    launches += 1
    return (y if passes == 3 else None), h_in


def _device(xh):
    if xh.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {xh.device}")
    return xh.device.type


def ssm_scan(xh, a_log, dt, Bm, Cm, *, chunk=128):
    """xh: (B, S, H, dh) float32 or bfloat16; a_log, dt: (B, S, H) (read
    as float32); Bm, Cm: (B, S, N) in xh's dtype, shared by the heads.
    S must be a multiple of min(chunk, S). Returns y: (B, S, H, dh) in
    xh's dtype. A CPU tensor takes any dh, N and chunk; a CUDA tensor
    must fit `_check_kernel`, and takes `scratch_bytes` of device scratch
    for the call."""
    refuse_autograd("ssm_scan", xh, a_log, dt, Bm, Cm)
    _check(xh, a_log, dt, Bm, Cm)
    Q = _chunk(xh.shape[1], chunk)
    if _device(xh) == "cpu":
        return ssm_scan_torch(xh, a_log, dt, Bm, Cm, chunk=Q)
    return _launch(xh, a_log, dt, Bm, Cm, Q, 3)[0]


def ssm_chunk_states(xh, a_log, dt, Bm, Cm, *, chunk=128):
    """The state entering each chunk, h_in: (B, H, S / chunk, dh, N)
    float32, as the card's first two passes leave it (a CUDA tensor: summed
    in float32, stored in xh's dtype) or as `ssm_scan_passes_torch`
    computes it (a CPU tensor). For checking the passes on the card; the
    model path does not call it."""
    refuse_autograd("ssm_chunk_states", xh, a_log, dt, Bm, Cm)
    _check(xh, a_log, dt, Bm, Cm)
    Q = _chunk(xh.shape[1], chunk)
    if _device(xh) == "cpu":
        return ssm_scan_passes_torch(xh, a_log, dt, Bm, Cm, chunk=Q)[1]
    return _launch(xh, a_log, dt, Bm, Cm, Q, 2)[1].float()
