"""Blockwise online-softmax (flash) attention on the card.

    out[b, s, h] = softmax_t(q[b, s, h] . k[b, t, h // G] / sqrt(d)
                             + mask[s, t]) @ v[b, :, h // G]

with G = H / Hk query heads per key/value head (grouped-query attention),
a causal mask (t <= s) and an optional sliding window (t > s - window).

The kernels are in `csrc/flash_attention.cu`, hand-written CUDA C++ for
Hopper (sm_90a) that replaces the TPU kernel
`repro/kernels/flash_attention.py::_flash_kernel`, both on the tensor
cores: for bfloat16 wgmma products fed by TMA (any head dim d % 8 == 0 up
to 256), for float32 mma.sync products in 3xTF32, three TF32 products
that keep about float32's precision (head dims in HEAD_DIMS); the source
notes say what bounds each and how the design answers. Both read the
(B, S, H, d) layout of the attention layer directly and index the
key/value head h // G themselves, where the reference folds heads into the
batch and repeats the key/value heads. `flash_attention` is their
wrapper: a CUDA tensor launches a kernel (or the wrapper raises, before
any launch, on a shape outside the kernel's envelope), a CPU tensor of
any shape takes the plain PyTorch version `flash_attention_torch`, a twin
of the reference's oracle `repro/kernels/ref.py::flash_attention_ref`.
There is no fallback from the card to the plain version.

The kernel has no backward pass, as the reference's Pallas call has no
`custom_vjp` (`jax.grad` through it raises): `flash_attention` raises on
every device when grad mode is on and an input requires grad, so a
training step never reaches it. The plain version stays differentiable.

`launches` counts kernel launches in this process; it moves only where
the kernel is launched.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build

launches = 0

NEG_INF = -2.0e38            # the oracle's mask value (ref.py)
TILE = 64                    # S and T are multiples of this on the card
HEAD_DIMS = (32, 64, 96, 128, 256)     # the float32 kernel's head dims
MAX_HEAD_DIM_BF16 = 256      # the bfloat16 kernel: d % 8 == 0, d <= 256
_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}


def flash_attention_torch(q, k, v, *, causal=True, window=0):
    """Plain PyTorch version: a masked softmax in float32, output in q's
    dtype. q: (B, S, H, d); k, v: (B, T, Hk, d) with H % Hk == 0."""
    B, S, H, d = q.shape
    T, Hk = k.shape[1], k.shape[2]
    G = H // Hk
    scale = 1.0 / math.sqrt(d)
    qg = q.float().reshape(B, S, Hk, G, d)
    logits = torch.einsum("bskgd,btkd->bkgst", qg, k.float()) * scale
    qpos = torch.arange(S, device=q.device)[:, None]
    kpos = torch.arange(T, device=q.device)[None, :]
    ok = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        ok = ok & (kpos <= qpos)
    if window and window > 0:
        ok = ok & (kpos > qpos - window)
    neg = torch.full((), NEG_INF, device=q.device)
    logits = torch.where(ok, logits, neg)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", w, v.float())
    return out.reshape(B, S, H, d).to(q.dtype)


def _check(q, k, v, window):
    """What every device takes: the plain version's contract."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"q, k, v must be (B, S, H, d), (B, T, Hk, d); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, _, H, d = q.shape
    if tuple(k.shape) != tuple(v.shape):
        raise ValueError(f"k shape {tuple(k.shape)} != v shape "
                         f"{tuple(v.shape)}")
    Bk, _, Hk, dk = k.shape
    if Bk != B or dk != d:
        raise ValueError(f"k shape {tuple(k.shape)} does not fit q shape "
                         f"{tuple(q.shape)}")
    if Hk < 1 or H % Hk:
        raise ValueError(f"{H} query heads are not a multiple of {Hk} "
                         f"key/value heads")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must all be float32 or bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q on {q.device}, k on {k.device}, v on "
                         f"{v.device}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k and v must be contiguous")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")


def _check_kernel(q, k):
    """The CUDA kernel's envelope, checked before any launch: S and T
    positive multiples of 64; bfloat16 (tensor cores) any d % 8 == 0 up to
    256 and ceil(S / 128) query tiles on the grid's y axis, float32
    (3xTF32) d in HEAD_DIMS and B * H on the grid's y axis."""
    B, S, H, d = q.shape
    T = k.shape[1]
    if B < 1 or S < TILE or T < TILE or S % TILE or T % TILE:
        raise ValueError(f"the CUDA kernel takes S and T positive multiples "
                         f"of {TILE}, got S = {S}, T = {T}")
    if q.dtype == torch.bfloat16:
        if d < 8 or d % 8 or d > MAX_HEAD_DIM_BF16:
            raise ValueError(f"the bfloat16 CUDA kernel takes head dims "
                             f"d % 8 == 0, 8 <= d <= {MAX_HEAD_DIM_BF16}, "
                             f"got {d}")
        if B * H > 2**31 - 1 or -(-S // 128) > 65535:
            raise ValueError(f"the bfloat16 CUDA kernel takes B * H <= "
                             f"2^31 - 1 and S <= 128 * 65535, got B * H = "
                             f"{B * H}, S = {S}")
    else:
        if d not in HEAD_DIMS:
            raise ValueError(f"the float32 CUDA kernel takes head dims "
                             f"{HEAD_DIMS}, got {d}")
        if B * H > 65535:
            raise ValueError(f"the float32 CUDA kernel takes B * H <= "
                             f"65535, got {B * H}")


def refuse_autograd(name, *tensors):
    """Raise when a backward pass could run through a kernel that has
    none: grad mode on and any of `tensors` requiring grad."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} has no backward pass (nor has the reference's Pallas "
            f"kernel): run it under torch.no_grad(), or train through the "
            f"plain path (attn_impl='einsum' or 'chunked'; "
            f"mamba2_forward(use_kernel=False))")


def _bind():
    fn = build.load("flash_attention").flash_attention
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def flash_attention(q, k, v, *, causal=True, window=0):
    """q: (B, S, H, d); k, v: (B, T, Hk, d), all float32 or all bfloat16,
    contiguous, on one device. Returns (B, S, H, d) in q's dtype. A CPU
    tensor takes any shape; a CUDA tensor must fit `_check_kernel`."""
    global launches
    refuse_autograd("flash_attention", q, k, v)
    window = int(window or 0)
    _check(q, k, v, window)
    if q.device.type == "cpu":
        return flash_attention_torch(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _check_kernel(q, k)
    B, S, H, d = q.shape
    T, Hk = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _bind()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  B, S, T, H, Hk, d, int(bool(causal)), window,
                  1.0 / math.sqrt(d), 0 if q.dtype == torch.float32 else 1,
                  stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: cudaError {err} "
                           f"(B={B}, S={S}, T={T}, H={H}, Hk={Hk}, d={d}, "
                           f"dtype={q.dtype})")
    launches += 1
    return out
