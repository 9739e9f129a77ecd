"""Masked gossip mixing (DESIGN.md §15) on the card.

    out[c, n] = sum_j mix[c, j] * x[j, n]

One synchronous gossip exchange under dynamic membership: the (C, C)
row-stochastic mixing matrix changes every round (dead rows identity,
heartbeat-decayed supports, the moving-target ring), applied to the
(C, N) client-stacked parameter matrix. The kernel is
`csrc/gossip_mix.cu`, a hand-written CUDA C++ kernel for Hopper (sm_90a)
that replaces the TPU kernel `repro/kernels/gossip_mix.py::_gossip_kernel`:
a product in float32 fused multiply-adds, never TF32, so it holds to a
float32 matmul. Up to 32 clients its row tile is sized to C (8 or 32
rows) and each thread's loads are 16 bytes wide and all in flight before
the first multiply-add; above 32 it tiles 32 x 64 outputs. Every output is
one chain of multiply-adds over j = 0 .. C - 1 in both, so the bits do not
depend on C's path. `gossip_mix_agg` is its wrapper: a CUDA tensor
launches the kernel (or the wrapper raises), a CPU tensor takes the plain
PyTorch version `gossip_mix_torch`. There is no fallback from the card
to the plain version.

`launches` counts kernel launches in this process; it moves only where
the kernel is launched.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

launches = 0

_DTYPES = {torch.float32: "gossip_mix_f32", torch.bfloat16: "gossip_mix_bf16"}
MAX_CLIENTS = 1024                 # csrc/gossip_mix.cu refuses more


def gossip_mix_torch(x: torch.Tensor, mix: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version (`gossip_mix_jnp` of the reference): f32
    product, output in x's dtype."""
    return (mix.float() @ x.float()).to(x.dtype)


def _check(x: torch.Tensor, mix: torch.Tensor) -> None:
    if x.dim() != 2:
        raise ValueError(f"x must be (C, N), got shape {tuple(x.shape)}")
    C, N = x.shape
    if C < 1 or N < 1 or C > MAX_CLIENTS:
        raise ValueError(f"x shape {tuple(x.shape)} outside 1 <= C <= "
                         f"{MAX_CLIENTS}, N >= 1")
    if x.dtype not in _DTYPES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if mix.dtype != torch.float32:
        raise TypeError(f"mix must be float32, got {mix.dtype}")
    if tuple(mix.shape) != (C, C):
        raise ValueError(f"mix shape {tuple(mix.shape)} != ({C}, {C})")
    if x.device != mix.device:
        raise ValueError(f"x on {x.device} but mix on {mix.device}")
    if not (x.is_contiguous() and mix.is_contiguous()):
        raise ValueError("x and mix must be contiguous")


def _bind(name: str):
    fn = getattr(build.load("gossip_mix"), name)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int64, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def gossip_mix_agg(x: torch.Tensor, mix: torch.Tensor) -> torch.Tensor:
    """x: (C, N) float32 or bfloat16, mix: (C, C) float32, both contiguous
    and on one device, 1 <= C <= MAX_CLIENTS. Returns the (C, N) mixed
    stack in x's dtype."""
    global launches
    _check(x, mix)
    if x.device.type == "cpu":
        return gossip_mix_torch(x, mix)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    C, N = x.shape
    out = torch.empty((C, N), dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _bind(_DTYPES[x.dtype])(x.data_ptr(), mix.data_ptr(),
                                  out.data_ptr(), C, N, stream)
    if err != 0:
        raise RuntimeError(f"gossip_mix_agg launch failed: cudaError {err} "
                           f"(C={C}, N={N}, dtype={x.dtype})")
    launches += 1
    return out
