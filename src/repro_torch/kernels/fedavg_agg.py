"""Fused FedAvg parameter aggregation (paper Eq. 5) on the card.

    out[n] = sum_c w[c] * x[c, n]

The kernel is `csrc/fedavg_agg.cu`, a hand-written CUDA C++ kernel for
Hopper (sm_90a) that replaces the TPU kernel
`repro/kernels/fedavg_agg.py::_fedavg_kernel`; its source notes say what
bounds it and how the design answers. `fedavg_agg` is its wrapper: a CUDA
tensor launches the kernel (or the wrapper raises), a CPU tensor takes
the plain PyTorch version `fedavg_agg_torch`. There is no fallback from
the card to the plain version.

`launches` counts kernel launches in this process; it moves only where
the kernel is launched.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

launches = 0

_DTYPES = {torch.float32: "fedavg_agg_f32", torch.bfloat16: "fedavg_agg_bf16"}
_MAX_CLIENTS = 48 * 1024 // 4       # weights staged in 48 KB of shared memory


def fedavg_agg_torch(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: f32 accumulate, output in x's dtype."""
    return (w[:, None].float() * x.float()).sum(0).to(x.dtype)


def _check(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.dim() != 2:
        raise ValueError(f"x must be (C, N), got shape {tuple(x.shape)}")
    C, N = x.shape
    if C < 1 or N < 1 or C > _MAX_CLIENTS:
        raise ValueError(f"x shape {tuple(x.shape)} outside 1 <= C <= "
                         f"{_MAX_CLIENTS}, N >= 1")
    if x.dtype not in _DTYPES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if w.dtype != torch.float32:
        raise TypeError(f"w must be float32, got {w.dtype}")
    if tuple(w.shape) != (C,):
        raise ValueError(f"w shape {tuple(w.shape)} != ({C},)")
    if x.device != w.device:
        raise ValueError(f"x on {x.device} but w on {w.device}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("x and w must be contiguous")


def _bind(name: str):
    fn = getattr(build.load("fedavg_agg"), name)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int64, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def fedavg_agg(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (C, N) float32 or bfloat16, w: (C,) float32, both contiguous
    and on one device. Returns the (N,) weighted sum in x's dtype."""
    global launches
    _check(x, w)
    if x.device.type == "cpu":
        return fedavg_agg_torch(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    C, N = x.shape
    out = torch.empty((N,), dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _bind(_DTYPES[x.dtype])(x.data_ptr(), w.data_ptr(),
                                  out.data_ptr(), C, N, stream)
    if err != 0:
        raise RuntimeError(f"fedavg_agg launch failed: cudaError {err} "
                           f"(C={C}, N={N}, dtype={x.dtype})")
    launches += 1
    return out
