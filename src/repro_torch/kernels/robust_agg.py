"""Coordinate-wise trimmed mean and median (Byzantine-robust aggregation)
on the card.

    out[n] = mean of the order statistics of rank trim..C-trim-1 of x[:, n]

`trim = 0` is the plain mean; `trim = (C-1)//2` is the median for odd
and even C (one or two middle values kept). The kernel is
`csrc/trimmed_mean_agg.cu`, a hand-written CUDA C++ kernel for Hopper
(sm_90a) that replaces the TPU kernel
`repro/kernels/robust_agg.py::_trimmed_kernel`: a bitonic sorting
network per column, in registers up to 64 clients and in shared memory
above. `trimmed_mean_agg` is its wrapper:
a CUDA tensor launches the kernel (or the wrapper raises), a CPU tensor
takes the plain PyTorch version `trimmed_mean_torch`. There is no
fallback from the card to the plain version.

A column that holds a NaN comes back NaN under both versions, as under
the TPU kernel and its CPU network (their min/max spreads a NaN to every
rank); a sort-based mean would sort the NaN last and drop it. ±inf are
ordinary values. `torch.median` is not used: it returns the lower middle
value for even C, where the median here averages the two. Both versions
add the kept order statistics in ascending order as one float32 chain
per column, so they give the same bits for the same sorted values.

`launches` counts kernel launches in this process; it moves only where
the kernel is launched.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

launches = 0

_DTYPES = {torch.float32: "trimmed_mean_agg_f32",
           torch.bfloat16: "trimmed_mean_agg_bf16"}
# csrc/trimmed_mean_agg.cu: a column padded to Cp = 1024 rows fills 128 KB
# of shared memory for a 32-thread block
MAX_CLIENTS = 1024


def _check_trim(C: int, trim: int) -> None:
    if not 0 <= 2 * trim < C:
        raise ValueError(f"trim={trim} invalid for C={C} clients "
                         f"(need 0 <= 2*trim < C)")


def trimmed_mean_torch(x: torch.Tensor, trim: int) -> torch.Tensor:
    """Plain PyTorch version: sort each column in f32, add rows
    trim..C-trim-1 in ascending order as one chain and divide by their
    count, NaN for a column that holds a NaN, output in x's dtype."""
    C = x.shape[0]
    _check_trim(C, trim)
    x32 = x.float()
    kept = torch.sort(x32, dim=0).values[trim:C - trim]
    acc = torch.zeros_like(kept[0])
    for row in kept:         # the kernel's order (torch.sum reassociates)
        acc = acc + row
    out = acc / (C - 2 * trim)
    out = torch.where(torch.isnan(x32).any(0),
                      torch.full_like(out, float("nan")), out)
    return out.to(x.dtype)


def _check(x: torch.Tensor, trim: int) -> None:
    if x.dim() != 2:
        raise ValueError(f"x must be (C, N), got shape {tuple(x.shape)}")
    C, N = x.shape
    if C < 1 or N < 1 or C > MAX_CLIENTS:
        raise ValueError(f"x shape {tuple(x.shape)} outside 1 <= C <= "
                         f"{MAX_CLIENTS}, N >= 1")
    if x.dtype not in _DTYPES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    _check_trim(C, trim)


def _bind(name: str):
    fn = getattr(build.load("trimmed_mean_agg"), name)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def trimmed_mean_agg(x: torch.Tensor, trim: int) -> torch.Tensor:
    """x: (C, N) float32 or bfloat16, contiguous, 1 <= C <= MAX_CLIENTS;
    0 <= 2*trim < C. Returns the (N,) trimmed mean in x's dtype."""
    global launches
    _check(x, trim)
    if x.device.type == "cpu":
        return trimmed_mean_torch(x, trim)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    C, N = x.shape
    out = torch.empty((N,), dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _bind(_DTYPES[x.dtype])(x.data_ptr(), out.data_ptr(), C, N,
                                  trim, C - trim, stream)
    if err != 0:
        raise RuntimeError(f"trimmed_mean_agg launch failed: cudaError "
                           f"{err} (C={C}, N={N}, trim={trim}, "
                           f"dtype={x.dtype})")
    launches += 1
    return out


def median_agg(x: torch.Tensor) -> torch.Tensor:
    """Coordinate-wise median: the maximal trim (C-1)//2."""
    return trimmed_mean_agg(x, (x.shape[0] - 1) // 2)
