"""Fused dequantize + weighted FedAvg reduce (DESIGN.md §12) on the card.

    out[n] = sum_c (s[c] * w[c]) * float(q[c, n])

The QSGD wire format is one int8 (C, N) matrix plus one float32 scale per
client; folding `scale * weight` into the reduction reads the int8 matrix
once, a quarter of the bytes of decode-then-`fedavg_agg`. The kernel is
`csrc/dequant_agg.cu`, a hand-written CUDA C++ kernel for Hopper (sm_90a)
that replaces the TPU kernel `repro/kernels/comm_agg.py::
_dequant_agg_kernel`. It splits the rows over up to 8 warps (one for
every 8 rows) and adds their partial sums in one fixed order, so it
agrees with the plain version to float32 reassociation (1e-6 of
sum_c |s_c w_c q[c, n]|) and repeats bit for bit. `dequant_agg` is its wrapper: a CUDA tensor
launches the kernel (or the wrapper raises), a CPU tensor takes the plain
PyTorch version `dequant_agg_torch`. There is no fallback from the card
to the plain version.

As in the reference, the round driver does not call it: codec runs
decode (`Codec.scan_encode_decode`) and aggregate through `fedavg_agg`.
Its callers are `ops.dequant_aggregate`, the tests and chip_smoke.py.

`launches` counts kernel launches in this process; it moves only where
the kernel is launched.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

launches = 0

MAX_CLIENTS = 48 * 1024 // 4       # the first port's envelope (s*w in 48 KB)


def dequant_agg_torch(values: torch.Tensor, scales: torch.Tensor,
                      weights: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version (`dequant_agg_jnp` of the reference): the
    scale x weight product folded first, then a float32 weighted sum."""
    sw = scales.float() * weights.float()
    return (values.float() * sw[:, None]).sum(0)


def _check(values, scales, weights) -> None:
    if values.dim() != 2:
        raise ValueError(f"values must be (C, N), got shape "
                         f"{tuple(values.shape)}")
    C, N = values.shape
    if C < 1 or N < 1 or C > MAX_CLIENTS:
        raise ValueError(f"values shape {tuple(values.shape)} outside "
                         f"1 <= C <= {MAX_CLIENTS}, N >= 1")
    if values.dtype != torch.int8:
        raise TypeError(f"values must be int8, got {values.dtype}")
    for name, t in (("scales", scales), ("weights", weights)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if tuple(t.shape) != (C,):
            raise ValueError(f"{name} shape {tuple(t.shape)} != ({C},)")
        if t.device != values.device:
            raise ValueError(f"values on {values.device} but {name} on "
                             f"{t.device}")
    if not (values.is_contiguous() and scales.is_contiguous()
            and weights.is_contiguous()):
        raise ValueError("values, scales and weights must be contiguous")


def _bind():
    fn = build.load("dequant_agg").dequant_agg
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def dequant_agg(values: torch.Tensor, scales: torch.Tensor,
                weights: torch.Tensor) -> torch.Tensor:
    """values: (C, N) int8, scales and weights: (C,) float32, all
    contiguous and on one device. Returns the (N,) float32 aggregate."""
    global launches
    _check(values, scales, weights)
    if values.device.type == "cpu":
        return dequant_agg_torch(values, scales, weights)
    if values.device.type != "cuda":
        raise ValueError(f"unsupported device {values.device}")
    C, N = values.shape
    out = torch.empty((N,), dtype=torch.float32, device=values.device)
    stream = torch.cuda.current_stream(values.device).cuda_stream
    err = _bind()(values.data_ptr(), scales.data_ptr(), weights.data_ptr(),
                  out.data_ptr(), C, N, stream)
    if err != 0:
        raise RuntimeError(f"dequant_agg launch failed: cudaError {err} "
                           f"(C={C}, N={N})")
    launches += 1
    return out
