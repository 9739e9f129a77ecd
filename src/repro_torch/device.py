"""Device resolution, float32 precision switches and seeded generators.

Every entry point of the port takes a `device` argument that defaults to
"cuda". A CUDA request on a machine without a card raises: the port
never carries on, on the CPU, unless the caller asked for the CPU.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """`device` (str or torch.device) -> torch.device, raising
    RuntimeError when CUDA is requested but absent. "meta" (shapes, no
    storage) is the dry-run's device."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() "
            f"is False; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise RuntimeError(f"unsupported device {str(dev)!r}")
    return dev


def deterministic_f32() -> None:
    """Compute float32 convolutions and matmuls in full float32, with
    deterministic cuDNN algorithms.

    The reference computes the CNN in full f32; cuDNN convolutions
    default to TF32 on Hopper, which keeps ~3 decimal digits. cuDNN's
    default backward algorithms may sum with atomics, in an order that
    changes from run to run; over the study's 8 rounds that moved a test
    accuracy by 0.09 between two runs of one seed on the card, so the
    port picks deterministic algorithms: one seed, one result (DESIGN.md
    §4). These are process-wide switches."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False


def generator(seed: int) -> torch.Generator:
    """A CPU `torch.Generator` seeded with `seed`. Draws are made on the
    CPU and moved, so one seed gives the same tensors on every device."""
    g = torch.Generator(device="cpu")
    g.manual_seed(int(seed))
    return g
