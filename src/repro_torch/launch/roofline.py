"""Roofline terms and model FLOPs for one NVIDIA H100 SXM (port of
`repro.launch.roofline`: `Roofline`, `model_flops_per_step`,
`active_param_count`).

Three terms per step, in seconds, from the H100 SXM data sheet:

    compute    = FLOPs / 989 TFLOP/s   (dense bfloat16 on the tensor cores)
    memory     = bytes / 3.35 TB/s     (HBM3)
    collective = link bytes / 450 GB/s (NVLink 4: 900 GB/s both ways,
                                        450 GB/s each way)

MFU is model FLOPs (6 N_active D for a training step) over the step
time and `PEAK_FLOPS`. The reference's `analyze` and
`parse_collective_bytes` read an XLA executable and its HLO text; their
counterpart on the mesh, reading the bytes that `launch.mesh`'s
collective helpers count on each rank, is ROADMAP §A.16b.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

PEAK_FLOPS = 989e12          # dense bf16 / card (H100 SXM data sheet)
HBM_BW = 3.35e12             # bytes/s / card, HBM3 (H100 SXM data sheet)
LINK_BW = 450e9              # bytes/s / card each way, NVLink 4


@dataclasses.dataclass
class Roofline:
    flops_per_device: float
    bytes_per_device: float
    collective_bytes_per_device: float
    collective_count: int
    chips: int
    peak_memory_per_device: Optional[float] = None

    @property
    def compute_s(self) -> float:
        return self.flops_per_device / PEAK_FLOPS

    @property
    def memory_s(self) -> float:
        return self.bytes_per_device / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.collective_bytes_per_device / LINK_BW

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    def to_dict(self) -> dict:
        return {
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "collective_bytes_per_device": self.collective_bytes_per_device,
            "collective_count": self.collective_count,
            "chips": self.chips,
            "peak_memory_per_device": self.peak_memory_per_device,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
        }


def model_flops_per_step(cfg, tokens: int, active_params: int) -> float:
    """MODEL_FLOPS = 6 * N(_active) * D tokens (a training step, forward
    and backward)."""
    return 6.0 * active_params * tokens


def active_param_count(cfg, params_total: int) -> int:
    """MoE: only the top_k (+ shared) experts are active per token."""
    if not cfg.moe:
        return params_total
    # expert params: E * (3 * d * f) per layer
    expert = cfg.num_layers * cfg.num_experts * 3 * cfg.d_model * cfg.d_ff
    active_expert = (cfg.num_layers
                     * (cfg.top_k + cfg.num_shared_experts)
                     * 3 * cfg.d_model * cfg.d_ff)
    return params_total - expert + active_expert


def mfu(step_s: float, model_flops: float) -> float:
    """The card's share of its bf16 peak spent on model FLOPs."""
    return model_flops / (step_s * PEAK_FLOPS)
