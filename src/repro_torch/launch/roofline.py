"""Roofline terms and model FLOPs for one NVIDIA H100 SXM (port of
`repro.launch.roofline`: `Roofline`, `model_flops_per_step`,
`active_param_count`).

Three terms per step, in seconds, from the H100 SXM data sheet:

    compute    = FLOPs / 989 TFLOP/s   (dense bfloat16 on the tensor cores)
    memory     = bytes / 3.35 TB/s     (HBM3)
    collective = link bytes / 450 GB/s (NVLink 4: 900 GB/s both ways,
                                        450 GB/s each way)

MFU is model FLOPs (6 N_active D for a training step) over the step
time and `PEAK_FLOPS`.

The reference's `analyze` and `parse_collective_bytes` read an XLA
executable's cost analysis and its HLO text. Here `collective_bytes`
reads the collectives that `core/collectives.py` counted on a rank (by
the reference's op kinds, with their result bytes) and weighs them as
the reference's parser does (an all-reduce twice: a ring moves about
twice the payload), and `analyze` takes the FLOPs, bytes and peak memory
that the dry-run measured (`launch/dryrun.py`). `LINK_BW` is applied to
every mesh axis alike, as the reference applies its one `ICI_BW`.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

PEAK_FLOPS = 989e12          # dense bf16 / card (H100 SXM data sheet)
HBM_BW = 3.35e12             # bytes/s / card, HBM3 (H100 SXM data sheet)
LINK_BW = 450e9              # bytes/s / card each way, NVLink 4


_WEIGHT = {"all-reduce": 2.0, "all-gather": 1.0, "reduce-scatter": 1.0,
           "all-to-all": 1.0, "collective-permute": 1.0}


def collective_bytes(counts) -> Dict[str, float]:
    """Per-kind link bytes (per device) from a rank's
    `collectives.collective_counts()`, with the keys of the reference's
    `parse_collective_bytes`: each kind, "count" and "total"."""
    out: Dict[str, float] = {
        k: counts.get("kind_bytes", {}).get(k, 0) * w
        for k, w in _WEIGHT.items()}
    out["count"] = sum(counts.get("kinds", {}).get(k, 0) for k in _WEIGHT)
    out["total"] = sum(out[k] for k in _WEIGHT)
    return out


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


def analyze(flops: float, nbytes: float, counts, chips: int,
            peak_memory: Optional[float] = None) -> Roofline:
    """The roofline of one device's program: its FLOPs, bytes and peak
    memory as measured, its collectives from the rank's counts."""
    coll = collective_bytes(counts)
    return Roofline(flops_per_device=float(flops),
                    bytes_per_device=float(nbytes),
                    collective_bytes_per_device=coll["total"],
                    collective_count=int(coll["count"]), chips=chips,
                    peak_memory_per_device=peak_memory)


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
