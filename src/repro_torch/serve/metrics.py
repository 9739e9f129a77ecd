"""Serving metrics: the result-JSON schema v2.4 `serving` block.

Everything here is computed from the MicroBatcher/ModelBuffer ledgers —
virtual-clock quantities, deterministic in (trace, config), identical
across the three training engines and across devices. Wall-clock
serving throughput is not part of the result document: result
documents are compared across machines and packages.
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np

from repro_torch.serve.batcher import MicroBatcher
from repro_torch.serve.hotswap import ModelBuffer


def percentile(sorted_xs: np.ndarray, q: float) -> float:
    """Nearest-rank percentile (deterministic, no interpolation — the
    convention load reports use: p99 is an OBSERVED latency)."""
    n = len(sorted_xs)
    if n == 0:
        return 0.0
    idx = max(0, min(n - 1, int(math.ceil(q / 100.0 * n)) - 1))
    return float(sorted_xs[idx])


def staleness_block(batcher: MicroBatcher, buffer: ModelBuffer) -> Dict:
    """Served-model staleness per COMPLETED request: versions published
    by the request's completion time minus the version it was served
    from (hotswap.py semantics). The histogram is keyed by the integer
    staleness as a string (JSON round-trip safe)."""
    stale = np.asarray(
        [buffer.latest_version_at(t) - v
         for t, v in zip(batcher.done_finish, batcher.done_version)],
        np.int64)
    hist: Dict[str, int] = {}
    for s in stale:
        hist[str(int(s))] = hist.get(str(int(s)), 0) + 1
    return {
        "mean": float(stale.mean()) if len(stale) else 0.0,
        "max": int(stale.max()) if len(stale) else 0,
        "hist": hist,
    }


def serving_block(batcher: MicroBatcher, buffer: ModelBuffer, *,
                  horizon: float, arrival: str, qps_target: float,
                  round_duration: float) -> Dict:
    """Assemble the schema-v2.4 `serving` block. Latencies are reported
    in milliseconds of VIRTUAL time (arrival -> completion, queueing +
    service under the affine service-time model)."""
    n_total = len(batcher.times)
    n_done = len(batcher.done_rid)
    n_shed = len(batcher.shed_rid)
    lat = (np.asarray(batcher.done_finish)
           - np.asarray(batcher.done_arrive)) * 1e3
    lat_sorted = np.sort(lat)
    occ = np.asarray(batcher.batch_sizes, np.float64)
    block = {
        "requests": int(n_total),
        "completed": int(n_done),
        "shed": int(n_shed),
        "shed_rate": float(n_shed / n_total) if n_total else 0.0,
        "qps_offered": float(n_total / horizon),
        "qps": float(n_done / horizon),
        "latency_ms": {
            "mean": float(lat.mean()) if n_done else 0.0,
            "p50": percentile(lat_sorted, 50.0),
            "p95": percentile(lat_sorted, 95.0),
            "p99": percentile(lat_sorted, 99.0),
            "max": float(lat_sorted[-1]) if n_done else 0.0,
        },
        "batches": len(batcher.batch_sizes),
        "batch_occupancy": (float(occ.mean() / batcher.max_batch)
                            if len(occ) else 0.0),
        "swap_count": int(buffer.swap_count),
        "staleness": staleness_block(batcher, buffer),
        "arrival": arrival,
        "qps_target": float(qps_target),
        "round_duration_s": float(round_duration),
        "horizon_s": float(horizon),
    }
    if batcher.done_correct:
        block["served_accuracy"] = float(np.mean(batcher.done_correct))
    else:
        block["served_accuracy"] = None
    return block
