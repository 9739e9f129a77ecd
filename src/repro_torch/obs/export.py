"""The result-document `telemetry` block (schema v2.3, DESIGN.md §6),
copied from the reference's `repro.obs.export.result_block` so the
port's results carry the same block, dispatch deltas included."""
from __future__ import annotations

from typing import Any, Dict, Optional

from repro_torch.obs.telemetry import Telemetry


def peak_rss_mb() -> float:
    """Peak RSS of this process in MiB (ru_maxrss is KiB on Linux —
    a monotone high-water mark, not current usage)."""
    import resource
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0


def result_block(tel: Optional[Telemetry]) -> Dict[str, Any]:
    """The `telemetry` block of result-JSON schema v2.3 (DESIGN.md §6):
    per-phase totals, run-level spans, the fused per-phase proxy (when
    one ran), counter totals, per-round series, dispatch-counter deltas,
    and peak RSS."""
    if tel is None or not tel.enabled:
        return {"enabled": False}
    proxy = tel.summary("proxy")
    return {
        "enabled": True,
        "phases": tel.summary("phase"),
        "run": tel.summary("run"),
        "fused_phase_proxy": proxy or None,
        "counters": {k: float(v) for k, v in sorted(tel.counters.items())},
        "series": {k: list(v) for k, v in sorted(tel.series.items())},
        "dispatch": tel.dispatch_delta(),
        "peak_rss_mb": peak_rss_mb(),
    }
