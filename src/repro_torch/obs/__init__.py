"""Telemetry (DESIGN.md §13): host-side lifecycle spans and dispatch
counters (`obs.telemetry`), the fused executor's per-round counters and
per-phase proxy (`obs.collectors`), and the exporters — Chrome-trace
JSON, the result-document block and the `torch.profiler` wrapper
(`obs.export`)."""
from repro_torch.obs.telemetry import Telemetry, count, dispatch_snapshot
from repro_torch.obs.export import (chrome_trace, peak_rss_mb,
                                    profiler_trace, result_block,
                                    validate_chrome_trace,
                                    write_chrome_trace)

__all__ = [
    "Telemetry", "chrome_trace", "count", "dispatch_snapshot",
    "peak_rss_mb", "profiler_trace", "result_block",
    "validate_chrome_trace", "write_chrome_trace",
]
