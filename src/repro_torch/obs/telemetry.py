"""Host-side tracer: the span/counter half of the telemetry subsystem
(DESIGN.md §13).

Zero-dep by design (stdlib `time` + `threading` only): this module is
imported by the kernel wrappers and the engine, so it must never pull
jax/numpy — the import edge points strictly outward from here.

Two layers:

* module-level DISPATCH COUNTERS (`count` / `dispatch_snapshot`) —
  process-wide tallies of host-level program dispatches / trace entries
  (kernel wrappers, engine train dispatch). A `Telemetry` instance
  snapshots them at construction so `dispatch_delta` attributes counts
  to one run even when several simulations share the process.
* per-run `Telemetry` — spans (monotonic perf_counter_ns clock),
  counters, and per-round series, recorded under a lock (the async tick
  loop and any plugin thread may record concurrently). `span(...)` is a
  context manager; when telemetry is disabled or suppressed it returns
  a shared no-op object, so the off path costs one attribute check.

Span CATEGORIES partition the trace into tracks (DESIGN.md §13):
  "phase" — the steady per-event lifecycle phases the driver wraps
            (select / local_train / corrupt / encode_decode /
            aggregate / eval / sequential_round).
  "run"   — run-level structure (warmup / round / precompute /
            fused_scan / fused_phase_proxy / classify).
  "proxy" — the fused executor's per-phase timing proxy: one
            instrumented per-round event at warmup where every phase
            BLOCKS on its device work (`sync_active`), so span
            durations are device time, not dispatch time. Entered via
            `category("proxy")`, which re-tags every span recorded
            under it (counters/series are muted there — the proxy is a
            measurement pass, not run work).

Steady-state spans deliberately do NOT block on device work: under
jax's async dispatch they measure host-side dispatch windows, which is
what keeps telemetry inside the ≤5% overhead budget — device-time
attribution is the proxy's job (fused) or the XLA profiler's
(`obs.export.profiler_trace`).
"""
from __future__ import annotations

import contextlib
import threading
import time
from typing import Any, Dict, List, Optional, Sequence

# -- module-level dispatch counters -----------------------------------------

_DISPATCH: Dict[str, int] = {}
_DISPATCH_LOCK = threading.Lock()


def count(name: str, n: int = 1) -> None:
    """Bump a process-wide dispatch tally (kernel wrappers / engine
    dispatch sites). Called at host level, so inside a traced program it
    counts TRACE entries, not device executions — the semantics are
    'how many times the host entered this dispatch path'."""
    with _DISPATCH_LOCK:
        _DISPATCH[name] = _DISPATCH.get(name, 0) + n


def dispatch_snapshot() -> Dict[str, int]:
    with _DISPATCH_LOCK:
        return dict(_DISPATCH)


# -- spans -------------------------------------------------------------------

class _NullSpan:
    """Shared no-op span: the disabled/suppressed fast path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("_tel", "_name", "_cat", "_args", "_t0")

    def __init__(self, tel: "Telemetry", name: str, cat: str,
                 args: Dict[str, Any]):
        self._tel, self._name, self._cat, self._args = tel, name, cat, args

    def __enter__(self):
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        tel = self._tel
        with tel._lock:
            tel.spans.append({
                "name": self._name, "cat": self._cat,
                "ts_us": (self._t0 - tel._t0) / 1e3,
                "dur_us": (t1 - self._t0) / 1e3,
                "args": self._args,
            })
        return False


class Telemetry:
    """One run's trace: spans + counters + per-round series."""

    def __init__(self, enabled: bool = True):
        self.enabled = bool(enabled)
        self.spans: List[Dict[str, Any]] = []
        self.counters: Dict[str, float] = {}
        self.series: Dict[str, List[float]] = {}
        self._lock = threading.Lock()
        self._suppress = 0
        self._cat: Optional[str] = None      # category() override
        self._t0 = time.perf_counter_ns()
        self._dispatch0 = dispatch_snapshot()

    # -- recording ----------------------------------------------------------
    @property
    def active(self) -> bool:
        return self.enabled and not self._suppress

    @property
    def sync_active(self) -> bool:
        """True when phase boundaries should BLOCK on device work (the
        fused per-phase proxy — see `FederatedSimulation.tel_sync`)."""
        return self.enabled and self._cat == "proxy"

    def span(self, name: str, cat: Optional[str] = None, **args):
        """Context manager recording one timed span. `cat` defaults to
        "phase"; an active `category(...)` override wins over it."""
        if not self.enabled or self._suppress:
            return _NULL_SPAN
        return _Span(self, name,
                     self._cat if self._cat is not None else (cat or "phase"),
                     args)

    def counter(self, name: str, value: float = 1.0) -> None:
        """Accumulate into a named run-total counter."""
        if not self.enabled or self._suppress or self._cat is not None:
            return
        with self._lock:
            self.counters[name] = self.counters.get(name, 0.0) + float(value)

    def append_series(self, name: str, value: float) -> None:
        """Append one per-round value to a named series."""
        if not self.enabled or self._suppress or self._cat is not None:
            return
        with self._lock:
            self.series.setdefault(name, []).append(float(value))

    def record_series(self, name: str, values: Sequence[float]) -> None:
        """Record a whole per-round series at once (the fused executor's
        end-of-run transfer of in-scan counters)."""
        if not self.enabled:
            return
        with self._lock:
            self.series[name] = [float(v) for v in values]

    # -- scoping ------------------------------------------------------------
    @contextlib.contextmanager
    def suppress(self):
        """Mute span/counter recording (warmup dry-runs the lifecycle to
        compile it; compile time must not pollute the phase totals)."""
        self._suppress += 1
        try:
            yield self
        finally:
            self._suppress -= 1

    @contextlib.contextmanager
    def category(self, cat: str):
        """Force every span recorded inside onto category `cat` and mute
        counters/series (the fused per-phase proxy re-tags the whole
        lifecycle as "proxy" spans)."""
        prev, self._cat = self._cat, cat
        try:
            yield self
        finally:
            self._cat = prev

    # -- summaries -----------------------------------------------------------
    def summary(self, cat: str = "phase") -> Dict[str, Dict[str, float]]:
        """{span name: {count, total_s, mean_s}} over one category."""
        with self._lock:
            spans = list(self.spans)
        out: Dict[str, Dict[str, float]] = {}
        for s in spans:
            if s["cat"] != cat:
                continue
            e = out.setdefault(s["name"], {"count": 0, "total_s": 0.0})
            e["count"] += 1
            e["total_s"] += s["dur_us"] / 1e6
        for e in out.values():
            e["mean_s"] = e["total_s"] / e["count"]
        return out

    def dispatch_delta(self) -> Dict[str, int]:
        """Dispatch-counter deltas since this Telemetry was constructed
        (only non-zero entries)."""
        now = dispatch_snapshot()
        delta = {k: v - self._dispatch0.get(k, 0) for k, v in now.items()}
        return {k: v for k, v in delta.items() if v}
