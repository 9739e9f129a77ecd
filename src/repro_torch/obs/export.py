"""Telemetry exporters (DESIGN.md §13; port of `repro.obs.export`):
Chrome-trace JSON, the result-document `telemetry` block (schema v2.3),
peak-RSS sampling, and the opt-in `torch.profiler` wrapper.

Chrome trace format (the subset Perfetto / chrome://tracing consume):
an object `{"traceEvents": [...]}` whose events carry `ph` (phase
letter), `ts` (microseconds), `pid`/`tid`, and `name`. This module
emits:

  M (metadata)  — one `thread_name` per track, so each lifecycle phase
                  renders as its own named track.
  B/E (begin /  — one pair per recorded span, stack-disciplined per
  end)            track (the emitter clamps children into their parent
                  and closes spans in LIFO order, so `ts` is monotone
                  per tid and every B has a matching E — exactly what
                  `validate_chrome_trace` checks).
  s/t/f (flow)  — spans recorded with a `flow=<name>` arg are chained
                  into one flow (async tick-batch rounds arrow from
                  batch to batch; serving hot-swaps).
  C (counter)   — per-round series render as counter tracks, spread
                  across the span they were measured under (the fused
                  run) or the whole trace extent.

Track assignment: category "phase" spans get one track per phase name;
every other category gets one track per category ("run", "proxy",
"serve").
"""
from __future__ import annotations

import contextlib
import json
from typing import Any, Dict, List, Optional

from repro_torch.obs.telemetry import Telemetry

_PID = 1


def peak_rss_mb() -> float:
    """Peak RSS of this process in MiB (ru_maxrss is KiB on Linux —
    a monotone high-water mark, not current usage)."""
    import resource
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0


# -- chrome trace -------------------------------------------------------------

def _track_label(span: Dict[str, Any]) -> str:
    return span["name"] if span["cat"] == "phase" else span["cat"]


def chrome_trace(tel: Telemetry) -> Dict[str, Any]:
    """Build the Chrome-trace document for one run's telemetry."""
    with tel._lock:
        spans = list(tel.spans)
        series = {k: list(v) for k, v in tel.series.items()}

    tracks: Dict[str, int] = {}

    def tid_for(label: str) -> int:
        if label not in tracks:
            tracks[label] = len(tracks) + 1
        return tracks[label]

    per_tid: Dict[int, List[Dict[str, Any]]] = {}
    flows: Dict[str, List[Any]] = {}
    for s in spans:
        t = tid_for(_track_label(s))
        per_tid.setdefault(t, []).append(s)
        flow = s["args"].get("flow")
        if flow:
            flows.setdefault(str(flow), []).append((s["ts_us"], t))

    meta: List[Dict[str, Any]] = [
        {"name": "process_name", "ph": "M", "pid": _PID, "tid": 0,
         "args": {"name": "repro_torch.federated_run"}}]
    events: List[Dict[str, Any]] = []

    # B/E pairs, stack-disciplined per track: children are clamped into
    # their parent so LIFO closing keeps ts monotone per tid
    for t in sorted(per_tid):
        group = sorted(per_tid[t],
                       key=lambda s: (s["ts_us"], -s["dur_us"]))
        stack: List[Any] = []          # [(end_us, name), ...]

        def _pop(out, t=t):
            end, name = stack.pop()
            out.append({"name": name, "ph": "E", "pid": _PID, "tid": t,
                        "ts": end})

        out: List[Dict[str, Any]] = []
        for s in group:
            ts, end = s["ts_us"], s["ts_us"] + s["dur_us"]
            while stack and stack[-1][0] <= ts:
                _pop(out)
            if stack and end > stack[-1][0]:
                end = stack[-1][0]
            args = {k: v for k, v in s["args"].items() if k != "flow"}
            out.append({"name": s["name"], "cat": s["cat"], "ph": "B",
                        "pid": _PID, "tid": t, "ts": ts, "args": args})
            stack.append((end, s["name"]))
        while stack:
            _pop(out)
        events.extend(out)

    # flow chains (async rounds): s -> t ... t -> f, one id per flow
    for fid, (flow, pts) in enumerate(sorted(flows.items()), start=1):
        if len(pts) < 2:
            continue
        pts.sort()
        for j, (ts, t) in enumerate(pts):
            ph = "s" if j == 0 else ("f" if j == len(pts) - 1 else "t")
            ev = {"name": flow, "cat": "flow", "ph": ph, "id": fid,
                  "pid": _PID, "tid": t, "ts": ts}
            if ph == "f":
                ev["bp"] = "e"
            events.append(ev)

    # counter tracks: spread each series across the fused scan's span
    # (where the values were accumulated) or the whole trace extent
    if series:
        window = _series_window(spans)
        ctid = tid_for("counters")
        for name, vals in sorted(series.items()):
            if not vals:
                continue
            lo, hi = window
            step = (hi - lo) / len(vals)
            for i, v in enumerate(vals):
                events.append({"name": name, "ph": "C", "pid": _PID,
                               "tid": ctid, "ts": lo + (i + 0.5) * step,
                               "args": {"value": v}})

    for label, t in tracks.items():
        meta.append({"name": "thread_name", "ph": "M", "pid": _PID,
                     "tid": t, "args": {"name": label}})
    # one stable global sort by ts: per-tid generated order is already
    # non-decreasing, so sorting only interleaves tracks (and pulls the
    # flow/counter events into place) without breaking B/E stack order
    events.sort(key=lambda e: e["ts"])
    return {"traceEvents": meta + events, "displayTimeUnit": "ms"}


def _series_window(spans) -> Any:
    for s in spans:
        if s["name"] == "fused_scan":
            return (s["ts_us"], s["ts_us"] + s["dur_us"])
    if spans:
        return (min(s["ts_us"] for s in spans),
                max(s["ts_us"] + s["dur_us"] for s in spans))
    return (0.0, 1.0)


def write_chrome_trace(tel: Telemetry, path: str) -> str:
    """Serialize the run's trace to `path`; open it in Perfetto
    (ui.perfetto.dev) or chrome://tracing."""
    doc = chrome_trace(tel)
    with open(path, "w") as f:
        json.dump(doc, f)
    return path


def validate_chrome_trace(doc: Any) -> List[str]:
    """Check a (parsed) trace document against the Chrome-trace-format
    requirements the CI schema test enforces: an object with a
    traceEvents list, required keys per event, per-track non-decreasing
    `ts`, and matched B/E pairs in stack order. Returns a list of error
    strings — empty means valid."""
    errors: List[str] = []
    if not isinstance(doc, dict) or not isinstance(
            doc.get("traceEvents"), list):
        return ["trace must be a JSON object with a 'traceEvents' list"]
    stacks: Dict[Any, List[str]] = {}
    last_ts: Dict[Any, float] = {}
    for i, ev in enumerate(doc["traceEvents"]):
        if not isinstance(ev, dict) or "ph" not in ev:
            errors.append(f"event {i}: not an object with a 'ph' key")
            continue
        ph = ev["ph"]
        if ph == "M":
            if "name" not in ev or "args" not in ev:
                errors.append(f"event {i}: metadata needs name/args")
            continue
        for k in ("name", "ts", "pid", "tid"):
            if k not in ev:
                errors.append(f"event {i}: missing {k!r}")
        key = (ev.get("pid"), ev.get("tid"))
        ts = ev.get("ts")
        if isinstance(ts, (int, float)):
            if key in last_ts and ts < last_ts[key] - 1e-6:
                errors.append(
                    f"event {i}: ts {ts} goes backwards on tid "
                    f"{key[1]} (last {last_ts[key]})")
            last_ts[key] = max(last_ts.get(key, float(ts)), float(ts))
        if ph == "B":
            stacks.setdefault(key, []).append(ev.get("name"))
        elif ph == "E":
            stack = stacks.setdefault(key, [])
            if not stack:
                errors.append(
                    f"event {i}: E {ev.get('name')!r} with no open B "
                    f"on tid {key[1]}")
            elif stack[-1] != ev.get("name"):
                errors.append(
                    f"event {i}: E {ev.get('name')!r} does not match "
                    f"the open B {stack[-1]!r} on tid {key[1]}")
                stack.pop()
            else:
                stack.pop()
        elif ph not in ("X", "C", "s", "t", "f", "i"):
            errors.append(f"event {i}: unknown ph {ph!r}")
    for key, stack in stacks.items():
        if stack:
            errors.append(f"tid {key[1]}: unclosed B events {stack}")
    return errors


# -- result-document block ----------------------------------------------------

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


# -- device profiles --------------------------------------------------------

@contextlib.contextmanager
def profiler_trace(logdir: Optional[str] = None):
    """Opt-in `torch.profiler` wrapper: a CPU + CUDA profile of the block
    lands in `logdir` as a Chrome trace beside the host trace. No-op when
    `logdir` is falsy, so callers can wrap unconditionally."""
    if not logdir:
        yield
        return
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(str(logdir), exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(str(logdir), "profile.json"))
