"""Round-boundary model hot-swap: double-buffered published params.

The serving engine never trains and the trainer never serves — the only
coupling is `ModelBuffer`. Each round boundary the driver PUBLISHES the
freshly aggregated global model into the slot the server is NOT reading
and flips the active index; a batch dispatched before the flip keeps the
reference it acquired and completes on the old version (in-flight work
is never drained or dropped). With two slots and a single-server batch
engine at most one dispatch is ever in flight, so a publish can never
overwrite the buffer a live batch is reading — the invariant the double
buffer encodes (on device this is what makes the swap a pointer flip,
not a copy).

Staleness semantics (DESIGN.md §14): a request served from version v
that COMPLETES when version V is the latest published is V - v rounds
stale. Version r is the global model after aggregation event r; version
0 is the pre-training init (published at t=0, so serving never lacks a
model).
"""
from __future__ import annotations

import bisect
from typing import Any, List, Tuple


class ModelBuffer:
    def __init__(self):
        self._slots: List[Any] = [None, None]
        self._active = -1
        self._version = -1
        # (time, version) per publish, time-ascending — the staleness
        # ledger: latest_version_at() answers "what was current when
        # this request completed" without retaining old params
        self.publishes: List[Tuple[float, int]] = []
        self._pub_times: List[float] = []

    @property
    def swap_count(self) -> int:
        """Hot-swaps = publishes beyond the initial install."""
        return max(0, len(self.publishes) - 1)

    def publish(self, params, version: int, t: float) -> None:
        if self.publishes:
            assert t >= self.publishes[-1][0] and \
                version > self.publishes[-1][1], (t, version)
        idx = 0 if self._active < 0 else 1 - self._active
        self._slots[idx] = params
        self._active = idx
        self._version = version
        self.publishes.append((float(t), int(version)))
        self._pub_times.append(float(t))

    def acquire(self):
        """Snapshot (version, params) at dispatch time. The caller holds
        the params reference for the batch's whole service time."""
        assert self._active >= 0, "no model published yet"
        return self._version, self._slots[self._active]

    def latest_version_at(self, t: float) -> int:
        """Version current at time `t` (publishes at exactly `t` count)."""
        i = bisect.bisect_right(self._pub_times, t)
        assert i > 0, "queried before the initial publish"
        return self.publishes[i - 1][1]
