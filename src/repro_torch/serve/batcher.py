"""Dynamic micro-batching engine over a virtual clock (DESIGN.md §14).

A single-server discrete-event simulation of the serving loop:

* ADMISSION — arrivals join a bounded FIFO queue; an arrival that finds
  the queue at `queue_depth` is SHED (recorded, never silently lost).
* DISPATCH — a batch fires at the earliest time the server is free AND
  either `max_batch` requests are queued or the oldest has waited
  `max_wait`; it takes up to `max_batch` requests off the head. One
  dispatch = one model call (the `dispatch_fn` seam).
* SERVICE — the virtual clock charges the affine service-time model
  `base + per_item * batch_size`; wall-clock serving throughput is not
  part of the result document.

Running on a VIRTUAL clock makes the serving metrics deterministic in
the trace + config alone: the per-round driver (publishing between
events) and the fused executor (replaying its stacked per-round models
after the scan) produce byte-identical serving blocks, which is what
lets tests pin cross-engine serving parity at all.

The model a batch uses is snapshotted from the `ModelBuffer` AT
DISPATCH; a hot-swap landing mid-service never touches in-flight work
(see hotswap.py). Dispatches strictly before a publish time use the old
version — `advance(t)` before `publish(..., t)` encodes the round
boundary.
"""
from __future__ import annotations

import collections
import math
from typing import Callable, List, Optional

import numpy as np

from repro_torch.serve.hotswap import ModelBuffer


class MicroBatcher:
    """Open-loop trace in, per-request/per-batch ledgers out.

    `dispatch_fn(params, example_indices) -> bool per-request
    correctness` is optional: None runs the pure queueing simulation
    (identical latency/occupancy/staleness ledgers, no model calls).
    """

    def __init__(self, times: np.ndarray, examples: np.ndarray, *,
                 max_batch: int, max_wait: float, queue_depth: int,
                 service_base: float, service_per_item: float,
                 buffer: ModelBuffer,
                 dispatch_fn: Optional[Callable] = None):
        assert len(times) == len(examples)
        self.times = np.asarray(times, np.float64)
        self.examples = np.asarray(examples, np.int64)
        self.max_batch = int(max_batch)
        self.max_wait = float(max_wait)
        self.queue_depth = int(queue_depth)
        self.service_base = float(service_base)
        self.service_per_item = float(service_per_item)
        self.buffer = buffer
        self.dispatch_fn = dispatch_fn
        # event-loop state
        self._next = 0                      # next undelivered arrival
        self._queue = collections.deque()   # request ids, FIFO
        self._server_free = 0.0
        # ledgers (parallel lists, one entry per completed request)
        self.done_rid: List[int] = []
        self.done_arrive: List[float] = []
        self.done_dispatch: List[float] = []
        self.done_finish: List[float] = []
        self.done_version: List[int] = []
        self.done_correct: List[bool] = []  # empty when dispatch_fn=None
        self.shed_rid: List[int] = []
        self.batch_sizes: List[int] = []
        self.batch_versions: List[int] = []

    # -- admission ----------------------------------------------------------
    def _admit_until(self, t: float) -> None:
        """Deliver every arrival with time <= t into the bounded queue.
        No dispatch happens inside the window (the caller is on its way
        to the NEXT dispatch), so occupancy only grows and shedding in
        arrival order is exact."""
        n = len(self.times)
        while self._next < n and self.times[self._next] <= t:
            if len(self._queue) >= self.queue_depth:
                self.shed_rid.append(self._next)
            else:
                self._queue.append(self._next)
            self._next += 1

    # -- the event loop -----------------------------------------------------
    def advance(self, t_to: float) -> None:
        """Fire every dispatch with dispatch time strictly before
        `t_to`. Called with the next round-boundary time before each
        hot-swap, and with +inf to drain."""
        n = len(self.times)
        while True:
            if not self._queue:
                if self._next >= n or self.times[self._next] >= t_to:
                    return
                self._admit_until(self.times[self._next])
                continue
            head_t = self.times[self._queue[0]]
            deadline = head_t + self.max_wait
            need = self.max_batch - len(self._queue)
            if need <= 0:
                trigger = head_t          # batch already full: fire asap
            elif self._next + need - 1 < n:
                # the moment the batch WOULD fill from future arrivals
                trigger = min(deadline, self.times[self._next + need - 1])
            else:
                trigger = deadline        # tail: no fill coming, wait out
            t_disp = max(trigger, self._server_free, head_t)
            if t_disp >= t_to:
                return
            # arrivals up to the dispatch instant are in the queue first
            # (they may complete the batch, or shed against the bound)
            self._admit_until(t_disp)
            self._dispatch(t_disp)

    def drain(self) -> None:
        self.advance(math.inf)

    def _dispatch(self, t: float) -> None:
        k = min(self.max_batch, len(self._queue))
        rids = [self._queue.popleft() for _ in range(k)]
        version, params = self.buffer.acquire()
        t_done = t + self.service_base + self.service_per_item * k
        self._server_free = t_done
        if self.dispatch_fn is not None:
            correct = np.asarray(
                self.dispatch_fn(params, self.examples[rids]), bool)
            assert correct.shape == (k,), correct.shape
            self.done_correct.extend(bool(c) for c in correct)
        for rid in rids:
            self.done_rid.append(rid)
            self.done_arrive.append(float(self.times[rid]))
            self.done_dispatch.append(t)
            self.done_finish.append(t_done)
            self.done_version.append(version)
        self.batch_sizes.append(k)
        self.batch_versions.append(version)

    # -- invariants the tests pin -------------------------------------------
    @property
    def in_flight(self) -> int:
        return len(self._queue)

    def accounted(self) -> bool:
        """Every generated request is completed, shed, or still queued —
        nothing is ever silently dropped (hot-swaps included)."""
        return (len(self.done_rid) + len(self.shed_rid)
                + len(self._queue) + (len(self.times) - self._next)
                == len(self.times))
