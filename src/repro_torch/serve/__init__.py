"""Federation-in-the-loop serving (DESIGN.md §14; the port's copy of
`repro.serve`, numpy only).

`ServeSession` ties the subsystem together for one training run:

    traffic.generate()  ->  open-loop trace (own seed fold, §4)
    MicroBatcher        ->  virtual-clock micro-batching + shedding
    ModelBuffer         ->  double-buffered round-boundary hot-swap
    metrics             ->  the result-JSON schema v2.4 `serving` block

The driver contract is three calls, identical for every engine:

    sess = ServeSession(fl, n_events=R, n_test=..., init_params=params)
    sess.publish_round(v, model)   # after each aggregation event v=1..R
    block = sess.result_block()    # drains the tail, summarizes

The per-round engines publish as they train; the fused executor stacks
the per-round global models as an extra scan output and REPLAYS the
publishes after the scan — virtual time makes the two orderings produce
byte-identical serving blocks.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Optional

import numpy as np

from repro_torch.serve import metrics, traffic
from repro_torch.serve.batcher import MicroBatcher
from repro_torch.serve.hotswap import ModelBuffer

__all__ = ["MicroBatcher", "ModelBuffer", "ServeSession", "metrics",
           "traffic"]


class ServeSession:
    """One training run's serving side-car.

    `fl` is the FLConfig (the serve_* fields); `n_events` the number of
    aggregation events (= published versions beyond the init); the
    horizon is `n_events * serve_round_duration` virtual seconds.
    `dispatch_fn(params, example_indices) -> per-request correctness`
    is the one model call per batch (on the card in the port); None skips model
    execution (pure queueing simulation — same block minus accuracy).
    """

    def __init__(self, fl, *, n_events: int, n_test: int, init_params,
                 dispatch_fn: Optional[Callable] = None, telemetry=None):
        self.fl = fl
        self.tel = telemetry
        self.horizon = float(n_events * fl.serve_round_duration)
        times, examples = traffic.generate(
            fl.serve_arrival, fl.serve_qps, self.horizon, n_test, fl.seed)
        self.buffer = ModelBuffer()
        self.buffer.publish(init_params, 0, 0.0)
        self.batcher = MicroBatcher(
            times, examples, max_batch=fl.serve_batch,
            max_wait=fl.serve_max_wait, queue_depth=fl.serve_queue,
            service_base=fl.serve_service_base,
            service_per_item=fl.serve_service_per_item,
            buffer=self.buffer, dispatch_fn=dispatch_fn)
        self._finished = False
        self._block = None
        if dispatch_fn is not None:
            # run the padded-batch dispatch shape once now, outside any
            # timed window (the first in-loop batch would otherwise
            # charge its one-time set-up to the build timer)
            dispatch_fn(init_params, np.zeros(1, np.int64))

    def _span(self, name, **args):
        if self.tel is None:
            return contextlib.nullcontext()
        return self.tel.span(name, cat="serve", **args)

    def publish_round(self, version: int, params) -> None:
        """Advance the virtual clock to this round boundary (serving
        the window's traffic on the OLD model), then hot-swap. A batch
        in service across the boundary completes untouched."""
        assert not self._finished
        t = float(version) * self.fl.serve_round_duration
        with self._span("serve_window", version=version,
                        flow="serve.swap"):
            self.batcher.advance(t)
        with self._span("hot_swap", version=version, flow="serve.swap"):
            self.buffer.publish(params, version, t)

    def hold_round(self, version: int) -> None:
        """A quorum-failed aggregation round publishes NOTHING
        (DESIGN.md §15): the virtual clock still advances through the
        round window — the window's traffic is served on the held model,
        so the staleness histogram reflects the held version — but no
        hot-swap occurs."""
        assert not self._finished
        t = float(version) * self.fl.serve_round_duration
        with self._span("serve_window", version=version, held=True,
                        flow="serve.swap"):
            self.batcher.advance(t)
        if self.tel is not None:
            self.tel.counter("serve.held_rounds")

    def result_block(self):
        """Drain remaining traffic and summarize; idempotent."""
        if not self._finished:
            with self._span("serve_drain"):
                self.batcher.drain()
            assert self.batcher.accounted() and self.batcher.in_flight == 0
            self._block = metrics.serving_block(
                self.batcher, self.buffer, horizon=self.horizon,
                arrival=self.fl.serve_arrival,
                qps_target=self.fl.serve_qps,
                round_duration=self.fl.serve_round_duration)
            if self.tel is not None:
                self.tel.counter("serve.requests", self._block["requests"])
                self.tel.counter("serve.shed", self._block["shed"])
                self.tel.counter("serve.swaps", self._block["swap_count"])
                self.tel.record_series("serve.batch_sizes",
                                       self.batcher.batch_sizes)
            self._finished = True
        return self._block
