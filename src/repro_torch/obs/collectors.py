"""Device-resident per-round counters and the fused per-phase timing proxy
(DESIGN.md §13; port of `repro.obs.collectors`).

Host spans cannot see inside the fused executor's rounds (one captured
CUDA graph replayed per round on the card), so fused-engine telemetry has
two pieces:

* `round_counters` — per-round scalars computed INSIDE the round body:
  they are written into (R,) device buffers next to the metric curves
  and transferred once at run end, with the curves. The driver-owned
  counter is the attacker count per round; strategies add their own
  through `Strategy.scan_telemetry` (model-delta L2 by default, HFL adds
  the group-spread L2).

* `fused_phase_proxy` — per-phase device timings: one throwaway
  per-round event runs under `Telemetry.category("proxy")`, where every
  lifecycle phase blocks on its device work
  (`FederatedSimulation.tel_sync`), so the recorded span durations
  approximate the per-phase cost of a round. The event runs twice —
  first suppressed (first-use costs), then measured — with a throwaway
  rng, so `sim.rng` and the measured run are untouched. The driver skips
  the proxy when `fused_chunk > 0` (the per-round path would materialize
  the unchunked participant stack that chunking exists to bound).

A replayed graph runs no Python, so the kernel wrappers' launch counters
(`launches`, one a call that launches) do not see its launches.
`device_window` measures them: a profile of a window that counts, by
name, the round kernels' executions on the device.
"""
from __future__ import annotations

import contextlib
import re
import time
from typing import Any, Dict

import numpy as np
import torch

from repro_torch.kernels import comm_agg, fedavg_agg, gossip_mix, robust_agg

# the hand-written kernels of the FL rounds, by name: the wrapper module
# (its `launches` counts the calls that launch) and the CUDA functions
# the wrapper launches, one a call
ROUND_KERNELS = {
    "fedavg_agg": (fedavg_agg, ("fedavg_agg_kernel", "fedavg_rows_kernel")),
    "trimmed_mean_agg": (robust_agg, ("trimmed_mean_kernel",
                                      "trimmed_reg_kernel")),
    "gossip_mix_agg": (gossip_mix, ("gossip_mix_kernel",
                                    "gossip_rows_kernel",
                                    "gossip_small_kernel")),
    "dequant_agg": (comm_agg, ("dequant_agg_kernel",)),
}


def wrapper_launches() -> Dict[str, int]:
    """Each round kernel's wrapper count (calls that launched it)."""
    return {name: mod.launches for name, (mod, _) in ROUND_KERNELS.items()}


def round_counters(strat, fx, carry_prev, carry_new, xs
                   ) -> Dict[str, Any]:
    """The per-round counter dict of one round (device scalars, no host
    read). Every value is a float32 scalar, so each counter stacks into
    one (R,) series."""
    out = {"attackers": xs["flags"].sum()}
    out.update(strat.scan_telemetry(fx, carry_prev, carry_new, xs))
    return {k: v.float() for k, v in out.items()}


def fused_phase_proxy(sim) -> None:
    """Run one instrumented per-round event so the trace carries a
    per-phase device-time breakdown for the fused run (see the module
    docstring for the double run and the skip condition)."""
    strat, tel = sim.strategy, sim.telemetry
    event = strat.num_events(sim) - 1
    if event < 0:
        return
    with tel.suppress():                      # first-use pass
        strat.run_event(sim, strat.init_state(sim), event,
                        rng=np.random.default_rng(sim.fl.seed))
    with tel.category("proxy"), \
            tel.span("fused_phase_proxy", cat="proxy"):
        strat.run_event(sim, strat.init_state(sim), event,
                        rng=np.random.default_rng(sim.fl.seed))
    if sim.device.type == "cuda":
        torch.cuda.synchronize(sim.device)


def device_window(box: Dict[str, Any]):
    """A `FederatedSimulation.build_hook` for the card: profiles the
    window with torch.profiler and stores in `box` its wall and
    device-busy milliseconds (the union of the device's activity
    intervals, so concurrent work counts once), the number of device
    events, the device idle share (None when the profiler records no
    device time), `kernels`: each round kernel's executions on the device
    by CUDA function name (a replayed graph's included), and
    `wrapper_calls`: the wrappers' own counts in the window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    patterns = {name: re.compile(r"\b(%s)\b" % "|".join(fns))
                for name, (_, fns) in ROUND_KERNELS.items()}

    @contextlib.contextmanager
    def hook():
        torch.cuda.synchronize()
        calls0 = wrapper_launches()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            yield
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        calls = {k: v - calls0[k] for k, v in wrapper_launches().items()}
        events = [e for e in prof.events()
                  if e.device_type == DeviceType.CUDA]
        spans = sorted((e.time_range.start, e.time_range.end)
                       for e in events)
        busy, end = 0.0, float("-inf")
        for a, b in spans:
            if b > end:
                busy += b - max(a, end)
                end = b
        busy /= 1e3
        box.update(wall_ms=wall, device_busy_ms=busy,
                   device_events=len(spans),
                   idle_share=(max(0.0, 1.0 - busy / wall) if busy > 0
                               else None),
                   kernels={name: sum(1 for e in events if pat.search(e.name))
                            for name, pat in patterns.items()},
                   wrapper_calls=calls)
    return hook
