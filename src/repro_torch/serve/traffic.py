"""Deterministic open-loop synthetic traffic (DESIGN.md §14).

Arrival processes over the scenario's test set. Three shapes, all with
the SAME mean offered load `qps` over the horizon so scenarios differ in
burstiness, not volume:

* ``poisson`` — homogeneous Poisson at rate `qps`.
* ``burst``   — on/off square wave: each period's first quarter runs at
  3x the base rate, the rest at 1/3x (mean = 1.0x) — the shape that
  exercises queue growth + shedding.
* ``diurnal`` — one sinusoidal "day" over the horizon, trough at t=0 and
  peak mid-run, ±80% around the base rate.

Inhomogeneous shapes are drawn by THINNING a homogeneous process at the
peak rate, so every shape consumes the generator identically per
candidate arrival.

rng contract (DESIGN.md §4): traffic draws from its OWN SeedSequence
fold of the run seed (`(seed, _TRAFFIC_SALT)`) and never touches the
simulation's `self.rng` stream — training is bitwise identical with
serving on or off, and the trace itself is reproducible across engines.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

# spells "SERV"; folded with the run seed so the traffic stream is
# independent of every other consumer of the seed (attacks fold event
# keys, codecs fold upload keys — same discipline)
_TRAFFIC_SALT = 0x53455256

# burst shape constants: quarter-period bursts at 3x, off-phase at 1/3x
_BURST_PERIODS = 4        # bursts per horizon
_BURST_DUTY = 0.25
_BURST_HI = 3.0
_BURST_LO = (1.0 - _BURST_DUTY * _BURST_HI) / (1.0 - _BURST_DUTY)
_DIURNAL_AMP = 0.8


def _rate(arrival: str, t: np.ndarray, horizon: float) -> np.ndarray:
    """Instantaneous rate MULTIPLIER (mean 1.0 over the horizon)."""
    if arrival == "poisson":
        return np.ones_like(t)
    if arrival == "burst":
        period = horizon / _BURST_PERIODS
        phase = np.mod(t, period) / period
        return np.where(phase < _BURST_DUTY, _BURST_HI, _BURST_LO)
    if arrival == "diurnal":
        return 1.0 + _DIURNAL_AMP * np.sin(
            2.0 * np.pi * t / horizon - 0.5 * np.pi)
    raise ValueError(f"unknown arrival process {arrival!r}")


def _peak(arrival: str) -> float:
    peaks = {"poisson": 1.0, "burst": _BURST_HI,
             "diurnal": 1.0 + _DIURNAL_AMP}
    if arrival not in peaks:
        raise ValueError(f"unknown arrival process {arrival!r}")
    return peaks[arrival]


def generate(arrival: str, qps: float, horizon: float, n_test: int,
             seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """The full open-loop trace: (arrival_times, example_indices).

    `arrival_times` is sorted float64 seconds in [0, horizon);
    `example_indices` maps each request onto the test set uniformly.
    Deterministic in (arrival, qps, horizon, n_test, seed) alone.
    """
    assert horizon > 0 and qps > 0 and n_test > 0
    rng = np.random.default_rng(
        np.random.SeedSequence((int(seed), _TRAFFIC_SALT)))
    peak_rate = qps * _peak(arrival)
    # candidate count: peak-rate Poisson over the horizon, + guard band
    n_cand = int(np.ceil(peak_rate * horizon + 6.0 * np.sqrt(
        peak_rate * horizon) + 16))
    while True:
        gaps = rng.exponential(1.0 / peak_rate, size=n_cand)
        cand = np.cumsum(gaps)
        if cand[-1] >= horizon:
            break
        # astronomically unlikely guard-band miss: widen and redraw
        n_cand *= 2
    cand = cand[cand < horizon]
    keep = rng.random(size=len(cand)) < (
        _rate(arrival, cand, horizon) / _peak(arrival))
    times = np.ascontiguousarray(cand[keep])
    examples = rng.integers(0, n_test, size=len(times)).astype(np.int64)
    return times, examples
