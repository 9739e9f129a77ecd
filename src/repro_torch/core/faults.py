"""Deterministic fault injection for the federation runtime
(DESIGN.md §15). A copy of `repro.core.faults` (numpy only): the same
salt and rng consumption order, so one (seed, profile) gives the
reference's schedule bit for bit. The port runs the loop and vectorized
drivers; `FaultSchedule.scan_xs` is kept for its fused executor
(ROADMAP §A.13).

Named fault profiles are compiled ONCE per run, from the run seed, into
precomputed per-round numpy schedules: the (R, C) alive mask, heartbeat
ages / detected-failure masks (`core/membership.py`), rejoin markers
with outage-length staleness, and — for gossip rounds — per-round
re-randomized moving-target rings with their masked row-stochastic
mixing matrices. Every engine (loop, vectorized, fused scan, mesh)
consumes these same arrays: the per-round drivers index them per event
on the host, the fused executor hoists them into scan inputs (`xs`),
so loop == vectorized == fused stays bitwise under an active profile
(the §4/§10 parity contract extended to faults).

The fault stream is rng-independent of the run stream: like attacks
(`_ATTACK_SALT`) and codecs (`_CODEC_SALT`), it derives from the run
seed through a private salt, so enabling a fault profile never perturbs
participant sampling or batch permutations — and `fault_profile="none"`
builds no schedule at all (every seam is a host-level `if`, keeping the
traced programs and results bitwise identical to a fault-free build).

Semantics of a dead round (upload-loss model): the client still appears
in the round plan and trains (its arrays are simulated then discarded —
"the upload was lost on the wire"), which is what keeps the run rng
consumption identical with faults on or off; the loss is applied at the
aggregation boundary by masking its weight / mixing row. Degradation
under partial membership is quorum-gated per aggregation event
(`FLConfig.quorum_frac`): below quorum the event's declared degraded
action is to hold the previous model (sync strategies) or skip the
merge (async); above quorum the masked weights renormalize. A rejoining
client resyncs from the current round model automatically (round bases
are pulled from the evolving global/group state) and its outage length
is accounted as rejoin staleness in the result `faults` block.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core import membership, topology

# Private rng fold for the fault stream (decoupled from the run rng and
# from the attack/codec salts — DESIGN.md §4).
_FAULT_SALT = 0xFA17_5EED

# rate below is FLConfig.churn_rate; "mid" pins its own severity so the
# chaos CI job is reproducible independent of scenario defaults.
FAULT_PROFILES = ("none", "churn", "dropout", "straggler", "flaky", "mid")

_MEAN_OUTAGE = 2.0      # churn: mean dead-span length (rounds)
_MID_RATE = 0.15        # "mid": fixed mid-severity churn rate
_MID_DROPOUT = 0.1      # "mid": i.i.d. transient-loss overlay rate


def quorum_threshold(n: int, quorum_frac: float) -> int:
    """Minimum alive participants for an n-client aggregation event to
    proceed (floor 1 — an event with zero uploads can never aggregate)."""
    return max(1, int(math.ceil(quorum_frac * n)))


def _alive_matrix(profile: str, rng: np.random.Generator, R: int, C: int,
                  rate: float) -> np.ndarray:
    """(R, C) alive mask for the named profile. Fixed consumption order
    per profile, so (seed, profile) regenerates bitwise."""
    if profile in ("churn", "mid"):
        # crash/rejoin churn as alternating alive/dead spans per client:
        # outage lengths are drawn AT crash time (geometric, mean
        # _MEAN_OUTAGE), so every outage is contiguous by construction —
        # no resurrection before the scheduled rejoin. Alive-span mean
        # is set so the stationary dead fraction ~= rate.
        r = _MID_RATE if profile == "mid" else min(max(rate, 0.0), 0.9)
        mean_alive = max(1.0, _MEAN_OUTAGE * (1.0 - r) / max(r, 1e-6))
        alive = np.ones((R, C), bool)
        for c in range(C):
            up = bool(rng.random() >= r)
            t = 0
            while t < R:
                mean = mean_alive if up else _MEAN_OUTAGE
                span = max(1, int(rng.geometric(1.0 / mean)))
                alive[t:t + span, c] = up
                t += span
                up = not up
        if profile == "mid":
            # the mid-severity MIX adds an i.i.d. transient-loss overlay
            # on top of the crash/rejoin spans: alive-span means are
            # ~11 rounds at _MID_RATE, so a short smoke horizon (the
            # chaos CI job runs 2-round scenarios) would otherwise
            # often compile an all-alive schedule and exercise nothing.
            # Overlay drawn AFTER the spans — fixed consumption order
            # keeps (seed, profile) regeneration bitwise.
            alive &= rng.random((R, C)) >= _MID_DROPOUT
        return alive
    if profile == "dropout":
        # transient dropout: i.i.d. per (round, client) — outages are
        # mostly single rounds, exercising rapid leave/rejoin cycling
        return rng.random((R, C)) >= rate
    if profile == "flaky":
        # flaky-link message loss: each UPLINK message independently
        # lost at half the configured rate (lighter than dropout — the
        # client itself is healthy, only this round's upload is lost)
        return rng.random((R, C)) >= 0.5 * rate
    if profile == "straggler":
        # straggler slowdown: an rng-chosen slow set misses every other
        # round's deadline (phase-shifted per client so the slow set
        # never synchronizes into one dead round)
        alive = np.ones((R, C), bool)
        n_slow = min(C, max(1, int(round(rate * C))))
        slow = np.sort(rng.choice(C, size=n_slow, replace=False))
        phase = rng.integers(0, 2, size=n_slow)
        for j, c in enumerate(slow):
            alive[(np.arange(R) + phase[j]) % 2 == 1, c] = False
        return alive
    raise ValueError(f"unknown fault profile {profile!r} "
                     f"(expected one of {FAULT_PROFILES})")


@dataclasses.dataclass
class FaultEvent:
    """One aggregation event's host-side fault view (numpy; the fused
    driver stacks the same fields across rounds into scan inputs)."""
    event: int
    alive: np.ndarray           # (k,) float32 — aggregation weight mask
    alive_b: np.ndarray         # (k,) bool
    n_alive: int
    qok: bool                   # event meets its quorum threshold
    rejoined: int               # participants rejoining this round
    rejoin_staleness: float     # summed outage lengths of the rejoiners


class FaultSchedule:
    """The whole run's precomputed fault schedule (see module docstring).

    Built by `compile_schedule`; indexed per event by the per-round
    drivers (`event_view` + the gossip/group helpers) and stacked whole
    into fused scan inputs (`scan_xs`). All arrays are plain numpy —
    bitwise reproducible from (seed, profile, rate, shape) alone."""

    def __init__(self, *, profile: str, seed: int, num_clients: int,
                 n_events: int, churn_rate: float, quorum_frac: float,
                 heartbeat_timeout: int, mtd: bool, event_size: int,
                 gossip_degree: int):
        if profile not in FAULT_PROFILES or profile == "none":
            raise ValueError(f"cannot compile schedule for profile "
                             f"{profile!r} (one of {FAULT_PROFILES[1:]})")
        self.profile = profile
        self.seed = seed
        self.num_clients = num_clients
        self.n_events = n_events
        self.churn_rate = churn_rate
        self.quorum_frac = quorum_frac
        self.heartbeat_timeout = heartbeat_timeout
        self.mtd = mtd
        self.event_size = event_size
        self.gossip_degree = gossip_degree

        rng = np.random.default_rng([seed, _FAULT_SALT])
        # fixed consumption order: alive matrix first, then (mtd only)
        # one ring permutation per round — (seed, profile) regenerates
        # the whole schedule bitwise (property-tested)
        self.alive = _alive_matrix(profile, rng, n_events, num_clients,
                                   churn_rate)
        self.ages = membership.heartbeat_ages(self.alive)
        self.detected = membership.detected_failures(self.ages,
                                                     heartbeat_timeout)
        self.rejoined, self.rejoin_staleness = membership.rejoin_events(
            self.alive, self.ages)
        if mtd:
            self.rings: List[List[List[int]]] = [
                membership.moving_target_ring(event_size, gossip_degree,
                                              rng)
                for _ in range(n_events)]
        else:
            self.rings = []
        self._static_ring = topology.ring_neighbors(event_size,
                                                    gossip_degree)

    # -- per-event views (per-round drivers) --------------------------------
    def quorum_ok(self, n_alive: int, n: int) -> bool:
        return n_alive >= quorum_threshold(n, self.quorum_frac)

    def event_view(self, event: int, pids: Sequence[int]) -> FaultEvent:
        pids = np.asarray(pids, np.int64)
        alive_b = self.alive[event, pids]
        n_alive = int(alive_b.sum())
        rej = self.rejoined[event, pids]
        return FaultEvent(
            event=event, alive=alive_b.astype(np.float32),
            alive_b=alive_b, n_alive=n_alive,
            qok=self.quorum_ok(n_alive, len(pids)),
            rejoined=int(rej.sum()),
            rejoin_staleness=float(
                self.rejoin_staleness[event, pids].sum()))

    def group_qok(self, event: int, pids: Sequence[int],
                  num_groups: int) -> np.ndarray:
        """(G,) per-group quorum over the contiguous position groups of
        `topology.hierarchical_groups` (HFL tier 1)."""
        alive_b = self.alive[event, np.asarray(pids, np.int64)]
        per = len(alive_b) // num_groups
        thr = quorum_threshold(per, self.quorum_frac)
        return (alive_b.reshape(num_groups, per).sum(axis=1) >= thr)

    def neighbors_for(self, event: int) -> List[List[int]]:
        """This round's gossip ring over participant POSITIONS 0..k-1:
        the static ring, or (mtd) the round's re-randomized one."""
        return self.rings[event] if self.mtd else self._static_ring

    def gossip_mix(self, event: int, pids: Sequence[int]) -> np.ndarray:
        """(k, k) masked row-stochastic mixing matrix for this round."""
        pids = np.asarray(pids, np.int64)
        return membership.masked_mix_matrix(
            self.neighbors_for(event), self.alive[event, pids],
            self.detected[event, pids])

    def gossip_gather(self, event: int, pids: Sequence[int], K: int
                      ) -> np.ndarray:
        """(k, K) defended-gossip neighborhood gather for this round."""
        pids = np.asarray(pids, np.int64)
        return membership.masked_gather_indices(
            self.neighbors_for(event), self.alive[event, pids], K,
            self.detected[event, pids])

    # -- fused scan inputs --------------------------------------------------
    def scan_xs(self, pids_l: Sequence[Sequence[int]], *,
                num_groups: Optional[int] = None, gossip: bool = False,
                gossip_defended: bool = False,
                gather_k: Optional[int] = None) -> Dict[str, np.ndarray]:
        """Stack the per-event views into per-round scan inputs for the
        fused executor — the SAME numpy code paths the per-round drivers
        index, evaluated once per round and stacked, so the two engines
        consume identical arrays (bitwise parity under faults)."""
        R = len(pids_l)
        views = [self.event_view(ev, pids) for ev, pids in
                 enumerate(pids_l)]
        xs: Dict[str, np.ndarray] = {
            "fault_alive": np.stack([v.alive for v in views]),
            "fault_qok": np.asarray([v.qok for v in views], bool),
        }
        if num_groups is not None:
            xs["fault_gqok"] = np.stack(
                [self.group_qok(ev, pids, num_groups)
                 for ev, pids in enumerate(pids_l)])
        if gossip:
            if gossip_defended:
                xs["fault_gidx"] = np.stack(
                    [self.gossip_gather(ev, pids, gather_k)
                     for ev, pids in enumerate(pids_l)]
                ).astype(np.int32)
            else:
                xs["fault_mix"] = np.stack(
                    [self.gossip_mix(ev, pids)
                     for ev, pids in enumerate(pids_l)])
        return xs

    # -- schedule-level accounting (result `faults` block) ------------------
    def schedule_stats(self) -> Dict[str, Any]:
        a = self.alive
        crashes = int((~a[1:] & a[:-1]).sum()) + int((~a[0]).sum())
        return {
            "profile": self.profile,
            "churn_rate": float(self.churn_rate),
            "quorum_frac": float(self.quorum_frac),
            "heartbeat_timeout": int(self.heartbeat_timeout),
            "mtd": bool(self.mtd),
            "churn_events": crashes,
            "rejoins": int(self.rejoined.sum()),
            "mean_rejoin_staleness": (
                float(self.rejoin_staleness.sum()
                      / max(1, self.rejoined.sum()))),
            "mean_alive_frac": float(a.mean()),
        }


def compile_schedule(fl, n_events: int,
                     event_size: int) -> Optional["FaultSchedule"]:
    """Compile `fl`'s fault profile into a schedule (None for "none" —
    the inert path builds nothing). `n_events` comes from the resolved
    strategy (async runs have one event per tick batch); `event_size`
    is the gossip-position count (`Strategy.event_size()`)."""
    if fl.fault_profile == "none":
        return None
    return FaultSchedule(
        profile=fl.fault_profile, seed=fl.seed,
        num_clients=fl.num_clients, n_events=n_events,
        churn_rate=fl.churn_rate, quorum_frac=fl.quorum_frac,
        heartbeat_timeout=fl.heartbeat_timeout, mtd=fl.fault_mtd,
        event_size=event_size, gossip_degree=fl.gossip_neighbors)
