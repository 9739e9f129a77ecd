"""Dynamic membership primitives: heartbeat failure detection and
moving-target gossip topologies (DESIGN.md §15). A copy of
`repro.core.membership` (numpy only).

Everything here is pure host-side numpy over boolean membership arrays —
the fault compiler (`core/faults.py`) calls these functions once per run
to precompute per-round schedules, and BOTH the per-round drivers and
the fused executor consume the resulting arrays, so the three engines
can never disagree about who is alive or which mixing graph a round
uses (the §4/§10 parity contract extended to membership).

Failure-detection model: a client that misses a round stops emitting
heartbeats; its peers count consecutive missed heartbeats (the client's
*age*) and declare it failed once the age reaches `heartbeat_timeout`
rounds. Between the crash and the detection the peer is still a
neighbor-list member whose messages are simply lost (its mixing weight
falls back to the receiver itself — a transient-link view); after
detection it is pruned from the neighbor support entirely and the
remaining weights renormalize (neighbor decay). A heartbeat on a later
round resets the age to zero (rejoin).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np


def heartbeat_ages(alive: np.ndarray) -> np.ndarray:
    """(R, C) alive mask -> (R, C) heartbeat ages: consecutive missed
    rounds up to and including round r (0 while alive). Monotone +1 over
    each outage, reset to 0 at rejoin — the invariants the property
    tests pin."""
    alive = np.asarray(alive, bool)
    R, C = alive.shape
    ages = np.zeros((R, C), np.int64)
    cur = np.zeros(C, np.int64)
    for r in range(R):
        cur = np.where(alive[r], 0, cur + 1)
        ages[r] = cur
    return ages


def detected_failures(ages: np.ndarray, timeout: int) -> np.ndarray:
    """Peers declared failed by the heartbeat detector: age has reached
    `timeout` consecutive missed rounds (age > 0 already implies the
    client is dead this round)."""
    return np.asarray(ages) >= max(1, int(timeout))


def rejoin_events(alive: np.ndarray, ages: np.ndarray
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """(rejoined (R, C) bool, staleness (R, C) int): a client rejoins at
    round r when it is alive after being dead at r-1; its staleness is
    the length of the outage it returns from (rounds of global progress
    it missed — the resync accounting in the result `faults` block)."""
    alive = np.asarray(alive, bool)
    R, C = alive.shape
    rejoined = np.zeros((R, C), bool)
    staleness = np.zeros((R, C), np.int64)
    if R > 1:
        rejoined[1:] = alive[1:] & ~alive[:-1]
        staleness[1:] = np.where(rejoined[1:], ages[:-1], 0)
    return rejoined, staleness


def moving_target_ring(k: int, degree: int, rng: np.random.Generator
                       ) -> List[List[int]]:
    """One re-randomized ring over positions 0..k-1: a fresh circular
    order drawn from `rng`, neighbors at +-1..degree/2 hops along it.
    Same equal-degree symmetric shape as `topology.ring_neighbors`, but
    a colluding set that sandwiched a victim last round is scattered
    this round — the moving-target defense of the acceptance scenario."""
    order = rng.permutation(k)
    pos = np.empty(k, np.int64)
    pos[order] = np.arange(k)
    half = max(1, degree // 2)
    out: List[List[int]] = []
    for c in range(k):
        i = pos[c]
        nbrs = {int(order[(i - d) % k]) for d in range(1, half + 1)}
        nbrs |= {int(order[(i + d) % k]) for d in range(1, half + 1)}
        out.append(sorted(nbrs - {c}))
    return out


def masked_mix_matrix(neighbors: Sequence[Sequence[int]],
                      alive: np.ndarray,
                      detected: Optional[np.ndarray] = None) -> np.ndarray:
    """The (k, k) row-stochastic gossip matrix under partial membership.

    Row p (alive): uniform over {p} + the neighbors not yet declared
    failed; the share of a neighbor that is dead but undetected (its
    link merely timed out this round) falls back to p itself, while
    detected peers are pruned from the support and the rest renormalize
    (heartbeat neighbor decay). Row p (dead): identity — a dead client
    mixes nothing and holds its own upload slot.

    Every row sums to exactly 1 and the off-diagonal support is
    symmetric (p mixes from q iff q mixes from p), which the property
    tests pin."""
    alive = np.asarray(alive, bool)
    k = alive.shape[0]
    det = (np.zeros(k, bool) if detected is None
           else np.asarray(detected, bool))
    mix = np.zeros((k, k), np.float32)
    for p in range(k):
        if not alive[p]:
            mix[p, p] = 1.0
            continue
        support = [p] + [int(n) for n in neighbors[p] if not det[n]]
        w = np.float32(1.0) / np.float32(len(support))
        for n in support:
            if alive[n]:
                mix[p, n] += w
            else:
                mix[p, p] += w          # undetected loss: keep own share
    return mix


def masked_gather_indices(neighbors: Sequence[Sequence[int]],
                          alive: np.ndarray, K: int,
                          detected: Optional[np.ndarray] = None
                          ) -> np.ndarray:
    """(k, K) neighborhood gather for DEFENDED gossip (median / trimmed
    mean over each gathered neighborhood): [self] + neighbors, with any
    dead or detected neighbor substituted by self so the neighborhood
    size stays the static K the sort kernel needs. A dead row gathers K
    copies of itself (its slot holds)."""
    alive = np.asarray(alive, bool)
    k = alive.shape[0]
    det = (np.zeros(k, bool) if detected is None
           else np.asarray(detected, bool))
    idx = np.empty((k, K), np.int64)
    for p in range(k):
        if not alive[p]:
            idx[p] = p
            continue
        row = [p] + [int(n) if (alive[n] and not det[n]) else p
                     for n in neighbors[p]]
        row = (row + [p] * K)[:K]
        idx[p] = row
    return idx
