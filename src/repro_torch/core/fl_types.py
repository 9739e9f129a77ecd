"""Federated-learning configuration types."""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

# The paper's three architectures. Since PR 4 `FLConfig.strategy` may
# name ANY strategy registered in `core.strategies.STRATEGY_REGISTRY`
# ("async", "fedprox", "fedavgm", "fedadam", third-party plugins);
# membership is validated against the registry when the simulation
# resolves the strategy (this module stays dependency-free).
STRATEGIES = ("hfl", "afl", "cfl")
ENGINES = ("loop", "vectorized", "fused")

# Adversarial axis (DESIGN.md §8). Canonical names live here (the only
# dependency-free core module) so `core.attacks`, `core.robust`,
# `core.scenarios`, and this config all validate against one vocabulary.
ATTACKS = ("none", "sign_flip", "gauss", "label_flip", "model_replace")
DEFENSES = ("none", "median", "trimmed_mean", "norm_clip", "krum",
            "multi_krum")

# Serving traffic shapes (DESIGN.md §14): deterministic open-loop arrival
# processes for the federation-in-the-loop serving engine.
ARRIVALS = ("poisson", "burst", "diurnal")


@dataclasses.dataclass(frozen=True)
class FLConfig:
    """Configuration for one federated training run.

    strategy:
      hfl — Centralized Hierarchical FL: clients -> group servers -> global
            server, two-tier FedAvg (paper §2.1).
      afl — Decentralized Aggregated FL: a sampled subset of peers trains
            locally then aggregates directly (paper §2.2). `afl_mode`
            selects the aggregation mechanism: "fedavg" (masked weighted
            average over participants) or "gossip" (ring neighbor
            averaging via collective-permute — the scalable decentralized
            variant; see DESIGN.md §2).
      cfl — Decentralized Continual FL: local models updated continually,
            merged into the evolving global parameters (paper §2.3). At
            host scale this is the sequential client-to-client pass; at
            pod scale it is the EMA-style continual merge (adaptation
            noted in DESIGN.md).
    """
    strategy: str = "afl"
    num_clients: int = 8
    # hfl
    num_groups: int = 2
    hfl_global_every: int = 2      # rounds between GLOBAL-tier aggregations
                                   # (groups refine locally in between —
                                   # the hierarchy's dissemination lag)
    # afl
    participation: float = 0.5     # fraction of clients sampled per round
    afl_mode: str = "fedavg"       # fedavg | gossip
    gossip_neighbors: int = 2      # ring degree for gossip mode
    # cfl
    merge_alpha: float = 0.5       # continual-merge rate
    # async (strategy="async": the tick-batch heterogeneous runtime —
    # DESIGN.md §5; defaults mirror the legacy AsyncSimulation wrapper)
    staleness_alpha: float = 0.6   # FedAsync base merge rate
    staleness_decay: float = 0.5   # polynomial staleness exponent
    updates_per_client: int = 4    # arrivals per surviving participant
    speed_model: str = "lognormal"  # uniform | lognormal | straggler
    dropout: float = 0.0           # fraction of participants that fail
    tick: float = 0.0              # arrival-time quantization grid
    # fedprox (strategy="fedprox": proximal local objective)
    prox_mu: float = 0.01          # proximal term weight mu
    # server-optimizer family (strategy="fedavgm" | "fedadam": the round
    # aggregate applied as a pseudo-gradient through a server optimizer)
    server_lr: float = 1.0         # server step size (1.0 + momentum 0
                                   # degenerates to plain FedAvg)
    server_momentum: float = 0.9   # FedAvgM server momentum
    # local optimization
    local_epochs: int = 1
    local_batch_size: int = 32
    lr: float = 0.05
    momentum: float = 0.9
    rounds: int = 20
    seed: int = 0
    # pod-scale trainer
    local_steps: int = 4           # K local steps between aggregation events
    aggregate_every: int = 1       # rounds between aggregation events
    # adversarial clients + robust aggregation (DESIGN.md §8)
    attack: str = "none"           # none | sign_flip | gauss | label_flip
                                   # | model_replace (core/attacks.py)
    attack_fraction: float = 0.25  # fraction of clients that are Byzantine
    attack_scale: float = 1.0      # attack magnitude (flip/boost factor,
                                   # gaussian sigma)
    defense: str = "none"          # none | median | trimmed_mean |
                                   # norm_clip | krum | multi_krum
                                   # (core/robust.py; which defense is
                                   # valid at which aggregation event is
                                   # strategy-dependent — DESIGN.md §8)
    defense_f: int = 0             # assumed Byzantine count (0 = derive
                                   # from attack_fraction, floor 1)
    clip_tau: float = 10.0         # norm_clip: max L2 of an update delta
    # fused-executor scaling (DESIGN.md §11). mesh_devices > 1 runs the
    # fused scan under shard_map with the stacked client axis partitioned
    # over a 1-D "data" mesh of that many devices (local training is
    # embarrassingly parallel per shard; aggregation events lower to
    # collectives). fused_chunk > 0 trains the participant stack in
    # sub-stacks of that size (lax.map over chunks), bounding peak
    # training-activation memory — the fallback that lifts the client
    # sweep past the single-stack memory ceiling.
    mesh_devices: int = 0          # 0/1 = single-device fused scan
    fused_chunk: int = 0           # 0 = whole participant stack at once
    # upload codec (DESIGN.md §12). Names any codec registered in
    # `core.codecs.CODEC_REGISTRY` ("none", "topk", "qsgd", plugins);
    # like `strategy`, membership is validated when the simulation
    # resolves the codec (this module stays dependency-free).
    # codec="none" runs the exact pre-codec upload path (bitwise).
    codec: str = "none"
    topk_frac: float = 0.1         # topk: fraction of coordinates kept
    quant_bits: int = 8            # qsgd: 8 (int8 + scale) | 16 (bf16)
    # federation-in-the-loop serving (DESIGN.md §14). serve=True runs the
    # request-serving engine alongside training: an open-loop synthetic
    # traffic generator (its OWN seed fold — it never consumes the run
    # rng, so training stays bitwise identical with serving on or off)
    # feeds a micro-batching engine in VIRTUAL time, and every round
    # boundary hot-swaps the freshly aggregated global model into the
    # double-buffered serving slot without draining in-flight batches.
    serve: bool = False
    serve_qps: float = 64.0        # mean offered load (requests / virtual s)
    serve_arrival: str = "poisson"  # poisson | burst | diurnal
    serve_batch: int = 8           # micro-batch admission cap
    serve_max_wait: float = 0.05   # max queue wait before dispatch (virtual s)
    serve_queue: int = 64          # bounded queue depth (overflow is shed)
    serve_round_duration: float = 1.0  # virtual seconds of traffic per round
    serve_service_base: float = 0.004  # service-time model: base latency (s)
    serve_service_per_item: float = 0.001  # + per-request cost (s)
    serve_dispatch: bool = True    # run the real compiled classify per batch
                                   # (False: pure queueing simulation)
    # telemetry (DESIGN.md §13). On by default: the host tracer records
    # lifecycle spans/counters and the fused executor adds in-scan
    # per-round counters — results are bitwise identical either way and
    # the rounds/s overhead is gated at <=5% (benchmarks/ci_bench.py
    # "obs" section). False runs the exact untraced driver.
    telemetry: bool = True
    # fault injection + dynamic membership (DESIGN.md §15). Names a
    # profile in `core.faults.FAULT_PROFILES`; "none" builds no schedule
    # at all (every fault seam is a host-level `if`, so the traced
    # programs and results stay bitwise identical to a fault-free
    # build). An active profile compiles, from the run seed through a
    # private salt, per-round alive masks + heartbeat/rejoin schedules
    # consumed identically by all engines; aggregation events degrade
    # gracefully under partial membership (masked-weight renormalize /
    # hold / skip) gated by `quorum_frac`.
    fault_profile: str = "none"    # none | churn | dropout | straggler
                                   # | flaky | mid
    churn_rate: float = 0.3        # profile severity (dead fraction /
                                   # loss rate / slow-set fraction)
    quorum_frac: float = 0.5       # min alive fraction for an event to
                                   # aggregate (below: degraded action)
    heartbeat_timeout: int = 1     # missed rounds before neighbors
                                   # declare a peer failed (decay)
    fault_mtd: bool = False        # moving-target defense: re-randomize
                                   # the gossip ring every round
    # attacker placement: "random" (rng-salted choice — the pre-fault
    # default, bitwise) or "colluding" (attackers packed on even ring
    # positions so static-ring neighborhoods are sandwiched — the
    # adversary the moving-target topology is measured against)
    attack_placement: str = "random"
    # simulation engine
    engine: str = "loop"           # loop       — per-client Python loop
                                   #              (paper-faithful timing: one
                                   #              dispatch per client)
                                   # vectorized — whole federation stacked,
                                   #              one vmap-of-scan dispatch
                                   #              per round + kernel-backed
                                   #              aggregation (see
                                   #              core/engine.py)
                                   # fused      — the vectorized engine's
                                   #              stacked state, with ALL
                                   #              rounds compiled into one
                                   #              lax.scan: client pytree,
                                   #              optimizer and strategy
                                   #              state device-resident for
                                   #              the whole run, one
                                   #              device->host transfer at
                                   #              the end (DESIGN.md §10;
                                   #              sync strategies only)

    def __post_init__(self):
        # strategy membership is validated against the plugin registry by
        # the simulation driver (plugins register names this module
        # cannot know); only the shape of the field is checked here
        assert isinstance(self.strategy, str) and self.strategy, \
            self.strategy
        assert self.engine in ENGINES, self.engine
        assert self.attack in ATTACKS, self.attack
        assert self.defense in DEFENSES, self.defense
        if self.strategy == "hfl":
            assert self.num_clients % self.num_groups == 0, \
                "clients must divide evenly into groups"
        assert self.mesh_devices >= 0, self.mesh_devices
        assert self.fused_chunk >= 0, self.fused_chunk
        assert isinstance(self.codec, str) and self.codec, self.codec
        assert 0.0 < self.topk_frac <= 1.0, self.topk_frac
        assert self.quant_bits in (8, 16), self.quant_bits
        if self.mesh_devices > 1 and self.codec != "none":
            raise ValueError(
                "upload codecs do not yet compose with the mesh-sharded "
                "fused executor (per-shard codec state and collective "
                "dequantize are future work — DESIGN.md §12); run "
                "mesh_devices<=1 or codec='none'")
        if self.serve and self.mesh_devices > 1:
            raise ValueError(
                "serving does not yet compose with the mesh-sharded "
                "fused executor (the shard_map out_specs describe the "
                "bare metric triple — stacking per-round served models "
                "per shard is future work, like the in-scan telemetry "
                "counters; DESIGN.md §14); run mesh_devices<=1 or "
                "serve=False")
        if self.serve:
            assert self.serve_arrival in ARRIVALS, self.serve_arrival
            assert self.serve_qps > 0, self.serve_qps
            assert self.serve_batch >= 1, self.serve_batch
            assert self.serve_max_wait >= 0, self.serve_max_wait
            assert self.serve_queue >= self.serve_batch, \
                "queue depth below the batch cap can never fill a batch"
            assert self.serve_round_duration > 0, self.serve_round_duration
            assert self.serve_service_base >= 0, self.serve_service_base
            assert self.serve_service_per_item >= 0, \
                self.serve_service_per_item
        assert isinstance(self.fault_profile, str) and self.fault_profile, \
            self.fault_profile
        assert 0.0 <= self.churn_rate <= 1.0, self.churn_rate
        assert 0.0 <= self.quorum_frac <= 1.0, self.quorum_frac
        assert self.heartbeat_timeout >= 1, self.heartbeat_timeout
        assert self.attack_placement in ("random", "colluding"), \
            self.attack_placement
        if self.fault_mtd and self.fault_profile == "none":
            raise ValueError(
                "fault_mtd re-randomizes the gossip ring from the FAULT "
                "schedule rng — it needs an active fault_profile "
                "(DESIGN.md §15); set fault_profile or drop fault_mtd")
        if self.mesh_devices > 1 and self.engine != "fused":
            raise ValueError(
                "mesh_devices only applies to the fused executor "
                "(engine='fused'); the per-round engines are "
                "single-device")

    @property
    def clients_per_group(self) -> int:
        return self.num_clients // self.num_groups

    def resolved_defense_f(self, event_size: Optional[int] = None) -> int:
        """The Byzantine count the defense assumes at one aggregation
        event: explicit `defense_f` if set, else `attack_fraction` of the
        event's client count (floor 1 — the field's 0.25 default also
        sizes defense-only runs) — clamped to the breakdown point
        `(n-1)//2` the event can actually tolerate. `event_size` is the
        number of clients aggregated (an HFL tier-1 group sees only its
        own slice of the federation; defaults to the full federation)."""
        n = self.num_clients if event_size is None else event_size
        f = self.defense_f if self.defense_f > 0 else max(
            1, math.ceil(self.attack_fraction * n))
        return max(0, min(f, (n - 1) // 2))
