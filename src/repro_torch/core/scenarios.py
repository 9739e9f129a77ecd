"""Declarative scenario registry and result documents (port of
`repro.core.scenarios`): `ScenarioSpec` with the reference's fields and
defaults, its `to_fl_config` and `asdict`, all 41 of the reference's
registrations word for word, `run_scenario`, which returns the
reference's result document (schema v2.5), and `load_result`.

A spec names one point of the evaluation space:

    strategy x partition (iid / Dirichlet-alpha) x topology
             x heterogeneity (speed model, dropout, staleness decay)
             x adversary (attack type/fraction -> defense; DESIGN.md §8)
             x upload codec (topk / qsgd; DESIGN.md §12)
             x faults (profile, churn rate, quorum, MTD; DESIGN.md §15)
             x engine (loop / vectorized / fused)

`run_scenario(name)` builds the dataset and partition, runs the
simulation and returns the result document, every value a plain Python
type; `run(name)` returns the run's `FLResult`. Both run on the card
unless `device="cpu"` is passed. Every registration runs: the fused
executor (`engine="fused"`, one CUDA graph of a round replayed on the
card), the serving side-car (`serve=True`) and the Chrome trace
(`trace_out=` / `--trace-out`).

    PYTHONPATH=src python -m repro_torch.core.scenarios --list
    PYTHONPATH=src python -m repro_torch.core.scenarios \\
        --run iid-hfl-vec [--device cpu] [--json out.json] \\
        [--fault-profile mid] [--churn-rate 0.3] [--quorum-frac 0.6]
    PYTHONPATH=src python -m repro_torch.core.scenarios \\
        --run obs-trace-fused-16c --trace-out trace.json
    PYTHONPATH=src python -m repro_torch.core.scenarios --grid ci

The document written by `--json` diffs against the reference's
(`python -m repro.core.scenarios --run iid-hfl-vec --json ref.json`).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import Dict, List, Optional, Tuple, Union

from repro_torch.core.codecs import (CODEC_REGISTRY_VERSION, codec_names,
                                     get_codec)
from repro_torch.core.faults import FAULT_PROFILES
from repro_torch.core.fl_types import ARRIVALS, ATTACKS, FLConfig
from repro_torch.core.simulation import FederatedSimulation
from repro_torch.core.strategies import (STRATEGY_REGISTRY_VERSION,
                                         get_strategy)
from repro_torch.data.partition import dirichlet_partition
from repro_torch.data.synthetic import DATASETS

# The reference's result-document schema (DESIGN.md §6): v2.5 added the
# "faults" block, v2.4 "serving", v2.3 "telemetry" and the warmup/steady
# timing split, v2.2 "communication", v2.1 "strategy", v2 "attack".
# `load_result` reads the older versions.
RESULT_SCHEMA_VERSION = 2.5

# One output root for every result writer (env-overridable), as in the
# reference: `--json` with a bare filename lands under <root>/results/.
OUTPUT_DIR = os.environ.get("REPRO_OUTPUT_DIR", "experiments")


def output_path(*parts: str) -> str:
    """Join under the shared output root, creating directories."""
    path = os.path.join(OUTPUT_DIR, *parts)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    return path


PARTITIONS = ("iid", "dirichlet")
ENGINES = ("loop", "vectorized", "fused")


@dataclasses.dataclass(frozen=True)
class ScenarioSpec:
    """One named, fully specified federated run (the reference's fields
    and defaults; those of axes the port does not run yet must keep
    their defaults)."""
    name: str
    description: str
    strategy: str = "afl"            # any registered Strategy plugin
    topology: str = "star"           # see Strategy.topologies
    engine: str = "vectorized"       # loop | vectorized | fused
    # data
    dataset: str = "mnist"           # mnist | fashion
    partition: str = "iid"           # iid | dirichlet
    dirichlet_alpha: float = 0.5
    n_train: int = 512
    n_test: int = 256
    # federation shape / schedule
    num_clients: int = 8
    num_groups: int = 2
    rounds: int = 2
    local_epochs: int = 1
    local_batch_size: int = 32
    lr: float = 0.05
    momentum: float = 0.9
    participation: float = 1.0
    gossip_neighbors: int = 2
    merge_alpha: float = 0.5
    # heterogeneity (async strategy only)
    speed_model: str = "uniform"
    dropout: float = 0.0
    staleness_alpha: float = 0.6
    staleness_decay: float = 0.5
    updates_per_client: int = 2
    tick: float = 1.0
    # strategy-plugin knobs (fedprox / server-optimizer family)
    prox_mu: float = 0.01
    server_lr: float = 1.0
    server_momentum: float = 0.9
    # adversarial clients + robust aggregation (DESIGN.md §8)
    attack: str = "none"             # core/attacks.py
    attack_fraction: float = 0.25
    attack_scale: float = 1.0
    attack_placement: str = "random"  # random | colluding
    defense: str = "none"            # core/robust.py
    defense_f: int = 0               # 0 = derive from attack_fraction
    clip_tau: float = 10.0
    # fault injection / dynamic membership (DESIGN.md §15)
    fault_profile: str = "none"      # core/faults.py FAULT_PROFILES
    churn_rate: float = 0.3
    quorum_frac: float = 0.5
    heartbeat_timeout: int = 1
    fault_mtd: bool = False
    # upload codec (DESIGN.md §12)
    codec: str = "none"
    topk_frac: float = 0.1
    quant_bits: int = 8
    # observability
    telemetry: bool = True
    # federation-in-the-loop serving (DESIGN.md §14)
    serve: bool = False
    serve_qps: float = 64.0
    serve_arrival: str = "poisson"
    serve_batch: int = 8
    serve_max_wait: float = 0.05
    serve_queue: int = 64
    serve_round_duration: float = 1.0
    seed: int = 0

    def __post_init__(self):
        try:
            cls = get_strategy(self.strategy)
        except KeyError as e:
            raise ValueError(str(e)) from None
        if self.topology not in cls.topologies:
            raise ValueError(
                f"{self.name}: topology {self.topology!r} is invalid for "
                f"strategy {self.strategy!r} (expected one of "
                f"{cls.topologies})")
        if self.partition not in PARTITIONS:
            raise ValueError(f"unknown partition {self.partition!r}")
        if self.dataset not in DATASETS:
            raise ValueError(f"unknown dataset {self.dataset!r}")
        if self.engine not in ENGINES:
            raise ValueError(f"unknown engine {self.engine!r} "
                             f"(expected one of {ENGINES})")
        if self.engine == "fused" and not cls.supports_fused:
            raise ValueError(
                f"{self.name}: strategy {self.strategy!r} does not support "
                f"the fused executor (DESIGN.md §10)")
        if self.attack not in ATTACKS:
            raise ValueError(f"unknown attack {self.attack!r} "
                             f"(expected one of {ATTACKS})")
        allowed = cls.defenses.get(self.topology, ("none",))
        if self.defense not in allowed:
            raise ValueError(
                f"{self.name}: defense {self.defense!r} does not apply to "
                f"the {self.strategy}/{self.topology} aggregation event "
                f"(expected one of {allowed}; DESIGN.md §8)")
        if self.codec not in codec_names():
            raise ValueError(
                f"{self.name}: unknown codec {self.codec!r} "
                f"(registered: {codec_names()})")
        if self.codec != "none":
            codec_cls = get_codec(self.codec)
            if self.defense not in codec_cls.defenses:
                raise ValueError(
                    f"{self.name}: codec {self.codec!r} does not support "
                    f"defense {self.defense!r} (declared: "
                    f"{codec_cls.defenses}; DESIGN.md §12)")
            if codec_cls.stateful and cls.codec_seam != "driver":
                raise ValueError(
                    f"{self.name}: stateful codec {self.codec!r} needs the "
                    f"stacked driver upload seam, which strategy "
                    f"{self.strategy!r} does not use (DESIGN.md §12)")
        if self.fault_profile not in FAULT_PROFILES:
            raise ValueError(
                f"{self.name}: unknown fault profile "
                f"{self.fault_profile!r} (expected one of "
                f"{FAULT_PROFILES})")
        if self.fault_mtd and self.topology != "ring":
            raise ValueError(
                f"{self.name}: fault_mtd re-randomizes the GOSSIP ring "
                f"per round — it needs topology='ring' (DESIGN.md §15)")
        if self.serve and self.serve_arrival not in ARRIVALS:
            raise ValueError(
                f"{self.name}: unknown serve_arrival "
                f"{self.serve_arrival!r} (expected one of {ARRIVALS})")
        if self.attack_placement not in ("random", "colluding"):
            raise ValueError(
                f"{self.name}: unknown attack placement "
                f"{self.attack_placement!r} (expected random|colluding)")

    def to_fl_config(self) -> FLConfig:
        """The underlying FLConfig: an AFL ring topology selects gossip
        mode."""
        return FLConfig(
            strategy=self.strategy,
            num_clients=self.num_clients, num_groups=self.num_groups,
            rounds=self.rounds, local_epochs=self.local_epochs,
            local_batch_size=self.local_batch_size, lr=self.lr,
            momentum=self.momentum, participation=self.participation,
            afl_mode="gossip" if self.topology == "ring" else "fedavg",
            gossip_neighbors=self.gossip_neighbors,
            merge_alpha=self.merge_alpha, seed=self.seed,
            staleness_alpha=self.staleness_alpha,
            staleness_decay=self.staleness_decay,
            updates_per_client=self.updates_per_client,
            speed_model=self.speed_model, dropout=self.dropout,
            tick=self.tick, prox_mu=self.prox_mu,
            server_lr=self.server_lr,
            server_momentum=self.server_momentum,
            attack=self.attack, attack_fraction=self.attack_fraction,
            attack_scale=self.attack_scale,
            attack_placement=self.attack_placement,
            defense=self.defense,
            defense_f=self.defense_f, clip_tau=self.clip_tau,
            fault_profile=self.fault_profile,
            churn_rate=self.churn_rate, quorum_frac=self.quorum_frac,
            heartbeat_timeout=self.heartbeat_timeout,
            fault_mtd=self.fault_mtd,
            codec=self.codec, topk_frac=self.topk_frac,
            quant_bits=self.quant_bits, telemetry=self.telemetry,
            serve=self.serve, serve_qps=self.serve_qps,
            serve_arrival=self.serve_arrival,
            serve_batch=self.serve_batch,
            serve_max_wait=self.serve_max_wait,
            serve_queue=self.serve_queue,
            serve_round_duration=self.serve_round_duration,
            engine=self.engine)

    def asdict(self) -> Dict:
        return dataclasses.asdict(self)


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

REGISTRY: Dict[str, ScenarioSpec] = {}


def register(spec: ScenarioSpec) -> ScenarioSpec:
    if spec.name in REGISTRY:
        raise ValueError(f"duplicate scenario name {spec.name!r}")
    REGISTRY[spec.name] = spec
    return spec


def get(name: str) -> ScenarioSpec:
    if name not in REGISTRY:
        known = ", ".join(sorted(REGISTRY))
        raise KeyError(f"unknown scenario {name!r} (known: {known})")
    return REGISTRY[name]


def names() -> List[str]:
    return sorted(REGISTRY)


# Every registration of the reference, word for word and in its order.
# strategy x engine coverage on the paper's IID setting
register(ScenarioSpec(
    "iid-hfl-vec", "centralized two-tier HFL, IID shards, stacked engine",
    strategy="hfl", topology="hierarchical", local_epochs=2))
register(ScenarioSpec(
    "iid-hfl-loop", "loop-engine twin of iid-hfl-vec (paper-faithful "
    "per-client dispatch timing)",
    strategy="hfl", topology="hierarchical", local_epochs=2, engine="loop"))
register(ScenarioSpec(
    "iid-afl-vec", "decentralized AFL, 50% participation, masked FedAvg",
    strategy="afl", topology="star", participation=0.5, local_epochs=2))
register(ScenarioSpec(
    "iid-cfl-vec", "decentralized continual CFL, sequential client pass",
    strategy="cfl", topology="sequential"))
register(ScenarioSpec(
    "ring-gossip-vec", "AFL in gossip mode: ring-neighbor averaging, full "
    "participation",
    strategy="afl", topology="ring", participation=1.0))
# fused-executor twins (DESIGN.md §10)
register(ScenarioSpec(
    "iid-hfl-fused", "fused-executor twin of iid-hfl-vec: all rounds in "
    "one lax.scan, device-resident group/global state, in-scan "
    "dissemination schedule",
    strategy="hfl", topology="hierarchical", local_epochs=2,
    engine="fused"))
register(ScenarioSpec(
    "attack-signflip-median-fused", "sign-flip attackers vs the bitonic "
    "median kernel, corrupted and defended entirely inside the fused "
    "round scan",
    strategy="afl", topology="star", participation=1.0, engine="fused",
    attack="sign_flip", attack_scale=4.0, defense="median"))
# non-IID Dirichlet label skew — loop engine (uneven shards are the loop
# engine's territory: the stacked engine truncates to the federation-min
# batch count)
register(ScenarioSpec(
    "dirichlet-afl-loop", "AFL under Dirichlet(0.3) label skew",
    strategy="afl", topology="star", engine="loop", partition="dirichlet",
    dirichlet_alpha=0.3, participation=0.5, n_train=768))
register(ScenarioSpec(
    "dirichlet-hfl-loop", "HFL under mild Dirichlet(1.0) label skew",
    strategy="hfl", topology="hierarchical", engine="loop",
    partition="dirichlet", dirichlet_alpha=1.0, n_train=768))
# heterogeneous async runtime (DESIGN.md §5)
register(ScenarioSpec(
    "async-uniform-vec", "async staleness-aware merge, homogeneous "
    "clients (full-federation tick batches)",
    strategy="async", topology="event", speed_model="uniform"))
register(ScenarioSpec(
    "async-straggler-vec", "async with one 4x straggler: fast clients "
    "keep merging while the straggler's updates arrive stale",
    strategy="async", topology="event", speed_model="straggler"))
register(ScenarioSpec(
    "async-dropout-vec", "async where half the participants fail "
    "mid-run; the survivors' merges carry the model",
    strategy="async", topology="event", speed_model="uniform", dropout=0.5,
    updates_per_client=3))
register(ScenarioSpec(
    "async-lognormal-loop", "async under continuous LogNormal speeds "
    "(singleton batches — the loop engine's regime)",
    strategy="async", topology="event", engine="loop",
    speed_model="lognormal", tick=0.0))

# strategy plugins: FedProx (proximal local objective under label skew)
# and the server-optimizer family over the kernel-backed aggregate
register(ScenarioSpec(
    "fedprox-dirichlet-vec", "FedProx (mu=0.1) under Dirichlet(0.5) "
    "label skew: the proximal pull bounds client drift",
    strategy="fedprox", topology="star", partition="dirichlet",
    dirichlet_alpha=0.5, n_train=768, prox_mu=0.1, local_epochs=2))
register(ScenarioSpec(
    "fedprox-iid-loop", "FedProx on IID shards under the loop engine "
    "(mu=0.01 barely perturbs FedAvg — the sanity point)",
    strategy="fedprox", topology="star", engine="loop", prox_mu=0.01))
register(ScenarioSpec(
    "fedavgm-iid-vec", "FedAvgM: server momentum (0.9) over the round "
    "pseudo-gradient, kernel-backed aggregate",
    strategy="fedavgm", topology="star", local_epochs=2,
    server_lr=0.7, server_momentum=0.9))
register(ScenarioSpec(
    "fedadam-iid-vec", "FedAdam: server Adam over the round "
    "pseudo-gradient",
    strategy="fedadam", topology="star", local_epochs=2, server_lr=0.1))
register(ScenarioSpec(
    "fedadam-signflip-median-vec", "FedAdam composed with the "
    "adversarial axis: sign-flip attackers, median aggregate feeding "
    "the server optimizer",
    strategy="fedadam", topology="star", local_epochs=2, server_lr=0.1,
    attack="sign_flip", attack_scale=4.0, defense="median"))

# adversarial axis — attack x defense x architecture (DESIGN.md §8). The
# 32-client sign-flip family is the acceptance measurement: same data,
# schedule and seed, only the attack/defense toggles differ, so the
# macro-F1 deltas isolate the aggregation rule. Plain SGD at a larger
# step, as calibrated in the reference.
_ACC32 = dict(strategy="afl", topology="star", participation=1.0,
              num_clients=32, n_train=3072, n_test=512, rounds=10,
              local_epochs=2, lr=0.08, momentum=0.0)
register(ScenarioSpec(
    "attack-none-32c-vec", "32-client no-attack baseline of the "
    "acceptance family (recovery reference)", **_ACC32))
register(ScenarioSpec(
    "attack-signflip-fedavg-32c-vec", "25% sign-flip attackers vs PLAIN "
    "FedAvg — demonstrates the degradation robust aggregation prevents",
    attack="sign_flip", attack_scale=4.0, **_ACC32))
register(ScenarioSpec(
    "attack-signflip-median-32c-vec", "25% sign-flip attackers vs "
    "coordinate-wise median (robust_agg kernel)",
    attack="sign_flip", attack_scale=4.0, defense="median", **_ACC32))
register(ScenarioSpec(
    "attack-signflip-trimmed-32c-vec", "25% sign-flip attackers vs "
    "trimmed mean (robust_agg kernel, f from attack fraction)",
    attack="sign_flip", attack_scale=4.0, defense="trimmed_mean",
    **_ACC32))
# defense coverage across the other architectures / aggregation events
register(ScenarioSpec(
    "attack-gauss-hfl-krum-vec", "centralized HFL with Gaussian-noise "
    "attackers; Krum selection at each group server (tier 1)",
    strategy="hfl", topology="hierarchical", num_clients=16, n_train=1024,
    local_epochs=2, attack="gauss", attack_scale=3.0, defense="krum"))
register(ScenarioSpec(
    "attack-replace-cfl-clip-vec", "sequential CFL with a boosted "
    "model-replacement attacker; norm-clipped continual merges",
    strategy="cfl", topology="sequential", attack="model_replace",
    attack_fraction=0.15, attack_scale=10.0, defense="norm_clip",
    clip_tau=3.0))
register(ScenarioSpec(
    "attack-labelflip-afl-trimmed-loop", "data-layer label-flip "
    "poisoning under the loop engine; trimmed-mean aggregation",
    strategy="afl", topology="star", engine="loop", participation=1.0,
    attack="label_flip", defense="trimmed_mean"))
register(ScenarioSpec(
    "attack-signflip-gossip-median-vec", "decentralized ring gossip "
    "where each node median-mixes its neighborhood (Byzantine neighbors "
    "bounded without any server)",
    strategy="afl", topology="ring", participation=1.0,
    attack="sign_flip", attack_scale=4.0, defense="median"))
register(ScenarioSpec(
    "attack-gauss-async-clip-vec", "async staleness merges under "
    "Gaussian attackers; every arriving delta norm-clipped",
    strategy="async", topology="event", speed_model="uniform",
    attack="gauss", attack_scale=3.0, defense="norm_clip", clip_tau=3.0))

# communication axis — upload codecs on the wire (DESIGN.md §12). The
# acceptance pair is `comm-qsgd-accept-32c-vec` against its dense twin
# (same data, schedule and seed; only the codec toggles): the
# reference's bar is >= 3.5x uplink compression with macro-F1 within
# 0.02 of the dense run. The pair runs the 32-client basis for 12 rounds.
register(ScenarioSpec(
    "comm-topk-afl-vec", "top-k sparsification (10% of coordinates) with "
    "error-feedback residuals on the AFL star",
    strategy="afl", topology="star", participation=1.0, local_epochs=2,
    codec="topk", topk_frac=0.1))
register(ScenarioSpec(
    "comm-qsgd-hfl-fused", "int8 stochastic quantization under the fused "
    "executor: dequantize-and-aggregate inside the round scan",
    strategy="hfl", topology="hierarchical", engine="fused",
    local_epochs=2, codec="qsgd"))
register(ScenarioSpec(
    "comm-qsgd-signflip-median-vec", "the codec x adversary crossing: "
    "sign-flip attackers quantized on the wire, median aggregation over "
    "the dequantized coordinates",
    strategy="afl", topology="star", participation=1.0, codec="qsgd",
    attack="sign_flip", attack_scale=4.0, defense="median"))
register(ScenarioSpec(
    "comm-topk-async-loop", "top-k + error feedback riding the async "
    "merge batches under the loop engine",
    strategy="async", topology="event", engine="loop",
    speed_model="uniform", codec="topk", topk_frac=0.25))
_COMM32 = dict(_ACC32, rounds=12)
register(ScenarioSpec(
    "comm-dense-accept-32c-vec", "32-client dense reference of the "
    "codec acceptance pair (the macro-F1 baseline qsgd is held to)",
    **_COMM32))
register(ScenarioSpec(
    "comm-qsgd-accept-32c-vec", "32-client qsgd acceptance run: the "
    "dense twin with int8 uploads (~4x uplink compression at matched "
    "macro-F1)",
    codec="qsgd", **_COMM32))

# observability (DESIGN.md §13): the trace-demo scenario, a fused run
# whose point is its Chrome trace
register(ScenarioSpec(
    "obs-trace-fused-16c", "16-client fused sign-flip/median run for "
    "the telemetry trace demo (make trace-demo / the CI trace artifact)",
    strategy="afl", topology="star", engine="fused", participation=1.0,
    num_clients=16, rounds=4, n_train=1024, attack="sign_flip",
    attack_scale=4.0, defense="median"))

# federation-in-the-loop serving (DESIGN.md §14)
register(ScenarioSpec(
    "serve-iid-fused", "fused-executor HFL with the serving side-car: "
    "per-round global models stacked in-scan, hot-swap replayed at "
    "round boundaries, Poisson traffic",
    strategy="hfl", topology="hierarchical", local_epochs=2,
    engine="fused", serve=True))
register(ScenarioSpec(
    "serve-hfl-burst", "centralized HFL under on/off burst traffic: "
    "3x-rate bursts against the bounded queue — occupancy high, "
    "overflow shed and accounted",
    strategy="hfl", topology="hierarchical", local_epochs=2, serve=True,
    serve_arrival="burst", serve_qps=256.0, serve_batch=4,
    serve_queue=8, serve_max_wait=0.02))
register(ScenarioSpec(
    "serve-qsgd-signflip-median", "the full-stack crossing: sign-flip "
    "attackers quantized on the wire, median-defended aggregation, and "
    "the surviving global model served under diurnal traffic",
    strategy="afl", topology="star", participation=1.0, codec="qsgd",
    attack="sign_flip", attack_scale=4.0, defense="median", serve=True,
    serve_arrival="diurnal"))

# churn-tolerant runtime (DESIGN.md §15). The acceptance PAIR is
# `churn-signflip-median-mtd` against its `-static` twin: same data,
# schedule, seed and churn; only the per-round moving-target ring
# re-randomization toggles, against colluding sign-flip neighborhoods
# (attackers at even ids sandwich every other ring position; on the
# static degree-4 ring each attacker's gather window holds 3 corrupt
# values of 5, saturating the median).
register(ScenarioSpec(
    "churn-afl-gossip-mtd", "clean gossip ring under 30% crash/rejoin "
    "churn with per-round moving-target re-randomization, fused "
    "executor (fault schedule as precomputed scan inputs)",
    strategy="afl", topology="ring", engine="fused", participation=1.0,
    fault_profile="churn", churn_rate=0.3, fault_mtd=True))
register(ScenarioSpec(
    "churn-hfl-quorum", "centralized HFL under mid-severity faults with "
    "a strict quorum: below-quorum groups hold their round-start model, "
    "below-quorum rounds hold the hierarchy",
    strategy="hfl", topology="hierarchical", local_epochs=2,
    fault_profile="mid", quorum_frac=0.6))
_CHURN32 = dict(_ACC32, topology="ring", attack="sign_flip",
                attack_scale=1.5, attack_placement="colluding",
                defense="median", gossip_neighbors=4,
                fault_profile="churn", churn_rate=0.3)
register(ScenarioSpec(
    "churn-signflip-median-mtd", "32-client acceptance run: colluding "
    "sign-flip neighborhoods on the gossip ring under 30% churn, median "
    "defense, WITH per-round moving-target re-randomization",
    fault_mtd=True, **_CHURN32))
register(ScenarioSpec(
    "churn-signflip-median-static", "static-ring twin of "
    "churn-signflip-median-mtd (the colluding sandwich persists every "
    "round — the baseline MTD is measured against)",
    fault_mtd=False, **_CHURN32))

# the reference's CI bench-smoke grid (`--grid ci`)
CI_SMOKE_GRID: Tuple[str, ...] = (
    "iid-hfl-vec", "ring-gossip-vec", "async-straggler-vec",
    "attack-replace-cfl-clip-vec", "fedprox-dirichlet-vec",
    "fedadam-iid-vec", "iid-hfl-fused", "comm-qsgd-signflip-median-vec",
    "serve-iid-fused")

# the port's groupings of the registrations, read by chip_smoke.py
BASELINE_SCENARIOS = ("iid-hfl-vec", "iid-hfl-loop", "iid-afl-vec",
                      "iid-cfl-vec", "ring-gossip-vec", "dirichlet-hfl-loop",
                      "dirichlet-afl-loop")
ASYNC_SCENARIOS = ("async-uniform-vec", "async-straggler-vec",
                   "async-dropout-vec", "async-lognormal-loop",
                   "attack-gauss-async-clip-vec")
CODEC_SCENARIOS = ("comm-topk-afl-vec", "comm-qsgd-signflip-median-vec",
                   "comm-topk-async-loop", "comm-dense-accept-32c-vec",
                   "comm-qsgd-accept-32c-vec")
COMM_ACCEPTANCE_PAIR = ("comm-qsgd-accept-32c-vec",
                        "comm-dense-accept-32c-vec")
CHURN_SCENARIOS = ("churn-afl-gossip-mtd", "churn-hfl-quorum",
                   "churn-signflip-median-mtd",
                   "churn-signflip-median-static")
ACCEPTANCE_FAMILY = ("attack-none-32c-vec", "attack-signflip-fedavg-32c-vec",
                     "attack-signflip-median-32c-vec",
                     "attack-signflip-trimmed-32c-vec")
FUSED_SCENARIOS = ("iid-hfl-fused", "attack-signflip-median-fused",
                   "churn-afl-gossip-mtd", "comm-qsgd-hfl-fused")
SERVE_SCENARIOS = ("serve-iid-fused", "serve-hfl-burst",
                   "serve-qsgd-signflip-median")
# the telemetry trace demo: its point is the Chrome trace
TRACE_DEMO = "obs-trace-fused-16c"


# ---------------------------------------------------------------------------
# resolution + execution
# ---------------------------------------------------------------------------

def resolve(spec: ScenarioSpec, device="cuda",
            model_init=None) -> FederatedSimulation:
    """Spec -> FederatedSimulation on `device`, with the dataset built and
    the partition applied. `model_init` passes through to the simulation
    (the parity tests inject the reference's initial parameters there)."""
    ds = DATASETS[spec.dataset](seed=spec.seed, n_train=spec.n_train,
                                n_test=spec.n_test)
    sim = FederatedSimulation(spec.to_fl_config(), ds, model_init=model_init,
                              device=device)
    if spec.partition == "dirichlet":
        # every client must fill at least one local batch
        sim.set_partition(dirichlet_partition(
            ds["train"][1], spec.num_clients, alpha=spec.dirichlet_alpha,
            seed=spec.seed, min_per_client=spec.local_batch_size))
    return sim


def run(name, device="cuda"):
    """Run one scenario (a registered name or a ScenarioSpec) on `device`
    and return its FLResult."""
    spec = get(name) if isinstance(name, str) else name
    return resolve(spec, device).run()


def communication_block(result) -> Optional[Dict]:
    """The result document's `communication` block of a run (None for a
    dense run): the run's byte-count cost model with the codec registry
    version."""
    comm = result.extra.get("communication")
    if comm is None:
        return None
    return {**comm, "registry_version": CODEC_REGISTRY_VERSION}


def run_scenario(scenario: Union[str, ScenarioSpec], device="cuda",
                 trace_out: Optional[str] = None, model_init=None,
                 build_hook=None) -> Dict:
    """Run one scenario on `device` and return the reference's result
    document (schema v2.5, DESIGN.md §6), block for block.
    `rounds_per_s` is sync rounds (or async merge batches) per second of
    build time. `trace_out` additionally writes the run's Chrome-trace
    JSON there (open it in Perfetto or chrome://tracing). `model_init` is
    the simulation's (see `resolve`) and `build_hook` is entered around
    its build window (`FederatedSimulation.build_hook`, e.g.
    `obs.collectors.device_window`); neither is an option of the run."""
    spec = get(scenario) if isinstance(scenario, str) else scenario
    sim = resolve(spec, device, model_init)
    sim.build_hook = build_hook
    r = sim.run()
    if trace_out:
        from repro_torch.obs import write_chrome_trace
        write_chrome_trace(sim.telemetry, trace_out)
    async_block = None
    units = spec.rounds
    if sim.strategy.timeline_result:
        async_block = {k: r.extra.get(k) for k in
                       ("merges", "batches", "mean_staleness", "makespan",
                        "dropped_clients", "participants")}
        units = r.extra.get("batches", spec.rounds)
    attack_block = None
    if spec.attack != "none" or spec.defense != "none":
        # the Byzantine allowance applied at one aggregation event: the
        # strategy declares its event size (an HFL group, AFL's sampled
        # participants)
        attack_block = {
            "attack": spec.attack,
            "fraction": spec.attack_fraction,
            "scale": spec.attack_scale,
            "attacked_clients": [int(c) for c in sim.attackers],
            "defense": spec.defense,
            "defense_f": sim.fl.resolved_defense_f(
                sim.strategy.event_size()),
            "clip_tau": spec.clip_tau,
        }
    return {
        "schema_version": RESULT_SCHEMA_VERSION,
        "scenario": spec.name,
        "spec": spec.asdict(),
        "strategy": {
            "plugin": sim.strategy.name,
            "registry_version": STRATEGY_REGISTRY_VERSION,
        },
        "metrics": {
            "test_accuracy": r.test_accuracy,
            "train_accuracy": r.train_accuracy,
            "precision": r.precision, "recall": r.recall, "f1": r.f1,
            "balanced_accuracy": r.balanced_accuracy,
        },
        "timing": {
            "build_time_s": r.build_time_s,
            "warmup_time_s": r.warmup_time_s,
            "steady_time_s": r.steady_time_s,
            "classification_time_s": r.classification_time_s,
            "rounds_per_s": (units / r.build_time_s
                             if r.build_time_s > 0 else 0.0),
        },
        "async": async_block,
        "attack": attack_block,
        "communication": communication_block(r),
        "telemetry": r.extra.get("telemetry"),
        "serving": r.extra.get("serving"),
        "faults": r.extra.get("faults"),
    }


def load_result(doc: Dict) -> Dict:
    """A result document of any schema version, upgraded to the current
    one (the reference's `load_result`): v1 documents read as unattacked,
    v2 as carrying the spec's strategy with a null registry version, v2.1
    as dense, v2.2 as untraced, v2.3 as train-only and v2.4 as fault-free
    runs. An unknown version raises ValueError."""
    v = doc.get("schema_version")
    if v == RESULT_SCHEMA_VERSION:
        return doc
    if v not in (2.4, 2.3, 2.2, 2.1, 2, 1):
        raise ValueError(f"unknown result schema_version {v!r}")
    added = {"faults": None}                                  # v2.4
    if v in (2.3, 2.2, 2.1, 2, 1):
        added["serving"] = None
    if v in (2.2, 2.1, 2, 1):
        added["telemetry"] = None
    if v in (2.1, 2, 1):
        added["communication"] = None
    if v in (2, 1):
        plugin = (doc.get("spec") or {}).get("strategy")
        added["strategy"] = {"plugin": plugin, "registry_version": None}
    if v == 1:
        added["attack"] = None
    return {**doc, "schema_version": RESULT_SCHEMA_VERSION, **added}


def main(argv: Optional[List[str]] = None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--list", action="store_true",
                    help="print the registry and exit")
    ap.add_argument("--run", nargs="+", metavar="NAME",
                    help="run the named scenario(s)")
    ap.add_argument("--grid", choices=["ci"],
                    help="run a predefined grid (ci = the bench-smoke set)")
    ap.add_argument("--json", metavar="PATH",
                    help="also write the result documents as a JSON list "
                         f"(bare filenames land under {OUTPUT_DIR}/results/)")
    ap.add_argument("--trace-out", metavar="PATH",
                    help="write the run's Chrome-trace JSON (one --run "
                         "scenario)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--fault-profile", choices=FAULT_PROFILES,
                    help="override every selected scenario's fault "
                         "profile (DESIGN.md §15)")
    ap.add_argument("--churn-rate", type=float,
                    help="override the fault schedule's churn/severity "
                         "rate (fraction in [0,1])")
    ap.add_argument("--quorum-frac", type=float,
                    help="override the quorum threshold fraction an "
                         "aggregation event needs to proceed")
    args = ap.parse_args(argv)
    overrides = {k: v for k, v in (("fault_profile", args.fault_profile),
                                   ("churn_rate", args.churn_rate),
                                   ("quorum_frac", args.quorum_frac))
                 if v is not None}
    if args.trace_out and not (args.run and len(args.run) == 1
                               and not args.grid):
        ap.error("--trace-out needs exactly one --run scenario")
    if args.list or not (args.run or args.grid):
        for n in names():
            s = REGISTRY[n]
            adv = ("clean" if s.attack == "none" and s.defense == "none"
                   else f"{s.attack}->{s.defense}")
            print(f"{n:34s} {s.strategy}/{s.topology}/{s.engine:10s} "
                  f"clients={s.num_clients:<3d} {adv:24s} {s.description}")
        return
    todo = list(args.run or []) + (list(CI_SMOKE_GRID) if args.grid else [])
    results = []
    for name in todo:
        spec = get(name)
        if overrides:
            # dataclasses.replace re-runs __post_init__, so an invalid
            # override combination fails before any training
            spec = dataclasses.replace(spec, **overrides)
        t0 = time.perf_counter()
        res = run_scenario(spec, device=args.device,
                           trace_out=args.trace_out)
        results.append(res)
        m, t = res["metrics"], res["timing"]
        faults, comm = res["faults"], res["communication"]
        tail = ("" if faults is None else
                f" quorum_failures={faults['quorum_failures']} "
                f"mean_alive_frac={faults['mean_alive_frac']:.3f}")
        if comm is not None:
            tail += (f" uplink_bytes={comm['uplink_bytes']} "
                     f"compression={comm['compression_ratio']:.4f}")
        print(f"{name}: test_acc={m['test_accuracy']:.3f} f1={m['f1']:.3f} "
              f"build={t['build_time_s']:.2f}s "
              f"rounds_per_s={t['rounds_per_s']:.3f}{tail} "
              f"({time.perf_counter() - t0:.1f}s on {args.device})",
              flush=True)
    if args.json:
        path = (args.json if os.path.dirname(args.json)
                else output_path("results", args.json))
        with open(path, "w") as f:
            json.dump(results, f, indent=1)
        print(f"results -> {path}")
    if args.trace_out:
        print(f"trace -> {args.trace_out}")


if __name__ == "__main__":
    main()
