"""Strategy plugin API (port of `repro.core.strategies`, the per-round
half): every FL architecture as one pluggable object driven by the
generic round driver in `core/simulation.py`.

    init_state           -> the strategy's mutable round state
    select_participants  -> RoundPlan: who trains this event, from which
                            base models
    local_spec           -> LocalSpec: the local objective
    aggregate_event      -> fold the uploads into the state through the
                            kernel-backed stacked operators
                            (`core/aggregation.py`)
    round_model / served_fn / extra_result -> metric + serving surface

The built-ins are the paper's three architectures: HFL, AFL and CFL.
The fused executor's `scan_*` hooks, fault-injection holds, attacks and
defenses, and the other registered strategies of the reference belong to
later slices of the port (ROADMAP §A.8, §A.9, §A.12, §A.13).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple, Type

import numpy as np

from repro_torch.core import aggregation as agg
from repro_torch.core import engine as engine_mod
from repro_torch.core import topology
from repro_torch.core.fl_types import DEFENSES
from repro_torch.models import cnn as cnn_mod

Params = Any


# ---------------------------------------------------------------------------
# plan / local-objective descriptors
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RoundPlan:
    """One aggregation event's schedule, as the strategy declared it.

    participants — absolute client ids in TRAINING ORDER (the order the
        rng-parity contract consumes batch permutations in).
    bases        — one round-start model per participant.
    event        — the aggregation-event index.
    meta         — strategy-private scratch carried to aggregate_event.
    """
    participants: List[int]
    bases: List[Params]
    event: int
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass(frozen=True)
class LocalSpec:
    """The local objective one event trains: `loss_fn(params, batch[,
    extra])` is the single-model loss (loop engine and the CFL pass);
    `stacked_loss_fn` its leading-client-axis twin. `extra="bases"`
    passes each participant's round-start model as the third argument."""
    loss_fn: Callable = cnn_mod.cnn_loss
    stacked_loss_fn: Callable = cnn_mod.cnn_loss_stacked
    extra: Optional[str] = None           # None | "bases"


# ---------------------------------------------------------------------------
# the Strategy protocol
# ---------------------------------------------------------------------------

class Strategy:
    """Base class of the plugin protocol (see module docstring).

    Class attributes (the declarative half):
      name        — registry key (`FLConfig.strategy`).
      topologies  — communication graphs the strategy supports.
      defenses    — {topology: valid defense names} at this strategy's
                    aggregation event (DESIGN.md §8/§9).
      centralized — True: the served model lives at a central server and
                    classification scores the full test set (paper
                    §1.2.7); False: on-device 1/N-shard classification.
    """

    name: str = ""
    topologies: Tuple[str, ...] = ("star",)
    defenses: Dict[str, Tuple[str, ...]] = {"star": DEFENSES}
    centralized = False

    def __init__(self, fl):
        self.fl = fl

    # -- validation ---------------------------------------------------------
    def active_topology(self) -> str:
        return self.topologies[0]

    def validate(self):
        """Raise if the config selects a topology this strategy does not
        declare, or a defense invalid at its aggregation event."""
        fl = self.fl
        topo = self.active_topology()
        if topo not in self.topologies:
            raise ValueError(
                f"topology {topo!r} is invalid for strategy "
                f"{self.name!r} (expected one of {self.topologies})")
        allowed = self.defenses.get(topo, ("none",))
        if fl.defense not in allowed:
            raise ValueError(
                f"defense {fl.defense!r} does not apply to the "
                f"{self.name}/{topo} aggregation event "
                f"(valid: {allowed}; DESIGN.md §8)")

    # -- lifecycle (override these) -----------------------------------------
    def init_state(self, sim) -> Any:
        raise NotImplementedError

    def num_events(self, sim) -> int:
        return self.fl.rounds

    def select_participants(self, sim, state, event: int,
                            rng: np.random.Generator) -> RoundPlan:
        raise NotImplementedError

    def local_spec(self, sim, state, plan) -> LocalSpec:
        return LocalSpec()

    def aggregate_event(self, sim, state, plan, uploads) -> Any:
        raise NotImplementedError

    def round_model(self, state) -> Params:
        raise NotImplementedError

    def served_fn(self, sim, state) -> Callable[[], Params]:
        state_ = state
        return lambda: self.round_model(state_)

    def extra_result(self, sim, state) -> Dict[str, Any]:
        return {}

    # -- default event driver (one generic synchronous round) ---------------
    def run_event(self, sim, state, event: int, rng=None):
        """plan -> local training (engine dispatch in the driver) ->
        aggregation. Returns (state, per-client accs, per-client losses).
        Every lifecycle phase is wrapped in a telemetry span."""
        rng = sim.rng if rng is None else rng
        tel = sim.telemetry
        with tel.span("round", cat="run", event=event):
            with tel.span("select", event=event):
                plan = self.select_participants(sim, state, event, rng)
                spec = self.local_spec(sim, state, plan)
            tel.append_series("participants", len(plan.participants))
            uploads, losses, accs = sim.local_train(plan, spec, rng)
            with tel.span("aggregate", event=event):
                state = self.aggregate_event(sim, state, plan, uploads)
        return state, accs, losses

    def warmup(self, sim):
        """Run every program the timed driver loop will run once, outside
        the build timer (DESIGN.md §3): kernel build and load, cuDNN
        set-up, allocator growth. The sim's own rng is untouched."""
        sim.warmup_default(self)

    def warmup_aggregate(self, sim):
        """Loop-engine half of the warmup: dry-run one aggregation event
        on dummy uploads, then the served model."""
        rng = np.random.default_rng(self.fl.seed)
        state = self.init_state(sim)
        plan = self.select_participants(sim, state,
                                        self.num_events(sim) - 1, rng)
        uploads = engine_mod.stack_forest(engine_mod.unstack_forest(
            engine_mod.replicate_tree(sim.init_params,
                                      len(plan.participants))))
        state = self.aggregate_event(sim, state, plan, uploads)
        self.served_fn(sim, state)()


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

STRATEGY_REGISTRY: Dict[str, Type[Strategy]] = {}


def register_strategy(cls: Type[Strategy]) -> Type[Strategy]:
    """Class decorator: register a Strategy subclass under `cls.name`."""
    if not cls.name:
        raise ValueError(f"{cls.__name__} needs a non-empty `name`")
    if cls.name in STRATEGY_REGISTRY:
        raise ValueError(f"duplicate strategy name {cls.name!r}")
    STRATEGY_REGISTRY[cls.name] = cls
    return cls


def get_strategy(name: str) -> Type[Strategy]:
    if name not in STRATEGY_REGISTRY:
        known = ", ".join(sorted(STRATEGY_REGISTRY))
        raise KeyError(f"unknown strategy {name!r} (known: {known})")
    return STRATEGY_REGISTRY[name]



# ---------------------------------------------------------------------------
# built-in strategies: the paper's three architectures
# ---------------------------------------------------------------------------

@register_strategy
class HFLStrategy(Strategy):
    """Centralized two-tier hierarchy (paper §2.1): every round all
    clients refine their group model; group servers aggregate (tier 1);
    the global server aggregates group models and disseminates every
    `hfl_global_every` rounds."""

    name = "hfl"
    topologies = ("hierarchical",)
    defenses = {"hierarchical": DEFENSES}
    centralized = True

    def init_state(self, sim):
        return {"groups": engine_mod.replicate_tree(sim.init_params,
                                                    self.fl.num_groups),
                "global": sim.init_params, "last": None}

    def select_participants(self, sim, state, event, rng):
        fl = self.fl
        per = fl.clients_per_group
        group_models = engine_mod.unstack_forest(state["groups"])
        plan = RoundPlan(list(range(fl.num_clients)),
                         [group_models[c // per]
                          for c in range(fl.num_clients)], event)
        # stacked bases (vectorized engine) without a per-client stack:
        # one repeat per leaf, built lazily
        groups = state["groups"]
        plan.meta["bases_stacked_fn"] = (
            lambda: engine_mod.repeat_groups(groups, per))
        return plan

    def aggregate_event(self, sim, state, plan, uploads):
        fl = self.fl
        w = np.asarray(sim.weights, np.float32)
        groups, gw = agg.hfl_tier1_stacked(uploads, fl.num_groups, w)
        global_model = state["global"]
        if ((plan.event + 1) % fl.hfl_global_every == 0
                or plan.event == fl.rounds - 1):
            global_model = agg.fedavg_stacked(groups, gw)
            groups = engine_mod.replicate_tree(global_model, fl.num_groups)
        return {"groups": groups, "global": global_model, "last": uploads}

    def round_model(self, state):
        return state["global"]

    def served_fn(self, sim, state):
        # the global server re-aggregates at classification time
        fl = self.fl
        w = np.asarray(sim.weights, np.float32)
        uploads = state["last"]
        return lambda: agg.hfl_aggregate_stacked(uploads, fl.num_groups, w)


@register_strategy
class AFLStrategy(Strategy):
    """Decentralized aggregated FL (paper §2.2): sample a participant
    subset, train locally, aggregate directly — masked FedAvg (star) or
    ring-neighbor gossip mixing (`afl_mode="gossip"`)."""

    name = "afl"
    topologies = ("star", "ring")
    defenses = {"star": DEFENSES,
                "ring": ("none", "median", "trimmed_mean")}

    def active_topology(self) -> str:
        return "ring" if self.fl.afl_mode == "gossip" else "star"

    def init_state(self, sim):
        return {"global": sim.init_params, "last": None}

    def select_participants(self, sim, state, event, rng):
        fl = self.fl
        parts = topology.sample_participants(rng, fl.num_clients,
                                             fl.participation)
        parts = [int(c) for c in parts]
        plan = RoundPlan(parts, [state["global"]] * len(parts), event)
        start, k = state["global"], len(parts)
        plan.meta["bases_stacked_fn"] = (
            lambda: engine_mod.replicate_tree(start, k))
        return plan

    def aggregate_event(self, sim, state, plan, uploads):
        fl = self.fl
        k = len(plan.participants)
        pw = np.asarray(sim.weights, np.float64)[plan.participants]
        if fl.afl_mode == "gossip":
            nbrs = topology.ring_neighbors(k, fl.gossip_neighbors)
            uploads = agg.gossip_stacked(uploads, nbrs, defense=fl.defense)
            global_model = agg.afl_aggregate_stacked(uploads, pw)
        else:
            global_model = agg.defended_aggregate_stacked(
                uploads, pw, defense=fl.defense, center=plan.bases[0])
        return {"global": global_model, "last": (uploads, pw)}

    def round_model(self, state):
        return state["global"]

    def served_fn(self, sim, state):
        fl = self.fl
        uploads, pw = state["last"]
        if fl.afl_mode == "gossip":
            return lambda: agg.afl_aggregate_stacked(uploads, pw)
        return lambda: agg.defended_aggregate_stacked(uploads, pw,
                                                      defense=fl.defense)


@register_strategy
class CFLStrategy(Strategy):
    """Decentralized continual FL (paper §2.3): the model passes client
    to client in an rng-permuted visit order; each local update merges
    into the evolving global parameters. Training and aggregation fuse,
    so the event runs through the driver's `sequential_round` (loop:
    per-visit host merges; vectorized: one pass over the visits with the
    kernel-backed merge)."""

    name = "cfl"
    topologies = ("sequential",)
    defenses = {"sequential": ("none", "norm_clip")}

    def init_state(self, sim):
        return {"model": sim.init_params}

    def select_participants(self, sim, state, event, rng):
        order = [int(c) for c in rng.permutation(self.fl.num_clients)]
        return RoundPlan(order, [state["model"]] * len(order), event)

    def run_event(self, sim, state, event, rng=None):
        rng = sim.rng if rng is None else rng
        tel = sim.telemetry
        with tel.span("round", cat="run", event=event):
            with tel.span("select", event=event):
                plan = self.select_participants(sim, state, event, rng)
            tel.append_series("participants", len(plan.participants))
            # training + merge fuse in sequential_round, which records
            # its own phase span
            model, losses, accs = sim.sequential_round(
                state["model"], plan.participants, self.fl.merge_alpha,
                self.local_spec(sim, state, plan), rng)
        return {"model": model}, accs, losses

    def aggregate_event(self, sim, state, plan, uploads):
        raise NotImplementedError(       # pragma: no cover
            "CFL fuses training and aggregation in sequential_round")

    def warmup_aggregate(self, sim):
        """Nothing to warm: the loop-engine CFL pass merges through
        eager host ops (covered by warmup_loop)."""

    def round_model(self, state):
        return state["model"]
