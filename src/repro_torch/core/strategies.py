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

The built-ins are the paper's three architectures (HFL, AFL, CFL), the
plugins FedProx, FedAvgM and FedAdam, and the async runtime
(`core/async_agg.py`, loaded on first lookup). Every round runs the
adversarial seam of DESIGN.md §8 and the upload seam of §12: uploads are
corrupted (`sim.corrupt`), then shipped through the active codec
(`sim.transport`), between local training and the defended aggregation
event; CFL ships per visit inside `sim.sequential_round`. Under fault
injection (DESIGN.md §15) every event reads its fault view from the
round driver: dead participants' uploads carry zero weight, a
below-quorum event holds its round-start state, HFL holds below-quorum
groups, and AFL gossip mixes through the schedule's per-round masked
matrix (the `gossip_mix_agg` kernel) or, defended, its gathered
neighborhoods.

A strategy may also opt into the FUSED executor (`engine="fused"`,
DESIGN.md §10): the whole run's state stays on the device and one round
is one function of device tensors — captured once as a CUDA graph and
replayed every round on the card, run eagerly round by round on the CPU.
The traceable half of the protocol — `scan_round` (the default wraps the
lifecycle pieces), `scan_bases`, `scan_aggregate`, `scan_carry` /
`scan_uncarry`, `scan_extra_xs`, `fault_scan_kwargs`, `scan_telemetry` —
lives on the Strategy too; `supports_fused` declares the opt-in (async
cannot fuse: its tick batches are data-dependent).

The MESH-sharded fused executor (`mesh_devices=N`, DESIGN.md §11) runs the
same round body in every rank of a `launch.mesh.World` on the rank's
contiguous sub-stack of clients: `supports_mesh` declares the opt-in,
`scan_carry_sharding` which carry entries carry the client axis,
`validate_mesh` the strategy's own preconditions, and `scan_aggregate`
lowers its event to the mesh operators of `core/aggregation.py` when
`fx.mesh_axis` is set (HFL: shard-local tier 1, one all_reduce at tier 2;
AFL: one all_reduce, gossip the masked all-to-all mix; server optimizers
step the replicated global model). CFL stays single-device.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import (Any, Callable, Dict, List, Optional, Sequence, Tuple,
                    Type)

import numpy as np
import torch

from repro_torch.core import aggregation as agg
from repro_torch.core import collectives
from repro_torch.core import engine as engine_mod
from repro_torch.core import faults as faults_mod
from repro_torch.core import topology
from repro_torch.core.fl_types import DEFENSES
from repro_torch.models import cnn as cnn_mod
from repro_torch.optim import optimizers
from repro_torch.tree import tree_leaves, tree_map

Params = Any

# Bump when the Strategy protocol or the registry's semantics change in a
# way a result document's reader can observe (recorded in every
# `run_scenario` document's "strategy" block, as in the reference).
STRATEGY_REGISTRY_VERSION = 1


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
    alphas       — per-participant merge rates (async staleness).
    meta         — strategy-private scratch carried to aggregate_event.
    """
    participants: List[int]
    bases: List[Params]
    event: int
    alphas: Optional[Sequence[float]] = None
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
      track_curves — False disables per-event curve tracking (async:
                    per-batch test-set evals would distort the makespan).
      mean_train_acc_over_events — True reports the mean local accuracy
                    over all events (async); False the last event's.
      timeline_result — True declares that `extra_result` carries the
                    timeline block (merges / batches / mean_staleness /
                    makespan / dropped_clients / participants).
      codec_seam  — where upload codecs attach (DESIGN.md §12): "driver"
                    is the corrupt -> transport -> aggregate seam over the
                    stacked upload matrix; "sequential" is per-visit
                    merging (CFL), where only stateless codecs apply.
    """

    name: str = ""
    topologies: Tuple[str, ...] = ("star",)
    defenses: Dict[str, Tuple[str, ...]] = {"star": DEFENSES}
    centralized = False
    track_curves = True
    mean_train_acc_over_events = False
    timeline_result = False
    codec_seam = "driver"

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

    def event_size(self) -> int:
        """Client count of one aggregation event — the basis for the
        Byzantine allowance `FLConfig.resolved_defense_f`."""
        return self.fl.num_clients

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
        attack corruption -> codec transport -> defended aggregation.
        Returns (state, per-client accs, per-client losses). Every
        lifecycle phase is wrapped in a telemetry span; strategies with a
        timeline chain their rounds into one trace flow."""
        rng = sim.rng if rng is None else rng
        tel = sim.telemetry
        flow = {"flow": "rounds"} if self.timeline_result else {}
        with tel.span("round", cat="run", event=event, **flow):
            with tel.span("select", event=event):
                plan = self.select_participants(sim, state, event, rng)
                spec = self.local_spec(sim, state, plan)
            tel.append_series("participants", len(plan.participants))
            fargs = self._fault_telemetry(sim, plan)
            uploads, losses, accs = sim.local_train(plan, spec, rng)
            uploads = sim.corrupt(uploads, plan)
            uploads = sim.transport(uploads, plan)
            with tel.span("aggregate", event=event, **fargs):
                state = self.aggregate_event(sim, state, plan, uploads)
                sim.tel_sync(state)
        return state, accs, losses

    def _fault_telemetry(self, sim, plan) -> Dict[str, Any]:
        """Record the event's fault view in telemetry (DESIGN.md §15):
        the `alive_clients` series and the churn / quorum counters, plus
        the annotations returned for the aggregate span. {} when fault
        injection is off."""
        fe = sim.fault_view(plan)
        if fe is None:
            return {}
        tel = sim.telemetry
        tel.append_series("alive_clients", fe.n_alive)
        dead = len(plan.participants) - fe.n_alive
        if dead:
            tel.counter("faults.lost_uploads", dead)
        if fe.rejoined:
            tel.counter("faults.rejoins", fe.rejoined)
        if not fe.qok:
            tel.counter("faults.quorum_failures", 1)
        return {"alive": fe.n_alive, "qok": fe.qok}

    def warmup(self, sim):
        """Run every program the timed driver loop will run once, outside
        the build timer (DESIGN.md §3): kernel build and load, cuDNN
        set-up, allocator growth. The sim's own rng is untouched."""
        sim.warmup_default(self)

    def warmup_aggregate(self, sim):
        """Loop-engine half of the warmup: dry-run one aggregation event
        on dummy (corrupted, transported) uploads, then the served model
        (the driver resets the codec state and wire log afterwards)."""
        rng = np.random.default_rng(self.fl.seed)
        state = self.init_state(sim)
        plan = self.select_participants(sim, state,
                                        self.num_events(sim) - 1, rng)
        uploads = engine_mod.stack_forest(engine_mod.unstack_forest(
            engine_mod.replicate_tree(sim.init_params,
                                      len(plan.participants))))
        state = self.aggregate_event(
            sim, state, plan,
            sim.transport(sim.corrupt(uploads, plan), plan))
        self.served_fn(sim, state)()

    # -- fused executor (DESIGN.md §10) -------------------------------------
    # `engine="fused"` keeps the whole run on the device. The driver
    # (`FederatedSimulation.run_fused`) hoists everything the per-round
    # path does on the host — participant schedules, the (rounds, k,
    # epochs*nb, B) batch-index tensor (consuming the run rng in the
    # per-round order, so §4 parity holds), attack flags and noise, codec
    # draws, the fault schedule — into per-round device inputs (`xs`),
    # and `scan_round` runs one round on device tensors: no host read, no
    # host-to-device copy, no Python branch on a device value, so the
    # round can be captured as a CUDA graph. The two strategy-shaped
    # holes are `scan_bases` (the round-start base stack from the carried
    # state) and `scan_aggregate` (the aggregation event, built from the
    # same `core.aggregation` operators as `aggregate_event`).
    # `scan_carry` / `scan_uncarry` bound the carry to a tree of tensors
    # (server optimizers re-attach their Optimizer on the way out).
    #
    # CONTRACT for `supports_fused = True`: besides the hooks being
    # device-only, `select_participants` must derive its schedule from
    # (event, rng) alone — the precompute calls it once per round with
    # the INITIAL state.

    supports_fused = False      # opt-in: see the contract above

    # -- mesh-sharded fused executor (DESIGN.md §11) ------------------------
    # `mesh_devices > 1` runs the fused round in every rank of a world,
    # each on its contiguous sub-stack of clients. A strategy opts in with
    # `supports_mesh = True` when its hooks are collective-correct:
    # `scan_bases`, local training and corruption are per client already,
    # so the one obligation is `scan_aggregate` lowering its event to the
    # mesh operators when `fx.mesh_axis` is set. `scan_carry_sharding`
    # declares, per top-level carry key, whether that subtree carries the
    # client axis ("client": dim 0 split over the ranks) or is
    # federation-global ("replicated"). `run_fused` validates the generic
    # preconditions (full participation, C % ranks, defense="none") before
    # any rank starts.

    supports_mesh = False

    def scan_carry_sharding(self, sim) -> Dict[str, str]:
        """Top-level carry key -> "client" | "replicated"."""
        raise NotImplementedError

    def validate_mesh(self, sim, ndev: int) -> None:
        """Strategy-specific mesh preconditions, raised before any rank
        starts (HFL: group/shard alignment)."""

    def scan_carry(self, sim, state):
        """Strategy state -> the tree of tensors carried from round to
        round."""
        return state

    def scan_uncarry(self, sim, carry):
        """Final carry -> full strategy state (for `round_model` /
        `served_fn` / `extra_result`)."""
        return carry

    def scan_extra_xs(self, sim, n_events: int) -> Dict[str, Any]:
        """Additional per-round inputs, each with leading dim n_events
        (e.g. HFL's dissemination flag). Called after the precompute has
        logged every event's fault view."""
        return {}

    def fault_scan_kwargs(self) -> Dict[str, Any]:
        """`FaultSchedule.scan_xs` kwargs for the fused precompute: which
        per-round fault arrays this strategy's `scan_aggregate` reads
        beyond the alive mask and quorum flag (HFL: the group quorums;
        gossip AFL: the mixing matrices or gather indices)."""
        return {}

    def scan_bases(self, fx, carry, xs) -> Params:
        """The (k, ...) stacked round-start models for this round's
        participants, from the carried state."""
        raise NotImplementedError

    def scan_aggregate(self, fx, carry, xs, uploads):
        """Fold the (possibly corrupted) uploads into the carry — the
        device-only twin of `aggregate_event`."""
        raise NotImplementedError

    def scan_round(self, fx, carry, xs):
        """One fused round: gather this round's batches from the
        device-resident federation dataset, train every participant,
        evaluate the paper's local-shard training accuracy, corrupt
        attacker uploads, ship them through the codec, aggregate. Returns
        (carry, (train_acc, train_loss, test_acc)) as device scalars —
        test_acc is NaN when curve tracking is off.

        On the mesh every per-client input (bases, batches, flags, noise,
        eval shards) is the rank's sub-stack: `fx.local_pids` maps the
        absolute participant ids to its rows, training and corruption run
        unchanged, and the two per-round scalars are averaged over the
        ranks in one all_reduce (equal shards make the mean of the shard
        means the federation mean)."""
        fl = fx.fl
        bases = self.scan_bases(fx, carry, xs)
        pids = fx.local_pids(xs["pids"])
        batch = engine_mod.gather_batches(fx.data_x, fx.data_y, pids,
                                          xs["idx"])
        spec = self.local_spec(fx.sim, None, None)
        extra = bases if spec.extra == "bases" else None
        params, losses, _ = engine_mod.train_clients_chunked(
            bases, batch, stacked_loss_fn=spec.stacked_loss_fn, lr=fl.lr,
            momentum=fl.momentum, extra=extra, chunk=fl.fused_chunk)
        accs = fx.local_accs(params, pids)
        uploads = fx.corrupt(params, bases, xs)
        uploads = fx.transport(uploads, bases, xs)
        carry = self.scan_aggregate(fx, carry, xs, uploads)
        acc, loss = fx.pmean(accs.mean(), losses[:, -fx.nb:].mean())
        return carry, (acc, loss, fx.test_acc(self.round_model(carry)))

    def scan_telemetry(self, fx, carry, new_carry, xs) -> Dict[str, Any]:
        """Strategy-specific per-round counters (device scalars; DESIGN.md
        §13), computed from the pre- and post-round carries and
        transferred once at run end. The default reports the L2 norm of
        the round's global-model step. Counters only read: fused results
        are the same with telemetry on or off."""
        d2 = sum(torch.sum(torch.square(b.float() - a.float()))
                 for a, b in zip(tree_leaves(self.round_model(carry)),
                                 tree_leaves(self.round_model(new_carry))))
        return {"model_delta_l2": torch.sqrt(d2)}


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

STRATEGY_REGISTRY: Dict[str, Type[Strategy]] = {}

# built-in strategies living in other modules, loaded on first lookup
# (async_agg imports this module, so it cannot be imported at top level)
_BUILTIN_MODULES = ("repro_torch.core.async_agg",)
_builtins_loaded = False


def register_strategy(cls: Type[Strategy]) -> Type[Strategy]:
    """Class decorator: register a Strategy subclass under `cls.name`."""
    if not cls.name:
        raise ValueError(f"{cls.__name__} needs a non-empty `name`")
    if cls.name in STRATEGY_REGISTRY:
        raise ValueError(f"duplicate strategy name {cls.name!r}")
    STRATEGY_REGISTRY[cls.name] = cls
    return cls


def _load_builtins():
    global _builtins_loaded
    if not _builtins_loaded:
        for mod in _BUILTIN_MODULES:
            importlib.import_module(mod)
        _builtins_loaded = True


def get_strategy(name: str) -> Type[Strategy]:
    _load_builtins()
    if name not in STRATEGY_REGISTRY:
        known = ", ".join(sorted(STRATEGY_REGISTRY))
        raise KeyError(f"unknown strategy {name!r} (known: {known})")
    return STRATEGY_REGISTRY[name]


def strategy_names() -> List[str]:
    _load_builtins()
    return sorted(STRATEGY_REGISTRY)


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

    def event_size(self) -> int:
        return self.fl.clients_per_group

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
        plan.meta["start_groups"] = state["groups"]   # (G, ...) centers
        # stacked bases (vectorized engine, corruption) without a
        # per-client stack: one repeat per leaf, built lazily
        groups = state["groups"]
        plan.meta["bases_stacked_fn"] = (
            lambda: engine_mod.repeat_groups(groups, per))
        return plan

    def aggregate_event(self, sim, state, plan, uploads):
        fl = self.fl
        fe = sim.fault_view(plan)
        if fe is not None and not fe.qok:
            # below-quorum round (DESIGN.md §15): the hierarchy — groups,
            # global and the serving tuple — holds its round-start values
            return {"groups": state["groups"], "global": state["global"],
                    "last": self._held_last(sim, state)}
        w = np.asarray(sim.weights, np.float32)
        starts = plan.meta["start_groups"]
        alive = None if fe is None else fe.alive
        groups, gw = agg.hfl_tier1_stacked(
            uploads, fl.num_groups, w, centers=starts, alive=alive,
            **sim.defense_kwargs(self.event_size()))
        if fe is not None:
            # per-group quorum: a below-quorum group server holds its
            # round-start model (and still enters tier 2 at full weight)
            gqok = sim.faults.group_qok(plan.event, plan.participants,
                                        fl.num_groups)
            groups = agg.tree_where_rows(gqok, groups, starts)
        global_model = state["global"]
        if ((plan.event + 1) % fl.hfl_global_every == 0
                or plan.event == fl.rounds - 1):
            global_model = agg.fedavg_stacked(groups, gw)
            groups = engine_mod.replicate_tree(global_model, fl.num_groups)
        last = ((uploads, starts) if fe is None
                else (uploads, starts, fe.alive))
        return {"groups": groups, "global": global_model, "last": last}

    def _held_last(self, sim, state):
        """The serving tuple a quorum-failed round holds: the previous
        event's or, when round 0 fails quorum, the init model's (uniform
        init uploads re-aggregate to the init model)."""
        if state["last"] is not None:
            return state["last"]
        fl = self.fl
        return (engine_mod.replicate_tree(sim.init_params, fl.num_clients),
                engine_mod.replicate_tree(sim.init_params, fl.num_groups),
                np.ones((fl.num_clients,), np.float32))

    def round_model(self, state):
        return state["global"]

    def served_fn(self, sim, state):
        # the global server re-aggregates at classification time, with
        # the round's defense and centers
        fl = self.fl
        w = np.asarray(sim.weights, np.float32)
        defkw = sim.defense_kwargs(self.event_size())
        last = state["last"]
        if len(last) == 2:
            uploads, starts = last
            return lambda: agg.hfl_aggregate_stacked(
                uploads, fl.num_groups, w, centers=starts, **defkw)
        # under faults: replay the degraded tiers as the round ran them —
        # alive-masked tier 1, per-group quorum holds, full-weight tier 2
        uploads, starts, alive = last
        per = fl.num_clients // fl.num_groups
        thr = faults_mod.quorum_threshold(per, fl.quorum_frac)
        gqok = (np.asarray(alive, np.float32).reshape(fl.num_groups, per)
                .sum(axis=1) >= thr)

        def serve():
            groups, gw = agg.hfl_tier1_stacked(
                uploads, fl.num_groups, w, centers=starts, alive=alive,
                **defkw)
            groups = agg.tree_where_rows(gqok, groups, starts)
            return agg.fedavg_stacked(groups, gw)
        return serve


    # -- fused executor -----------------------------------------------------
    supports_fused = True
    # mesh: groups align to shards (num_groups % ranks == 0), so tier 1 is
    # the rank-local reshape with no collective; only tier 2 reduces
    supports_mesh = True

    def scan_carry_sharding(self, sim):
        sharding = {"groups": "client", "global": "replicated",
                    "up": "client", "start": "client"}
        if sim.faults is not None:
            sharding["alive"] = "client"
        return sharding

    def validate_mesh(self, sim, ndev):
        if self.fl.num_groups % ndev:
            raise ValueError(
                f"HFL mesh path needs groups aligned to shards: "
                f"num_groups={self.fl.num_groups} must be a multiple of "
                f"mesh_devices={ndev} so tier 1 never crosses a shard "
                f"boundary (DESIGN.md §11)")

    def scan_carry(self, sim, state):
        carry = {"groups": state["groups"], "global": state["global"],
                 "up": engine_mod.replicate_tree(sim.init_params,
                                                 self.fl.num_clients),
                 "start": state["groups"]}
        if sim.faults is not None:
            # the last event's alive mask rides the carry, so the serving
            # tuple re-aggregates with the same degraded masking
            carry["alive"] = torch.ones((self.fl.num_clients,),
                                        dtype=torch.float32,
                                        device=sim.device)
        return carry

    def scan_uncarry(self, sim, carry):
        last = (carry["up"], carry["start"])
        if "alive" in carry:
            last = last + (carry["alive"].cpu().numpy(),)
        return {"groups": carry["groups"], "global": carry["global"],
                "last": last}

    def scan_extra_xs(self, sim, n_events):
        fl = self.fl
        # the per-round driver's dissemination schedule as a per-round
        # flag (a Python `if` there, a `torch.where` here)
        return {"hfl_global": np.array(
            [((ev + 1) % fl.hfl_global_every == 0 or ev == fl.rounds - 1)
             for ev in range(n_events)], bool)}

    def fault_scan_kwargs(self):
        return {"num_groups": self.fl.num_groups}

    def scan_bases(self, fx, carry, xs):
        # participants are always 0..C-1 in id order (select_participants)
        return engine_mod.repeat_groups(carry["groups"],
                                        self.fl.clients_per_group)

    def scan_aggregate(self, fx, carry, xs, uploads):
        fl = self.fl
        start_groups = carry["groups"]
        alive = xs.get("fault_alive")
        if fx.mesh_axis is not None:
            # tier 1 nests in the rank's shard: local math, no collective;
            # tier 2 is ONE all_reduce over the local group models
            # (defense="none" on the mesh, checked before the ranks start)
            g_loc = fx.weights.shape[0] // fl.clients_per_group
            with collectives.collective_scope("hfl.tier1"):
                groups, gw = agg.hfl_tier1_local(uploads, fx.weights, g_loc,
                                                 alive=alive)
                if alive is not None:
                    # the rank's slice of the per-group quorum flags
                    lo = fx.mesh_axis.index * g_loc
                    groups = agg.tree_where_rows(
                        xs["fault_gqok"][lo:lo + g_loc], groups, start_groups)
            with collectives.collective_scope("hfl.tier2"):
                new_global = agg.mesh_fedavg_stacked(groups, gw,
                                                     axis=fx.mesh_axis)
        else:
            groups, gw = agg.hfl_tier1_stacked(
                uploads, fl.num_groups, fx.weights, centers=start_groups,
                alive=alive, **fx.defense_kwargs(self.event_size()))
            if alive is not None:
                groups = agg.tree_where_rows(xs["fault_gqok"], groups,
                                             start_groups)
            # global aggregation and dissemination on the schedule flag:
            # the tier-2 reduction over G group models runs every round
            # and the flag selects it
            new_global = agg.fedavg_stacked(groups, gw)
        disseminate = xs["hfl_global"]
        global_model = agg.tree_where(disseminate, new_global,
                                      carry["global"])
        groups = agg.tree_where(
            disseminate, engine_mod.replicate_tree(
                new_global, tree_leaves(groups)[0].shape[0]), groups)
        out = {"groups": groups, "global": global_model,
               "up": uploads, "start": start_groups}
        if alive is not None:
            # below-quorum round: every carried value holds
            qok = xs["fault_qok"]
            out = {key: agg.tree_where(qok, val, carry[key])
                   for key, val in out.items()}
            out["alive"] = torch.where(qok, alive, carry["alive"])
        return out

    def scan_telemetry(self, fx, carry, new_carry, xs):
        # the hierarchy's dissemination lag: L2 spread of the group
        # models around their mean (0 on dissemination rounds)
        out = super().scan_telemetry(fx, carry, new_carry, xs)
        d2 = sum(torch.sum(torch.square(
                     g.float() - g.float().mean(dim=0, keepdim=True)))
                 for g in tree_leaves(new_carry["groups"]))
        out["group_spread_l2"] = torch.sqrt(d2)
        return out


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

    def event_size(self) -> int:
        fl = self.fl
        return max(1, int(round(fl.participation * fl.num_clients)))

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
        fe = sim.fault_view(plan)
        if fe is not None and not fe.qok:
            # below-quorum round: hold the global model and the serving
            # tuple (DESIGN.md §15)
            return {"global": state["global"],
                    "last": self._held_last(sim, state)}
        defkw = sim.defense_kwargs(k)
        pw = np.asarray(sim.weights, np.float64)[plan.participants]
        start = plan.bases[0]
        alive = None if fe is None else fe.alive
        if fl.afl_mode == "gossip":
            # defended mixing bounds Byzantine neighbors; the final
            # consensus average over the mixed models stays plain
            if fe is None:
                nbrs = topology.ring_neighbors(k, fl.gossip_neighbors)
                uploads = agg.gossip_stacked(uploads, nbrs,
                                             defense=fl.defense,
                                             f=defkw["f"])
            elif fl.defense == "none":
                # dynamic membership: the schedule's per-round masked
                # (under MTD re-randomized) mixing matrix
                uploads = agg.masked_gossip_stacked(
                    uploads, mix=sim.faults.gossip_mix(
                        plan.event, plan.participants))
            else:
                uploads = agg.masked_gossip_stacked(
                    uploads, gather_idx=sim.faults.gossip_gather(
                        plan.event, plan.participants,
                        fl.gossip_neighbors + 1),
                    defense=fl.defense, f=defkw["f"])
            global_model = agg.afl_aggregate_stacked(uploads, pw,
                                                     alive=alive)
        else:
            global_model = agg.defended_aggregate_stacked(
                uploads, pw, center=start, alive=alive, **defkw)
        last = ((uploads, pw, start, k) if fe is None
                else (uploads, pw, start, k, fe.alive))
        return {"global": global_model, "last": last}

    def _held_last(self, sim, state):
        """The serving tuple a quorum-failed round holds (a round-0
        failure holds the init model's)."""
        if state["last"] is not None:
            return state["last"]
        k = self.event_size()
        return (engine_mod.replicate_tree(sim.init_params, k),
                np.ones((k,), np.float32), sim.init_params, k,
                np.ones((k,), np.float32))

    def round_model(self, state):
        return state["global"]

    def served_fn(self, sim, state):
        fl = self.fl
        uploads, pw, start, k, *rest = state["last"]
        alive = rest[0] if rest else None
        defkw = sim.defense_kwargs(k)
        if fl.afl_mode == "gossip":
            return lambda: agg.afl_aggregate_stacked(uploads, pw,
                                                     alive=alive)
        return lambda: agg.defended_aggregate_stacked(
            uploads, pw, center=start, alive=alive, **defkw)


    # -- fused executor -----------------------------------------------------
    supports_fused = True
    # mesh: star is one all_reduce; gossip the masked all-to-all mix
    # (neighbour models cross shard boundaries)
    supports_mesh = True

    def scan_carry_sharding(self, sim):
        sharding = {"global": "replicated", "up": "client", "pw": "client",
                    "start": "replicated"}
        if sim.faults is not None:
            sharding["alive"] = "client"
        return sharding

    def scan_carry(self, sim, state):
        k = self.event_size()
        carry = {"global": state["global"],
                 "up": engine_mod.replicate_tree(sim.init_params, k),
                 "pw": torch.ones((k,), dtype=torch.float32,
                                  device=sim.device),
                 "start": state["global"]}
        if sim.faults is not None:
            carry["alive"] = torch.ones((k,), dtype=torch.float32,
                                        device=sim.device)
        return carry

    def scan_uncarry(self, sim, carry):
        last = (carry["up"], carry["pw"], carry["start"], self.event_size())
        if "alive" in carry:
            last = last + (carry["alive"].cpu().numpy(),)
        return {"global": carry["global"], "last": last}

    def fault_scan_kwargs(self):
        fl = self.fl
        if fl.afl_mode != "gossip":
            return {}
        if fl.defense == "none":
            return {"gossip": True}
        return {"gossip": True, "gossip_defended": True,
                "gather_k": fl.gossip_neighbors + 1}

    def scan_bases(self, fx, carry, xs):
        return engine_mod.replicate_tree(carry["global"],
                                         xs["pids"].shape[0])

    def scan_aggregate(self, fx, carry, xs, uploads):
        fl = self.fl
        k = xs["pids"].shape[0]
        pw = fx.weights[fx.local_pids(xs["pids"])]
        start = carry["global"]
        alive = xs.get("fault_alive")
        if fx.mesh_axis is not None:
            # defense="none" on the mesh (checked before the ranks start);
            # the ring spans the GLOBAL client ids, so the mix is built at
            # federation size and applied as one collective (under faults
            # the per-round masked mix: positions are ids under full
            # participation)
            if fl.afl_mode == "gossip":
                mix = (xs["fault_mix"] if alive is not None else fx.const(
                    "mesh_ring_mix", lambda: agg.gossip_mix_matrix(
                        topology.ring_neighbors(fl.num_clients,
                                                fl.gossip_neighbors))))
                uploads = agg.mesh_gossip_stacked(uploads, mix,
                                                  axis=fx.mesh_axis)
            global_model = agg.mesh_fedavg_stacked(
                uploads, pw if alive is None else pw * alive,
                axis=fx.mesh_axis)
            out = {"global": global_model, "up": uploads, "pw": pw,
                   "start": start}
            return self._fault_hold(carry, xs, out, alive)
        defkw = fx.defense_kwargs(k)
        if fl.afl_mode == "gossip":
            if alive is None:
                nbrs = topology.ring_neighbors(k, fl.gossip_neighbors)
                if fl.defense == "none":
                    ring = {"mix": fx.const("ring_mix", lambda:
                                            agg.gossip_mix_matrix(nbrs))}
                else:
                    ring = {"gather_idx": fx.const(
                        "ring_gather",
                        lambda: agg.gossip_gather_indices(nbrs))}
                uploads = agg.gossip_stacked(uploads, nbrs,
                                             defense=fl.defense,
                                             f=defkw["f"], **ring)
            elif fl.defense == "none":
                uploads = agg.masked_gossip_stacked(uploads,
                                                    mix=xs["fault_mix"])
            else:
                uploads = agg.masked_gossip_stacked(
                    uploads, gather_idx=xs["fault_gidx"],
                    defense=fl.defense, f=defkw["f"])
            global_model = agg.afl_aggregate_stacked(uploads, pw,
                                                     alive=alive)
        else:
            global_model = agg.defended_aggregate_stacked(
                uploads, pw, center=start, alive=alive, **defkw)
        out = {"global": global_model, "up": uploads, "pw": pw,
               "start": start}
        return self._fault_hold(carry, xs, out, alive)

    def _fault_hold(self, carry, xs, out, alive):
        """Quorum gate of a fused round: a below-quorum round keeps the
        carried values (the per-round driver's host `if`)."""
        if alive is None:
            return out
        qok = xs["fault_qok"]
        held = {key: agg.tree_where(qok, out[key], carry[key])
                for key in out}
        held["alive"] = torch.where(qok, alive, carry["alive"])
        return held


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
    codec_seam = "sequential"   # per-visit wire: stateless codecs only

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
            # logs this event's fault view; sequential_round re-derives
            # the same view for the per-visit merge masking
            self._fault_telemetry(sim, plan)
            # training + merge fuse in sequential_round, which records
            # its own phase span
            model, losses, accs = sim.sequential_round(
                state["model"], plan.participants, plan.event,
                self.fl.merge_alpha, self.local_spec(sim, state, plan), rng)
        return {"model": model}, accs, losses

    def aggregate_event(self, sim, state, plan, uploads):
        raise NotImplementedError(       # pragma: no cover
            "CFL fuses training and aggregation in sequential_round")

    def warmup_aggregate(self, sim):
        """Nothing to warm: the loop-engine CFL pass merges through
        eager host ops (covered by warmup_loop)."""

    def round_model(self, state):
        return state["model"]


    # -- fused executor -----------------------------------------------------
    # CFL's training and aggregation already fuse in `cfl_round_scan`
    # (one pass over the visit order, corruption and kernel-backed merge
    # inside), so the fused round is that pass — `scan_round` is
    # overridden whole, like `run_event` is for the per-round driver.
    supports_fused = True

    def scan_round(self, fx, carry, xs):
        fl = self.fl
        pids = xs["pids"]
        batch = engine_mod.gather_batches(fx.data_x, fx.data_y, pids,
                                          xs["idx"])
        model, losses, accs = engine_mod.cfl_round_scan(
            carry["model"], batch, fx.eval_x[pids], fx.eval_y[pids],
            fl.merge_alpha, loss_fn=fx.eng.loss_fn, apply_fn=fx.eng.apply_fn,
            lr=fl.lr, momentum=fl.momentum, attack=fl.attack,
            attack_scale=fl.attack_scale, attack_flags=xs["flags"],
            attack_noise=xs.get("noise"), defense=fl.defense,
            clip_tau=fl.clip_tau, codec=fx.sim.codec,
            codec_keys=xs.get("ckeys"), fault_alive=xs.get("fault_alive"),
            fault_qok=xs.get("fault_qok"),
            merge_weights=fx.const("cfl_merge", lambda: agg.cfl_merge_weights(
                fl.merge_alpha)))
        return {"model": model}, (accs.mean(), losses[:, -fx.nb:].mean(),
                                  fx.test_acc(model))


# ---------------------------------------------------------------------------
# plugins shipped through the Strategy API alone
# ---------------------------------------------------------------------------

def _sq_dist(params, ref, stacked: bool):
    """sum ||p - r||^2 over the leaves, per client when `stacked`."""
    total = 0
    for p, r in zip(tree_leaves(params), tree_leaves(ref)):
        d = torch.square(p.float() - r.float())
        total = total + (d.reshape(p.shape[0], -1).sum(dim=1) if stacked
                         else d.sum())
    return total


@register_strategy
class FedProxStrategy(AFLStrategy):
    """FedProx (Li et al. 2020): AFL's schedule and aggregation with a
    proximal local objective — each client minimizes

        F_c(w) + (mu/2) ||w - w_base||^2

    where w_base is the model it pulled at round start. `local_spec`
    returns the prox-augmented loss with `extra="bases"`; schedule,
    engines, attacks and defenses are inherited."""

    name = "fedprox"
    topologies = ("star",)
    defenses = {"star": DEFENSES}

    def __init__(self, fl):
        super().__init__(fl)
        mu = float(fl.prox_mu)

        def prox_loss(params, batch, ref):
            loss, acc = cnn_mod.cnn_loss(params, batch)
            return loss + 0.5 * mu * _sq_dist(params, ref, False), acc

        def prox_loss_stacked(params, batch, ref):
            loss_c, acc_c = cnn_mod.cnn_loss_stacked(params, batch)
            return loss_c + 0.5 * mu * _sq_dist(params, ref, True), acc_c

        self._spec = LocalSpec(prox_loss, prox_loss_stacked, extra="bases")

    def local_spec(self, sim, state, plan):
        return self._spec


class ServerOptStrategy(AFLStrategy):
    """Server-optimizer family (Reddi et al. 2021): the round's defended,
    kernel-backed aggregate is a pseudo-gradient step

        g_t = w_t - aggregate_t

    that a SERVER optimizer applies: FedAvgM (momentum SGD) or FedAdam
    (Adam). With server_lr=1 and no momentum this is plain FedAvg."""

    topologies = ("star",)
    defenses = {"star": DEFENSES}
    centralized = True

    def make_opt(self):
        raise NotImplementedError

    def init_state(self, sim):
        opt = self.make_opt()
        return {"global": sim.init_params, "opt": opt,
                "opt_state": opt.init(sim.init_params), "last": None}

    def aggregate_event(self, sim, state, plan, uploads):
        k = len(plan.participants)
        fe = sim.fault_view(plan)
        if fe is not None and not fe.qok:
            # below-quorum round: no pseudo-gradient step — the server
            # optimizer's state holds along with the model (DESIGN.md §15)
            return {"global": state["global"], "opt": state["opt"],
                    "opt_state": state["opt_state"],
                    "last": self._held_last(sim, state)}
        pw = np.asarray(sim.weights, np.float64)[plan.participants]
        g = state["global"]
        alive = None if fe is None else fe.alive
        aggregate = agg.defended_aggregate_stacked(
            uploads, pw, center=g, alive=alive, **sim.defense_kwargs(k))
        pseudo_grad = tree_map(lambda a, b: (a - b).float(), g, aggregate)
        updates, opt_state = state["opt"].update(pseudo_grad,
                                                 state["opt_state"], g)
        last = ((uploads, pw, g, k) if fe is None
                else (uploads, pw, g, k, fe.alive))
        return {"global": optimizers.apply_updates(g, updates),
                "opt": state["opt"], "opt_state": opt_state, "last": last}

    def served_fn(self, sim, state):
        # the server optimizer's state lives server-side: serve its model
        model = state["global"]
        return lambda: model


    # -- fused executor -----------------------------------------------------
    # The server optimizer's state is a tree of tensors (Adam's step count
    # included): it rides the carry like the model does, and a
    # below-quorum round holds it; the Optimizer is re-attached on the way
    # out.

    def scan_carry_sharding(self, sim):
        # the server optimizer steps the replicated global model with a
        # replicated pseudo-gradient: its state is the same on every rank
        sharding = super().scan_carry_sharding(sim)
        sharding["opt_state"] = "replicated"
        return sharding

    def scan_carry(self, sim, state):
        carry = super().scan_carry(sim, state)
        carry["opt_state"] = state["opt_state"]
        return carry

    def scan_uncarry(self, sim, carry):
        state = super().scan_uncarry(sim, carry)
        state["opt"] = self.make_opt()
        state["opt_state"] = carry["opt_state"]
        return state

    def scan_aggregate(self, fx, carry, xs, uploads):
        k = xs["pids"].shape[0]
        pw = fx.weights[fx.local_pids(xs["pids"])]
        g = carry["global"]
        alive = xs.get("fault_alive")
        if fx.mesh_axis is not None:
            aggregate = agg.mesh_fedavg_stacked(
                uploads, pw if alive is None else pw * alive,
                axis=fx.mesh_axis)
        else:
            aggregate = agg.defended_aggregate_stacked(
                uploads, pw, center=g, alive=alive, **fx.defense_kwargs(k))
        pseudo_grad = tree_map(lambda a, b: (a - b).float(), g, aggregate)
        updates, opt_state = self.make_opt().update(
            pseudo_grad, carry["opt_state"], g)
        out = {"global": optimizers.apply_updates(g, updates),
               "opt_state": opt_state, "up": uploads, "pw": pw,
               "start": g}
        return self._fault_hold(carry, xs, out, alive)


@register_strategy
class FedAvgMStrategy(ServerOptStrategy):
    """FedAvgM: server momentum-SGD over the round pseudo-gradient."""
    name = "fedavgm"

    def make_opt(self):
        return optimizers.sgd(self.fl.server_lr,
                              momentum=self.fl.server_momentum)


@register_strategy
class FedAdamStrategy(ServerOptStrategy):
    """FedAdam: server Adam over the round pseudo-gradient."""
    name = "fedadam"

    def make_opt(self):
        return optimizers.adam(self.fl.server_lr)
