"""Staleness-aware asynchronous aggregation — async as a Strategy plugin
(port of `repro.core.async_agg`).

Heterogeneous clients finish local training at different times. Instead
of synchronous rounds, the server merges each arriving update at once,
down-weighted by its staleness:

    theta <- (1 - a(tau)) * theta + a(tau) * theta_c,
    a(tau) = alpha * (1 + tau) ** -decay

(tau = server steps since the client pulled its base model — FedAsync,
Xie et al. 2019, polynomial staleness).

Tick-batch protocol (DESIGN.md §5): arrivals are grouped by (optionally
tick-quantized) finish time into batches; the clients of a batch train
from the model at batch start and their updates merge in arrival order.
The timeline (`build_timeline`) is host numpy, consumed in the
reference's order, so one seed gives the reference's timeline bit for
bit under both engines and on every device.

`AsyncStrategy` runs on the generic round driver: each tick batch is one
aggregation event; `select_participants` walks the timeline and derives
per-arrival staleness rates; the merge is ONE weighted reduction on the
`fedavg_agg` kernel (`aggregation.async_batch_merge`) whose composed
weights equal the sequential FedAsync folds. `AsyncSimulation` remains as
a thin deprecated wrapper over the strategy.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import aggregation as agg
from repro_torch.core import attacks, robust, topology
from repro_torch.core import engine as engine_mod
from repro_torch.core import strategies as strat_mod
from repro_torch.core.strategies import RoundPlan


def staleness_alpha(alpha: float, staleness: int, decay: float = 0.5
                    ) -> float:
    return alpha * (1.0 + staleness) ** (-decay)


SPEED_MODELS = ("uniform", "lognormal", "straggler")


def make_speeds(model: str, num_clients: int, rng: np.random.Generator, *,
                sigma: float = 0.5, straggler_factor: float = 4.0,
                quantize: float = 0.0) -> np.ndarray:
    """Per-client step-time factors for the named heterogeneity model.

    uniform    — every client takes one time unit per local round.
    lognormal  — LogNormal(0, sigma) step times (some clients 3-4x slower).
    straggler  — one rng-chosen client `straggler_factor`x slower.

    `quantize` > 0 snaps speeds onto that grid, so arrivals collide into
    large same-tick batches.
    """
    if model == "uniform":
        s = np.ones(num_clients)
    elif model == "lognormal":
        s = rng.lognormal(0.0, sigma, num_clients)
    elif model == "straggler":
        s = np.ones(num_clients)
        s[rng.integers(num_clients)] = straggler_factor
    else:
        raise ValueError(f"unknown speed model {model!r} "
                         f"(expected one of {SPEED_MODELS})")
    if quantize > 0:
        s = np.maximum(quantize, np.round(s / quantize) * quantize)
    return s


# ---------------------------------------------------------------------------
# timeline (schedule-rng half of the DESIGN.md §4 parity contract)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class AsyncTimeline:
    """The full precomputed arrival schedule of one async run."""
    speeds: np.ndarray
    participants: Tuple[int, ...]
    n_updates: np.ndarray
    dropped_clients: Tuple[int, ...]
    batches: List[Tuple[float, List[int]]]   # [(time, [client, ...]), ...]


def build_timeline(num_clients: int, seed: int, *, speeds=None,
                   speed_model: str = "lognormal",
                   participation: float = 1.0, dropout: float = 0.0,
                   updates_per_client: int = 4,
                   tick: float = 0.0) -> AsyncTimeline:
    """Schedule rng consumed in a fixed order (speeds, participation,
    dropout), so one seed builds one timeline under every engine. Client
    c's k-th arrival lands at the (tick-quantized) cumulative time of k+1
    local rounds; dropped clients stop producing arrivals after their
    rng-chosen failure point (at least one participant survives)."""
    rng = np.random.default_rng(seed)
    speeds = (np.asarray(speeds, float) if speeds is not None
              else make_speeds(speed_model, num_clients, rng))
    parts = topology.sample_participants(rng, num_clients, participation)
    participants = tuple(int(c) for c in parts)
    n_updates = np.zeros(num_clients, int)
    n_updates[list(participants)] = updates_per_client
    dropped: Tuple[int, ...] = ()
    if dropout > 0 and len(participants) > 1:
        n_drop = min(int(round(dropout * len(participants))),
                     len(participants) - 1)
        if n_drop:
            victims = rng.choice(np.asarray(participants), n_drop,
                                 replace=False)
            n_updates[victims] = rng.integers(0, updates_per_client,
                                              size=n_drop)
            dropped = tuple(int(v) for v in np.sort(victims))

    def _quantize(t: float) -> float:
        if tick <= 0:
            return t
        return float(np.ceil(round(t / tick, 9)) * tick)

    arrivals: Dict[float, List[int]] = {}
    for c in range(num_clients):
        t = 0.0
        for _ in range(int(n_updates[c])):
            t = _quantize(t + float(speeds[c]))
            arrivals.setdefault(t, []).append(c)
    batches = [(t, sorted(arrivals[t])) for t in sorted(arrivals)]
    return AsyncTimeline(speeds, participants, n_updates, dropped, batches)


# ---------------------------------------------------------------------------
# async as a Strategy plugin
# ---------------------------------------------------------------------------

@strat_mod.register_strategy
class AsyncStrategy(strat_mod.Strategy):
    """Event-driven async FL on the generic round driver: one aggregation
    event per tick batch. `select_participants` consumes the timeline and
    derives per-arrival staleness rates; `aggregate_event` folds the batch
    through `async_batch_merge` after the optional norm_clip of each
    arriving delta. Per-batch curve tracking is off, so the timed surface
    is the merge path, not test-set evals.

    Configuration comes from the FLConfig async fields
    (`staleness_alpha/decay`, `updates_per_client`, `speed_model`,
    `dropout`, `tick`, plus `participation`)."""

    name = "async"
    topologies = ("event",)
    defenses = {"event": ("none", "norm_clip")}
    track_curves = False
    mean_train_acc_over_events = True
    timeline_result = True

    def __init__(self, fl):
        super().__init__(fl)
        self.alpha = fl.staleness_alpha
        self.decay = fl.staleness_decay
        self.timeline = build_timeline(
            fl.num_clients, fl.seed, speed_model=fl.speed_model,
            participation=fl.participation, dropout=fl.dropout,
            updates_per_client=fl.updates_per_client, tick=fl.tick)

    def init_state(self, sim):
        return {"model": sim.init_params, "server_step": 0,
                "base_version": np.zeros(self.fl.num_clients, int),
                "staleness": [], "makespan": 0.0}

    def num_events(self, sim) -> int:
        return len(self.timeline.batches)

    def select_participants(self, sim, state, event, rng):
        t, clients = self.timeline.batches[event]
        taus = [state["server_step"] + i - int(state["base_version"][c])
                for i, c in enumerate(clients)]
        plan = RoundPlan(list(clients),
                         [state["model"]] * len(clients), event,
                         alphas=[staleness_alpha(self.alpha, tau,
                                                 self.decay)
                                 for tau in taus])
        plan.meta["taus"] = taus
        plan.meta["time"] = t
        model, k = state["model"], len(clients)
        plan.meta["bases_stacked_fn"] = (
            lambda: engine_mod.replicate_tree(model, k))
        return plan

    def aggregate_event(self, sim, state, plan, uploads):
        fl = self.fl
        tel = sim.telemetry
        k = len(plan.participants)
        taus = plan.meta["taus"]
        fe = sim.fault_view(plan)
        state["makespan"] = plan.meta["time"]
        if k == 0 or (fe is not None and not fe.qok):
            # a batch whose every arrival dropped (or a below-quorum batch
            # under fault injection) is a no-op: no merge, no server_step
            # advance, no base_version bump (DESIGN.md §15)
            tel.counter("async.batches", 1)
            tel.append_series("batch_size",
                              0 if fe is None else int(fe.n_alive))
            tel.append_series("mean_staleness", 0.0)
            return state
        model = state["model"]
        alphas = np.asarray(plan.alphas, np.float32)
        if fe is not None:
            # a dead arrival's update is lost on the wire: alpha = 0 folds
            # to an exact no-op in the batched-merge weights
            alphas = alphas * fe.alive
            merged = fe.alive_b
        else:
            merged = np.ones(k, bool)
        if fl.defense == "norm_clip":
            # every arriving delta is clipped against the batch-start
            # model before the staleness merge
            uploads = robust.clip_deltas_stacked(model, uploads, fl.clip_tau)
        model = agg.async_batch_merge(model, uploads, alphas)
        state["model"] = model
        n_merged = int(merged.sum())
        state["server_step"] += n_merged
        # the batch is atomic: every MERGED member pulls the post-batch
        # model (a dead client resyncs when it rejoins)
        merged_ids = np.asarray(plan.participants, int)[merged]
        state["base_version"][merged_ids] = state["server_step"]
        merged_taus = [t for t, m in zip(taus, merged) if m]
        state["staleness"].extend(merged_taus)
        tel.counter("async.merges", n_merged)
        tel.counter("async.batches", 1)
        tel.append_series("batch_size", n_merged)
        tel.append_series("mean_staleness",
                          float(np.mean(merged_taus)) if merged_taus
                          else 0.0)
        return state

    def round_model(self, state):
        return state["model"]

    def served_fn(self, sim, state):
        model = state["model"]        # continually merged: serving-ready
        return lambda: model

    def extra_result(self, sim, state):
        tl = self.timeline
        return {"merges": state["server_step"],
                "batches": len(tl.batches),
                "mean_staleness": (float(np.mean(state["staleness"]))
                                   if state["staleness"] else 0.0),
                "makespan": state["makespan"],
                "dropped_clients": list(tl.dropped_clients),
                "participants": list(tl.participants),
                "final_model": state["model"]}

    # -- warmup -------------------------------------------------------------
    def warmup(self, sim):
        """Run every program the timed loop will run once, for every
        DISTINCT batch size, with a throwaway rng (`sim.rng` untouched):
        corruption, clip, the codec round trip (the driver resets the
        codec state and wire log afterwards) and the batched merge; the
        loop engine also trains each distinct shard's epoch shape, the
        vectorized engine one stacked batch per size."""
        from repro_torch.core.simulation import (_batched, _predict,
                                                 _sgd_epoch)
        fl = self.fl
        sizes = sorted({len(cs) for _, cs in self.timeline.batches})
        rng = np.random.default_rng(0)
        if sim.vec is None:
            sim.warmup_loop(self)
        else:
            sim._warmup_predicts()
        for k in sizes:
            clients = list(range(k))
            stacked = engine_mod.replicate_tree(sim.init_params, k)
            if sim.vec is not None:
                eng = sim.vec
                data = eng.batched_clients(rng, clients, fl.local_epochs)
                stacked, _, _ = eng.train(stacked, data)
                eng.local_accs(stacked, clients)
            if fl.attack not in ("none", "label_flip"):
                # all flags on, so the corruption runs even when the dry
                # client ids are not attackers
                attacks.corrupt_stacked(
                    stacked, stacked, np.ones(k, bool),
                    attacks.client_keys(attacks.event_key(fl.seed, 0),
                                        clients),
                    kind=fl.attack, scale=fl.attack_scale)
            if fl.defense == "norm_clip":
                robust.clip_deltas_stacked(sim.init_params, stacked,
                                           fl.clip_tau)
            if sim.codec is not None:
                stacked = sim.transport(
                    stacked, RoundPlan(clients, [sim.init_params] * k, 0))
            agg.async_batch_merge(sim.init_params, stacked,
                                  np.full(k, self.alpha, np.float32))
        if sim.vec is not None:
            return
        # warmup_loop ran a fixed 2-batch epoch and client 0's eval
        # shape; also run the actual per-shard epoch and local-eval
        # shapes of the timed `_local_train` calls (shards may be uneven)
        B = fl.local_batch_size
        done_nb, done_eval = set(), set()
        for c in np.nonzero(self.timeline.n_updates)[0]:
            x, y = sim.client_data[c]
            nb = len(x) // B
            if nb not in done_nb:
                done_nb.add(nb)
                data = _batched(x, y, B, rng, sim.device)
                _sgd_epoch(sim.init_params, sim.opt.init(sim.init_params),
                           data, (fl.lr, fl.momentum))
            n_eval = min(len(x), 512)
            if n_eval not in done_eval:
                done_eval.add(n_eval)
                _predict(sim.init_params,
                         torch.as_tensor(x[:n_eval], device=sim.device))


# ---------------------------------------------------------------------------
# deprecated legacy surface
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class AsyncResult:
    test_accuracy: float
    merges: int
    mean_staleness: float
    makespan: float
    train_accuracy: float = 0.0
    batches: int = 0
    build_time_s: float = 0.0
    classification_time_s: float = 0.0
    precision: float = 0.0
    recall: float = 0.0
    f1: float = 0.0
    balanced_accuracy: float = 0.0
    dropped_clients: Tuple[int, ...] = ()
    participants: Tuple[int, ...] = ()


class AsyncSimulation:
    """DEPRECATED wrapper: event-driven async FL over a
    `FederatedSimulation`'s client substrate. Use
    `FLConfig(strategy="async", ...)` instead; the run path is
    `AsyncStrategy` on the generic round driver either way, and this
    class only adapts the legacy constructor and `AsyncResult`."""

    def __init__(self, sync_sim, alpha=0.6, decay=0.5, speeds=None,
                 updates_per_client=4, *, speed_model="lognormal",
                 participation=1.0, dropout=0.0, tick=0.0,
                 engine: Optional[str] = None):
        warnings.warn(
            "AsyncSimulation is deprecated: async is a Strategy plugin "
            "now — use FLConfig(strategy='async') with FederatedSimulation",
            DeprecationWarning, stacklevel=2)
        self.engine = engine if engine is not None else sync_sim.fl.engine
        if self.engine not in ("loop", "vectorized"):
            raise ValueError(f"unknown engine {self.engine!r} "
                             f"(expected 'loop' or 'vectorized')")
        self.sim = sync_sim
        fl = dataclasses.replace(
            sync_sim.fl, staleness_alpha=alpha, staleness_decay=decay,
            updates_per_client=updates_per_client, speed_model=speed_model,
            participation=participation, dropout=dropout, tick=tick)
        self.strategy = AsyncStrategy(fl)
        if speeds is not None:
            self.strategy.timeline = build_timeline(
                fl.num_clients, fl.seed, speeds=speeds,
                participation=participation, dropout=dropout,
                updates_per_client=updates_per_client, tick=tick)
        tl = self.strategy.timeline
        self.speeds = tl.speeds
        self.participants = tl.participants
        self.n_updates = tl.n_updates
        self.dropped_clients = tl.dropped_clients
        self.alpha, self.decay, self.tick = alpha, decay, tick
        self.updates_per_client = updates_per_client

    def schedule(self) -> List[Tuple[float, List[int]]]:
        return [(t, list(cs)) for t, cs in self.strategy.timeline.batches]

    def run(self) -> AsyncResult:
        sim = self.sim
        prev_strategy, prev_vec = sim.strategy, sim.vec
        if self.engine == "vectorized" and sim.vec is None:
            sim.vec = engine_mod.VectorizedClientEngine(
                sim.fl, sim.client_data, sim.weights, device=sim.device)
        elif self.engine == "loop":
            sim.vec = None
        sim.strategy = self.strategy
        try:
            r = sim.run()
        finally:
            # the wrapped sim keeps its own engine and strategy
            sim.strategy, sim.vec = prev_strategy, prev_vec
        self.final_model = r.extra.get("final_model")
        e = r.extra
        return AsyncResult(
            test_accuracy=r.test_accuracy, merges=e["merges"],
            mean_staleness=e["mean_staleness"], makespan=e["makespan"],
            train_accuracy=r.train_accuracy, batches=e["batches"],
            build_time_s=r.build_time_s,
            classification_time_s=r.classification_time_s,
            precision=r.precision, recall=r.recall, f1=r.f1,
            balanced_accuracy=r.balanced_accuracy,
            dropped_clients=tuple(e["dropped_clients"]),
            participants=tuple(e["participants"]))
