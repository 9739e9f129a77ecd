"""Host-level federated-learning simulation — the generic round driver
(port of `repro.core.simulation` for the `loop` and `vectorized`
engines).

Runs the paper's CNN on client-partitioned data under the HFL, AFL or
CFL strategy (`core/strategies.py`) and reports the paper's measurement
suite (Tables 1-2): training / testing accuracy, build time,
classification time, precision, recall, F1, balanced accuracy, confusion
matrix, and per-round accuracy/loss curves (Figures 9/11).

* engine dispatch — `FLConfig.engine` selects how one event's local
  training executes:
    "loop"       — per-client Python loop (the paper-faithful timing
                   surface).
    "vectorized" — the federation as one stacked tree; local training is
                   one stacked step sequence and aggregation goes through
                   the kernel-backed stacked operators.
* rng-parity bookkeeping — batch construction consumes the run rng in
  one canonical order (client-major, epoch-minor) under both engines
  (DESIGN.md §4).
* metric tracking + the paper's timing protocol (DESIGN.md §3): build
  time excludes the warmup, classification time is min-of-3 on the
  served model, and every timer synchronizes the card on entry and exit.

Parameters, batches and eval sets live on `device` ("cuda" by default;
the tests pass "cpu"). Float32 convolutions and matmuls run in full f32
on the card with deterministic cuDNN algorithms: the constructor turns
TF32 off and determinism on (`device.deterministic_f32`).

Configs outside this slice raise NotImplementedError naming the ROADMAP
item that brings them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch.core import aggregation
from repro_torch.core import engine as engine_mod
from repro_torch.core import strategies as strat_mod
from repro_torch.core.fl_types import FLConfig
from repro_torch.core.metrics import Timer, classification_metrics
from repro_torch.data.partition import iid_partition
from repro_torch.kernels import fedavg_agg as fedavg_kernel
from repro_torch.models import cnn as cnn_mod
from repro_torch.obs import export as obs_export
from repro_torch.obs.telemetry import Telemetry
from repro_torch.optim import optimizers
from repro_torch.tree import tree_map


@dataclasses.dataclass
class FLResult:
    strategy: str
    dataset: str
    train_accuracy: float
    test_accuracy: float
    build_time_s: float
    classification_time_s: float
    precision: float
    recall: float
    f1: float
    balanced_accuracy: float
    confusion: np.ndarray
    round_train_acc: List[float]
    round_train_loss: List[float]
    round_test_acc: List[float]
    # DESIGN.md §3 timing split: `build_time_s` is the steady-state
    # measured window (warmup excluded); `warmup_time_s` is the warmup
    # window that precedes it; `steady_time_s` aliases build_time_s
    warmup_time_s: float = 0.0
    steady_time_s: float = 0.0
    # the schema-v2.3 "telemetry" block and the run's kernel launches
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def row(self) -> Dict[str, float]:
        return {k: getattr(self, k) for k in
                ("strategy", "dataset", "train_accuracy", "test_accuracy",
                 "build_time_s", "classification_time_s", "precision",
                 "recall", "f1", "balanced_accuracy")}


# Config values outside slice 1, each with the ROADMAP item that ports it.
_LATER_SLICES = (
    ("engine", lambda v: v == "fused", "§A.13 (fused executor)"),
    ("mesh_devices", lambda v: v > 1, "§A.16 (mesh)"),
    ("codec", lambda v: v != "none", "§A.11 (codecs, kernel B4)"),
    ("fault_profile", lambda v: v != "none", "§A.12 (churn, kernel B3)"),
    ("attack", lambda v: v != "none", "§A.9 (adversarial axis, kernel B2)"),
    ("defense", lambda v: v != "none", "§A.9 (adversarial axis, kernel B2)"),
    ("serve", lambda v: bool(v), "§A.14 (obs/ and serve/)"),
    ("strategy", lambda v: v not in ("hfl", "afl", "cfl"),
     "§A.8 (strategy plugins and async)"),
)


def check_slice(fl: FLConfig) -> None:
    """Raise NotImplementedError for any config this slice cannot run."""
    for field, outside, item in _LATER_SLICES:
        value = getattr(fl, field)
        if outside(value):
            raise NotImplementedError(
                f"FLConfig.{field}={value!r} is not ported yet: "
                f"ROADMAP {item} brings it to repro_torch")


# ---------------------------------------------------------------------------

def _sgd_epoch(params, opt_state, data, lr_momentum, *,
               loss_fn=cnn_mod.cnn_loss, extra=None):
    """One local epoch over pre-batched data: (nb, B, 28,28,1)/(nb, B).
    Returns (params, opt_state, mean loss, mean acc) as device tensors."""
    lr, momentum = lr_momentum
    opt = optimizers.sgd(lr, momentum=momentum)
    nb = data["label"].shape[0]
    params, opt_state, losses, accs = engine_mod.sgd_steps(
        params, opt_state,
        [{k: v[i] for k, v in data.items()} for i in range(nb)],
        opt, loss_fn, extra)
    return (params, opt_state, torch.stack(losses).mean(),
            torch.stack(accs).mean())


@torch.no_grad()
def _predict(params, images):
    return cnn_mod.cnn_apply(params, images).argmax(-1)


def _batched(x, y, batch_size, rng, device):
    order = rng.permutation(len(x))
    nb = len(x) // batch_size
    sel = order[: nb * batch_size]
    return {"image": torch.as_tensor(
                x[sel].reshape(nb, batch_size, *x.shape[1:]), device=device),
            "label": torch.as_tensor(
                y[sel].reshape(nb, batch_size), dtype=torch.long,
                device=device)}


class FederatedSimulation:
    """Python-level multi-client FL simulation on one device: the generic
    round driver plus the engine and metric machinery the Strategy
    protocol builds on.

    `model_init` is a callable taking a CPU `torch.Generator` seeded with
    `fl.seed` and returning the parameter tree (default `init_cnn`); the
    tree is moved to `device`, so one seed gives the same initial model on
    every device. Tests inject the reference's parameters through it."""

    def __init__(self, fl: FLConfig, dataset: Dict[str, Any],
                 model_init=None, device="cuda"):
        check_slice(fl)
        self.device = device_mod.resolve_device(device)
        device_mod.deterministic_f32()
        self.fl = fl
        self.dataset = dataset
        self.rng = np.random.default_rng(fl.seed)
        # per-run tracer (DESIGN.md §13); dispatch counters and kernel
        # launches are snapshotted here so the run's delta is its own
        self.telemetry = Telemetry(enabled=fl.telemetry)
        self._launches0 = fedavg_kernel.launches
        params = (model_init or cnn_mod.init_cnn)(
            device_mod.generator(fl.seed))
        self.init_params = tree_map(
            lambda t: torch.as_tensor(t).to(self.device), params)
        self.strategy = strat_mod.get_strategy(fl.strategy)(fl)
        self.strategy.validate()
        self.opt = optimizers.sgd(fl.lr, momentum=fl.momentum)
        xtr, ytr = dataset["train"]
        self._install_clients(iid_partition(ytr, fl.num_clients,
                                            seed=fl.seed))

    # -- local work ---------------------------------------------------------
    def _local_train(self, params, cid, spec=None):
        """Returns (params, last-epoch loss, POST-training local accuracy).

        "Training accuracy" follows the paper's protocol: the client's
        local model evaluated on its own shard after local training."""
        x, y = self.client_data[cid]
        loss_fn = spec.loss_fn if spec is not None else cnn_mod.cnn_loss
        extra = params if (spec is not None and spec.extra == "bases") \
            else None
        opt_state = self.opt.init(params)
        loss = torch.zeros(())
        for _ in range(self.fl.local_epochs):
            data = _batched(x, y, self.fl.local_batch_size, self.rng,
                            self.device)
            params, opt_state, loss, _ = _sgd_epoch(
                params, opt_state, data, (self.fl.lr, self.fl.momentum),
                loss_fn=loss_fn, extra=extra)
        n_eval = min(len(x), 512)
        preds = _predict(params, self._client_eval_dev(cid)).cpu().numpy()
        acc = float(np.mean(preds == y[:n_eval]))
        return params, float(loss), acc

    # -- device-resident eval arrays (built once per run, not per call) -----
    def _client_eval_dev(self, cid):
        dev = self._eval_dev.get(cid)
        if dev is None:
            x, _ = self.client_data[cid]
            dev = self._eval_dev[cid] = torch.as_tensor(
                x[: min(len(x), 512)], device=self.device)
        return dev

    def _split_dev(self, split, batch):
        """The split's images as device-resident `batch`-sized chunks."""
        key = (split, batch)
        chunks = self._split_cache.get(key)
        if chunks is None:
            x = self.dataset[split][0]
            chunks = [torch.as_tensor(x[i:i + batch], device=self.device)
                      for i in range(0, len(x), batch)]
            self._split_cache[key] = chunks
        return chunks

    def _eval(self, params, split="test", batch=500):
        return np.concatenate(
            [_predict(params, xb).cpu().numpy()
             for xb in self._split_dev(split, batch)])

    def _install_clients(self, parts):
        xtr, ytr = self.dataset["train"]
        self.parts = parts
        self.client_data = [(xtr[p], ytr[p]) for p in parts]
        self.weights = [len(p) for p in parts]
        self._eval_dev = {}              # per-client device eval shards
        self._split_cache = {}           # device test/train eval chunks
        self.vec = (engine_mod.VectorizedClientEngine(
                        self.fl, self.client_data, self.weights,
                        device=self.device)
                    if self.fl.engine == "vectorized" else None)

    # -- driver primitives (the plugin-facing surface) ----------------------
    def _build_bases_stacked(self, plan):
        """One FRESH stacked round-start-bases tree: from the strategy's
        lazy `bases_stacked_fn` if declared, else by stacking the list."""
        fn = plan.meta.get("bases_stacked_fn")
        return (fn() if fn is not None
                else engine_mod.stack_forest(plan.bases))

    def local_train(self, plan, spec, rng):
        """One event's local training under the active engine. Consumes
        `rng` in the canonical client-major, epoch-minor order (§4) and
        returns (stacked uploads, per-client losses, per-client accs) —
        the uploads carry a leading participant axis under BOTH engines,
        so strategies aggregate through one stacked-operator path."""
        fl = self.fl
        with self.telemetry.span("local_train", k=len(plan.participants)):
            if self.vec is not None:
                eng = self.vec
                data = eng.batched_clients(rng, plan.participants,
                                           fl.local_epochs)
                bases = self._build_bases_stacked(plan)
                extra = bases if spec.extra == "bases" else None
                params, losses, _ = eng.train(
                    bases, data, stacked_loss_fn=spec.stacked_loss_fn,
                    extra=extra)
                accs = eng.local_accs(params, plan.participants)
                return (params,
                        losses[:, -eng.nb:].mean(dim=1).cpu().numpy(), accs)
            locals_, losses, accs = [], [], []
            for c, base in zip(plan.participants, plan.bases):
                p, loss, acc = self._local_train(base, c, spec=spec)
                locals_.append(p)
                losses.append(loss)
                accs.append(acc)
            return engine_mod.stack_forest(locals_), losses, accs

    def sequential_round(self, model, order, alpha, spec, rng):
        """One continual (CFL-style) pass: clients train in visit order,
        each update merging into the carried model. Loop engine: per-visit
        training + host merges; vectorized: one pass over the visits with
        the kernel-backed merge. Returns (model, losses, accs)."""
        with self.telemetry.span("sequential_round", k=len(order)):
            if self.vec is not None:
                eng = self.vec
                data = eng.batched_clients(rng, order, self.fl.local_epochs)
                model, losses, accs = eng.cfl_round(model, order, data,
                                                    alpha)
                return (model,
                        losses[:, -eng.nb:].mean(dim=1).cpu().numpy(),
                        accs.cpu().numpy())
            losses, accs = [], []
            for c in order:
                local, loss, acc = self._local_train(model, c, spec=spec)
                model = aggregation.cfl_merge(model, local, alpha)
                losses.append(loss)
                accs.append(acc)
            return model, losses, accs

    # -- warmup (DESIGN.md §3: one-time costs stay out of the timers) -------
    def warmup_default(self, strategy):
        """Engine-appropriate default warmup for a strategy: loop runs
        the local-train/predict programs once; vectorized dry-runs one
        FINAL event (tier-2 paths included) plus the served model with a
        throwaway rng — `self.rng` is untouched."""
        if self.vec is None:
            self.warmup_loop(strategy)
            strategy.warmup_aggregate(self)
            return
        self._warmup_predicts()
        rng = np.random.default_rng(self.fl.seed)
        state = strategy.init_state(self)
        state, _, _ = strategy.run_event(
            self, state, strategy.num_events(self) - 1, rng=rng)
        strategy.served_fn(self, state)()

    def warmup_loop(self, strategy):
        """Run the loop engine's programs once outside the measured
        windows."""
        spec = strategy.local_spec(
            self, None, strat_mod.RoundPlan([0], [self.init_params], 0))
        x, y = self.client_data[0]
        data = _batched(x[: 2 * self.fl.local_batch_size],
                        y[: 2 * self.fl.local_batch_size],
                        self.fl.local_batch_size, np.random.default_rng(0),
                        self.device)
        extra = self.init_params if spec.extra == "bases" else None
        _sgd_epoch(self.init_params, self.opt.init(self.init_params), data,
                   (self.fl.lr, self.fl.momentum), loss_fn=spec.loss_fn,
                   extra=extra)
        self._warmup_predicts()
        n_eval = min(len(x), 512)
        _predict(self.init_params,
                 torch.as_tensor(x[:n_eval], device=self.device))

    def _warmup_predicts(self):
        """Run the classification/eval `_predict` shapes once (shared by
        both engines)."""
        x_test = self.dataset["test"][0]
        shard = -(-len(x_test) // self.fl.num_clients)
        for xb in (x_test[:500], x_test, x_test[:shard]):
            _predict(self.init_params, torch.as_tensor(xb,
                                                       device=self.device))

    # -- the generic driver loop --------------------------------------------
    def run(self) -> FLResult:
        fl, strat = self.fl, self.strategy
        tel = self.telemetry
        curves = {"train_acc": [], "train_loss": [], "test_acc": []}
        state = strat.init_state(self)
        # warmup is suppressed so one-time costs never pollute the phase
        # totals (DESIGN.md §13); its window is timed separately (§3)
        warmup_timer = Timer(device=self.device)
        with tel.span("warmup", cat="run"), warmup_timer, tel.suppress():
            strat.warmup(self)
        n_events = strat.num_events(self)
        train_acc = 0.0
        build_timer = Timer(device=self.device)

        with build_timer:
            for ev in range(n_events):
                state, accs, losses = strat.run_event(self, state, ev)
                train_acc = float(np.mean(np.asarray(accs)))
                self._track(curves, accs, losses, strat.round_model(state))
        return self._classify_and_result(state, curves, train_acc,
                                         build_timer,
                                         warmup_timer=warmup_timer)

    def _test_head_dev(self, shard):
        """Cached device-resident head of the test split (the
        classification-phase input)."""
        key = ("test_head", shard)
        dev = self._split_cache.get(key)
        if dev is None:
            dev = self._split_cache[key] = torch.as_tensor(
                self.dataset["test"][0][:shard], device=self.device)
        return dev

    def _classify_and_result(self, state, curves, train_acc,
                             build_timer, warmup_timer=None) -> FLResult:
        """The paper's classification-time protocol (§1.2.7) + result
        assembly: centralized strategies serve the full test set at the
        server (after materializing the served model); decentralized
        strategies classify on-device — every client scores its own 1/N
        test shard in parallel, so measured wall time is one shard pass
        (+ any pre-serving aggregation the strategy's served_fn
        performs)."""
        fl, strat = self.fl, self.strategy
        served_fn = strat.served_fn(self, state)
        x_test, y_true = self.dataset["test"]
        shard = (len(x_test) if strat.centralized
                 else -(-len(x_test) // fl.num_clients))
        xs = self._test_head_dev(shard)
        with self.telemetry.span("classify", cat="run"):
            best = None
            for _ in range(3):      # min-of-3: immune to scheduler noise
                t = Timer(device=self.device)
                with t:
                    served = served_fn()
                    pred_head = _predict(served, xs).cpu().numpy()
                best = t.elapsed if best is None else min(best, t.elapsed)
            pred_tail = (self._eval(served)[shard:] if shard < len(x_test)
                         else np.empty((0,), pred_head.dtype))
            y_pred = np.concatenate([pred_head, pred_tail])
            m = classification_metrics(y_true, y_pred, 10)

        extra = dict(strat.extra_result(self, state))
        if self.vec is not None and self.vec.dropped_samples:
            # the stacked engine trains every client for the federation-
            # minimum batch count (engine.ShardTruncationWarning)
            extra["truncated_samples_per_epoch"] = dict(
                self.vec.dropped_samples)
        extra["telemetry"] = obs_export.result_block(self.telemetry)
        # launches of the hand-written kernel since construction (0 on
        # the CPU, where the wrapper takes its plain version)
        extra["kernel_launches"] = {
            "fedavg_agg": fedavg_kernel.launches - self._launches0}
        extra["device"] = str(self.device)

        return FLResult(
            strategy=strat.name, dataset=self.dataset["name"],
            train_accuracy=train_acc, test_accuracy=m["accuracy"],
            build_time_s=build_timer.elapsed,
            classification_time_s=best,
            precision=m["precision"], recall=m["recall"], f1=m["f1"],
            balanced_accuracy=m["balanced_accuracy"], confusion=m["confusion"],
            round_train_acc=curves["train_acc"],
            round_train_loss=curves["train_loss"],
            round_test_acc=curves["test_acc"],
            warmup_time_s=(warmup_timer.elapsed
                           if warmup_timer is not None else 0.0),
            steady_time_s=build_timer.elapsed,
            extra=extra,
        )

    def _track(self, curves, accs, losses, model_for_eval):
        curves["train_acc"].append(float(np.mean(np.asarray(accs))))
        curves["train_loss"].append(float(np.mean(np.asarray(losses))))
        with self.telemetry.span("eval"):
            preds = self._eval(model_for_eval)
        curves["test_acc"].append(
            float(np.mean(preds == self.dataset["test"][1])))
