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
* adversarial axis (DESIGN.md §8) — a seed-drawn Byzantine subset
  (`attack_mask`) poisons its shard (label_flip) or corrupts its upload
  between local training and aggregation (`corrupt`, and per visit in
  `sequential_round`); strategies aggregate through the defended
  operators with `defense_kwargs`.
* upload codecs (DESIGN.md §12) — `FLConfig.codec` resolves through the
  codec registry (`core/codecs.py`); `transport` encodes and decodes each
  event's upload stack between corruption and aggregation (per visit in
  `sequential_round`), with error-feedback rows gathered from and
  scattered into the per-client codec state, and logs the event's
  analytic wire bytes into the `communication` result block.
  `codec="none"` leaves `self.codec` None and every seam an identity.
* fault injection (DESIGN.md §15) — a named `fault_profile` compiles
  into a precomputed numpy schedule (`core/faults.py`) from its own
  salted generator; strategies read each event's view through
  `fault_view`, the sequential pass masks dead visitors' merges, and the
  result carries the schema-v2.5 `faults` block. `fault_profile="none"`
  builds no schedule and every fault seam is a host-level `if`.
* metric tracking + the paper's timing protocol (DESIGN.md §3): build
  time excludes the warmup, classification time is min-of-3 on the
  served model, and every timer synchronizes the card on entry and exit.

Parameters, batches and eval sets live on `device` ("cuda" by default;
the tests pass "cpu"). Float32 convolutions and matmuls run in full f32
on the card with deterministic cuDNN algorithms: the constructor turns
TF32 off and determinism on (`device.deterministic_f32`).

Configs the port does not run yet raise NotImplementedError naming the
ROADMAP item that brings them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch.core import aggregation, attacks, robust
from repro_torch.core import codecs as codecs_mod
from repro_torch.core import faults as faults_mod
from repro_torch.core import engine as engine_mod
from repro_torch.core import strategies as strat_mod
from repro_torch.core.fl_types import FLConfig
from repro_torch.core.metrics import Timer, classification_metrics
from repro_torch.data.partition import iid_partition
from repro_torch.kernels import comm_agg as comm_kernel
from repro_torch.kernels import fedavg_agg as fedavg_kernel
from repro_torch.kernels import gossip_mix as gossip_kernel
from repro_torch.kernels import ops
from repro_torch.kernels import robust_agg as robust_kernel
from repro_torch.models import cnn as cnn_mod
from repro_torch.obs import export as obs_export
from repro_torch.obs.telemetry import Telemetry
from repro_torch.optim import optimizers
from repro_torch.tree import tree_leaves, tree_map


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


# Config values the port does not run yet, each with the ROADMAP item
# that ports it.
_LATER_SLICES = (
    ("engine", lambda v: v == "fused", "§A.13 (fused executor)"),
    ("mesh_devices", lambda v: v > 1, "§A.16 (mesh)"),
    ("serve", lambda v: bool(v), "§A.14 (obs/ and serve/)"),
)


def check_slice(fl: FLConfig) -> None:
    """Raise NotImplementedError for any config the port cannot run."""
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
        self._launches0 = self._kernel_launches()
        params = (model_init or cnn_mod.init_cnn)(
            device_mod.generator(fl.seed))
        self.init_params = tree_map(
            lambda t: torch.as_tensor(t).to(self.device), params)
        self.strategy = strat_mod.get_strategy(fl.strategy)(fl)
        self.strategy.validate()
        # the upload codec (DESIGN.md §12); codec="none" leaves it None
        # and every transport seam returns early
        self.model_dim = sum(leaf.numel()
                             for leaf in tree_leaves(self.init_params))
        self.codec = None
        self.codec_state = {}
        self._comm_log: List[int] = []   # participants per logged event
        if fl.codec != "none":
            self.codec = codecs_mod.get_codec(fl.codec)(fl)
            self.codec.validate(fl)
            if (self.codec.stateful
                    and self.strategy.codec_seam != "driver"):
                raise ValueError(
                    f"codec {fl.codec!r} carries per-client state "
                    f"(error feedback), which needs the stacked driver "
                    f"upload seam; strategy {self.strategy.name!r} "
                    f"aggregates sequentially "
                    f"(codec_seam={self.strategy.codec_seam!r}) — use a "
                    f"stateless codec or a stacked strategy")
            self.codec_state = self._codec_init_state()
        # fault-injection schedule (DESIGN.md §15), from its own salted
        # generator so the run rng never shifts; None for "none"
        self.faults = faults_mod.compile_schedule(
            fl, n_events=self.strategy.num_events(self),
            event_size=self.strategy.event_size())
        self._fault_log: Dict[int, Any] = {}
        # Byzantine subset: drawn from a dedicated generator (never the
        # schedule rng), so the attack axis leaves the §4 parity intact
        self.attack_mask = (
            attacks.attacker_mask(fl.num_clients, fl.attack_fraction,
                                  fl.seed, placement=fl.attack_placement)
            if fl.attack != "none" else np.zeros(fl.num_clients, bool))
        self.attackers = np.flatnonzero(self.attack_mask)
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

    @staticmethod
    def _kernel_launches():
        return {"fedavg_agg": fedavg_kernel.launches,
                "trimmed_mean_agg": robust_kernel.launches,
                "gossip_mix_agg": gossip_kernel.launches,
                "dequant_agg": comm_kernel.launches}

    def set_partition(self, parts):
        """Re-partition the train split (e.g. Dirichlet non-IID) after
        construction; rebuilds the vectorized engine state if active."""
        self._install_clients(parts)

    def _install_clients(self, parts):
        """Per-client shards from a partition: label_flip poisons the
        attackers' shards here (the poisoned shard is what both engines
        batch from), and the vectorized engine state is (re)built on the
        final data."""
        xtr, ytr = self.dataset["train"]
        self.parts = parts
        self.client_data = []
        for c, p in enumerate(parts):
            y = ytr[p]
            if self.fl.attack == "label_flip" and self.attack_mask[c]:
                y = attacks.flip_labels(y)
            self.client_data.append((xtr[p], y))
        self.weights = [len(p) for p in parts]
        self._eval_dev = {}              # per-client device eval shards
        self._split_cache = {}           # device test/train eval chunks
        self.vec = (engine_mod.VectorizedClientEngine(
                        self.fl, self.client_data, self.weights,
                        device=self.device)
                    if self.fl.engine == "vectorized" else None)

    # -- driver primitives (the plugin-facing surface) ----------------------
    def defense_kwargs(self, event_size=None) -> Dict[str, Any]:
        """kwargs for the defended aggregation operators, with the
        Byzantine allowance resolved for this event's client count."""
        fl = self.fl
        return {"defense": fl.defense,
                "f": fl.resolved_defense_f(event_size),
                "tau": fl.clip_tau}

    def _bases_stacked(self, plan):
        """The plan's round-start bases as ONE stacked tree, built at most
        once per plan (from the strategy's lazy `bases_stacked_fn` if
        declared, else by stacking the list) and shared by the stacked
        training input, the FedProx proximal reference and corruption.
        Training builds new tensors and never writes to its input."""
        bases = plan.meta.get("bases_stacked")
        if bases is None:
            fn = plan.meta.get("bases_stacked_fn")
            bases = plan.meta["bases_stacked"] = (
                fn() if fn is not None
                else engine_mod.stack_forest(plan.bases))
        return bases

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
                bases = self._bases_stacked(plan)
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

    def corrupt(self, uploads, plan):
        """Corrupt the attacker rows of the trained upload stack against
        the plan's round-start bases; noise keys derive from (seed, event,
        absolute client id), so both engines corrupt alike."""
        fl = self.fl
        flags = self.attack_mask[np.asarray(plan.participants, int)]
        if fl.attack in ("none", "label_flip") or not flags.any():
            return uploads
        with self.telemetry.span("corrupt", attackers=int(flags.sum())):
            keys = attacks.client_keys(
                attacks.event_key(fl.seed, plan.event), plan.participants)
            return attacks.corrupt_stacked(
                uploads, self._bases_stacked(plan), flags, keys,
                kind=fl.attack, scale=fl.attack_scale)

    def transport(self, uploads, plan):
        """Ship one event's upload stack through the active codec:
        encode -> decode on the raveled (k, N) matrix, error-feedback rows
        gathered from and scattered into the per-client codec state, and
        the event's analytic wire bytes logged (DESIGN.md §12). Identity
        when codec="none". Runs after `corrupt` (the wire carries the
        corrupted encoded update) and before aggregation (defenses see
        dequantized coordinates)."""
        codec = self.codec
        if codec is None:
            return uploads
        fl = self.fl
        with self.telemetry.span("encode_decode", codec=codec.name):
            mat = ops.stacked_ravel(uploads)
            keys = codecs_mod.upload_keys(fl.seed, plan.event,
                                          plan.participants)
            base = (ops.stacked_ravel(self._bases_stacked(plan))
                    if codec.needs_bases else None)
            if codec.stateful:
                pids = torch.as_tensor(np.asarray(plan.participants,
                                                  np.int64),
                                       device=mat.device)
                rows = {k: a[pids] for k, a in self.codec_state.items()}
                dec, new_rows = codec.scan_encode_decode(
                    mat, keys, base=base, rows=rows)
                self.codec_state = {
                    k: a.index_copy(0, pids, new_rows[k])
                    for k, a in self.codec_state.items()}
            else:
                dec, _ = codec.scan_encode_decode(mat, keys, base=base,
                                                  rows=None)
            self._comm_log.append(len(plan.participants))
            self.telemetry.counter(
                "codec.uplink_bytes",
                len(plan.participants) * codec.bytes_on_wire(self.model_dim))
            return ops.stacked_unravel(uploads, dec)

    def _codec_init_state(self):
        return self.codec.init_state(self.fl.num_clients, self.model_dim,
                                     device=self.device)

    def _reset_codec(self):
        """Re-zero the codec state and the wire log (warmups dry-run the
        transport, which must not leak residuals or bytes into the
        measured run)."""
        if self.codec is not None:
            self.codec_state = self._codec_init_state()
            self._comm_log = []

    def fault_view(self, plan):
        """The plan's event-level fault view (DESIGN.md §15), or None when
        fault injection is off. Precomputed numpy indexing, so strategies
        may call it from aggregation events and warmup dry-runs alike;
        every call logs the view into `_fault_log` (idempotently: the
        schedule is immutable), which feeds the result's `faults` block."""
        if self.faults is None:
            return None
        fe = self.faults.event_view(plan.event, plan.participants)
        self._fault_log[plan.event] = fe
        return fe

    def sequential_round(self, model, order, event, alpha, spec, rng):
        """One continual (CFL-style) pass: clients train in visit order,
        each (possibly corrupted, possibly norm-clipped) update merging
        into the carried model; the visit's corruption base is the model
        it pulled. Loop engine: per-visit training + host merges;
        vectorized: one pass over the visits with the kernel-backed merge.
        Under faults a dead visitor still trains (rng parity) but its
        merge is discarded, and a below-quorum round reverts to its start
        model. Returns (model, losses, accs)."""
        fl = self.fl
        codec = self.codec
        attacking = fl.attack not in ("none", "label_flip")
        keys = attacks.client_keys(attacks.event_key(fl.seed, event), order)
        # the strategy's run_event has logged this event's view
        fe = (self.faults.event_view(event, order)
              if self.faults is not None else None)
        # per-visit wire seam (stateless codecs only): every visit ships,
        # keyed by (seed, event, absolute client id)
        ckeys = (codecs_mod.upload_keys(fl.seed, event, order)
                 if codec is not None else None)
        with self.telemetry.span("sequential_round", k=len(order)):
            if codec is not None:
                self._comm_log.append(len(order))
                self.telemetry.counter(
                    "codec.uplink_bytes",
                    len(order) * codec.bytes_on_wire(self.model_dim))
            if self.vec is not None:
                eng = self.vec
                data = eng.batched_clients(rng, order, fl.local_epochs)
                model, losses, accs = eng.cfl_round(
                    model, order, data, alpha, attack=fl.attack,
                    attack_scale=fl.attack_scale,
                    attack_flags=self.attack_mask[np.asarray(order, int)],
                    attack_keys=keys, defense=fl.defense,
                    clip_tau=fl.clip_tau, codec=codec, codec_keys=ckeys,
                    fault_alive=None if fe is None else fe.alive,
                    fault_qok=None if fe is None else fe.qok)
                return (model,
                        losses[:, -eng.nb:].mean(dim=1).cpu().numpy(),
                        accs.cpu().numpy())
            losses, accs = [], []
            model0 = model
            for i, (c, key) in enumerate(zip(order, keys)):
                local, loss, acc = self._local_train(model, c, spec=spec)
                losses.append(loss)
                accs.append(acc)
                if fe is not None and not fe.alive_b[i]:
                    continue         # upload lost: the merge is discarded
                if attacking and self.attack_mask[c]:
                    local = attacks.corrupt_tree(local, model, True, key,
                                                 kind=fl.attack,
                                                 scale=fl.attack_scale)
                if codec is not None:
                    # the merged update is the decoded encoding of the
                    # (corrupted) local model
                    local = codecs_mod.roundtrip_tree(
                        codec, local, [ckeys[i]], base_tree=model)
                if fl.defense == "norm_clip":
                    local = robust.clip_update(model, local, fl.clip_tau)
                model = aggregation.cfl_merge(model, local, alpha)
            if fe is not None and not fe.qok:
                model = model0       # below quorum: the round holds
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
        self._warmup_attack()
        n_eval = min(len(x), 512)
        _predict(self.init_params,
                 torch.as_tensor(x[:n_eval], device=self.device))

    def _warmup_attack(self):
        """Run the loop engine's per-client corruption and clip once
        outside the build window (first-use allocations)."""
        fl = self.fl
        if fl.attack not in ("none", "label_flip") and len(self.attackers):
            attacks.corrupt_tree(self.init_params, self.init_params, True,
                                 (fl.seed, 0, 0), kind=fl.attack,
                                 scale=fl.attack_scale)
        if fl.defense == "norm_clip":
            robust.clip_update(self.init_params, self.init_params,
                               fl.clip_tau)

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
        self._reset_codec()
        n_events = strat.num_events(self)
        all_accs: List[float] = []
        train_acc = 0.0
        build_timer = Timer(device=self.device)

        with build_timer:
            for ev in range(n_events):
                state, accs, losses = strat.run_event(self, state, ev)
                train_acc = float(np.mean(np.asarray(accs)))
                all_accs.extend(float(a) for a in np.ravel(accs))
                if strat.track_curves:
                    self._track(curves, accs, losses,
                                strat.round_model(state))
        if strat.mean_train_acc_over_events:
            train_acc = float(np.mean(all_accs)) if all_accs else 0.0
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
        if self.codec is not None:
            extra["communication"] = self._communication_block()
        if self.faults is not None:
            # schema-v2.5 faults block, absent when fault_profile="none"
            extra["faults"] = self._faults_block()
        if self.vec is not None and self.vec.dropped_samples:
            # the stacked engine trains every client for the federation-
            # minimum batch count (engine.ShardTruncationWarning)
            extra["truncated_samples_per_epoch"] = dict(
                self.vec.dropped_samples)
        extra["telemetry"] = obs_export.result_block(self.telemetry)
        # launches of the hand-written kernels since construction (0 on
        # the CPU, where the wrappers take their plain versions)
        extra["kernel_launches"] = {
            k: v - self._launches0[k]
            for k, v in self._kernel_launches().items()}
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

    def _faults_block(self) -> Dict[str, Any]:
        """The schema-v2.5 `faults` result block (DESIGN.md §15): the
        schedule's statistics (deterministic in (seed, profile)) plus the
        run's observed event log — quorum failures, degraded rounds and
        the mean alive fraction over the events driven."""
        block = self.faults.schedule_stats()
        log = self._fault_log
        fails = sorted(ev for ev, fe in log.items() if not fe.qok)
        degraded = sorted(ev for ev, fe in log.items()
                          if fe.n_alive < len(fe.alive))
        block["events_logged"] = len(log)
        block["quorum_failures"] = len(fails)
        block["quorum_failed_events"] = fails
        block["degraded_rounds"] = len(degraded)
        block["mean_event_alive_frac"] = (
            float(np.mean([fe.n_alive / max(1, len(fe.alive))
                           for fe in log.values()])) if log else 1.0)
        return block

    def _communication_block(self) -> Dict[str, Any]:
        """The byte-count cost model (DESIGN.md §12), from the per-event
        participant log. Analytic: bytes follow from the wire format and
        the participant count, never from device buffers, so they are the
        same under every engine and device. Uplink is what participants
        ship through the codec; downlink the dense model each pulled; the
        compression ratio is dense f32 uplink over codec uplink."""
        codec, dim = self.codec, self.model_dim
        per_up = [k * codec.bytes_on_wire(dim) for k in self._comm_log]
        per_down = [k * 4 * dim for k in self._comm_log]
        up, dense = sum(per_up), sum(per_down)
        return {
            "codec": codec.name,
            "uplink_bytes_per_round": per_up,
            "downlink_bytes_per_round": per_down,
            "uplink_bytes": int(up),
            "downlink_bytes": int(sum(per_down)),
            "dense_uplink_bytes": int(dense),
            "compression_ratio": (dense / up) if up else 1.0,
        }

    def _track(self, curves, accs, losses, model_for_eval):
        curves["train_acc"].append(float(np.mean(np.asarray(accs))))
        curves["train_loss"].append(float(np.mean(np.asarray(losses))))
        with self.telemetry.span("eval"):
            preds = self._eval(model_for_eval)
        curves["test_acc"].append(
            float(np.mean(preds == self.dataset["test"][1])))
