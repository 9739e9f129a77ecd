"""Host-level federated-learning simulation — the generic round driver
(port of `repro.core.simulation`: the `loop`, `vectorized` and `fused`
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
    "fused"      — the whole run on the device (`run_fused`, DESIGN.md
                   §10): schedules, batch indices, attack, codec and fault
                   inputs are hoisted out of the rounds (same rng order,
                   so §4 parity holds), one round is one function of
                   device tensors — on the card captured once as a CUDA
                   graph and replayed every round, on the CPU run eagerly
                   round by round — and the per-round metrics come back in
                   ONE device-to-host transfer at run end. With
                   `mesh_devices=N` (DESIGN.md §11) the rounds run in N
                   rank processes on `torch.distributed`, each on its
                   contiguous sub-stack of clients (`run_fused`).
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
* federation-in-the-loop serving (DESIGN.md §14) — `serve=True` runs the
  `serve.ServeSession` side-car: each round's global model is published
  at its round boundary (replayed after the run by the fused engine) and
  a virtual-clock open-loop trace is served on the card between swaps;
  the result carries the schema-v2.4 `serving` block, the same bytes
  under every engine.
* metric tracking + the paper's timing protocol (DESIGN.md §3): build
  time excludes the warmup, classification time is min-of-3 on the
  served model, and every timer synchronizes the card on entry and exit.

Parameters, batches and eval sets live on `device` ("cuda" by default;
the tests pass "cpu"). Float32 convolutions and matmuls run in full f32
on the card with deterministic cuDNN algorithms: the constructor turns
TF32 off and determinism on (`device.deterministic_f32`).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch.core import aggregation, attacks, collectives, robust
from repro_torch.core import codecs as codecs_mod
from repro_torch.core import faults as faults_mod
from repro_torch.core import engine as engine_mod
from repro_torch.core import strategies as strat_mod
from repro_torch.core.fl_types import FLConfig
from repro_torch.core.metrics import Timer, classification_metrics
from repro_torch.data.partition import iid_partition
from repro_torch.kernels import ops
from repro_torch.models import cnn as cnn_mod
from repro_torch.obs import collectors as obs_collectors
from repro_torch.obs import export as obs_export
from repro_torch.obs.telemetry import Telemetry
from repro_torch.optim import optimizers
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


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


class FusedContext:
    """What one fused round sees (DESIGN.md §10): the device-resident run
    state — stacked federation dataset, per-client eval shards, client
    weights, test split — plus the static config and the run's device
    constants. `Strategy.scan_round` / `scan_bases` / `scan_aggregate`
    receive it as their first argument.

    On the mesh (DESIGN.md §11) the round runs in every rank and every
    client-axis tensor here is the rank's sub-stack: `mesh_axis` is the
    rank's `launch.mesh.MeshAxis`, `local_pids` maps absolute participant
    ids to the rank's rows (the client axis is split contiguously), and
    `pmean` averages per-round scalars over the ranks. All three are the
    identity when `mesh_axis` is None, so strategy code is written once."""

    def __init__(self, sim, consts, *, mesh_axis=None):
        self.sim, self.fl, self.eng = sim, sim.fl, sim.vec
        self.nb = sim.vec.nb
        self.data_x = consts["data_x"]
        self.data_y = consts["data_y"]
        self.eval_x = consts["eval_x"]
        self.eval_y = consts["eval_y"]
        self.weights = consts["weights"]          # (C,) float32
        self.x_test = consts["x_test"]
        self.y_test = consts["y_test"]
        self.track = sim.strategy.track_curves
        self.mesh_axis = mesh_axis
        self._consts: Dict[str, torch.Tensor] = {}
        # per-client codec state (error-feedback residuals) of the
        # current round: the driver parks the carried rows here across
        # the strategy's scan_round call (None when stateless or off)
        self._codec_carry = None

    def const(self, key, make):
        """The run's device constant `key`, built from the host array
        `make()` at its first use — a warmup round, before any capture —
        and reused by every round after (no host-to-device copy in a
        round)."""
        t = self._consts.get(key)
        if t is None:
            t = self._consts[key] = torch.as_tensor(make(),
                                                    device=self.sim.device)
        return t

    def local_pids(self, pids):
        """Absolute participant ids -> rows of this rank's sub-stack
        (identity off the mesh). Valid under the full participation that
        `_mesh_check` enforces: rank s holds ids [s*C_loc, (s+1)*C_loc)."""
        if self.mesh_axis is None:
            return pids
        return pids - self.mesh_axis.index * self.data_x.shape[0]

    def pmean(self, *xs):
        """The mean over the ranks of per-rank scalars, in one all_reduce
        (identity off the mesh; shards are equal, so the mean of shard
        means is the federation mean). Returns a tuple."""
        if self.mesh_axis is None:
            return xs
        buf = collectives.all_reduce_sum(torch.stack(xs), self.mesh_axis)
        return tuple((buf / self.mesh_axis.size).unbind())

    def defense_kwargs(self, event_size=None):
        return self.sim.defense_kwargs(event_size)

    @torch.no_grad()
    def local_accs(self, params, pids):
        """The paper's post-training local-shard accuracy, on the device —
        `VectorizedClientEngine.local_accs` without the host read."""
        preds = engine_mod.predict_clients(
            params, self.eval_x[pids],
            stacked_apply_fn=self.eng.stacked_apply_fn)
        return (preds == self.eval_y[pids]).float().mean(dim=1)

    def corrupt(self, uploads, bases, xs):
        """In-round attack corruption: the per-round operator with the
        flags and the gauss noise hoisted into the round's inputs; honest
        rows pass through bitwise (DESIGN.md §8)."""
        fl = self.fl
        if fl.attack in ("none", "label_flip") \
                or not self.sim.attack_mask.any():
            return uploads
        return attacks.corrupt_stacked(uploads, bases, xs["flags"], None,
                                       kind=fl.attack, scale=fl.attack_scale,
                                       noise=xs.get("noise"))

    def transport(self, uploads, bases, xs):
        """In-round codec round trip — the fused twin of
        `FederatedSimulation.transport`, with the codec's draws hoisted
        into `xs['ckeys']`; error-feedback rows ride the carry through
        `_codec_carry`. Identity when codec="none"."""
        codec = self.sim.codec
        if codec is None:
            return uploads
        mat = ops.stacked_ravel(uploads)
        base = ops.stacked_ravel(bases) if codec.needs_bases else None
        keys = xs.get("ckeys")
        if codec.stateful:
            pids = xs["pids"]
            rows = {k: a[pids] for k, a in self._codec_carry.items()}
            dec, new_rows = codec.scan_encode_decode(mat, keys, base=base,
                                                     rows=rows)
            self._codec_carry = {k: a.index_copy(0, pids, new_rows[k])
                                 for k, a in self._codec_carry.items()}
        else:
            dec, _ = codec.scan_encode_decode(mat, keys, base=base,
                                              rows=None)
        return ops.stacked_unravel(uploads, dec)

    @torch.no_grad()
    def test_acc(self, model):
        """Per-round curve point on the full test split, in the per-round
        driver's 500-image chunks (NaN when curves are off)."""
        if not self.track:
            return torch.full((), float("nan"), device=self.x_test.device)
        n = self.x_test.shape[0]
        preds = torch.cat([_predict(model, self.x_test[i:i + 500])
                           for i in range(0, n, 500)])
        return (preds == self.y_test).float().mean()


def _fused_consts(sim):
    """The device arrays every fused round reads."""
    eng = sim.vec
    data_x, data_y = eng.stacked_dataset()
    x_test, y_test = sim.dataset["test"]
    return {"data_x": data_x, "data_y": data_y,
            "eval_x": eng.eval_x, "eval_y": eng.eval_y,
            "weights": torch.as_tensor(
                np.asarray(sim.weights, np.float64).astype(np.float32),
                device=sim.device),
            "x_test": torch.as_tensor(x_test, device=sim.device),
            "y_test": torch.as_tensor(y_test, dtype=torch.long,
                                      device=sim.device)}


def _take(x, t):
    """Round `t`'s slice of a stacked (R, ...) input (a list: per leaf),
    selected on the device by the (1,) round-index tensor `t`."""
    if isinstance(x, list):
        return [_take(e, t) for e in x]
    return x.index_select(0, t).squeeze(0)


def _assign(dst, src) -> None:
    """Copy tree `src` into the same-structured tree of buffers `dst`.
    A leaf of `src` that shares storage with a buffer (a carried value
    passed through) is cloned first, so no copy reads a buffer another
    copy has already written."""
    dl, sl = tree_leaves(dst), tree_leaves(src)
    held = {d.untyped_storage().data_ptr() for d in dl}
    sl = [x.clone() if x.untyped_storage().data_ptr() in held else x
          for x in sl]
    for d, x in zip(dl, sl):
        d.copy_(x)


class FederatedSimulation:
    """Python-level multi-client FL simulation on one device: the generic
    round driver plus the engine and metric machinery the Strategy
    protocol builds on.

    `model_init` is a callable taking a CPU `torch.Generator` seeded with
    `fl.seed` and returning the parameter tree (default `init_cnn`); the
    tree is moved to `device`, so one seed gives the same initial model on
    every device. Tests inject the reference's parameters through it.

    `mesh_backend` (None, "gloo" or "nccl") and `mesh_world` (a running
    `launch.mesh.World` to reuse, of the run's size) apply to the
    mesh-sharded fused run (`run_fused`), which `FLConfig.mesh_devices`
    selects; they are not `FLConfig` fields, so the config schema stays
    the reference's."""

    def __init__(self, fl: FLConfig, dataset: Dict[str, Any],
                 model_init=None, device="cuda", *, mesh_backend=None,
                 mesh_world=None):
        self.device = device_mod.resolve_device(device)
        self.mesh_backend, self.mesh_world = mesh_backend, mesh_world
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
            if fl.engine == "fused" and not self.codec.supports_fused:
                raise ValueError(
                    f"codec {fl.codec!r} does not support the fused "
                    f"executor (Codec.supports_fused)")
            self.codec_state = self._codec_init_state()
        # fault-injection schedule (DESIGN.md §15), from its own salted
        # generator so the run rng never shifts; None for "none"
        self.faults = faults_mod.compile_schedule(
            fl, n_events=self.strategy.num_events(self),
            event_size=self.strategy.event_size())
        self._fault_log: Dict[int, Any] = {}
        # a context-manager factory entered around the build window, e.g.
        # `obs.collectors.device_window`, which profiles the timed rounds
        # alone (idle share, kernels launched); None enters nothing
        self.build_hook = None
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
        return obs_collectors.wrapper_launches()

    def set_partition(self, parts):
        """Re-partition the train split (e.g. Dirichlet non-IID) after
        construction; rebuilds the vectorized engine state if active."""
        self._install_clients(parts)

    def _install_clients(self, parts):
        """Per-client shards from a partition: label_flip poisons the
        attackers' shards here (the poisoned shard is what both engines
        batch from), and the vectorized engine state is (re)built on the
        final data. The fused engine shares the vectorized engine's
        stacked state."""
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
                    if self.fl.engine in ("vectorized", "fused") else None)

    # -- driver primitives (the plugin-facing surface) ----------------------
    def tel_sync(self, x):
        """Telemetry phase boundary: under the fused per-phase proxy
        (`Telemetry.sync_active`) wait for the card's work, so the
        enclosing span measures device time. A no-op otherwise: steady
        spans measure host windows. Returns `x`."""
        if self.telemetry.sync_active and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return x

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
                return self.tel_sync(
                    (params, losses[:, -eng.nb:].mean(dim=1).cpu().numpy(),
                     accs))
            locals_, losses, accs = [], [], []
            for c, base in zip(plan.participants, plan.bases):
                p, loss, acc = self._local_train(base, c, spec=spec)
                locals_.append(p)
                losses.append(loss)
                accs.append(acc)
            return self.tel_sync(
                (engine_mod.stack_forest(locals_), losses, accs))

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
            return self.tel_sync(attacks.corrupt_stacked(
                uploads, self._bases_stacked(plan), flags, keys,
                kind=fl.attack, scale=fl.attack_scale))

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
            return self.tel_sync(ops.stacked_unravel(uploads, dec))

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
                return self.tel_sync(
                    (model, losses[:, -eng.nb:].mean(dim=1).cpu().numpy(),
                     accs.cpu().numpy()))
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
            return self.tel_sync((model, losses, accs))

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
        if self.fl.engine == "fused":
            return self.run_fused()
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
        # federation-in-the-loop serving (DESIGN.md §14): the session's
        # traffic draws from its own seed fold, and the publish hook only
        # READS the round model — training is the same with serving on or
        # off
        serve_sess = self._make_serve_session(n_events)
        all_accs: List[float] = []
        train_acc = 0.0
        build_timer = Timer(device=self.device)

        with build_timer, self._build_hook():
            for ev in range(n_events):
                state, accs, losses = strat.run_event(self, state, ev)
                train_acc = float(np.mean(np.asarray(accs)))
                all_accs.extend(float(a) for a in np.ravel(accs))
                if strat.track_curves:
                    self._track(curves, accs, losses,
                                strat.round_model(state))
                if serve_sess is not None:
                    # round boundary: serve the window's traffic on the old
                    # model, then hot-swap the fresh aggregate in — unless
                    # the round failed quorum: then nothing publishes
                    # (DESIGN.md §15)
                    fe = self._fault_log.get(ev)
                    if fe is not None and not fe.qok:
                        serve_sess.hold_round(ev + 1)
                    else:
                        serve_sess.publish_round(ev + 1,
                                                 strat.round_model(state))
        if strat.mean_train_acc_over_events:
            train_acc = float(np.mean(all_accs)) if all_accs else 0.0
        return self._classify_and_result(state, curves, train_acc,
                                         build_timer,
                                         warmup_timer=warmup_timer)

    # -- the fused executor (DESIGN.md §10) ---------------------------------
    def _build_hook(self):
        return (self.build_hook() if self.build_hook is not None
                else contextlib.nullcontext())

    def _fused_inputs(self, state0, R):
        """The host precompute of a fused run (`_fused_host_inputs`), each
        array uploaded in one host-to-device copy. Returns ({name: (R, ...)
        device tensor, or a list of them per leaf}, per-round participant
        arrays)."""
        host, pids_l = self._fused_host_inputs(state0, R)
        return self._upload_inputs(host), pids_l

    def _fused_host_inputs(self, state0, R):
        """Consume `self.rng` in the per-round order — per event, the
        participant schedule (`select_participants`, against the initial
        state), then one batch permutation per (client, epoch)
        (`batch_indices`) — and derive every other per-round input from
        the same seams the per-round drivers call: attack flags and gauss
        noise, codec draws, the fault schedule's views (also logged into
        `_fault_log`) and the strategy's extra inputs. Returns ({name:
        (R, ...) host array, or a list of them per leaf}, per-round
        participant arrays); nothing goes to the device."""
        fl, strat = self.fl, self.strategy
        pids_l, idx_l = [], []
        for ev in range(R):
            plan = strat.select_participants(self, state0, ev, self.rng)
            pids_l.append(np.asarray(plan.participants, np.int64))
            idx_l.append(self.vec.batch_indices(self.rng, plan.participants,
                                                fl.local_epochs))
        pids = np.stack(pids_l)
        host = {"pids": pids, "idx": np.stack(idx_l).astype(np.int64),
                "flags": self.attack_mask[pids]}
        if fl.attack == "gauss" and self.attack_mask.any():
            one = tree_map(lambda leaf: leaf[None].cpu(), self.init_params)
            noise = [attacks.stacked_noise(attacks.client_keys(
                         attacks.event_key(fl.seed, ev), pids_l[ev]), one)
                     for ev in range(R)]
            host["noise"] = [torch.stack(leaf) for leaf in zip(*noise)]
        if self.faults is not None:
            # the SAME numpy views the per-round drivers index
            host.update(self.faults.scan_xs(pids_l,
                                            **strat.fault_scan_kwargs()))
            for ev in range(R):
                self._fault_log[ev] = self.faults.event_view(ev, pids_l[ev])
        host.update(strat.scan_extra_xs(self, R))
        if self.codec is not None:
            draws = [self.codec.draws(codecs_mod.upload_keys(
                         fl.seed, ev, pids_l[ev]), self.model_dim)
                     for ev in range(R)]
            if draws[0] is not None:
                host["ckeys"] = torch.stack(draws)
        return host, pids_l

    def _upload_inputs(self, host):
        """Per-round host inputs -> device tensors of their scan dtypes."""
        dtypes = {"pids": torch.long, "idx": torch.long, "flags": torch.bool,
                  "fault_alive": torch.float32, "fault_qok": torch.bool,
                  "fault_gqok": torch.bool, "fault_mix": torch.float32,
                  "fault_gidx": torch.long, "hfl_global": torch.bool}

        def up(name, a):
            if isinstance(a, list):
                return [up(name, e) for e in a]
            return torch.as_tensor(a, dtype=dtypes.get(name)).to(self.device)
        return {k: up(k, v) for k, v in host.items()}

    def run_fused(self, graph: bool = True, *,
                  ranks: Optional[int] = None) -> FLResult:
        """The whole run on the device: strategy state, optimizer state
        and the stacked federation stay there from the first round to the
        last, the per-round metrics are written into (R,) device buffers
        and come back in ONE transfer at the end.

        The host precompute (`_fused_inputs`, untimed) consumes `self.rng`
        exactly as the per-round driver does (§4), so the rng state after
        the run is the vectorized run's. One round is `body`: a function
        of device tensors that reads round t's inputs by a device round
        index, writes its outputs and the new carry into static buffers
        and advances the index. On the card the warmup runs the body
        eagerly on a side stream on a throwaway copy of the carry (kernel
        builds, first-use allocations), then captures ONE round as a CUDA
        graph; the build timer measures R replays and the one transfer. A
        failed capture raises: the run never falls back. On the CPU, or
        with `graph=False` (the card's eager loop, which chip_smoke.py
        holds the graph to), the same body runs eagerly round by round.

        Mesh (`mesh_devices=N > 1`; DESIGN.md §11): the rounds run in the N
        ranks of a `launch.mesh.World` (the `mesh_world` given, or one
        started for the call and stopped after it), each on its contiguous
        sub-stack of clients, and each aggregation event is one sum
        all_reduce (`core/aggregation.py`'s mesh operators). The caller
        checks the reference's preconditions and runs the host precompute
        as above, without the upload; every rank receives the config, the
        dataset, the partition, the initial params and the rng state,
        redoes the same (deterministic) precompute and takes its shard of
        the carry, the per-round inputs and the stacked data — nothing on a
        device is pickled. Under nccl (a card a rank) the round is captured
        as a CUDA graph and replayed as on one device; under gloo (the CPU,
        or ranks sharing a card) the same body runs eagerly round by round.
        The build time is rank 0's R rounds between two barriers (start-up
        and the rendezvous stay outside, as the reference's compile does),
        the warmup rank 0's warmup; in-round telemetry is off. The final
        carry is gathered, untimed, onto the caller's device for the
        classification phase; `self.mesh_report` records the backend, the
        form (graph or eager), and each rank's collective counts, kernel
        launches (none: the mesh path runs plain torch ops, as the
        reference's runs plain jnp) and peak device memory. `ranks` runs
        the mesh path on that many ranks where `mesh_devices` would not
        (`ranks=1`: one rank under nccl, the round captured, which
        chip_smoke.py holds to the single-device run); None follows
        `mesh_devices`.

        Kernel launches: a wrapper counts its calls in Python — the
        warmup's, the capture's (one a captured call), the per-phase
        proxy's and, in the eager loop, every round's. A replay runs no
        Python and counts nothing; `obs.collectors.device_window`, as the
        `build_hook`, measures the replays' launches on the device."""
        fl, strat = self.fl, self.strategy
        if self.vec is None:
            raise ValueError(
                "run_fused needs the stacked engine state "
                "(FLConfig.engine='fused', or 'vectorized' when calling "
                "run_fused directly)")
        if not strat.supports_fused:
            raise ValueError(
                f"strategy {strat.name!r} does not support the fused "
                f"executor (Strategy.supports_fused; async-style "
                f"data-dependent schedules cannot be hoisted out of the "
                f"rounds)")
        dev = self.device
        if ranks is None:
            ranks = fl.mesh_devices if fl.mesh_devices > 1 else 0
        elif fl.mesh_devices > 1 and ranks != fl.mesh_devices:
            raise ValueError(f"ranks={ranks}, but FLConfig.mesh_devices="
                             f"{fl.mesh_devices}")
        if self.mesh_world is not None and self.mesh_world.size != ranks:
            raise ValueError(
                f"mesh_world has {self.mesh_world.size} ranks, the run "
                f"{ranks or 'none'} (FLConfig.mesh_devices="
                f"{fl.mesh_devices})")
        tel = self.telemetry
        R = strat.num_events(self)
        if R < 1:
            raise ValueError("the fused executor needs at least one round")
        state0 = strat.init_state(self)
        rng_state = self.rng.bit_generator.state
        with tel.span("precompute", cat="run", rounds=R):
            if ranks:
                # the ranks redo the precompute and upload their shards
                _, pids_l = self._fused_host_inputs(state0, R)
            else:
                xs, pids_l = self._fused_inputs(state0, R)
                consts = _fused_consts(self)
        k = len(pids_l[0])
        # the carry: private buffers, written in place every round
        carry = {"strategy": tree_map(torch.clone,
                                      strat.scan_carry(self, state0))}
        if self.codec is not None and self.codec.stateful:
            carry["codec"] = self._codec_init_state()
        bufs: Dict[Any, torch.Tensor] = {}
        if ranks:
            self._mesh_check(ranks, np.stack(pids_l), carry["strategy"])
            host, carry["strategy"], warmup_timer, build_timer = \
                self._run_mesh(R, graph, rng_state, ranks)
        else:
            if 0 < fl.fused_chunk < k and k % fl.fused_chunk:
                raise ValueError(f"fused_chunk={fl.fused_chunk} must divide "
                                 f"the participant stack ({k} clients)")
            warmup_timer, build_timer = Timer(device=dev), Timer(device=dev)

            @contextlib.contextmanager
            def warmup():
                with tel.span("warmup", cat="run"), warmup_timer, \
                        tel.suppress():
                    yield
                    self._warmup_predicts()

            @contextlib.contextmanager
            def build():
                # per-phase device-time proxy (obs/collectors.py): one
                # instrumented per-round event. Skipped when chunked (the
                # per-round path would materialize the unchunked stack).
                if tel.enabled and not fl.fused_chunk:
                    obs_collectors.fused_phase_proxy(self)
                    self._reset_codec()
                with build_timer, self._build_hook(), \
                        tel.span("fused_scan", cat="run", rounds=R):
                    yield

            host, bufs = self._drive_rounds(
                FusedContext(self, consts), carry, xs, R,
                use_graph=graph and dev.type == "cuda",
                scan_tel=tel.enabled, warmup=warmup, build=build)
        if "codec" in carry:
            self.codec_state = carry["codec"]
        if self.codec is not None:
            # analytic wire accounting, from the hoisted schedules
            self._comm_log = [len(p) for p in pids_l]
        for name in host:
            if name.startswith("scan."):
                tel.record_series(name, host[name])
        tel.record_series("participants", [len(p) for p in pids_l])
        if self.codec is not None:
            bw = self.codec.bytes_on_wire(self.model_dim)
            tel.record_series("codec.uplink_bytes",
                              [len(p) * bw for p in pids_l])
            tel.counter("codec.uplink_bytes",
                        sum(len(p) * bw for p in pids_l))
        state = strat.scan_uncarry(self, carry["strategy"])
        curves = {"train_acc": [], "train_loss": [], "test_acc": []}
        if strat.track_curves:
            curves = {key: [float(v) for v in host[key]]
                      for key in curves}
        train_acc = float(host["train_acc"][-1])
        serve_sess = self._make_serve_session(R)
        if serve_sess is not None:
            # replay the publishes the per-round engines make live: one
            # hot-swap per round, in round order, at the same virtual
            # times — the serving block is the same under every engine
            template = strat.round_model(state)
            n_leaves = len(tree_leaves(template))
            with tel.span("serve_replay", cat="serve", rounds=R):
                for ev in range(R):
                    fe = self._fault_log.get(ev)
                    if fe is not None and not fe.qok:
                        # quorum-failed round: nothing published live
                        # either — replay the hold (DESIGN.md §15)
                        serve_sess.hold_round(ev + 1)
                        continue
                    serve_sess.publish_round(ev + 1, tree_unflatten(
                        template, [bufs[("model", i)][ev]
                                   for i in range(n_leaves)]))
        return self._classify_and_result(state, curves, train_acc,
                                         build_timer,
                                         warmup_timer=warmup_timer)

    def _drive_rounds(self, fx, carry, xs, R, *, use_graph, scan_tel,
                      warmup, build):
        """Run R fused rounds on `carry` (written in place): the warmup and
        (with `use_graph`) the capture inside the `warmup()` context, the
        R replays or eager rounds and the one transfer of the per-round
        metrics inside `build()`. Returns ({name: (R,) numpy series},
        {name: (R, ...) device buffer})."""
        fl, strat, dev = self.fl, self.strategy, self.device

        def body(carry, t, bufs):
            """One round: read round t's inputs, train, corrupt, ship,
            aggregate; write the outputs into `bufs` and the new carry
            into `carry`; t += 1. Device work only."""
            x = {name: _take(v, t) for name, v in xs.items()}
            sc = carry["strategy"]
            fx._codec_carry = carry.get("codec")
            sc_new, (acc, loss, tacc) = strat.scan_round(fx, sc, x)
            out = {"train_acc": acc, "train_loss": loss, "test_acc": tacc}
            if scan_tel:
                out.update(("scan." + name, v) for name, v in
                           obs_collectors.round_counters(
                               strat, fx, sc, sc_new, x).items())
            if fl.serve:
                # serving (DESIGN.md §14): the round's global model is
                # kept, and its publish is replayed after the run
                out.update((("model", i), leaf) for i, leaf in enumerate(
                    tree_leaves(strat.round_model(sc_new))))
            for name, v in out.items():
                buf = bufs.get(name)
                if buf is None:
                    buf = bufs[name] = torch.full(
                        (R,) + tuple(v.shape), float("nan"), dtype=v.dtype,
                        device=dev)
                buf.index_copy_(0, t, v.unsqueeze(0))
            new = {"strategy": sc_new}
            if "codec" in carry:
                new["codec"] = fx._codec_carry
            _assign(carry, new)
            t.add_(1)

        t = torch.zeros((1,), dtype=torch.long, device=dev)
        with warmup():
            # first-use costs (kernel builds, allocator growth) on a
            # throwaway copy of the carry
            wcarry = tree_map(torch.clone, carry)
            wbufs: Dict[Any, torch.Tensor] = {}
            if use_graph:
                side = torch.cuda.Stream(device=dev)
                side.wait_stream(torch.cuda.current_stream(dev))
                with torch.cuda.stream(side):
                    for _ in range(3):
                        body(wcarry, torch.zeros_like(t), wbufs)
                torch.cuda.current_stream(dev).wait_stream(side)
                torch.cuda.synchronize(dev)
            else:
                body(wcarry, torch.zeros_like(t), wbufs)
            # the output buffers exist before the first counted round, so
            # a captured round writes into them and allocates none
            bufs = {name: torch.full_like(b, float("nan"))
                    for name, b in wbufs.items()}
            del wcarry, wbufs
            if use_graph:
                g = torch.cuda.CUDAGraph()
                try:
                    with torch.cuda.graph(g):
                        body(carry, t, bufs)
                except Exception as e:
                    raise RuntimeError(
                        f"the fused round could not be captured as a CUDA "
                        f"graph ({type(e).__name__}: {e}); the run does "
                        f"not fall back to the eager loop") from e
        with build():
            if use_graph:
                for _ in range(R):
                    g.replay()
            else:
                for _ in range(R):
                    body(carry, t, bufs)
            names = [n for n in bufs if not isinstance(n, tuple)]
            host = dict(zip(names, torch.stack(
                [bufs[n].float() for n in names]).cpu().numpy()))
        return host, bufs

    # -- the mesh-sharded fused executor (DESIGN.md §11) ---------------------
    # per-round inputs whose dim 1 is the client axis (split over the
    # ranks); every other input is replicated
    _MESH_CLIENT_XS = ("pids", "idx", "flags", "noise", "fault_alive")
    # constants whose dim 0 is the client axis; the test split is
    # replicated
    _MESH_CLIENT_CONSTS = ("data_x", "data_y", "eval_x", "eval_y", "weights")

    def _mesh_check(self, ndev, pids, carry) -> None:
        """The reference's mesh preconditions (`_mesh_wrap`) for `ndev`
        ranks, each raising with its message before any rank starts; then
        the placement (the backend, the rank slots) and the strategy's
        carry sharding."""
        from repro_torch.launch import mesh as mesh_mod
        fl, strat = self.fl, self.strategy
        C = fl.num_clients
        if not strat.supports_mesh:
            raise ValueError(
                f"strategy {strat.name!r} does not support the "
                f"mesh-sharded fused executor (Strategy.supports_mesh; "
                f"sequential schedules cannot shard the client axis)")
        if fl.defense != "none":
            raise ValueError(
                f"mesh_devices={ndev} with defense={fl.defense!r}: "
                f"in-scan defenses rank uploads across the WHOLE "
                f"federation and do not lower to per-shard collectives "
                f"(run the single-device fused path instead)")
        if fl.codec != "none" or fl.serve:
            raise ValueError(
                "upload codecs and serving do not compose with the "
                "mesh-sharded fused executor (FLConfig rejects them at "
                "mesh_devices > 1)")
        if C % ndev:
            raise ValueError(
                f"mesh path needs equal shards: num_clients={C} must be "
                f"a multiple of mesh_devices={ndev}")
        if fl.fused_chunk and (C // ndev) % fl.fused_chunk:
            raise ValueError(
                f"fused_chunk={fl.fused_chunk} must divide the LOCAL "
                f"participant stack ({C // ndev} clients per shard)")
        strat.validate_mesh(self, ndev)
        want = np.arange(C)
        if pids.size and (pids.shape[1] != C
                          or not np.array_equal(
                              pids, np.broadcast_to(want, pids.shape))):
            raise ValueError(
                "mesh path needs full participation (participation=1.0): "
                "the client axis is sharded positionally, so every round "
                "must train clients 0..C-1 in id order")
        if self.mesh_world is not None:
            if self.mesh_world.device.type != self.device.type:
                raise ValueError(
                    f"mesh_world runs on {self.mesh_world.device.type}, the "
                    f"simulation on {self.device.type}")
            if self.mesh_backend not in (None, self.mesh_world.backend):
                raise ValueError(
                    f"mesh_backend={self.mesh_backend!r}, but mesh_world "
                    f"runs {self.mesh_world.backend!r}")
            backend = self.mesh_world.backend
        else:
            backend = mesh_mod.resolve_backend(self.mesh_backend,
                                               self.device, ndev)
        mesh_mod.make_client_mesh(ndev, available=mesh_mod.rank_slots(
            self.device, backend))
        sharding = strat.scan_carry_sharding(self)
        if set(sharding) != set(carry):
            raise ValueError(
                f"scan_carry_sharding keys {sorted(sharding)} do not "
                f"match the scan carry {sorted(carry)}")

    def _run_mesh(self, R, graph, rng_state, ndev):
        """Run the R rounds in the ranks (`_mesh_rank`) and gather their
        results: (per-round metrics, the final strategy carry on the
        caller's device, warmup timer, build timer)."""
        from repro_torch.launch import mesh as mesh_mod
        tel, sharding = self.telemetry, self.strategy.scan_carry_sharding(self)
        world = self.mesh_world
        params = tree_map(lambda leaf: leaf.detach().cpu(), self.init_params)
        with tel.span("fused_scan", cat="run", rounds=R, ranks=ndev):
            own = world is None
            if own:
                world = mesh_mod.World(ndev, device=self.device,
                                       backend=self.mesh_backend)
            try:
                outs = world.run(_mesh_rank, self.fl, self.dataset,
                                 self.parts, params, rng_state, graph)
            finally:
                if own:
                    world.close()
        carry = {}
        for key, how in sharding.items():
            if how == "client":
                carry[key] = tree_map(lambda *ls: torch.cat(ls),
                                      *[o["carry"][key] for o in outs])
            else:
                carry[key] = outs[0]["carry"][key]
        # re-home the final carry for the classification phase (untimed)
        carry = tree_map(lambda leaf: leaf.to(self.device), carry)
        first = outs[0]
        self.mesh_report = {
            "ranks": ndev, "backend": first["backend"],
            "form": "graph" if first["graph"] else "eager",
            "collectives": [o["collectives"] for o in outs],
            "kernel_launches": [o["kernel_launches"] for o in outs],
            "peak_bytes": [o["peak_bytes"] for o in outs],
            "build_s": [o["build_s"] for o in outs]}
        self._warmup_predicts()
        return (first["host"], carry, Timer(elapsed=first["warmup_s"]),
                Timer(elapsed=first["build_s"]))

    def _mesh_rank_rounds(self, rank, graph):
        """A rank's share of a mesh run (called in the rank by
        `_mesh_rank`): the precompute, this rank's shard of the carry, the
        per-round inputs and the constants, then `_drive_rounds` with the
        build window between two barriers."""
        fl, strat, dev = self.fl, self.strategy, self.device
        collectives.reset_collective_counts()
        launches0 = self._kernel_launches()
        axis = rank.axis()
        R = strat.num_events(self)
        state0 = strat.init_state(self)
        host, _ = self._fused_host_inputs(state0, R)
        c_loc = fl.num_clients // axis.size
        lo = axis.index * c_loc

        def rows(a, dim):
            """This rank's block of `a` (numpy or torch) along `dim`."""
            n = a.shape[dim] // axis.size
            return a[(slice(None),) * dim
                     + (slice(axis.index * n, (axis.index + 1) * n),)]

        xs = self._upload_inputs(
            {k: (tree_map(lambda a: rows(a, 1), v)
                 if k in self._MESH_CLIENT_XS else v)
             for k, v in host.items()})
        consts = {k: (v[lo:lo + c_loc].clone()
                      if k in self._MESH_CLIENT_CONSTS else v)
                  for k, v in _fused_consts(self).items()}
        sharding = strat.scan_carry_sharding(self)
        carry = {"strategy": {
            k: tree_map(lambda a: (rows(a, 0) if sharding[k] == "client"
                                   else a).clone(), v)
            for k, v in strat.scan_carry(self, state0).items()}}
        use_graph = graph and dev.type == "cuda" and rank.backend == "nccl"
        warmup_timer, build_timer = Timer(device=dev), Timer(device=dev)

        @contextlib.contextmanager
        def build():
            rank.barrier()
            with build_timer:
                yield
                rank.barrier()

        host, _ = self._drive_rounds(
            FusedContext(self, consts, mesh_axis=axis), carry, xs, R,
            use_graph=use_graph, scan_tel=False,
            warmup=lambda: warmup_timer, build=build)
        keep = {k: tree_map(lambda a: a.cpu(), v)
                for k, v in carry["strategy"].items()
                if sharding[k] == "client" or rank.rank == 0}
        return {"host": host if rank.rank == 0 else None, "carry": keep,
                "build_s": build_timer.elapsed,
                "warmup_s": warmup_timer.elapsed, "graph": use_graph,
                "backend": rank.backend,
                "collectives": collectives.collective_counts(),
                "kernel_launches": {
                    k: v - launches0[k]
                    for k, v in self._kernel_launches().items()},
                "peak_bytes": (torch.cuda.max_memory_allocated(dev)
                               if dev.type == "cuda" else None)}

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
        performs). The run's final strategy state is kept as
        `final_state`."""
        fl, strat = self.fl, self.strategy
        self.final_state = state
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
        serve_sess = getattr(self, "_serve_session", None)
        if serve_sess is not None:
            # drains the tail traffic and summarizes (DESIGN.md §14):
            # virtual-clock quantities, the same under every engine
            extra["serving"] = serve_sess.result_block()
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

    def _make_serve_session(self, n_events: int):
        """Build the DESIGN.md §14 serving side-car (None when serving is
        off). The dispatch seam pads every micro-batch to the
        `serve_batch` admission cap, so serving runs one classify shape on
        the card. Sets `self._serve_session` (read by
        `_classify_and_result` for the schema-v2.4 block)."""
        fl = self.fl
        self._serve_session = None
        if not fl.serve:
            return None
        from repro_torch import serve as serve_mod
        x_test, y_test = self.dataset["test"]
        dispatch = None
        if fl.serve_dispatch:
            xd = torch.as_tensor(x_test, device=self.device)
            yt = np.asarray(y_test)
            pad = fl.serve_batch

            def dispatch(params, example_idx):
                ei = np.asarray(example_idx, np.int64)
                idx = np.zeros(pad, np.int64)
                idx[: len(ei)] = ei
                preds = _predict(params, xd[torch.as_tensor(
                    idx, device=self.device)]).cpu().numpy()
                return preds[: len(ei)] == yt[ei]

        self._serve_session = serve_mod.ServeSession(
            fl, n_events=n_events, n_test=len(x_test),
            init_params=self.init_params, dispatch_fn=dispatch,
            telemetry=self.telemetry)
        return self._serve_session

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


def _mesh_rank(rank, fl, dataset, parts, params, rng_state, graph):
    """One rank of a mesh-sharded fused run (`World.run` calls it in every
    rank): the caller's simulation rebuilt from its config, dataset,
    partition, initial params and rng state, then its share of the rounds
    (`FederatedSimulation._mesh_rank_rounds`)."""
    sim = FederatedSimulation(dataclasses.replace(fl, telemetry=False),
                              dataset, model_init=lambda _gen: params,
                              device=rank.device)
    if len(parts) != len(sim.parts) or not all(
            np.array_equal(a, b) for a, b in zip(parts, sim.parts)):
        sim.set_partition(parts)
    sim.rng.bit_generator.state = rng_state
    return sim._mesh_rank_rounds(rank, graph)
