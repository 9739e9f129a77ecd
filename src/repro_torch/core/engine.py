"""Vectorized stacked-client engine (port of `repro.core.engine`).

The federation is ONE tree whose leaves carry a leading client axis;
local training for every participant runs as one sequence of stacked
steps (the sum of per-client losses, one `torch.autograd.grad`, one SGD
update), and aggregation goes through the kernel-backed stacked
operators of `core/aggregation.py`.

Pieces:

* stack/unstack utilities — list-of-trees <-> stacked tree.
* `train_clients` — local SGD for every participant at once;
  `train_clients_chunked` trains the stack one sub-stack at a time (the
  fused executor's `fused_chunk`).
* `predict_clients` — post-training local-shard evaluation.
* `cfl_round_scan` — the continual (sequential) strategy as a loop over
  the visit order, with per-visit corruption and norm clipping, each
  merge on the `fedavg_agg` kernel. It reads no device value back to the
  host: dead visitors and below-quorum rounds are selected away with
  `torch.where`, so the fused executor can capture it.
* `batch_indices` / `gather_batches` / `stacked_dataset` — batch
  construction split so the per-round path gathers on the host while
  the fused executor (DESIGN.md §10) hoists the (rounds, k, T, B) index
  tensor out of its rounds and gathers from the device-resident
  federation dataset on the device.
* `VectorizedClientEngine` — host-side driver state: per-client shards,
  stacked eval sets, and the rng-consumption protocol shared with the
  loop engine so both engines see identical batch orders (DESIGN.md §4).
"""
from __future__ import annotations

import warnings
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import aggregation, attacks, codecs
from repro_torch.models import cnn as cnn_mod
from repro_torch.obs import telemetry
from repro_torch.optim import optimizers
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

Params = Any


class ShardTruncationWarning(UserWarning):
    """The vectorized engine truncated unequal client shards to the
    federation-minimum batch count (see VectorizedClientEngine).
    `dropped` maps absolute client id -> samples dropped PER EPOCH
    beyond what the loop engine's per-client flooring already drops —
    the documented loop-vs-vectorized divergence on skewed shards."""

    def __init__(self, msg: str, dropped: Dict[int, int]):
        super().__init__(msg)
        self.dropped = dropped


# ---------------------------------------------------------------------------
# stacking utilities
# ---------------------------------------------------------------------------

def stack_forest(trees: List[Params]) -> Params:
    """List of identically-shaped trees -> one tree, leading client axis."""
    return tree_map(lambda *ls: torch.stack(ls), *trees)


def unstack_forest(stacked: Params) -> List[Params]:
    """Inverse of `stack_forest`."""
    n = tree_leaves(stacked)[0].shape[0]
    return [tree_map(lambda leaf: leaf[i], stacked) for i in range(n)]


def replicate_tree(tree: Params, n: int) -> Params:
    """One model -> a stacked federation of `n` copies."""
    return tree_map(
        lambda leaf: leaf.unsqueeze(0).expand((n,) + tuple(leaf.shape))
        .contiguous(), tree)


def repeat_groups(stacked_groups: Params, per: int) -> Params:
    """(G, ...) group models -> (G*per, ...) client stack, contiguous
    group blocks (matches `topology.hierarchical_groups` ordering). An
    expand and a copy: no repeat count is read back from the device."""
    def rep(leaf):
        G = leaf.shape[0]
        return (leaf.unsqueeze(1).expand((G, per) + tuple(leaf.shape[1:]))
                .reshape((G * per,) + tuple(leaf.shape[1:])))
    return tree_map(rep, stacked_groups)


# ---------------------------------------------------------------------------
# training / evaluation
# ---------------------------------------------------------------------------

def _loss_and_grads(loss_fn, params, batch, extra=None):
    """(loss, acc, grads of loss.sum()) — for a stacked loss the sum's
    gradient is exactly the per-client gradients (clients are
    independent)."""
    leaves = [leaf.detach().requires_grad_(True)
              for leaf in tree_leaves(params)]
    p = tree_unflatten(params, leaves)
    loss, acc = (loss_fn(p, batch) if extra is None
                 else loss_fn(p, batch, extra))
    grads = torch.autograd.grad(loss.sum(), leaves)
    return loss.detach(), acc.detach(), tree_unflatten(params, list(grads))


def sgd_steps(params, opt_state, batches, opt, loss_fn, extra=None):
    """Local SGD over `batches` (a sequence of batch dicts). Returns
    (params, opt_state, losses, accs) with one loss/acc tensor per step;
    nothing is read back to the host."""
    losses, accs = [], []
    for batch in batches:
        loss, acc, grads = _loss_and_grads(loss_fn, params, batch, extra)
        with torch.no_grad():
            updates, opt_state = opt.update(grads, opt_state, params)
            params = optimizers.apply_updates(params, updates)
        losses.append(loss)
        accs.append(acc)
    return params, opt_state, losses, accs


def _local_sgd_scan(params, data, opt, loss_fn):
    """Local SGD over pre-batched data (T, B, ...), momentum state
    persisting across all T steps (epochs are concatenated along T)."""
    T = data["label"].shape[0]
    params, _, losses, accs = sgd_steps(
        params, opt.init(params),
        [{k: v[t] for k, v in data.items()} for t in range(T)],
        opt, loss_fn)
    return params, torch.stack(losses), torch.stack(accs)


def train_clients(stacked_params, data, *, stacked_loss_fn, lr, momentum,
                  extra=None):
    """All participants' local training as one sequence of stacked steps.

    data leaves: (C, T, B, ...) with T = local_epochs * batches_per_epoch.
    `stacked_loss_fn(stacked_params, batch[, extra])` returns per-client
    ((C,) losses, (C,) accs). Returns (new stacked params, per-batch
    losses (C, T), accs (C, T)). The input tree is not modified."""
    opt = optimizers.sgd(lr, momentum=momentum)
    T = data["label"].shape[1]
    params, _, losses, accs = sgd_steps(
        stacked_params, opt.init(stacked_params),
        [{k: v[:, t] for k, v in data.items()} for t in range(T)],
        opt, stacked_loss_fn, extra)
    return params, torch.stack(losses, dim=1), torch.stack(accs, dim=1)


def train_clients_chunked(stacked_params, data, *, stacked_loss_fn, lr,
                          momentum, extra=None, chunk):
    """`train_clients` one participant SUB-STACK of `chunk` clients at a
    time (DESIGN.md §11 chunking): peak training-activation memory scales
    with `chunk` rather than the federation size. Clients are
    independent, so this equals the unchunked path up to the order the
    convolutions of a smaller batch sum in (not bitwise). `chunk` <= 0 or
    >= the stack trains it whole; otherwise it must divide the stack."""
    C = tree_leaves(stacked_params)[0].shape[0]
    if chunk <= 0 or chunk >= C:
        return train_clients(stacked_params, data,
                             stacked_loss_fn=stacked_loss_fn, lr=lr,
                             momentum=momentum, extra=extra)
    if C % chunk:
        raise ValueError(f"fused_chunk={chunk} must divide the participant "
                         f"stack ({C} clients)")

    def part(tree, a):
        return tree_map(lambda leaf: leaf[a:a + chunk], tree)

    runs = [train_clients(part(stacked_params, a), part(data, a),
                          stacked_loss_fn=stacked_loss_fn, lr=lr,
                          momentum=momentum,
                          extra=None if extra is None else part(extra, a))
            for a in range(0, C, chunk)]
    params = tree_map(lambda *ls: torch.cat(ls), *[r[0] for r in runs])
    return (params, torch.cat([r[1] for r in runs]),
            torch.cat([r[2] for r in runs]))


def gather_batches(data_x, data_y, pids, idx):
    """Device-side batch construction for one fused round: gather the
    event's participants' batches out of the stacked federation dataset
    (`stacked_dataset`). `pids`: (k,) absolute client ids; `idx`: (k, T,
    B) per-client shard indices (`batch_indices`). Returns {"image": (k,
    T, B, ...), "label": (k, T, B)} — the values `batched_clients` builds
    on the host, with no host round trip."""
    k, T, B = idx.shape
    rows = idx.reshape(k, -1)
    pid_col = pids[:, None]
    img = data_x[pid_col, rows].reshape((k, T, B) + tuple(data_x.shape[2:]))
    lab = data_y[pid_col, rows].reshape(k, T, B)
    return {"image": img, "label": lab}


@torch.no_grad()
def predict_clients(stacked_params, images, *, stacked_apply_fn):
    """Per-client predictions on per-client eval shards: (C, n, ...) ->
    (C, n) int labels."""
    return stacked_apply_fn(stacked_params, images).argmax(-1)


def cfl_round_scan(model, data, eval_images, eval_labels, alpha, *,
                   loss_fn, apply_fn, lr, momentum, attack="none",
                   attack_scale=1.0, attack_flags=None, attack_keys=None,
                   attack_noise=None, defense="none", clip_tau=10.0,
                   codec=None, codec_keys=None, fault_alive=None,
                   fault_qok=None, merge_weights=None):
    """One CFL round — the sequential client-to-client continual pass —
    as a loop over clients in visit order.

    data leaves: (C, T, B, ...) already permuted into visit order;
    eval_images/labels: (C, n, ...) in the same order. Each visit trains
    from the carried model and scores its (honest) local model on its own
    shard. Adversarial axis (DESIGN.md §8): the visit's base is the
    carried model, so an attacker (`attack_flags[i]`, visit order)
    corrupts its upload against it, with noise keyed by `attack_keys[i]`;
    `defense="norm_clip"` clips the (possibly corrupted) delta before the
    merge (`defended_cfl_merge`). Every merge is the kernel-backed
    `cfl_merge_stacked` (C=2 weighted reduction).

    Upload codecs (DESIGN.md §12): the per-visit wire seam sits between
    corruption and the merge; the merged update is the decoded encoding
    of the (corrupted) local model, each visit keyed by `codec_keys[i]`
    (from (seed, event, absolute client id), codec salt). Only stateless
    codecs reach here (the driver validates).

    Fault injection (DESIGN.md §15): `fault_alive` is a per-visit (C,)
    0/1 mask — a dead visitor trains (rng parity) and its merge is
    computed, then discarded: `torch.where` keeps the carried model, the
    exact values of the loop engine's skipped host merge; `fault_qok`
    False holds the whole round at its start model the same way. Both
    None is the fault-free pass.

    Device inputs (the fused executor): `attack_flags` may be a (C,) bool
    tensor (corruption then runs branch-free, `attacks.corrupt_tree`),
    `attack_noise` the hoisted per-leaf (C, ...) gauss noise in place of
    `attack_keys`, `codec_keys` a (C, N) tensor of hoisted codec draws,
    and `merge_weights` the (2,) merge weights built once per run.

    Returns (final model, losses (C, T), post-train local accs (C,))."""
    opt = optimizers.sgd(lr, momentum=momentum)
    C = data["label"].shape[0]
    attacking = attack not in ("none", "label_flip")
    if attacking and attack_keys is None and attack_noise is None:
        raise ValueError(
            f"cfl_round_scan: attack={attack!r} corrupts uploads per visit "
            f"and needs per-visit attack_keys (derive them from the run "
            f"seed via attacks.client_keys)")
    if codec is not None and codec_keys is None:
        raise ValueError(
            f"cfl_round_scan: codec={codec.name!r} needs per-visit "
            f"codec_keys (derive them via codecs.upload_keys)")
    dev = tree_leaves(model)[0].device
    if fault_alive is not None:
        fault_alive = torch.as_tensor(fault_alive, dtype=torch.float32,
                                      device=dev)
    losses, accs = [], []
    model0 = model
    for i in range(C):
        local, loss_t, _ = _local_sgd_scan(
            model, {k: v[i] for k, v in data.items()}, opt, loss_fn)
        with torch.no_grad():
            preds = apply_fn(local, eval_images[i]).argmax(-1)
            accs.append((preds == eval_labels[i]).float().mean())
        losses.append(loss_t)
        if attacking:
            local = attacks.corrupt_tree(
                local, model, attack_flags[i],
                None if attack_keys is None else attack_keys[i],
                kind=attack, scale=attack_scale,
                noise=(None if attack_noise is None
                       else [n[i] for n in attack_noise]))
        if codec is not None:
            local = codecs.roundtrip_tree(codec, local, codec_keys[i:i + 1],
                                          base_tree=model)
        if defense == "norm_clip":
            merged = aggregation.defended_cfl_merge(
                model, local, alpha, clip_tau, weights=merge_weights)
        else:
            merged = aggregation.cfl_merge_stacked(model, local, alpha,
                                                   weights=merge_weights)
        if fault_alive is not None:
            # a dead visitor's upload is lost: its merge is discarded
            merged = aggregation.tree_where(fault_alive[i] > 0, merged,
                                            model)
        model = merged
    if fault_qok is not None:
        # below quorum: the round holds its start model
        model = aggregation.tree_where(
            torch.as_tensor(fault_qok, dtype=torch.bool, device=dev),
            model, model0)
    return model, torch.stack(losses), torch.stack(accs)


# ---------------------------------------------------------------------------
# host-side driver
# ---------------------------------------------------------------------------

class VectorizedClientEngine:
    """Host state for the vectorized engine.

    Owns the per-client shards, the stacked local eval sets (on the
    device), and the batch construction. Batching consumes the caller's
    numpy rng in exactly the loop engine's order (client-major,
    epoch-minor permutations), so the two engines run the same SGD
    sequence and agree up to float tolerance.

    Constraint: all clients must yield the same number of batches per
    epoch; with unequal shards the batch count is truncated to the
    federation minimum (the loop engine floors per client instead — use
    shard-divisible datasets when exact parity matters).
    """

    def __init__(self, fl, client_data: List[Tuple[np.ndarray, np.ndarray]],
                 weights: Sequence[float], *, device,
                 loss_fn=cnn_mod.cnn_loss, apply_fn=cnn_mod.cnn_apply,
                 stacked_loss_fn=cnn_mod.cnn_loss_stacked,
                 stacked_apply_fn=cnn_mod.cnn_apply_stacked):
        self.fl = fl
        self.device = torch.device(device)
        self.client_data = client_data
        self.weights = np.asarray(weights, np.float64)
        self.loss_fn = loss_fn                    # single-model (CFL pass)
        self.apply_fn = apply_fn
        self.stacked_loss_fn = stacked_loss_fn    # leading-client-axis path
        self.stacked_apply_fn = stacked_apply_fn
        sizes = [len(x) for x, _ in client_data]
        self.nb = min(sizes) // fl.local_batch_size
        if self.nb == 0:
            raise ValueError(
                f"local_batch_size={fl.local_batch_size} exceeds the "
                f"smallest client shard ({min(sizes)} samples)")
        # unequal shards: every client is truncated to the federation-
        # minimum batch count, while the loop engine floors PER CLIENT.
        # Record the per-client divergence and warn once, structured.
        B = fl.local_batch_size
        self.dropped_samples = {
            c: (n // B) * B - self.nb * B
            for c, n in enumerate(sizes) if (n // B) * B > self.nb * B}
        if self.dropped_samples:
            total = sum(self.dropped_samples.values())
            warnings.warn(ShardTruncationWarning(
                f"unequal client shards: the vectorized engine truncates "
                f"every client to the federation-minimum {self.nb} "
                f"batch(es)/epoch, dropping {total} sample(s)/epoch that "
                f"the loop engine trains on (per-client: "
                f"{self.dropped_samples}); loop-vs-vectorized parity is "
                f"statistical on this partition",
                self.dropped_samples), stacklevel=2)
        self.n_eval = min(512, min(sizes))
        self.eval_x = torch.as_tensor(
            np.stack([x[: self.n_eval] for x, _ in client_data]),
            device=self.device)
        self.eval_y = torch.as_tensor(
            np.stack([y[: self.n_eval] for _, y in client_data]),
            dtype=torch.long, device=self.device)

    # -- batching -----------------------------------------------------------
    def batch_indices(self, rng: np.random.Generator,
                      client_ids: Sequence[int], epochs: int) -> np.ndarray:
        """The (k, epochs*nb, B) int32 batch-index tensor for one event:
        per-client indices into the client's OWN shard, rng order
        identical to the loop engine — for each client (in the given
        order), one permutation per epoch (DESIGN.md §4)."""
        B = self.fl.local_batch_size
        nb, T = self.nb, epochs * self.nb
        idx = np.empty((len(client_ids), T, B), np.int32)
        for i, c in enumerate(client_ids):
            n = len(self.client_data[c][0])
            for e in range(epochs):
                sel = rng.permutation(n)[: nb * B]
                idx[i, e * nb:(e + 1) * nb] = sel.reshape(nb, B)
        return idx

    def batched_clients(self, rng: np.random.Generator,
                        client_ids: Sequence[int], epochs: int
                        ) -> Dict[str, torch.Tensor]:
        """Stacked pre-batched data for `client_ids`: the `batch_indices`
        tensor gathered on the host, then moved to the device. Leaves:
        (C, epochs*nb, B, ...)."""
        idx = self.batch_indices(rng, client_ids, epochs)
        T, B = idx.shape[1], idx.shape[2]
        x0 = self.client_data[0][0]
        imgs = np.empty((len(client_ids), T, B) + x0.shape[1:], x0.dtype)
        labs = np.empty((len(client_ids), T, B), np.int64)
        for i, c in enumerate(client_ids):
            x, y = self.client_data[c]
            imgs[i] = x[idx[i]]
            labs[i] = y[idx[i]]
        return {"image": torch.as_tensor(imgs, device=self.device),
                "label": torch.as_tensor(labs, device=self.device)}

    def stacked_dataset(self):
        """The whole federation's shards as ONE device-resident pair
        (images (C, n_max, ...), labels (C, n_max)), built once and cached
        — the fused executor's gather source. Shards shorter than n_max
        are zero-padded; batch indices never reference the pad (they are
        permutations of each client's own shard length)."""
        cached = getattr(self, "_stacked_dataset", None)
        if cached is None:
            n_max = max(len(x) for x, _ in self.client_data)
            x0 = self.client_data[0][0]
            imgs = np.zeros((len(self.client_data), n_max) + x0.shape[1:],
                            x0.dtype)
            labs = np.zeros((len(self.client_data), n_max), np.int64)
            for c, (x, y) in enumerate(self.client_data):
                imgs[c, :len(x)] = x
                labs[c, :len(y)] = y
            cached = (torch.as_tensor(imgs, device=self.device),
                      torch.as_tensor(labs, device=self.device))
            self._stacked_dataset = cached
        return cached

    # -- device-program wrappers --------------------------------------------
    def train(self, stacked_params, data, *, stacked_loss_fn=None,
              extra=None):
        """One event's stacked training dispatch."""
        telemetry.count("engine.train_dispatch")
        return train_clients(
            stacked_params, data,
            stacked_loss_fn=stacked_loss_fn or self.stacked_loss_fn,
            lr=self.fl.lr, momentum=self.fl.momentum, extra=extra)

    def local_accs(self, stacked_params, client_ids) -> np.ndarray:
        """Post-training local-shard accuracy per client — the paper's
        "training accuracy" protocol."""
        idx = torch.as_tensor(np.asarray(client_ids), device=self.device)
        preds = predict_clients(stacked_params, self.eval_x[idx],
                                stacked_apply_fn=self.stacked_apply_fn)
        return ((preds == self.eval_y[idx]).float().mean(dim=1)
                .cpu().numpy())

    def cfl_round(self, model, order, data, alpha, *, attack="none",
                  attack_scale=1.0, attack_flags=None, attack_keys=None,
                  defense="none", clip_tau=10.0, codec=None,
                  codec_keys=None, fault_alive=None, fault_qok=None):
        telemetry.count("engine.cfl_round_dispatch")
        idx = torch.as_tensor(np.asarray(order), device=self.device)
        return cfl_round_scan(model, data, self.eval_x[idx],
                              self.eval_y[idx], alpha, loss_fn=self.loss_fn,
                              apply_fn=self.apply_fn, lr=self.fl.lr,
                              momentum=self.fl.momentum, attack=attack,
                              attack_scale=attack_scale,
                              attack_flags=attack_flags,
                              attack_keys=attack_keys, defense=defense,
                              clip_tau=clip_tau, codec=codec,
                              codec_keys=codec_keys, fault_alive=fault_alive,
                              fault_qok=fault_qok)
