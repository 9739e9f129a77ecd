"""Vectorized stacked-client engine (port of `repro.core.engine`).

The federation is ONE tree whose leaves carry a leading client axis;
local training for every participant runs as one sequence of stacked
steps (the sum of per-client losses, one `torch.autograd.grad`, one SGD
update), and aggregation goes through the kernel-backed stacked
operators of `core/aggregation.py`.

Pieces:

* stack/unstack utilities — list-of-trees <-> stacked tree.
* `train_clients` — local SGD for every participant at once.
* `predict_clients` — post-training local-shard evaluation.
* `cfl_round_scan` — the continual (sequential) strategy as a loop over
  the visit order, each merge on the `fedavg_agg` kernel.
* `VectorizedClientEngine` — host-side driver state: per-client shards,
  stacked eval sets, and the rng-consumption protocol shared with the
  loop engine so both engines see identical batch orders (DESIGN.md §4).

The fused executor's pieces (`gather_batches`, `stacked_dataset`, the
chunked trainer) belong to a later slice (ROADMAP §A.13).
"""
from __future__ import annotations

import warnings
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import aggregation
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
    group blocks (matches `topology.hierarchical_groups` ordering)."""
    return tree_map(lambda leaf: torch.repeat_interleave(leaf, per, dim=0),
                    stacked_groups)


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


@torch.no_grad()
def predict_clients(stacked_params, images, *, stacked_apply_fn):
    """Per-client predictions on per-client eval shards: (C, n, ...) ->
    (C, n) int labels."""
    return stacked_apply_fn(stacked_params, images).argmax(-1)


def cfl_round_scan(model, data, eval_images, eval_labels, alpha, *,
                   loss_fn, apply_fn, lr, momentum):
    """One CFL round — the sequential client-to-client continual pass —
    as a loop over clients in visit order.

    data leaves: (C, T, B, ...) already permuted into visit order;
    eval_images/labels: (C, n, ...) in the same order. Each visit trains
    from the carried model, scores its local model on its own shard, and
    merges through the kernel-backed `cfl_merge_stacked` (C=2 weighted
    reduction). Returns (final model, losses (C, T), post-train local
    accs (C,))."""
    opt = optimizers.sgd(lr, momentum=momentum)
    C = data["label"].shape[0]
    losses, accs = [], []
    for i in range(C):
        local, loss_t, _ = _local_sgd_scan(
            model, {k: v[i] for k, v in data.items()}, opt, loss_fn)
        with torch.no_grad():
            preds = apply_fn(local, eval_images[i]).argmax(-1)
            accs.append((preds == eval_labels[i]).float().mean())
        model = aggregation.cfl_merge_stacked(model, local, alpha)
        losses.append(loss_t)
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

    def cfl_round(self, model, order, data, alpha):
        telemetry.count("engine.cfl_round_dispatch")
        idx = torch.as_tensor(np.asarray(order), device=self.device)
        return cfl_round_scan(model, data, self.eval_x[idx],
                              self.eval_y[idx], alpha, loss_fn=self.loss_fn,
                              apply_fn=self.apply_fn, lr=self.fl.lr,
                              momentum=self.fl.momentum)
