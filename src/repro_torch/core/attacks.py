"""Byzantine client attacks — the adversarial workload axis (port of
`repro.core.attacks`; DESIGN.md §8).

A configurable subset of clients is adversarial. Model-poisoning attacks
corrupt the client's trained parameters between local training and the
aggregation event; the data-poisoning attack (label_flip) corrupts the
client's shard before training. Corruptions are relative to `base`, the
model the client pulled at the start of its local round:

  sign_flip      theta_mal = base - scale * (theta_c - base)
  gauss          theta_mal = theta_c + scale * N(0, I)
  model_replace  theta_mal = base + scale * (theta_c - base)
  label_flip     data layer: shard labels y -> (num_classes - 1) - y
                 (`corrupt_tree` is the identity)

Corruption is computed in float32 and cast back to the leaf's dtype.

RNG contract (DESIGN.md §4): the attacker set comes from a generator
derived from the config seed (`attacker_ids`, numpy, bitwise the
reference's), never from the schedule rng. Gaussian noise is keyed by
(seed, aggregation event, absolute client id, leaf index) through one
seam, `gauss_noise`: it draws on a CPU `torch.Generator` and moves the
result, so one seed gives the same noise on the CPU and the card and
under both engines. `jax.random` cannot be reproduced in torch; the
parity tests replace `gauss_noise` with the reference's draws.

A noise key is the tuple (seed, event, client id): `event_key` and
`client_keys` build it as the reference builds its PRNG keys.

Device flags (the fused executor): `corrupt_tree` and `corrupt_stacked`
take the attacker flags as a bool tensor and the gauss noise hoisted
(`stacked_noise`, drawn through the same seam before the run); they then
corrupt every row and keep the honest rows with `torch.where`, reading
nothing back to the host. Honest rows pass through bitwise, attackers'
rows are the host path's values.
"""
from __future__ import annotations

from typing import Any, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.fl_types import ATTACKS
from repro_torch.tree import tree_leaves, tree_unflatten

Params = Any
NoiseKey = Tuple[int, int, int]

_ATTACK_SALT = 0x5EED_A77C        # decouples attack keys from model init
NUM_CLASSES = 10


def attacker_ids(num_clients: int, fraction: float, seed: int,
                 placement: str = "random") -> np.ndarray:
    """The Byzantine subset: `fraction` of the federation, chosen by a
    generator derived from (seed, salt). At least one attacker when
    fraction > 0; at least one honest client always. `placement=
    "colluding"` packs the attackers on even client ids instead."""
    if fraction <= 0 or num_clients <= 1:
        return np.empty((0,), int)
    k = min(num_clients - 1, max(1, int(round(fraction * num_clients))))
    if placement == "colluding":
        order = list(range(0, num_clients, 2)) + \
            list(range(1, num_clients, 2))
        return np.sort(np.asarray(order[:k], int))
    if placement != "random":
        raise ValueError(f"unknown attack placement {placement!r} "
                         f"(expected 'random' or 'colluding')")
    rng = np.random.default_rng([seed, _ATTACK_SALT])
    return np.sort(rng.choice(num_clients, size=k, replace=False))


def attacker_mask(num_clients: int, fraction: float, seed: int,
                  placement: str = "random") -> np.ndarray:
    mask = np.zeros((num_clients,), bool)
    mask[attacker_ids(num_clients, fraction, seed, placement)] = True
    return mask


def flip_labels(labels: np.ndarray, num_classes: int = NUM_CLASSES
                ) -> np.ndarray:
    """Deterministic label flip y -> (K-1) - y (an involution)."""
    return (num_classes - 1 - labels).astype(labels.dtype)


def event_key(seed: int, event: int) -> Tuple[int, int]:
    """The noise key of one aggregation event."""
    return (int(seed), int(event))


def client_keys(key: Tuple[int, int], client_ids) -> List[NoiseKey]:
    """Per-client noise keys from absolute ids — subset/order
    independent."""
    seed, event = key
    return [(seed, event, int(c) & 0x7FFFFFFF) for c in client_ids]


def gauss_noise(seed: int, event: int, client_id: int, leaf_index: int,
                shape, device) -> torch.Tensor:
    """Standard normal f32 noise for one leaf of one client's upload at
    one event: drawn on a CPU generator seeded from (seed ^ salt, event,
    client id, leaf index), then moved to `device`."""
    ss = np.random.SeedSequence([int(seed) ^ _ATTACK_SALT, int(event),
                                 int(client_id) & 0x7FFFFFFF,
                                 int(leaf_index)])
    g = torch.Generator(device="cpu")
    g.manual_seed(int(ss.generate_state(1, np.uint64)[0]))
    return torch.randn(tuple(shape), generator=g,
                       dtype=torch.float32).to(device)


def _check_kind(kind: str) -> None:
    if kind not in ATTACKS:
        raise ValueError(f"unknown attack {kind!r} (expected {ATTACKS})")


def _attack_leaf(kind, local32, base32, scale, noise=None):
    if kind == "sign_flip":
        return base32 - scale * (local32 - base32)
    if kind == "model_replace":
        return base32 + scale * (local32 - base32)
    return local32 + scale * noise                  # gauss


def stacked_noise(keys: Sequence[NoiseKey], template_stacked: Params
                  ) -> List[torch.Tensor]:
    """The gauss noise of `keys` (one per row) for every leaf of a stacked
    tree, drawn on the CPU through `gauss_noise`: a list of (k, ...)
    float32 tensors in leaf order (the fused executor hoists these)."""
    return [torch.stack([gauss_noise(*key, i, leaf.shape[1:], "cpu")
                         for key in keys])
            for i, leaf in enumerate(tree_leaves(template_stacked))]


def _row_where(flags: torch.Tensor, a: torch.Tensor, b: torch.Tensor):
    """torch.where over the leading axis of `a`/`b` (flags 0-dim or (k,))."""
    return torch.where(flags.reshape(tuple(flags.shape)
                                     + (1,) * (a.dim() - flags.dim())), a, b)


def corrupt_tree(local: Params, base: Params, flag, key: NoiseKey, *,
                 kind: str, scale: float, noise=None) -> Params:
    """One client's corruption; `flag` gates the attack (honest clients
    pass through unchanged), `key` = (seed, event, client id) keys the
    gauss noise, one draw per leaf in sorted-key order. A tensor `flag`
    selects branch-free, with `noise` the hoisted per-leaf draws."""
    _check_kind(kind)
    device_flag = isinstance(flag, torch.Tensor)
    if kind in ("none", "label_flip") or not (device_flag or flag):
        return local
    scale = float(np.float32(scale))
    out = []
    for i, (l, b) in enumerate(zip(tree_leaves(local), tree_leaves(base))):
        n = None
        if kind == "gauss":
            n = (noise[i] if noise is not None
                 else gauss_noise(*key, i, l.shape, l.device))
        atk = _attack_leaf(kind, l.float(), b.float(), scale, n).to(l.dtype)
        out.append(_row_where(flag, atk, l) if device_flag else atk)
    return tree_unflatten(local, out)


def corrupt_stacked(stacked: Params, base_stacked: Params, flags,
                    keys: Sequence[NoiseKey], *, kind: str,
                    scale: float, noise=None) -> Params:
    """Corruption over the leading client axis: row c of every leaf is
    corrupted iff flags[c], with noise keyed by keys[c] (derive them with
    `client_keys` from absolute ids for engine parity). Tensor `flags`
    corrupt every row and keep the honest ones with `torch.where`, with
    `noise` the hoisted per-leaf (k, ...) draws (`stacked_noise`)."""
    _check_kind(kind)
    if isinstance(flags, torch.Tensor):
        if kind in ("none", "label_flip"):
            return stacked
        scale = float(np.float32(scale))
        out = []
        for i, (l, b) in enumerate(zip(tree_leaves(stacked),
                                       tree_leaves(base_stacked))):
            atk = _attack_leaf(kind, l.float(), b.float(), scale,
                               None if noise is None else noise[i])
            out.append(_row_where(flags, atk.to(l.dtype), l))
        return tree_unflatten(stacked, out)
    flags = np.asarray(flags, bool)
    if kind in ("none", "label_flip") or not flags.any():
        return stacked
    scale = float(np.float32(scale))
    rows = np.flatnonzero(flags)
    out = []
    for i, (l, b) in enumerate(zip(tree_leaves(stacked),
                                   tree_leaves(base_stacked))):
        idx = torch.as_tensor(rows, device=l.device)
        noise = (torch.stack([gauss_noise(*keys[r], i, l.shape[1:],
                                          l.device) for r in rows])
                 if kind == "gauss" else None)
        atk = _attack_leaf(kind, l[idx].float(), b[idx].float(), scale,
                           noise)
        leaf = l.clone()
        leaf[idx] = atk.to(l.dtype)
        out.append(leaf)
    return tree_unflatten(stacked, out)


def corrupt_clients(client_params: Sequence[Params],
                    base_params: Sequence[Params],
                    client_ids: Sequence[int], mask: np.ndarray, *,
                    kind: str, scale: float, seed: int, event: int,
                    ) -> list:
    """Corrupt a *list* of client trees: `base_params` lists one
    round-start model per client, `mask` is indexed by absolute client
    id. Keys derive as in `corrupt_stacked`."""
    if kind in ("none", "label_flip") or not np.any(mask):
        return list(client_params)
    if len(base_params) != len(client_params):
        raise ValueError(
            f"base_params must list one round-start model per client "
            f"({len(base_params)} != {len(client_params)})")
    keys = client_keys(event_key(seed, event), client_ids)
    return [corrupt_tree(p, b, bool(mask[c]), k, kind=kind, scale=scale)
            for p, b, c, k in zip(client_params, base_params, client_ids,
                                  keys)]
