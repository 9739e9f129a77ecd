"""Parameter trees between the reference and the port.

Both packages keep the same layout (nested dicts with the same keys,
conv kernels HWIO, dense kernels (in, out), the model zoo's scanned
stacks with a leading layer axis and its lists of per-layer dicts), so
conversion copies leaves and changes no layout. torch cannot reproduce `jax.random` draws, so
parity runs hand the reference's initial parameters to the port through
`params_from_jax` (the caller turns them into numpy first, e.g.
`jax.tree.map(np.asarray, params)`; this module never imports jax).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.tree import tree_map


def params_from_jax(np_tree, device="cpu"):
    """Tree (dicts, lists, None) of numpy arrays (the reference's
    parameters) -> the same tree of tensors on `device`, copied."""
    return tree_map(
        lambda a: torch.tensor(np.array(a, copy=True), device=device),
        np_tree)


def params_to_numpy(tree):
    """Tree of tensors -> the same tree of numpy arrays (host copies),
    the form the reference accepts through `jnp.asarray`."""
    return tree_map(lambda t: t.detach().cpu().numpy().copy(), tree)
