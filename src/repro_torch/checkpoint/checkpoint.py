"""Checkpointing: flatten a params/opt-state tree to a .npz + JSON
metadata (paths, shapes, dtypes, step counter); restart-safe (write to a
temporary file, then rename). Port of `repro.checkpoint.checkpoint`, in
its file format: the keys are the leaves' paths "a/b/0/c" in
`repro_torch.tree` order (dict keys sorted, list entries by index, None
holding no leaf), bfloat16 is stored as float32, and a restore checks
every shape. So a checkpoint written by either package restores in the
other.
"""
from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.tree import tree_unflatten


def _leaves_with_paths(tree, prefix=()) -> List[Tuple[str, Any]]:
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _leaves_with_paths(tree[k], prefix + (str(k),))]
    if isinstance(tree, list):
        return [kv for i, t in enumerate(tree)
                for kv in _leaves_with_paths(t, prefix + (str(i),))]
    if tree is None:
        return []
    return [("/".join(prefix), tree)]


def _to_numpy(leaf) -> np.ndarray:
    leaf = torch.as_tensor(leaf).detach().cpu()
    if leaf.dtype == torch.bfloat16:          # npz has no native bf16
        leaf = leaf.float()
    return leaf.numpy()


def _flatten(tree) -> Dict[str, np.ndarray]:
    return {key: _to_numpy(leaf) for key, leaf in _leaves_with_paths(tree)}


def save_checkpoint(directory: str, step: int, tree: Any,
                    extra_meta: Optional[dict] = None) -> str:
    os.makedirs(directory, exist_ok=True)
    flat = _flatten(tree)
    path = os.path.join(directory, f"ckpt_{step:08d}.npz")
    meta = {
        "step": step,
        "keys": sorted(flat),
        "shapes": {k: list(v.shape) for k, v in flat.items()},
        "dtypes": {k: str(v.dtype) for k, v in flat.items()},
        **(extra_meta or {}),
    }
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    with os.fdopen(fd, "wb") as f:
        np.savez(f, **flat)
    os.replace(tmp, path)
    with open(path.replace(".npz", ".json"), "w") as f:
        json.dump(meta, f, indent=1)
    return path


def latest_checkpoint(directory: str) -> Optional[str]:
    if not os.path.isdir(directory):
        return None
    ckpts = sorted(p for p in os.listdir(directory)
                   if p.startswith("ckpt_") and p.endswith(".npz"))
    return os.path.join(directory, ckpts[-1]) if ckpts else None


def restore_checkpoint(path: str, template: Any) -> Any:
    """Restore into the structure of `template`, a tree of tensors
    (shape-checked): each leaf comes back in its template's dtype, on its
    template's device."""
    leaves = []
    with np.load(path) as data:
        for key, leaf in _leaves_with_paths(template):
            arr = data[key]
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(f"shape mismatch for {key}: "
                                 f"{arr.shape} vs {tuple(leaf.shape)}")
            leaves.append(torch.from_numpy(arr).to(leaf.device, leaf.dtype))
    return tree_unflatten(template, leaves)


def checkpoint_step(path: str) -> int:
    with open(path.replace(".npz", ".json")) as f:
        return json.load(f)["step"]
