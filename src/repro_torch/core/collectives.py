"""The port's counted collectives (DESIGN.md §11's mesh path).

Every collective of the mesh-sharded fused executor goes through
`all_reduce_sum` or `barrier`, which count their calls and bytes by name
in this process (`collective_counts`), under the active
`collective_scope`: so a test reads that a scope (HFL's tier 1) issued no
collective at all, and the zoo's sharded half (ROADMAP §A.16b) reads its
collective bytes from the same counts. The core layer's mesh operators
call these directly; `launch/mesh.py`, which starts the ranks and makes
their process groups, re-exports them. An axis is any object with a
process `group` (None: the whole world), as `launch.mesh.MeshAxis` is.
"""
from __future__ import annotations

import collections
import contextlib
from typing import Dict, List

import torch

_CALLS: collections.Counter = collections.Counter()
_BYTES: collections.Counter = collections.Counter()
_SCOPES: collections.Counter = collections.Counter()
_SCOPE: List[str] = []


def collective_counts() -> Dict[str, Dict[str, int]]:
    """This process's collective calls and bytes by name ("all_reduce",
    and "scope/all_reduce" inside `collective_scope("scope")`), and how
    often each scope was entered."""
    return {"calls": dict(_CALLS), "bytes": dict(_BYTES),
            "scopes": dict(_SCOPES)}


def reset_collective_counts() -> None:
    _CALLS.clear()
    _BYTES.clear()
    _SCOPES.clear()


@contextlib.contextmanager
def collective_scope(name: str):
    """Count the collectives issued inside under "name/<op>" as well."""
    _SCOPES[name] += 1
    _SCOPE.append(name)
    try:
        yield
    finally:
        _SCOPE.pop()


def _count(op: str, nbytes: int) -> None:
    keys = [op] + [f"{s}/{op}" for s in _SCOPE]
    for k in keys:
        _CALLS[k] += 1
        _BYTES[k] += nbytes


def all_reduce_sum(t: torch.Tensor, axis=None) -> torch.Tensor:
    """Sum `t` in place over the ranks of `axis` (the whole world when
    None) and return it."""
    import torch.distributed as dist
    _count("all_reduce", t.numel() * t.element_size())
    dist.all_reduce(t, op=dist.ReduceOp.SUM,
                    group=None if axis is None else axis.group)
    return t


def barrier(device=None) -> None:
    """Wait for every rank of the world."""
    import torch.distributed as dist
    _count("barrier", 0)
    dev = None if device is None else torch.device(device)
    if dev is not None and dev.type == "cuda" \
            and dist.get_backend() == "nccl":
        dist.barrier(device_ids=[dev.index])
    else:
        dist.barrier()
