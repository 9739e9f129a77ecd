"""The port's counted collectives (DESIGN.md §11's mesh path and the zoo's
sharded steps).

Every collective of the port goes through this module, which counts each
call in this process (`collective_counts`), under the active
`collective_scope`, so a test reads that a scope (HFL's tier 1) issued
no collective at all. Two tallies are kept:

* "calls" / "bytes": what went to the process group, by name. Gloo runs
  only `all_reduce` and `broadcast` on CUDA tensors, so on every backend
  each collective but `all_gather` is ONE sum `all_reduce` on the wire
  (or a `barrier`); `all_gather` is one `all_gather` (gloo's on host
  copies of CUDA tensors). Ranks that share a card swap CUDA IPC
  handles instead ("card_exchange") for the gathers of a sharded step,
  and read each other's blocks card to card.
* "kinds" / "kind_bytes": the collective each call stands for, under the
  reference's HLO op names ("all-reduce", "all-gather", "reduce-scatter",
  "collective-permute"), with the bytes of its result, which is what the
  reference's `roofline.parse_collective_bytes` reads from HLO text
  (`launch.roofline.collective_bytes` weighs them as it does).

`all_reduce_sum` sums in place; `all_gather` sends each rank's block
once; `card_gather` makes many gathers at once between ranks that share
a card, reading the blocks card to card (the zoo's sharded steps gather
every weight a step, which through the host bounded them);
`reduce_scatter`
is a sum and then the caller's slice; `ppermute` is a slot expansion
read at the senders' slots. Inside `dry_run()` no collective touches a
process group: each counts its kind and bytes and returns a tensor of its
result's shape (on the meta device when its input is there), as if every
rank held the same data. The dry-run (`launch/dryrun.py`) runs rank 0's
program so.

The core layer's mesh operators call these directly; `launch/mesh.py`,
which starts the ranks and makes their process groups, re-exports them.
An axis is any object with a process `group` (None: the whole world),
its `size`, this rank's `index` on it and (for `all_gather`) the global
ranks of its `members` in axis order, as `launch.mesh.MeshAxis` is.
"""
from __future__ import annotations

import collections
import contextlib
from typing import Dict, List, Sequence

import torch

_CALLS: collections.Counter = collections.Counter()
_BYTES: collections.Counter = collections.Counter()
_SCOPES: collections.Counter = collections.Counter()
_SCOPE: List[str] = []
_KINDS: collections.Counter = collections.Counter()
_KIND_BYTES: collections.Counter = collections.Counter()
# the dry-run's count-only mode: process-wide, not a context variable, so a
# checkpointed layer recomputed on the autograd engine's thread sees it
_DRY = [False]


def collective_counts() -> Dict[str, Dict[str, int]]:
    """This process's collective calls and bytes by name ("all_reduce",
    and "scope/all_reduce" inside `collective_scope("scope")`), how often
    each scope was entered, and the calls and result bytes by the
    reference's op kind ("kinds", "kind_bytes")."""
    return {"calls": dict(_CALLS), "bytes": dict(_BYTES),
            "scopes": dict(_SCOPES), "kinds": dict(_KINDS),
            "kind_bytes": dict(_KIND_BYTES)}


def reset_collective_counts() -> None:
    for c in (_CALLS, _BYTES, _SCOPES, _KINDS, _KIND_BYTES):
        c.clear()


@contextlib.contextmanager
def dry_run():
    """Count collectives without issuing them (the dry-run's mode): no
    process group is touched, and each collective returns a tensor of its
    result's shape computed as if every rank held this rank's data."""
    prev, _DRY[0] = _DRY[0], True
    try:
        yield
    finally:
        _DRY[0] = prev


def in_dry_run() -> bool:
    return _DRY[0]


@contextlib.contextmanager
def collective_scope(name: str):
    """Count the collectives issued inside under "name/<op>" as well."""
    _SCOPES[name] += 1
    _SCOPE.append(name)
    try:
        yield
    finally:
        _SCOPE.pop()


def _count(op: str, nbytes: int, kind: str = "", n: int = 1,
           kind_bytes: int = 0) -> None:
    keys = [op] + [f"{s}/{op}" for s in _SCOPE]
    for k in keys:
        _CALLS[k] += 1
        _BYTES[k] += nbytes
    _count_kind(kind, n, kind_bytes)


def _count_kind(kind: str, n: int, kind_bytes: int) -> None:
    if kind:
        _KINDS[kind] += n
        _KIND_BYTES[kind] += kind_bytes


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _sum(t: torch.Tensor, axis, kind: str, n: int = 1,
         kind_bytes=None) -> torch.Tensor:
    """The one wire operation: sum `t` in place over `axis`, counted as
    one all_reduce standing for `n` collectives of `kind`."""
    import torch.distributed as dist
    _count("all_reduce", _nbytes(t), kind, n,
           _nbytes(t) if kind_bytes is None else kind_bytes)
    if not _DRY[0]:
        dist.all_reduce(t, op=dist.ReduceOp.SUM,
                        group=None if axis is None else axis.group)
    return t


def all_reduce_sum(t: torch.Tensor, axis=None) -> torch.Tensor:
    """Sum `t` in place over the ranks of `axis` (the whole world when
    None) and return it."""
    return _sum(t, axis, "all-reduce")


def all_gather(x: torch.Tensor, axis, dim: int = 0) -> torch.Tensor:
    """The ranks' `x` joined along `dim` in axis order: one `all_gather`
    of the ranks' blocks, counted with the bytes of its result. Under
    gloo a CUDA block goes through a host copy (gloo gathers CPU
    tensors only): the blocks arrive in pinned memory, each is copied to
    `x`'s device and they are joined there, which on ranks sharing a
    card beat a join on the host and the slot-expanded sum
    (tests/torch_gather_probe.py; PERF.md §5)."""
    n = axis.size
    _count("all_gather", _nbytes(x) * n, "all-gather", 1, _nbytes(x) * n)
    if _DRY[0]:
        return torch.cat([x] * n, dim)
    import torch.distributed as dist
    block = x.contiguous()
    staged = block.is_cuda and dist.get_backend(axis.group) == "gloo"
    if staged:
        block = block.cpu()
    parts = [torch.empty(block.shape, dtype=block.dtype, device=block.device,
                         pin_memory=staged) for _ in range(n)]
    dist.all_gather(parts, block, group=axis.group)
    # a group lists its ranks in ascending order; the axis may not
    order = sorted(axis.members)
    return torch.cat([parts[order.index(r)].to(x.device)
                      for r in axis.members], dim)


def on_shared_card(x) -> bool:
    """Whether `x`'s collectives join ranks that share a card through
    gloo (a CUDA tensor in a gloo world, out of the dry-run): those ranks
    can read each other's blocks card to card (`card_gather`)."""
    import torch.distributed as dist
    return (isinstance(x, torch.Tensor) and x.is_cuda and not _DRY[0]
            and dist.is_initialized() and dist.get_backend() == "gloo")


def card_gather(items) -> List[torch.Tensor]:
    """Many gathers at once between ranks that share a card, every block
    read card to card through CUDA IPC. `items` lists (x, result shape,
    [(rank, slices of the result that rank's x fills)], [result bytes of
    each all-gather it stands for]); every rank passes its own x for the
    same items in the same order. The ranks swap one list of IPC handles
    (one gloo object all-gather over the world, counted as one
    "card_exchange" call); each copies the blocks it needs into its
    results on its own stream, waits for its copies and meets the others
    at a barrier, after which no rank reads another's block. Each item is
    counted by kind as the all-gathers it stands for, as `all_gather`
    counts them."""
    import torch.distributed as dist
    from torch.multiprocessing.reductions import (rebuild_cuda_tensor,
                                                  reduce_tensor)
    me = dist.get_rank()
    # a block shared by an earlier call and freed since waits for this
    # before the allocator reuses it
    torch.cuda.ipc_collect()
    blocks = [x.contiguous() for x, *_ in items]     # alive to the barrier
    _count("card_exchange", 0)
    handles: List = [None] * dist.get_world_size()
    dist.all_gather_object(handles, [reduce_tensor(b)[1] for b in blocks])
    outs, opened = [], []
    for k, (x, shape, places, kind_bytes) in enumerate(items):
        for nbytes in kind_bytes:
            _count_kind("all-gather", 1, nbytes)
        out = torch.empty(shape, dtype=x.dtype, device=x.device)
        for j, where in places:
            if j != me:
                opened.append(rebuild_cuda_tensor(*handles[j][k]))
            out[where].copy_(blocks[k] if j == me else opened[-1])
        outs.append(out)
    if items:
        torch.cuda.current_stream(items[0][0].device).synchronize()
    opened.clear()                        # let go of every peer's block
    dist.barrier()
    blocks.clear()
    torch.cuda.ipc_collect()
    return outs


def reduce_scatter(x: torch.Tensor, axis, index) -> torch.Tensor:
    """The sum of `x` over `axis`, of which this rank keeps `x[index]`
    (its block): one sum all_reduce, then the slice."""
    _sum(x, axis, "reduce-scatter", 1, _nbytes(x[index]))
    return x[index].clone()


def ppermute(x: torch.Tensor, axis, shifts: Sequence[int]):
    """For each shift s, the `x` of the rank s places before this one on
    the axis ring (rank i sends to i + s, as `lax.ppermute` with the
    permutation j -> j + s): one sum all_reduce of an (axis.size,
    *x.shape) slot expansion serves every shift, counted as one
    collective-permute a shift."""
    n, i = axis.size, axis.index
    if _DRY[0]:
        _count("all_reduce", _nbytes(x) * n, "collective-permute",
               len(shifts), _nbytes(x) * len(shifts))
        return [x.clone() for _ in shifts]
    slots = x.new_zeros((n,) + tuple(x.shape))
    slots[i] = x
    _sum(slots, axis, "collective-permute", len(shifts),
         _nbytes(x) * len(shifts))
    return [slots[(i - s) % n] for s in shifts]


def barrier(device=None) -> None:
    """Wait for every rank of the world."""
    import torch.distributed as dist
    _count("barrier", 0)
    if _DRY[0]:
        return
    dev = None if device is None else torch.device(device)
    if dev is not None and dev.type == "cuda" \
            and dist.get_backend() == "nccl":
        dist.barrier(device_ids=[dev.index])
    else:
        dist.barrier()
