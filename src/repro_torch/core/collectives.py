"""The port's counted collectives (DESIGN.md §11's mesh path and the zoo's
sharded steps).

Every collective of the port goes through this module, which counts each
call in this process (`collective_counts`), under the active
`collective_scope`, so a test reads that a scope (HFL's tier 1) issued
no collective at all. Two tallies are kept:

* "calls" / "bytes": what went to the process group, by name. Gloo runs
  only `all_reduce` and `broadcast` on CUDA tensors, so on every backend
  each collective but `all_gather` and `all_to_all` is ONE sum
  `all_reduce` on the wire (or a `barrier`); `all_gather` is one
  `all_gather` (gloo's on host copies of CUDA tensors), `all_to_all` one
  `all_to_all_single`. Ranks that share a card swap CUDA IPC
  handles instead ("card_exchange") for the gathers of a sharded step,
  and read each other's blocks card to card.
* "kinds" / "kind_bytes": the collective each call stands for, under the
  reference's HLO op names ("all-reduce", "all-gather", "reduce-scatter",
  "collective-permute", "all-to-all"), with the bytes of its result,
  which is what the reference's `roofline.parse_collective_bytes` reads
  from HLO text (`launch.roofline.collective_bytes` weighs them as it
  does).

`all_reduce_sum` sums in place; `all_gather` sends each rank's block
once (where gloo moves CUDA tensors, both take a host path of one copy
each way for results of at most `SMALL_GATHER_BYTES`: a decode step's
activations); `card_gather` and `card_reduce` make many gathers and
sums at once between ranks that share a card, reading the blocks card
to card (the zoo's sharded steps gather every layer's weights and sum
its gradients a step, which through the host bounded them), and
`packed_gather` a take's leaves of at most SMALL_GATHER_BYTES over one
axis in one host all_gather (a decode step's norms, where a card
exchange waits longer); `ppermute` is a slot expansion read at the
senders' slots. The tensor-parallel steps'
autograd operations (`copy_to`, `reduce_from`, `sum_over`, and
`gather_leaves`, an all-gather whose backward reduce-scatters the
gradient) and the expert- and context-parallel exchanges (`all_to_all`,
whose backward is the inverse all-to-all, and `gather_seq`, the keys' and
values' all-gather over the sequence axis, whose backward
reduce-scatters) sit at the end. Inside `dry_run()` no collective touches a
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
import math
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


# the largest result (the gathered bytes) of a gloo collective of CUDA
# tensors that takes the host path (`_small_on_gloo`). On 8 ranks sharing an
# H100 (tests/torch_collective_latency.py; PERF.md section 6) the host sum
# waited about half gloo's own up to 1 MB and more from 4 MB, the host join
# less than the per-block copies to 128 KB, as long to 1 MB and more from
# 4 MB: one size for both
SMALL_GATHER_BYTES = 1 << 20


def _small_on_gloo(t: torch.Tensor, group, nbytes: int) -> bool:
    """Whether a collective of `t` whose result on the wire is `nbytes`
    takes the host path: gloo moves CUDA tensors through host copies, and
    for a result of at most SMALL_GATHER_BYTES one copy each way and one
    gloo all_gather wait less than gloo's own handling of CUDA tensors
    (tests/torch_collective_latency.py; PERF.md section 6)."""
    import torch.distributed as dist
    return (t.is_cuda and nbytes <= SMALL_GATHER_BYTES
            and dist.get_backend(group) == "gloo")


def _sum(t: torch.Tensor, axis, kind: str, n: int = 1,
         kind_bytes=None) -> torch.Tensor:
    """The one wire operation: sum `t` in place over `axis`, counted as
    one all_reduce standing for `n` collectives of `kind`. On the host
    path (`_small_on_gloo`) it is a gloo all_gather of host copies summed
    in group order, the same bits on every rank."""
    import torch.distributed as dist
    _count("all_reduce", _nbytes(t), kind, n,
           _nbytes(t) if kind_bytes is None else kind_bytes)
    if _DRY[0]:
        return t
    group = None if axis is None else axis.group
    size = dist.get_world_size(group)
    if not _small_on_gloo(t, group, _nbytes(t) * size):
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
        return t
    block = t.detach().cpu()
    parts = [torch.empty_like(block) for _ in range(size)]
    dist.all_gather(parts, block, group=group)
    for p in parts[1:]:
        parts[0] += p
    with torch.no_grad():
        t.copy_(parts[0])
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
    card beat a join on the host and the slot-expanded sum for a layer's
    weights (tests/torch_gather_probe.py; PERF.md §5); a result of at
    most SMALL_GATHER_BYTES is joined on the host and copied once."""
    n = axis.size
    _count("all_gather", _nbytes(x) * n, "all-gather", 1, _nbytes(x) * n)
    if _DRY[0]:
        return torch.cat([x] * n, dim)
    import torch.distributed as dist
    block = x.contiguous()
    staged = block.is_cuda and dist.get_backend(axis.group) == "gloo"
    small = _small_on_gloo(block, axis.group, _nbytes(x) * n)
    if staged:
        block = block.cpu()
    parts = [torch.empty(block.shape, dtype=block.dtype, device=block.device,
                         pin_memory=staged and not small) for _ in range(n)]
    dist.all_gather(parts, block, group=axis.group)
    # a group lists its ranks in ascending order; the axis may not
    order = sorted(axis.members)
    ordered = [parts[order.index(r)] for r in axis.members]
    if small:
        return torch.cat(ordered, dim).to(x.device)
    return torch.cat([p.to(x.device) for p in ordered], dim)


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
    counts them.

    A rank packs its blocks in one buffer a dtype and shares it once for
    each rank that reads it (the ranks it reads from, by the symmetry of a
    gather); each reader opens its own share, once a peer: PyTorch's CUDA
    IPC counts one release a share (a block whose one share seven readers
    released stayed allocated for good in its sender, ROADMAP C.5), and
    opening a share costs far more than reading it."""
    import torch.distributed as dist
    from torch.multiprocessing.reductions import (rebuild_cuda_tensor,
                                                  reduce_tensor)
    me = dist.get_rank()
    # a block shared by an earlier call and freed since waits for this
    # before the allocator reuses it
    torch.cuda.ipc_collect()
    # the blocks packed in one buffer a dtype (alive to the barrier): a
    # reader opens one share a peer, whatever the number of items
    packs: Dict = {}
    where = []
    for x, *_ in items:
        at = sum(b.numel() for b in packs.get(x.dtype, []))
        packs.setdefault(x.dtype, []).append(x.detach().reshape(-1))
        where.append((x.dtype, at))
    flat = {dt: torch.cat(bs) for dt, bs in packs.items()}
    readers: Dict = {}
    for x, _, places, _ in items:
        readers.setdefault(x.dtype, set()).update(
            j for j, _ in places if j != me)
    _count("card_exchange", 0)
    handles: List = [None] * dist.get_world_size()
    dist.all_gather_object(handles, {
        dt: {j: reduce_tensor(b)[1] for j in sorted(readers[dt])}
        for dt, b in flat.items()})
    peers: Dict = {}
    outs = []
    for (x, shape, places, kind_bytes), (dt, at) in zip(items, where):
        for nbytes in kind_bytes:
            _count_kind("all-gather", 1, nbytes)
        out = torch.empty(shape, dtype=x.dtype, device=x.device)
        n = x.numel()
        for j, w in places:
            if j == me:
                src = flat[dt]
            else:
                if (j, dt) not in peers:
                    peers[j, dt] = rebuild_cuda_tensor(*handles[j][dt][me])
                src = peers[j, dt]
            out[w].copy_(src[at:at + n].view(x.shape))
        outs.append(out)
    if items:
        torch.cuda.current_stream(items[0][0].device).synchronize()
    peers.clear()                         # let go of every peer's block
    dist.barrier()
    flat.clear()
    torch.cuda.ipc_collect()
    return outs


def card_reduce(items) -> List[torch.Tensor]:
    """Many sums at once between ranks that share a card, each read card
    to card through CUDA IPC: `items` lists (flat buffer, members: the
    global ranks of the sum's axis in axis order, [(offset, shape,
    index)]: the buffer's pieces, each a tensor of `shape` at `offset`
    of which this rank keeps `index`); every rank passes its own buffer
    for the same items in the same order. Each rank adds the members'
    pieces at its own index, in axis order, so ranks that keep the same
    block get the same bits. Shares and exchanges as `card_gather`
    (counted as one "card_exchange" call); the caller counts the kinds."""
    import torch.distributed as dist
    from torch.multiprocessing.reductions import (rebuild_cuda_tensor,
                                                  reduce_tensor)
    me = dist.get_rank()
    torch.cuda.ipc_collect()
    bufs = [b.detach().contiguous() for b, *_ in items]
    _count("card_exchange", 0)
    handles: List = [None] * dist.get_world_size()
    dist.all_gather_object(handles, [
        {j: reduce_tensor(b)[1] for j in members if j != me}
        for b, (_, members, _) in zip(bufs, items)])
    outs, opened = [], []
    for k, (_, members, pieces) in enumerate(items):
        peers = [bufs[k] if j == me else rebuild_cuda_tensor(
            *handles[j][k][me]) for j in members]
        opened.extend(peers)
        for at, shape, index in pieces:
            n = math.prod(shape)
            acc = None
            for b in peers:
                part = b[at:at + n].view(shape)[index]
                acc = part.clone() if acc is None else acc.add_(part)
            outs.append(acc)
    if items:
        torch.cuda.current_stream(bufs[0].device).synchronize()
    opened.clear()
    dist.barrier()
    bufs.clear()
    torch.cuda.ipc_collect()
    return outs


def _all_to_all(x: torch.Tensor, axis, split_dim: int,
                concat_dim: int) -> torch.Tensor:
    """`x` cut into axis.size blocks along `split_dim`, block p sent to the
    rank at position p of the axis, and the blocks received joined along
    `concat_dim` in axis order: one all-to-all, counted as the reference's
    "all-to-all" with the bytes of its result (the bytes of `x`). Ranks
    sharing a card read their peers' blocks card to card
    (`card_all_to_all`); elsewhere one `all_to_all_single` (gloo's on
    CPU tensors, NCCL's on the card)."""
    n, i = axis.size, axis.index
    if on_shared_card(x):
        _count_kind("all-to-all", 1, _nbytes(x))
        return card_all_to_all(x, axis, split_dim, concat_dim)
    _count("all_to_all", _nbytes(x), "all-to-all", 1, _nbytes(x))
    if _DRY[0]:
        return torch.cat([x.chunk(n, split_dim)[i]] * n, concat_dim)
    import torch.distributed as dist
    # all_to_all_single cuts its input along dim 0 in the group's order
    # (ascending global ranks); the axis may list its ranks in another
    order = sorted(axis.members)
    pos = [axis.members.index(r) for r in order]
    blocks = x.chunk(n, split_dim)
    send = torch.stack([blocks[p] for p in pos]).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=axis.group)
    got = [recv[order.index(r)] for r in axis.members]
    return torch.cat(got, concat_dim)


def card_all_to_all(x: torch.Tensor, axis, split_dim: int,
                    concat_dim: int) -> torch.Tensor:
    """`_all_to_all` between ranks that share a card, in one card exchange
    (`card_gather`): item p is each rank's block p, read only by the rank
    at position p of the axis, which places its peers' blocks in axis
    order. Shares as `card_gather` (one a reader, so a rank's block is
    opened once by each peer); not counted by kind here."""
    n, i = axis.size, axis.index
    blocks = [b.contiguous() for b in x.chunk(n, split_dim)]
    shape = list(blocks[i].shape)
    step = shape[concat_dim]
    shape[concat_dim] = step * n
    items = []
    for p, b in enumerate(blocks):
        if p != i:
            items.append((b, (0,), [], []))
            continue
        places = []
        for q, r in enumerate(axis.members):
            where = [slice(None)] * len(shape)
            where[concat_dim] = slice(q * step, (q + 1) * step)
            places.append((r, tuple(where)))
        items.append((b, tuple(shape), places, []))
    return card_gather(items)[i]


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


# -- tensor parallelism: autograd operations over a mesh axis -----------------
# Megatron's pair for a tensor-parallel block whose input and output are
# whole on every rank of `axis`: `copy_to` at its entry (identity forward,
# the gradient summed backward: each rank's branch adds its part of the
# input's gradient), `reduce_from` after its row-parallel product (the
# partial outputs summed forward; every rank then computes the same
# downstream, so the gradient passes through). Both are counted as the
# reference's "all-reduce". `sum_over` is the two at once, for a sum whose
# result feeds rank-specific work (the gated norm's sum of squares).

class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum(g.contiguous().clone(), ctx.axis, "all-reduce"), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return _sum(x.contiguous().clone(), axis, "all-reduce")

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to(x: torch.Tensor, axis) -> torch.Tensor:
    """Megatron's f over `axis`: `x`, its gradient summed over the axis."""
    return _CopyTo.apply(x, axis)


def reduce_from(x: torch.Tensor, axis) -> torch.Tensor:
    """Megatron's g over `axis`: the sum of the ranks' `x`, its gradient
    passed through."""
    return _ReduceFrom.apply(x, axis)


def sum_over(x: torch.Tensor, axis) -> torch.Tensor:
    """The sum of the ranks' `x`, its gradient summed too."""
    return copy_to(reduce_from(x, axis), axis)


def max_over(x: torch.Tensor, axis) -> torch.Tensor:
    """The elementwise max of the ranks' `x` (no gradient): one sum
    all_reduce of an (axis.size, *x.shape) slot expansion, counted as the
    reference's one "all-reduce" (a max there)."""
    x = x.detach()
    slots = x.new_zeros((axis.size,) + tuple(x.shape))
    slots[axis.index] = x
    _sum(slots, axis, "all-reduce", 1, _nbytes(x))
    return slots.amax(0)


class LeafPlan(tuple):
    """How `gather_leaves` makes one leaf's compute slice from the rank's
    stored shard, and how its gradient goes back (`launch.mesh.leaf_plan`
    builds it): `dims` [(dim, axis)] gathered in turn by `all_gather`;
    `card` the `card_gather` item of the same gathers less its first
    entry, the shard (None: nothing to gather); `select` (dim, ((lo,
    hi), ...)) cut from the gathered tensor (None: all of it); `shape` the
    gathered tensor's shape; `sum_axis` the axis the gradient is summed
    over (None: no sum); `index` the rank's stored block within the
    gathered tensor; `kind` the reference's op the gradient's sum stands
    for ("reduce-scatter" where the stored shard is cut over a summed
    axis, else "all-reduce")."""

    def __new__(cls, dims, card, select, shape, sum_axis, index, kind):
        return super().__new__(cls, (dims, card, select, tuple(shape),
                                     sum_axis, index, kind))

    dims = property(lambda s: s[0])
    card = property(lambda s: s[1])
    select = property(lambda s: s[2])
    shape = property(lambda s: s[3])
    sum_axis = property(lambda s: s[4])
    index = property(lambda s: s[5])
    kind = property(lambda s: s[6])


def _select(x, select):
    """The compute slice of a gathered tensor: a copy, so that nothing
    keeps the gathered tensor alive."""
    if select is None:
        return x
    d, ranges = select
    return torch.cat([x.narrow(d, lo, hi - lo) for lo, hi in ranges], d)


def _unselect(g, select, shape):
    if select is None:
        return g
    d, ranges = select
    out = g.new_zeros(shape)
    at = 0
    for lo, hi in ranges:
        out.narrow(d, lo, hi - lo).copy_(g.narrow(d, at, hi - lo))
        at += hi - lo
    return out


class _GatherLeaves(torch.autograd.Function):
    """Forward: each stored shard gathered (all of them in one card
    exchange on ranks sharing a card) and its compute slice cut.
    Backward: each slice's gradient placed in the gathered shape, summed
    over its axis (one sum all_reduce a summed axis and dtype for all the
    leaves) and cut to the rank's stored block: the all-gather's
    transpose, a reduce-scatter where the shard is cut over the summed
    axes."""

    @staticmethod
    def forward(ctx, plans, *shards):
        ctx.plans = plans
        full = list(shards)
        cards = [(i, p.card) for i, p in enumerate(plans) if p.card]
        axis = cards and on_shared_card(shards[0]) and _one_small_gather(
            [(shards[i], plans[i]) for i, _ in cards])
        if axis:
            for (i, _), x in zip(cards, packed_gather(
                    [(shards[i], plans[i].dims[0][0]) for i, _ in cards],
                    axis)):
                full[i] = x
        elif cards and on_shared_card(shards[0]):
            for (i, _), x in zip(cards, card_gather(
                    [(shards[i],) + c for i, c in cards])):
                full[i] = x
        else:
            # each leaf's slice is cut as soon as it is gathered, so one
            # gathered leaf at a time is alive
            for i, p in enumerate(plans):
                for d, axis in p.dims:
                    full[i] = all_gather(full[i], axis, dim=d)
                full[i] = _select(full[i], p.select)
            return tuple(full)
        return tuple(_select(x, p.select) for x, p in zip(full, plans))

    @staticmethod
    def backward(ctx, *grads):
        plans = ctx.plans
        padded = [_unselect(g, p.select, p.shape)
                  for g, p in zip(grads, plans)]
        groups: Dict = {}
        for i, p in enumerate(plans):
            if p.sum_axis is not None:
                groups.setdefault((p.sum_axis.name, padded[i].dtype),
                                  []).append(i)
        out = [x[p.index] for x, p in zip(padded, plans)]
        card = grads and on_shared_card(grads[0])
        items, where = [], []
        for members in groups.values():
            axis = plans[members[0]].sum_axis
            # ranks sharing a card read one leaf's gradient where it lies
            # (a whole leaf's is the size of the leaf: no second copy);
            # a sum in place works on a copy
            buf = (padded[members[0]].contiguous().reshape(-1)
                   if card and len(members) == 1 else
                   torch.cat([padded[i].reshape(-1) for i in members]))
            pieces, at = [], 0
            for i in members:
                n = padded[i].numel()
                pieces.append((at, tuple(padded[i].shape), plans[i].index))
                if not card:
                    out[i] = buf[at:at + n].view(padded[i].shape)[
                        plans[i].index]
                at += n
                _count_kind(plans[i].kind, 1, _nbytes(
                    out[i] if plans[i].kind == "reduce-scatter"
                    else padded[i]))
            if card:
                # ranks sharing a card read each other's pieces card to card
                items.append((buf, axis.members, pieces))
                where.extend(members)
            else:
                _sum(buf, axis, "")
        if items:
            for i, x in zip(where, card_reduce(items)):
                out[i] = x
        # a view of a padded gradient is copied, so that nothing keeps the
        # padded tensor alive; a sum's fresh result is returned as it is
        return (None,) + tuple(
            x if x._base is None and x.is_contiguous()
            else x.clone(memory_format=torch.contiguous_format) for x in out)


def _one_small_gather(leaves):
    """The axis over which every (shard, `LeafPlan`) of `leaves` gathers
    one dim, where they share it and a dtype and their gathered results
    come to at most SMALL_GATHER_BYTES (a decode step's norms and small
    leaves), else None."""
    axes = {p.dims[0][1].name for _, p in leaves if len(p.dims) == 1}
    if (len(axes) != 1 or any(len(p.dims) != 1 for _, p in leaves)
            or len({x.dtype for x, _ in leaves}) != 1):
        return None
    axis = leaves[0][1].dims[0][1]
    total = sum(_nbytes(x) for x, _ in leaves) * axis.size
    return axis if total <= SMALL_GATHER_BYTES else None


def packed_gather(items, axis) -> List[torch.Tensor]:
    """Each (x, dim) of `items` all-gathered along `dim` over `axis` in
    axis order, by one `all_gather` of their flat concatenation, joined
    on the host: on ranks sharing a card a card exchange waited ~4x as
    long as a gloo all_gather of up to 1 MB (PERF.md section 6). Counted
    as one call standing for an all-gather an item."""
    import torch.distributed as dist
    n = axis.size
    flat = torch.cat([x.detach().reshape(-1) for x, _ in items]).cpu()
    _count("all_gather", _nbytes(flat) * n)
    for x, _ in items:
        _count_kind("all-gather", 1, _nbytes(x) * n)
    parts = [torch.empty_like(flat) for _ in range(n)]
    dist.all_gather(parts, flat, group=axis.group)
    order = sorted(axis.members)
    ranks = [parts[order.index(r)] for r in axis.members]
    out, at = [], 0
    for x, d in items:
        k = x.numel()
        out.append(torch.cat([p[at:at + k].view(x.shape) for p in ranks],
                             d).to(x.device))
        at += k
    return out


def gather_leaves(plans, shards) -> List[torch.Tensor]:
    """The compute slices of `shards` by their `LeafPlan`s, through an
    autograd function whose backward sums each slice's gradient over its
    axis and keeps the rank's stored block (`_GatherLeaves`)."""
    return list(_GatherLeaves.apply(tuple(plans), *shards))


# -- expert and context parallelism: autograd exchanges over a mesh axis ----

class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, split_dim, concat_dim):
        ctx.args = (axis, concat_dim, split_dim)
        return _all_to_all(x, axis, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, *ctx.args), None, None, None


def all_to_all(x: torch.Tensor, axis, split_dim: int,
               concat_dim: int) -> torch.Tensor:
    """The all-to-all of `_all_to_all` (the expert-parallel dispatch's
    boundary); its backward is the inverse all-to-all of the gradient
    (split along `concat_dim`, joined along `split_dim`)."""
    return _AllToAll.apply(x, axis, split_dim, concat_dim)


def _block(shape, dim, n, i):
    where = [slice(None)] * len(shape)
    step = shape[dim] // n
    where[dim] = slice(i * step, (i + 1) * step)
    return tuple(where)


class _GatherSeq(torch.autograd.Function):
    """Forward: each of `xs` all-gathered along `dim` over `axis` (one card
    exchange for all of them on ranks sharing a card). Backward: each
    gradient summed over the axis and cut to the rank's block, a
    reduce-scatter (one card exchange for all, or one sum all_reduce
    each)."""

    @staticmethod
    def forward(ctx, axis, dim, *xs):
        ctx.axis, ctx.dim = axis, dim
        n = axis.size
        if xs and on_shared_card(xs[0]):
            items = []
            for x in xs:
                shape = list(x.shape)
                shape[dim] *= n
                items.append((x.contiguous(), tuple(shape), [
                    (r, _block(shape, dim, n, q))
                    for q, r in enumerate(axis.members)],
                    [_nbytes(x) * n]))
            return tuple(card_gather(items))
        return tuple(all_gather(x.contiguous(), axis, dim) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        axis, dim = ctx.axis, ctx.dim
        n, i = axis.size, axis.index
        mine = [_block(g.shape, dim, n, i) for g in grads]
        for g, w in zip(grads, mine):
            _count_kind("reduce-scatter", 1, _nbytes(g[w]))
        if grads and on_shared_card(grads[0]):
            items = [(g.contiguous().reshape(-1), axis.members,
                      [(0, tuple(g.shape), w)]) for g, w in zip(grads, mine)]
            out = card_reduce(items)
        else:
            out = [_sum(g.contiguous().clone(), axis, "")[w]
                   for g, w in zip(grads, mine)]
        return (None, None) + tuple(
            x.clone(memory_format=torch.contiguous_format) for x in out)


def gather_seq(xs: Sequence[torch.Tensor], axis,
               dim: int = 1) -> List[torch.Tensor]:
    """The ranks' blocks of each of `xs` joined along `dim` in axis order
    (context parallelism's keys and values, each rank holding a block of
    the sequence); the backward reduce-scatters each gradient back to the
    rank's block."""
    return list(_GatherSeq.apply(axis, dim, *xs))
