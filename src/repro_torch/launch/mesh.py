"""Meshes and the SPMD world of the mesh-sharded fused executor (port of
`repro.launch.mesh`, DESIGN.md §11).

Shape-only meshes (`MeshShape`, from `sharding/specs.py`):

* `make_host_mesh(data, model, devices=...)` — a ("data", "model") mesh
  over the devices there are, each axis clamped to a divisor;
* `make_production_mesh` / `make_fl_mesh` — the 16x16 and 2x16x16 meshes
  of the reference's dry run, as shapes (`launch/dryrun.py` runs rank 0
  of them on the meta device);
* `make_client_mesh(devices)` — the 1-D ("data",) mesh of the fused
  executor: the stacked CLIENT axis is laid over `devices` ranks.

The reference runs one SPMD program over a mesh of devices (`shard_map`).
The port runs one process per rank on `torch.distributed` instead:

* `World(size, device="cuda", backend=None)` spawns the ranks (`spawn`
  start method, never `fork`), which meet at a `file://` rendezvous in a
  temporary directory, and keeps them for any number of tasks:
  `world.run(fn, *args)` calls `fn(rank, *args)` on every rank and
  returns the ranks' results in rank order. A rank that raises fails the
  call with the rank's traceback (`RankError`); a rank blocked in a
  collective fails at the group `timeout`, so a dead rank fails the run
  and never hangs it. Every rank leaves through `destroy_process_group`.
* The backend follows the placement (`resolve_backend`): gloo on the
  CPU; gloo over CUDA tensors when ranks share a card (NCCL refuses two
  ranks on one card); nccl when every rank has a card of its own. A
  backend that cannot run the placement raises; nothing gives way to
  another backend or to the CPU.
* In a rank, `rank.axis()` is the 1-D world's "data" axis and
  `rank.mesh(shape)` lays a multi-axis `MeshShape` over the world's
  ranks (row-major); a `MeshAxis` carries the rank's index on the axis,
  its size and the process group of its members.
* Every collective of the port goes through `core/collectives.py`
  (re-exported here), which counts its calls and bytes on each rank
  (`collective_counts`), under the active `collective_scope`: so a test
  reads that a scope (HFL's tier 1) issued no collective at all.
* The zoo's sharded steps keep each leaf as the rank's shard of it, cut
  by a `specs.NamedSharding`: `shard_tree` cuts a tree's leaves (no
  collective), `gather_tree` joins them back with one `all_gather` a
  sharded dim, or, on ranks that share a card, all of the tree's at once
  card to card (`card_plan`, `collectives.card_gather`).
  `dry_run_mesh(shape)` is rank 0 of a mesh that has no processes, for
  the count-only dry-run.

Gloo runs only `all_reduce` and `broadcast` on CUDA tensors, so every
other collective is a sum `all_reduce` on the wire, a gather a gloo
`all_gather` of host copies (`core/collectives.py`). A rank on the card
empties its cache after each task: the ranks share the card with each
other and with the caller.

The reference's `axis_types_kw`, `activate_mesh` and `shard_map_compat`
are shims between jax versions for installing a mesh and tracing a
function over it; they have no counterpart: the ranks run the round body
themselves.
"""
from __future__ import annotations

import datetime
import itertools
import multiprocessing
import multiprocessing.connection
import os
import shutil
import tempfile
import time
import traceback
from typing import Any, Dict, List, Optional, Sequence

import torch

# the counted collectives live in the core layer, which the mesh operators
# call; re-exported here beside the world that runs them
from repro_torch import device as device_mod
from repro_torch.core import collectives
from repro_torch.core.collectives import (  # noqa: F401
    all_gather, all_reduce_sum, barrier, collective_counts,
    collective_scope, ppermute, reduce_scatter, reset_collective_counts)
from repro_torch.sharding.specs import MeshShape, entry_axes
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

# ranks that may share one card under gloo (8 ranks take 10 GB each of an
# 80 GB card at most)
RANKS_PER_CARD = 8
# seconds the ranks may take to start and meet (8 ranks importing torch and
# creating their CUDA contexts took 15.6 s on one H100)
START_TIMEOUT = 180.0


def largest_divisor_at_most(n: int, k: int) -> int:
    """The largest divisor of `n` that is <= `k` (>= 1)."""
    k = max(1, min(k, n))
    while n % k:
        k -= 1
    return k


def make_host_mesh(data: int = 1, model: int = 1, *,
                   devices: Optional[int] = None) -> MeshShape:
    """Small ("data", "model") mesh over `devices` (default: the cards
    there are). Requested axis sizes are clamped to DIVISORS of the device
    count, not just its magnitude: `min(data, n)` alone builds impossible
    factorizations at non-power-of-two counts (6 devices, data=4 -> a 4x1
    mesh stranding two), so each axis takes the largest divisor of the
    remaining devices instead."""
    if devices is None:
        devices = torch.cuda.device_count() if torch.cuda.is_available() else 1
    n = int(devices)
    data = largest_divisor_at_most(n, data)
    model = largest_divisor_at_most(n // data, model)
    return MeshShape((data, model), ("data", "model"))


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    """The reference's target meshes, as shapes: 16x16 = 256 chips
    single-pod; (pod=2, 16, 16) = 512 chips multi-pod."""
    if multi_pod:
        return MeshShape((2, 16, 16), ("pod", "data", "model"))
    return MeshShape((16, 16), ("data", "model"))


def make_fl_mesh(*, clients: int = 16, model: int = 16,
                 multi_pod: bool = False) -> MeshShape:
    """Mesh for pod-scale federated runs: "data" hosts FL clients (one
    client per slice), "model" is tensor-parallel within a client, and
    "pod" carries HFL's hierarchy tier in multi-pod runs."""
    if multi_pod:
        return MeshShape((2, clients, model), ("pod", "data", "model"))
    return MeshShape((clients, model), ("data", "model"))


def rank_slots(device, backend: str) -> int:
    """Ranks a placement can host: one a card under nccl, RANKS_PER_CARD a
    card under gloo, a core each on the CPU."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return os.cpu_count() or 1
    n = torch.cuda.device_count()
    return n if backend == "nccl" else n * RANKS_PER_CARD


def make_client_mesh(devices: int = 0, *, available: int) -> MeshShape:
    """1-D ("data",) mesh for the mesh-sharded fused executor (DESIGN.md
    §11): the stacked CLIENT axis is laid over "data"; there is no model
    axis (the paper CNN fits on any device — the scale problem is the
    client count). `devices` <= 0 uses every available rank slot;
    otherwise it must not exceed them (a silent clamp would change the
    sharding the caller validated client divisibility against)."""
    if devices <= 0:
        devices = available
    if devices > available:
        raise ValueError(
            f"mesh_devices={devices} exceeds the {available} rank slot(s) "
            f"of this placement (see launch.mesh.rank_slots)")
    return MeshShape((devices,), ("data",))


def resolve_backend(backend: Optional[str], device, world: int) -> str:
    """The process-group backend for `world` ranks on `device`: gloo on
    the CPU; on the card nccl when every rank has a card of its own, gloo
    when ranks share one. `backend` names it explicitly; one that cannot
    run the placement raises."""
    if backend not in (None, "gloo", "nccl"):
        raise ValueError(f"mesh_backend={backend!r}: expected None, 'gloo' "
                         f"or 'nccl'")
    dev = torch.device(device)
    if dev.type == "cpu":
        if backend == "nccl":
            raise ValueError(
                "mesh_backend='nccl' needs CUDA tensors, and this placement "
                "is the CPU: use gloo (or None) on the CPU")
        return "gloo"
    if dev.type != "cuda":
        raise ValueError(f"no mesh backend for device {str(dev)!r}")
    shared = world > torch.cuda.device_count()
    if backend is None:
        return "gloo" if shared else "nccl"
    if backend == "nccl" and shared:
        raise ValueError(
            f"mesh_backend='nccl' with {world} ranks on "
            f"{torch.cuda.device_count()} card(s): NCCL refuses two ranks "
            f"on one card; use gloo (or None) when ranks share a card")
    return backend


# ---------------------------------------------------------------------------
# process groups of mesh axes, made once per process
# ---------------------------------------------------------------------------

_GROUPS: Dict[tuple, Any] = {}


def _new_group(ranks: Sequence[int], dry: bool = False):
    """A process group of `ranks`, made once per process. Every rank must
    ask for the same groups in the same order (SPMD code does). A mesh
    with no processes (`dry`) makes none."""
    import torch.distributed as dist
    if dry:
        return None
    key = tuple(ranks)
    if key not in _GROUPS:
        _GROUPS[key] = (None if len(key) == dist.get_world_size()
                        else dist.new_group(list(key)))
    return _GROUPS[key]


class MeshAxis:
    """One rank's view of a mesh axis: its `index` on the axis, the
    axis's `size`, and the process `group` of the ranks it reduces with
    (None: the whole world). `instances` lists every instance of the axis
    across the mesh (the global ranks of each), so subgroups are made in
    one order on every rank; `mesh` is the `RankMesh` it belongs to."""

    def __init__(self, name, index: int, size: int, group,
                 instances: List[List[int]], rank: int, mesh=None):
        self.name, self.index, self.size = name, index, size
        self.group, self.instances, self.rank = group, instances, rank
        self.mesh = mesh

    @property
    def members(self) -> List[int]:
        """The global ranks of this rank's instance, in axis order."""
        return next(m for m in self.instances if self.rank in m)

    def split(self, parts: List[List[int]]) -> "MeshAxis":
        """The axis of this rank's part, where `parts` splits the axis's
        indices into groups (`topology.mesh_axis_groups`); every rank
        makes the subgroups of every instance, in one order."""
        mine = None
        instances = []
        for inst in self.instances:
            for part in parts:
                ranks = [inst[i] for i in part]
                instances.append(ranks)
                g = _new_group(ranks, self.mesh is not None
                               and self.mesh.dry)
                if self.rank in ranks:
                    mine = MeshAxis(self.name, ranks.index(self.rank),
                                    len(ranks), g, [], self.rank, self.mesh)
        mine.instances = instances
        return mine

    def __repr__(self):
        return (f"MeshAxis({self.name!r}, index={self.index}, "
                f"size={self.size})")


class RankMesh:
    """A `MeshShape` laid over the world's ranks, row-major (the last axis
    varies fastest with the rank). A `dry` mesh has no processes behind
    it (`dry_run_mesh`)."""

    def __init__(self, shape: MeshShape, rank: int, world: int,
                 dry: bool = False):
        if shape.size != world:
            raise ValueError(f"mesh {shape} needs {shape.size} ranks, the "
                             f"world has {world}")
        self.shape, self.rank, self.dry = shape, rank, dry
        self.names = shape.axis_names
        sizes = shape.axis_sizes
        self._strides = [1] * len(sizes)
        for i in range(len(sizes) - 2, -1, -1):
            self._strides[i] = self._strides[i + 1] * sizes[i + 1]

    def _rank_of(self, coords) -> int:
        return sum(c * s for c, s in zip(coords, self._strides))

    def coords_of(self, rank: int) -> Dict[str, int]:
        """`rank`'s index on each mesh axis."""
        return {n: (rank // st) % size for n, st, size in
                zip(self.names, self._strides, self.shape.axis_sizes)}

    @property
    def coords(self) -> Dict[str, int]:
        """This rank's index on each mesh axis."""
        return self.coords_of(self.rank)

    def axis(self, names) -> MeshAxis:
        """The axis over `names` (a name or a tuple of names, their
        product in the given order)."""
        names = (names,) if isinstance(names, str) else tuple(names)
        dims = [self.names.index(n) for n in names]
        sizes = self.shape.axis_sizes
        others = [d for d in range(len(sizes)) if d not in dims]
        instances = []
        for fixed in itertools.product(*(range(sizes[d]) for d in others)):
            members = []
            for varying in itertools.product(*(range(sizes[d])
                                               for d in dims)):
                c = [0] * len(sizes)
                for d, v in zip(others, fixed):
                    c[d] = v
                for d, v in zip(dims, varying):
                    c[d] = v
                members.append(self._rank_of(c))
            instances.append(members)
        group = None
        for members in instances:
            g = _new_group(members, self.dry)
            if self.rank in members:
                group, mine = g, members
        index = mine.index(self.rank)
        return MeshAxis(names if len(names) > 1 else names[0], index,
                        len(mine), group, instances, self.rank, self)


def dry_run_mesh(shape: MeshShape, rank: int = 0) -> RankMesh:
    """Rank `rank` of `shape` with no processes behind it: its axes have
    no process group, so use it inside `collectives.dry_run()`, where no
    collective issues a call."""
    if not collectives.in_dry_run():
        raise RuntimeError("dry_run_mesh is for collectives.dry_run(): "
                           "its axes have no process group")
    return RankMesh(shape, rank, shape.size, dry=True)


# ---------------------------------------------------------------------------
# leaves stored as shards
# ---------------------------------------------------------------------------

def shard(x: torch.Tensor, sharding, rank_mesh: RankMesh) -> torch.Tensor:
    """This rank's shard of the global tensor `x` (a copy); a 0-d leaf (the
    decode state's "index") and a leaf that is not a tensor are whole on
    every rank."""
    if not isinstance(x, torch.Tensor):
        return x
    return x[sharding.index(x.shape, rank_mesh.coords)].clone(
        memory_format=torch.contiguous_format)


def _gathered_dims(sharding, keep):
    """[(dim, the axes it is gathered over)] of a sharding, axes in
    `keep` left sharded; they must lead their dim's entry, so the kept
    block is contiguous."""
    dims = []
    for d, e in enumerate(sharding.spec):
        axes = entry_axes(e)
        rest = tuple(a for a in axes if a not in keep)
        if not rest:
            continue
        if axes[len(axes) - len(rest):] != rest:
            raise ValueError(f"kept axes {tuple(keep)} do not lead the "
                             f"entry {e!r} of {sharding.spec}")
        dims.append((d, rest))
    return dims


def gather(x: torch.Tensor, sharding, rank_mesh: RankMesh,
           keep: Sequence[str] = ()) -> torch.Tensor:
    """The global tensor of which `x` is this rank's shard: one
    `all_gather` for each sharded dim, over the dim's axes. Axes in
    `keep` stay sharded (the batch axes of a data-parallel step)."""
    if not isinstance(x, torch.Tensor):
        return x
    for d, rest in _gathered_dims(sharding, keep):
        x = all_gather(x, rank_mesh.axis(rest), dim=d)
    return x


def card_plan(x: torch.Tensor, sharding, rank_mesh: RankMesh,
              keep: Sequence[str] = ()):
    """What `gather` of `x` makes, as `collectives.card_gather` takes it:
    (x, the result's shape, [(rank, the slices of the result that rank's
    shard fills)], [the result bytes of each of gather's all-gathers]),
    or None when nothing is gathered. The ranks are those that differ
    from this one only on the gathered axes; along each gathered dim a
    rank's block sits at its row-major index over the dim's axes, as
    `all_gather` over `rank_mesh.axis(rest)` lays it."""
    dims = _gathered_dims(sharding, keep)
    if not isinstance(x, torch.Tensor) or not dims:
        return None
    sizes = rank_mesh.shape.shape
    shape, nbytes, kind_bytes = list(x.shape), x.numel() * x.element_size(), []
    for d, rest in dims:
        n = 1
        for a in rest:
            n *= sizes[a]
        shape[d] *= n
        nbytes *= n
        kind_bytes.append(nbytes)
    gathered = {a for _, rest in dims for a in rest}
    mine = rank_mesh.coords
    places = []
    for j in range(rank_mesh.shape.size):
        cj = rank_mesh.coords_of(j)
        if any(cj[a] != mine[a] for a in rank_mesh.names
               if a not in gathered):
            continue
        where = [slice(None)] * x.dim()
        for d, rest in dims:
            block = 0
            for a in rest:
                block = block * sizes[a] + cj[a]
            where[d] = slice(block * x.shape[d], (block + 1) * x.shape[d])
        places.append((j, tuple(where)))
    return x, tuple(shape), places, kind_bytes


def shard_tree(tree, shardings, rank_mesh: RankMesh):
    """`shard` over a tree and its tree of shardings."""
    return tree_map(lambda x, s: shard(x, s, rank_mesh), tree, shardings)


def gather_tree(tree, shardings, rank_mesh: RankMesh,
                keep: Sequence[str] = ()):
    """`gather` over a tree of shards and its tree of shardings. Ranks
    that share a card under gloo make every leaf's gathers at once, card
    to card (`collectives.card_gather`: the same results and counts, with
    no copy through the host); elsewhere each leaf is gathered in turn."""
    leaves = tree_leaves(tree)
    if not any(collectives.on_shared_card(x) for x in leaves):
        return tree_map(lambda x, s: gather(x, s, rank_mesh, keep), tree,
                        shardings)
    plans = [card_plan(x, s, rank_mesh, keep)
             for x, s in zip(leaves, tree_leaves(shardings))]
    done = iter(collectives.card_gather([p for p in plans if p]))
    return tree_unflatten(tree, [x if p is None else next(done)
                                 for x, p in zip(leaves, plans)])


class Rank:
    """What a task sees in a rank: its `rank`, the world `size`, its
    `device` and the `backend`."""

    def __init__(self, rank: int, size: int, device, backend: str):
        self.rank, self.size = rank, size
        self.device, self.backend = torch.device(device), backend

    def axis(self, name: str = "data") -> MeshAxis:
        """The 1-D world as one axis."""
        return RankMesh(MeshShape((self.size,), (name,)), self.rank,
                        self.size).axis(name)

    def mesh(self, shape: MeshShape) -> RankMesh:
        return RankMesh(shape, self.rank, self.size)

    def barrier(self) -> None:
        barrier(self.device)


# ---------------------------------------------------------------------------
# the world: spawned ranks, kept for many tasks
# ---------------------------------------------------------------------------

class RankError(RuntimeError):
    """A rank raised, died or timed out; the message carries its
    traceback."""


def _rank_main(rank, size, backend, device, init_method, timeout_s, conn):
    import torch.distributed as dist
    dev = torch.device(device)
    started = False
    try:
        if dev.type == "cpu":
            # one intra-op thread a rank: several ranks (and test workers)
            # share the host's cores
            torch.set_num_threads(1)
        else:
            torch.cuda.set_device(dev)
        dist.init_process_group(
            backend, init_method=init_method, world_size=size, rank=rank,
            timeout=datetime.timedelta(seconds=timeout_s))
        started = True
        conn.send(("ready", None))
        me = Rank(rank, size, dev, backend)
        while True:
            try:
                task = conn.recv()
            except EOFError:
                break
            if task is None:
                break
            fn, args, kwargs = task
            try:
                out = fn(me, *args, **kwargs)
            except BaseException:
                conn.send(("error", traceback.format_exc()))
                break        # the group may be mid-collective: leave it
            if dev.type == "cuda":
                # ranks share the card with each other and the caller:
                # give back what the task left cached, its blocks shared
                # with the other ranks included
                torch.cuda.ipc_collect()
                torch.cuda.empty_cache()
            conn.send(("ok", out))
    except BaseException:
        try:
            conn.send(("error", traceback.format_exc()))
        except Exception:
            pass
    finally:
        if started:
            dist.destroy_process_group()
        conn.close()


class World:
    """`size` rank processes on `device` joined in one process group.

    `device` "cuda" (the default) puts rank r on card r % cards; "cpu"
    puts every rank on the host (gloo, one intra-op thread each).
    `timeout` is the process group's: a collective that waits longer
    raises on its rank. Use as a context manager, or call `close()`."""

    def __init__(self, size: int, *, device="cuda",
                 backend: Optional[str] = None, timeout: float = 60.0):
        if size < 1:
            raise ValueError(f"a world needs at least one rank, not {size}")
        self.device = device_mod.resolve_device(device)
        self.backend = resolve_backend(backend, self.device, size)
        make_client_mesh(size, available=rank_slots(self.device,
                                                     self.backend))
        self.size, self.timeout = size, float(timeout)
        self.broken: Optional[str] = None
        self._tmp = tempfile.mkdtemp(prefix="repro_torch_world_")
        init_method = "file://" + os.path.join(self._tmp, "rendezvous")
        ctx = multiprocessing.get_context("spawn")
        self._conns, self._procs = [], []
        try:
            for r in range(size):
                ours, theirs = ctx.Pipe()
                p = ctx.Process(
                    target=_rank_main, daemon=True, name=f"mesh-rank-{r}",
                    args=(r, size, self.backend, str(self.rank_device(r)),
                          init_method, self.timeout, theirs))
                p.start()
                theirs.close()
                self._conns.append(ours)
                self._procs.append(p)
            self._collect("start-up", START_TIMEOUT)
        except BaseException:
            self.close()
            raise

    def rank_device(self, r: int) -> torch.device:
        if self.device.type == "cpu":
            return torch.device("cpu")
        return torch.device("cuda", r % torch.cuda.device_count())

    def _collect(self, what: str, timeout: Optional[float]) -> List[Any]:
        """Every rank's reply, in rank order. Raises RankError on the
        first error, a rank that dies, or the deadline."""
        out: List[Any] = [None] * self.size
        pending = dict(enumerate(self._conns))
        deadline = None if timeout is None else time.monotonic() + timeout
        while pending:
            ready = multiprocessing.connection.wait(list(pending.values()),
                                                    timeout=1.0)
            for conn in ready:
                r = next(k for k, c in pending.items() if c is conn)
                try:
                    kind, value = conn.recv()
                except (EOFError, OSError):
                    self._fail(f"rank {r} died during {what} (exit code "
                               f"{self._procs[r].exitcode})")
                if kind == "error":
                    self._fail(f"rank {r} raised during {what}:\n{value}")
                out[r] = value
                del pending[r]
            for r in list(pending):
                if not self._procs[r].is_alive() and not pending[r].poll():
                    self._fail(f"rank {r} died during {what} (exit code "
                               f"{self._procs[r].exitcode})")
            if deadline is not None and time.monotonic() > deadline:
                self._fail(f"ranks {sorted(pending)} did not answer within "
                           f"{timeout:.0f}s during {what}")
        return out

    def _fail(self, msg: str):
        self.broken = msg
        self.close(grace=1.0)     # the others may wait in a collective
        raise RankError(msg)

    def run(self, fn, *args, timeout: Optional[float] = None, **kwargs):
        """`fn(rank, *args, **kwargs)` on every rank (`fn` importable by
        name, arguments picklable); returns the ranks' results in rank
        order. A failure closes the world."""
        if self.broken:
            raise RankError(f"the world is closed: {self.broken}")
        for conn in self._conns:
            conn.send((fn, args, kwargs))
        return self._collect(getattr(fn, "__name__", "a task"), timeout)

    def close(self, grace: float = 10.0) -> None:
        """Stop every rank: ask, wait up to `grace` seconds, then
        terminate the ones still running."""
        for conn in self._conns:
            try:
                conn.send(None)
            except (OSError, ValueError):
                pass
        end = time.monotonic() + grace
        for p in self._procs:
            p.join(timeout=max(0.0, end - time.monotonic()))
        for p in self._procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=5.0)
            if p.is_alive():
                p.kill()
                p.join()
        for conn in self._conns:
            conn.close()
        self._conns, self._procs = [], []
        if self.broken is None:
            self.broken = "closed"
        shutil.rmtree(self._tmp, ignore_errors=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
