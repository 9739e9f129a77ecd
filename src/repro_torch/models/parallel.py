"""A rank's tensor-parallel view of one sharded step: the port's form of the
reference's `shard_activation` (`repro.models.layers`), which has GSPMD
split a layer's compute over "model" where the activations keep "model"
on their features.

The sharded steps (`launch.train.make_sharded_train_step`, the sharded
prefill and decode of `launch.serve`, `FederatedTrainer(mesh=)`) run the
model on the rank's stored shards inside `use(Parallel(...))`. The model
then takes each block's leaves through `Parallel.take`, one layer at a
time, inside the layer's checkpoint, so remat gathers them again in its
recompute and no rank ever holds the whole tree:

* `take` makes the rank's compute slices of a layer's stored shards
  (`specs.compute_layout`: attention heads and MLP columns, MoE experts,
  Mamba2 heads, the vocabulary, or the whole leaf) by their
  `launch.mesh.leaf_plan`s, in one card exchange on ranks sharing a card
  (`collectives.gather_leaves`); in the backward pass their gradients come
  back summed over the step's batch axes (and over "model" where several
  ranks read a leaf in part) and cut to the stored shards.
* `tp(kind)` is the view itself where blocks of that kind are cut over
  "model" (`specs.cut_kinds`), else None; a cut block enters through `f`
  and leaves through `g` after its row-parallel product, Megatron's pair
  (`core.collectives.copy_to` / `reduce_from`).
* `ep(kind)` is the view where the experts are cut over "model" and the
  ranks along it hold other rows (the single-pod moe profile's train step
  and prefill, `specs.ep_axis`): each rank runs its experts on every
  rank's tokens routed to them, through an all-to-all
  (`collectives.all_to_all`). Where those ranks hold the same rows (the
  decode step), `tp("moe")` cuts the experts with a sum over "model".
* A decode step (`decode=True`: `launch.serve.make_sharded_serve_step`)
  cuts its tokens over the FSDP axes only, so the ranks along "model" hold
  the same rows under every profile and each computes its "model" shard
  of attention, the MLPs, the experts and the vocabulary. Its KV caches
  stay cut as `decode_state_shardings` stores them: `cache(key)` is a
  layer's `KVCut`, which says where the rank's cache lies and what it
  computes there. A cache cut by kv heads over "model" holds the rank's
  heads, which its own columns of `wq` / `wk` / `wv` project. A cache cut
  by position (or whole) holds a block of positions: the rank gathers the
  new token's q, k and v over "model", writes the entry if its block holds
  the slot, and attends with every query head over its block, the partial
  softmaxes then joined over the axes that split the positions
  (flash-decoding's split, `models.attention`). Ranks that hold the same
  block and the same rows (the batch axes where the batch does not divide,
  long_500k's one row) split the block's positions between them too.
* A decode step's stationary blocks (`stationary(prefix, name)`, ROADMAP
  A.19b item 6; `specs.still_blocks`): GQA attention, the dense MLPs and
  Mamba2's `in_proj` / `out_proj` whose weights are stored with one dim
  cut compute where the weight lies, as the reference's compiled decode
  does, and the step moves the tokens' activations instead: `take`
  gathers none of their products' leaves. The block's input holds every
  row of the batch (`enter` / `whole`: the rank's rows all-gathered over
  the axes whose ranks hold the others, once where the residual stream is
  not whole already); each rank multiplies its share of the rows by its
  stored block (a `Still`: the block's range, the axes it is cut over,
  and the ranks that hold the same block, which split the rows), and the
  `Stationary` handle sums the partial products of a block cut on its
  input over every mesh axis in one sum, or joins a block cut on its
  output in one all-gather (Mamba2's `in_proj`: an all-to-all to the
  rank's rows). The output holds every row again, so the residual stream
  stays whole over the batch between stationary blocks; attention takes
  its cache block's rows and its heads from the whole q, k and v, and
  joins its output once for `wo`; any other block (`enter` without a
  handle: MoE, MLA, xLSTM, cross-attention) takes the rank's rows.
* `seq()` is the view where the step's batch stays cut by sequence over
  `specs.seq_axis` (the multi-pod fsdp profile's context parallelism):
  a rank holds a block of positions, attends with its own queries to
  every rank's keys and values (`gather_seq`), and is row-local
  elsewhere. `block(segments)` lays the rank's positions out: a vision
  prefix's block of patches then its block of tokens, each at its
  absolute position in the whole sequence (`SeqBlock`).
* Without remat (`cfg.remat` off) a backward pass would keep every
  gathered weight that autograd saves until it runs, the whole model at
  the end of the forward pass; inside `regathering()` such a weight (or
  its cast) is saved as how to gather it again, and the backward pass
  gathers each layer again, once, when it first needs it.

Off a mesh `current()` is None and every layer runs as on one device.
"""
from __future__ import annotations

import contextlib
import math
import weakref
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.core import collectives
from repro_torch.sharding import specs as sh
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

# process-wide, as the dry-run's mode: the layers read it when the forward
# pass starts; a layer recomputed on the autograd engine's thread holds the
# view through its closure
_ACTIVE: list = [None]


def current() -> Optional["Parallel"]:
    """The active view, or None off a mesh."""
    return _ACTIVE[0]


@contextlib.contextmanager
def use(par: Optional["Parallel"]):
    """Run the model under `par` (None: as on one device)."""
    prev, _ACTIVE[0] = _ACTIVE[0], par
    try:
        yield par
    finally:
        _ACTIVE[0] = prev


def _at(tree, key):
    for k in key:
        tree = tree[k]
    return tree


class KVCut(NamedTuple):
    """Where a rank's block of one (B, cap, Hk, dh) KV cache lies and what
    it computes there (`Parallel.cache`). `kind` is the stored cut over
    "model" (`specs.cache_cut`: "heads", "seq" or "whole"); the block
    holds positions [`offset`, `offset` + its length) of `capacity` and kv
    heads from `kv0` on. The rank attends with query heads `heads` (first,
    count) over positions `span` (start, count) of its block, and joins
    its partial softmaxes over `axis` (a `launch.mesh.MeshAxis`; None: its
    span is every position). The block holds rows `block` (start, count)
    of the batch; the rank's token rows are `rows` (start, count) of the
    block's; where the block holds more rows than the rank's tokens (a
    batch cut over fewer axes than the tokens), the new entries of the
    others come over `row_axis` (else None)."""
    kind: str
    capacity: int
    offset: int
    kv0: int
    heads: Tuple[int, int]
    span: Tuple[int, int]
    axis: object
    block: Tuple[int, int]
    rows: Tuple[int, int]
    row_axis: object


class Still(NamedTuple):
    """Where a rank's block of a stationary product's (in, out) weight lies
    (`Parallel.stationary`): `form` "rows" where the stored block cuts the
    product's input dim, "cols" where it cuts its output dim; the block is
    [`lo`, `hi`) along that dim, cut over `axis` (a `launch.mesh.MeshAxis`,
    whose index is the block's). The ranks holding the same block (those
    along `split`) split the batch where its rows divide between them: the
    rank computes the token rows `rows` (start, count) of the whole batch
    (every row, and `split` None, where they do not, as for a batch of
    one row). Its partial products are summed over `sum`: `axis` and
    `split`."""
    form: str
    lo: int
    hi: int
    axis: object
    split: object
    rows: Tuple[int, int]
    sum: object


class Stationary:
    """A decode step's handle of one stationary block (`Parallel.
    stationary`): its products' `Still`s by leaf ("wq/kernel", "wi_gate",
    "in_proj/kernel"), and the collectives that move the tokens'
    activations to the weights. The block's input holds every row of the
    batch (`Parallel.whole`); a product's rows form gives a partial sum of
    every output column (`total`: one sum of a block's partial products
    over the axes of their `Still.sum`), its columns form the block's
    output columns (`join`: one all-gather to the whole output, or `own`:
    the rank's token rows of every column)."""

    def __init__(self, view: "Parallel", cuts: Dict[str, Still]):
        self.view, self.cuts = view, cuts

    def __getitem__(self, leaf: str) -> Still:
        return self.cuts[leaf]

    def total(self, parts):
        """[(a partial product of the rank's rows, its `Still`)] -> each
        summed over its `sum` axes, every row of the batch: one sum of all
        of them that share those axes (each placed at its rows of the
        batch, zeros elsewhere)."""
        B = self.view.batch
        groups: Dict[object, list] = {}
        for i, (y, st) in enumerate(parts):
            if y.shape[0] != B:
                full = y.new_zeros((B,) + tuple(y.shape[1:]))
                full[st.rows[0]:st.rows[0] + st.rows[1]] = y
                y = full
            groups.setdefault(st.sum.name, (st.sum, []))[1].append((i, y))
        out = [None] * len(parts)
        for axis, members in groups.values():
            summed = collectives.all_reduce_sum(
                torch.cat([y for _, y in members], -1), axis)
            for (i, _), y in zip(members, summed.split(
                    [y.shape[-1] for _, y in members], -1)):
                out[i] = y
        return out

    @staticmethod
    def join(y, rows=None, cols=None):
        """The whole of a grid of blocks of which `y` is the rank's: its
        rows' block at its index on the axis `rows`, its columns' at its
        index on `cols` (either None: not cut), in one all-gather."""
        names = tuple(n for a in (rows, cols) if a is not None
                      for n in ((a.name,) if isinstance(a.name, str)
                                else a.name))
        if not names:
            return y
        mesh = (rows or cols).mesh
        nr = rows.size if rows is not None else 1
        nc = cols.size if cols is not None else 1
        g = collectives.all_gather(y.contiguous()[None], mesh.axis(names),
                                   dim=0)
        g = g.reshape(nr, nc, *y.shape).movedim(1, -2)
        return g.reshape(nr * y.shape[0], *y.shape[1:-1], nc * y.shape[-1])

    def own(self, y, st: Still):
        """The rank's token rows of every output column of the product
        whose part `y` is: where the block is cut over the token rows'
        axes (Mamba2's `in_proj`), an all-gather of the block's rows over
        `split`, then an all-to-all to the rank's rows over `axis`; else
        the whole product's rows."""
        v = self.view
        if st.form == "rows":
            return v.rows(self.total([(y, st)])[0])
        names = st.axis.name if isinstance(st.axis.name, tuple) else (
            st.axis.name,)
        if v.row_axis is not None and names == v.row_axes:
            if st.split is not None:
                y = collectives.all_gather(y.contiguous(), st.split, dim=0)
            return collectives.all_to_all(y.contiguous(), st.axis, 0, -1)
        return v.rows(self.join(y, st.split, st.axis))


class Parallel:
    """One rank's view: its `rank_mesh`, the model config's compute
    layouts for the rank's index on "model", and the stored shardings of
    the parameter tree (`shardings`, of the global `param_specs`). Build it
    under the rules the shardings were made by (`specs.config_rules`).
    `batch_axes` are the axes whose gradients are summed over (the ranks
    holding other rows or other positions); `row_axes` the axes whose
    ranks hold other rows (default `batch_axes`). `whole` names blocks a
    decode step computes whole ("mamba"; `specs.compute_layout`).
    `seq` names the axes the step's batch stays cut by sequence over (the
    caller's batch spec; `specs.context_parallel`), () where it is not.
    `decode` makes a decode step's view (module docstring); `caches` maps
    each KV cache it keeps cut (a state path, "layers/3") to its global
    shape and stored `NamedSharding`; `batch` is a decode step's number of
    tokens, whose stationary blocks it computes (`stationary`)."""

    def __init__(self, cfg, rank_mesh, shardings, param_specs, *,
                 batch_axes: Sequence[str] = (), whole: Sequence[str] = (),
                 row_axes: Optional[Sequence[str]] = None,
                 seq: Sequence[str] = (), decode: bool = False,
                 caches=None, batch: Optional[int] = None):
        mesh = rank_mesh.shape
        self.name, experts_only = sh.model_axis(mesh, decode)
        self.axis = rank_mesh.axis(self.name) if self.name else None
        self.size = self.axis.size if self.axis else 1
        self.index = self.axis.index if self.axis else 0
        self.cut: Dict[str, bool] = sh.cut_kinds(cfg, self.size,
                                                 experts_only, decode)
        if "mamba" in whole:
            self.cut["mamba"] = False
        rows = batch_axes if row_axes is None else row_axes
        self.row_axes = tuple(rows)
        # the experts' all-to-all: ranks along the expert axis hold other
        # rows; holding the same rows they cut the experts with a sum
        self.expert_parallel = experts_only and self.name in rows
        # a decode step of `batch` tokens: its stationary blocks
        self.batch = batch
        still = (sh.still_blocks(cfg, mesh, param_specs)
                 if decode and batch else {})
        self.layouts = sh.compute_layouts(cfg, mesh, param_specs,
                                          self.index, whole, decode, still)
        self.param_specs = param_specs
        self.shardings = shardings
        self.rank_mesh = rank_mesh
        self.batch_axes = tuple(batch_axes)
        self.seq_axis = rank_mesh.axis(seq) if seq else None
        self.caches: Dict[str, KVCut] = {
            key: self._kv_cut(cfg, shape, s)
            for key, (shape, s) in (caches or {}).items()}
        # the rank's token rows of the batch, and the axis over the ranks
        # holding the others
        self.row_axis = (rank_mesh.axis(self.row_axes) if rows and batch
                         else None)
        n = (batch or 0) // (self.row_axis.size if self.row_axis else 1)
        self.token_rows = ((self.row_axis.index if self.row_axis else 0)
                           * n, n)
        self.stills: Dict[str, Dict[str, Still]] = {
            prefix: {leaf: self._still(prefix + "/" + leaf, dim)
                     for leaf, dim in leaves.items()}
            for prefix, leaves in still.items()}
        self.ran = set()         # the block kinds that ran cut
        # leaf path -> the shape of the compute slice `take` last made
        self.taken: Dict[str, tuple] = {}
        self._plans: Dict[tuple, list] = {}
        self._taken_paths: Dict[tuple, list] = {}
        self._made = None        # inside `regathering()`: what take made

    # -- the tensor-parallel handle of a block --------------------------------

    def tp(self, kind: str) -> Optional["Parallel"]:
        """This view where blocks of `kind` are cut over "model" and the
        ranks along it hold the same rows, else None (the block computes
        whole on every rank, or runs through `ep`)."""
        if self.cut.get(kind) and not self.expert_parallel:
            self.ran.add(kind)
            return self
        return None

    def ep(self, kind: str) -> Optional["Parallel"]:
        """This view where blocks of `kind` (the experts) are cut over
        "model" and the ranks along it hold other rows: the all-to-all
        form (`models.moe`); else None."""
        if self.cut.get(kind) and self.expert_parallel:
            self.ran.add(kind)
            return self
        return None

    def stationary(self, prefix: str, name: str) -> Optional["Stationary"]:
        """The handle of the block `name` ("attn", "mlp", "mamba") under
        `prefix` ("layers", "blocks/3", "shared_attn") where its products
        compute where their weights are stored, else None (module
        docstring)."""
        cuts = self.stills.get(f"{prefix}/{name}")
        if cuts is None:
            return None
        self.ran.add(name)
        return Stationary(self, cuts)

    def _still(self, path: str, dim: int) -> "Still":
        """The `Still` of the stationary leaf at `path` (per layer), cut
        along `dim` of its (in, out) weight."""
        key = [int(k) if k.isdigit() else k for k in path.split("/")]
        shape = tuple(_at(self.param_specs, key).shape)
        s = _at(self.shardings, key)
        if sh._STACKED_RE.search(path):
            shape = shape[1:]
            s = sh.NamedSharding(self.rank_mesh.shape, sh.P(*s.spec[1:]))
        where = s.index(shape, self.rank_mesh.coords)[dim]
        names = sh.entry_axes(s.spec[dim])
        mesh = self.rank_mesh.shape
        spare = tuple(a for a in mesh.axis_names
                      if a not in names and mesh.shape[a] > 1)
        if self.batch % sh.axis_size(mesh, spare):
            spare = ()           # too few rows to split: each computes all
        split = self.rank_mesh.axis(spare) if spare else None
        n = self.batch // (split.size if split else 1)
        return Still("rows" if dim == 0 else "cols", where.start, where.stop,
                     self.rank_mesh.axis(names), split,
                     ((split.index if split else 0) * n, n),
                     self.rank_mesh.axis(names + spare))

    def whole(self, x):
        """`x` (the rank's token rows, or all of them) over every row of
        the batch: one all-gather over the ranks holding the others."""
        if x.shape[0] == self.batch or self.row_axis is None:
            return x
        return collectives.all_gather(x.contiguous(), self.row_axis, dim=0)

    def rows(self, x):
        """The rank's token rows of `x` (all of the batch's rows, or the
        rank's already)."""
        r0, n = self.token_rows
        if x.shape[0] != self.batch or n == self.batch:
            return x
        return x[r0:r0 + n]

    def enter(self, x, still: Optional["Stationary"]):
        """A block's input: every row of the batch for a stationary block,
        else the rank's token rows."""
        return self.whole(x) if still is not None else self.rows(x)

    def cache(self, key: str) -> Optional[KVCut]:
        """The `KVCut` of the KV cache at state path `key` ("layers/3",
        "shared/0"), None where the step gathers it whole."""
        return self.caches.get(key)

    def _kv_cut(self, cfg, shape, sharding) -> KVCut:
        """The rank's `KVCut` of a cache of global `shape` stored by
        `sharding`. Its query heads: its own (H / M from index x H / M)
        where the block holds its kv heads, or where the cache is whole and
        its projections are cut by heads; else all of them. Its positions:
        the block's, cut again evenly over the axes whose ranks hold the
        same block and the same rows ("model" too for a whole cache
        attended with every head) where the block's length divides."""
        mesh, axis = self.rank_mesh.shape, self.rank_mesh.axis
        H = cfg.num_heads
        kind = sh.cache_cut(sharding.spec)
        where = sharding.index(shape, self.rank_mesh.coords)
        blk = where[1].stop - where[1].start
        M = self.size
        own = (kind == "heads" or (kind == "whole" and self.cut["attn"]
                                   and H % M == 0))
        heads = (self.index * H // M, H // M) if own else (0, H)
        # the token rows' axes the block's rows are not cut over
        more = tuple(a for a in self.row_axes
                     if a not in sh.entry_axes(sharding.spec[0]))
        n_rows = (where[0].stop - where[0].start) // sh.axis_size(mesh, more)
        rows = (axis(more).index * n_rows if more else 0, n_rows)
        held = (set(sharding.axes()) | set(self.row_axes)
                | ({self.name} if own else set()))
        spare = tuple(a for a in mesh.axis_names
                      if a not in held and mesh.shape[a] > 1)
        R = sh.axis_size(mesh, spare)
        split = spare if spare and blk % R == 0 else ()
        span = (0, blk)
        if split:
            n = blk // R
            span = (axis(split).index * n, n)
        joined = tuple(a for a in mesh.axis_names if a in split
                       or (a == "model" and kind == "seq"))
        return KVCut(kind, shape[1], where[1].start, where[2].start, heads,
                     span, axis(joined) if joined else None,
                     (where[0].start, where[0].stop - where[0].start), rows,
                     axis(more) if more else None)

    def gather(self, x):
        """The ranks' `x` along "model" joined on its last dim (the new
        token's q, k or v from the rank's columns of a decode step's
        projections)."""
        return collectives.all_gather(x.contiguous(), self.axis, dim=-1)

    def seq(self) -> Optional["Parallel"]:
        """This view where the step's rows are cut by sequence (context
        parallelism), else None."""
        if self.seq_axis is None:
            return None
        self.ran.add("seq")
        return self

    def block(self, segments: Sequence[int], device) -> "SeqBlock":
        """The rank's block of positions, `segments` its local lengths of
        each run of the whole sequence (one run: tokens or frames; two: a
        vision prefix's patches, then the tokens)."""
        return SeqBlock(self, segments, device)

    def gather_seq(self, *xs):
        """Every rank's positions of each of `xs` ((B, S/M, ...) blocks),
        in order; the backward reduce-scatters."""
        return collectives.gather_seq(xs, self.seq_axis, dim=1)

    def all_to_all(self, x, split_dim: int, concat_dim: int):
        return collectives.all_to_all(x, self.axis, split_dim, concat_dim)

    def f(self, x):
        return collectives.copy_to(x, self.axis)

    def g(self, x):
        return collectives.reduce_from(x, self.axis)

    def sum(self, x):
        return collectives.sum_over(x, self.axis)

    def max(self, x):
        return collectives.max_over(x, self.axis)

    # -- the stored shards, one layer at a time ------------------------------

    @staticmethod
    def unstack(layers):
        """A stacked "layers" subtree as per-layer views: leaf -> tuple of
        L views (one `unbind` a leaf, whose backward stacks the layers'
        gradients once)."""
        return tree_map(lambda a: a.unbind(0), layers)

    @staticmethod
    def layer(unstacked, i):
        return tree_map(lambda t: t[i], unstacked)

    def gathered_bytes(self) -> Dict[str, int]:
        """Leaf path -> the bytes one `take` of it gathers (one layer's of a
        stacked leaf): the shape its stored shard is gathered to, 0 where
        the rank computes with its stored shard as it is (a stationary
        leaf, a vocabulary kept cut over "model")."""
        from repro_torch.launch import mesh as mesh_mod
        out = {}
        for (path, x), s, lay in zip(
                tree_leaves(sh._paths(self.param_specs)),
                tree_leaves(self.shardings), tree_leaves(self.layouts)):
            shape = tuple(x.shape)
            if sh._STACKED_RE.search(path):
                shape = shape[1:]
                s = sh.NamedSharding(self.rank_mesh.shape, sh.P(*s.spec[1:]))
            shard = s.shard_shape(shape)
            got = mesh_mod.gathered_shape(shard, s, lay, self.rank_mesh,
                                          self.name)
            out[path] = (0 if tuple(got) == tuple(shard)
                         else math.prod(got) * x.element_size())
        return out

    def take(self, stored, *key):
        """The compute slices of the stored subtree `stored`, which sits at
        `key` in the parameter tree (("layers",) for any layer of the
        stack, ("blocks", i), ("embed",), ...)."""
        leaves = tree_leaves(stored)
        plans = self._plans.get(key)
        if plans is None:
            from repro_torch.launch import mesh as mesh_mod
            mesh = self.rank_mesh.shape
            stacked = "layers" in key
            plans = []
            for x, s, lay in zip(leaves, tree_leaves(_at(self.shardings,
                                                         key)),
                                 tree_leaves(_at(self.layouts, key))):
                if stacked:
                    s = sh.NamedSharding(mesh, sh.P(*s.spec[1:]))
                plans.append(mesh_mod.leaf_plan(
                    tuple(x.shape), s, lay, self.rank_mesh,
                    self.batch_axes, self.name))
            self._plans[key] = plans
            self._taken_paths[key] = [path for path, _ in tree_leaves(
                sh._paths(_at(self.param_specs, key),
                          "".join(f"{k}/" for k in key)))]
        out = collectives.gather_leaves(plans, leaves)
        for path, t in zip(self._taken_paths[key], out):
            self.taken[path] = tuple(t.shape)
        if self._made is not None:
            self._remember(leaves, plans, out)
        return tree_unflatten(stored, out)

    # -- without remat: gathered weights saved as how to gather them --------

    @contextlib.contextmanager
    def regathering(self):
        """Autograd saves each gathered weight (or its cast) that the
        backward pass needs as how to gather it again (module
        docstring)."""
        self._made = {}
        try:
            with torch.autograd.graph.saved_tensors_hooks(self._pack,
                                                          self._unpack):
                yield
        finally:
            self._made = None

    def _remember(self, leaves, plans, out):
        """Note each of one gather's outputs, and its autograd node, as
        made by that gather; the backward pass's copy of the layer is
        dropped when the node runs (every use of the layer is then done)."""
        record = {"leaves": leaves, "plans": plans, "again": None}
        node = next((t.grad_fn for t in out if t.grad_fn is not None), None)
        for i, t in enumerate(out):
            self._made[id(t)] = (weakref.ref(t), record, i)
        if node is not None:
            self._made[id(node)] = (weakref.ref(node), record, None)

            def drop(grads):
                record["again"] = None
            node.register_prehook(drop)

    def _find(self, t):
        entry = self._made.get(id(t))
        if entry is not None and entry[0]() is t:
            return entry
        return None

    def _pack(self, t):
        made = self._find(t._base if t._base is not None else t)
        cast = None
        if made is None and t.grad_fn is not None and type(
                t.grad_fn).__name__ == "ToCopyBackward0":
            node, index = t.grad_fn.next_functions[0]
            found = None if node is None else self._find(node)
            if found is not None:
                made, cast = (found[0], found[1], index), t.dtype
        if made is None:
            return t
        return (made[1], made[2], cast, t.shape, t.stride(),
                t.storage_offset())

    def _unpack(self, packed):
        if isinstance(packed, torch.Tensor):
            return packed
        record, i, cast, shape, stride, offset = packed
        if record["again"] is None:
            with torch.no_grad():
                record["again"] = collectives.gather_leaves(
                    record["plans"], [x.detach() for x in record["leaves"]])
        w = record["again"][i]
        if cast is not None:
            w = w.to(cast)
        return w.as_strided(shape, stride, offset)


class SeqBlock:
    """A rank's block of positions under context parallelism: of every run
    of the whole sequence (lengths M x `segments`, runs one after another)
    the rank holds block `index` of M. `q_pos` are its positions' absolute
    places, `k_pos` those of the keys `gather_seq` brings (every rank's
    block in rank order). The reference's GSPMD cuts the concatenated
    prefix + token sequence into M contiguous blocks instead; the rank's
    batch arrives cut run by run (`train.batch_shardings` cuts
    `vision_embeds` and the tokens by position each), so keeping that
    layout saves two exchanges a step, and the positions make the RoPE,
    masks and key order the reference's."""

    def __init__(self, view: Parallel, segments: Sequence[int], device):
        ax = view.seq_axis
        M, m = ax.size, ax.index
        starts = [M * sum(segments[:j]) for j in range(len(segments))]

        def pos(r):
            return torch.cat([s0 + r * n + torch.arange(n, device=device)
                              for s0, n in zip(starts, segments)])
        self.view = view
        self.q_pos = pos(m)
        self.k_pos = torch.cat([pos(r) for r in range(M)])

    def gather_seq(self, *xs):
        return self.view.gather_seq(*xs)
