"""Partition-spec rules: map parameter paths and activations to mesh axes
(port of `repro.sharding.specs`).

Conventions
-----------
* mesh axes: ("data", "model") single-pod, ("pod", "data", "model")
  multi-pod.
* FSDP axis = ("pod", "data") when present, else ("data",) — a weight's
  first shardable dim is laid over it; the tensor-parallel dim over
  "model".
* Activations: batch over the FSDP axis, hidden features over "model"
  where the dimension divides.

`fit_spec` drops any mesh axis that does not evenly divide its dim, which
keeps every architecture shardable whatever its odd vocab or head-count
sizes (e.g. seamless vocab = 256206).

The module is pure shape logic. A mesh is anything with `axis_names` and
a `shape` mapping axis name -> size (`MeshShape` here; the reference's
`jax.sharding.Mesh` and its tests' `FakeMesh` have the same two
attributes), and a spec is a `PartitionSpec` (`P(...)`): a tuple whose
entries are an axis name, a tuple of axis names or None, one per leading
dim of the array. `NamedSharding(mesh, spec)` is the reference's
`jax.sharding.NamedSharding` as shape logic: the shape of one shard, and
which slice of the global array the rank at given mesh coordinates
holds. `tree_shardings` wraps every spec of `tree_specs` in one, as the
reference's does; `launch.mesh.shard_tree` / `gather_tree` cut and join
the leaves of the zoo's sharded steps by them.
"""
from __future__ import annotations

import contextlib
import contextvars
import itertools
import re
from typing import Dict, Sequence, Tuple

from repro_torch.tree import tree_leaves, tree_map


class PartitionSpec(tuple):
    """An immutable spec: one entry per leading dim — an axis name, a tuple
    of axis names (the dim is laid over their product) or None
    (replicated). Trailing dims without an entry are replicated. Entries
    are normalized as jax's PartitionSpec normalizes them: a one-name
    tuple is the name, an empty one None, a list a tuple."""

    def __new__(cls, *entries):
        return super().__new__(cls, (_entry(e) for e in entries))

    def __repr__(self):
        return "P(" + ", ".join(repr(e) for e in self) + ")"


def _entry(e):
    if isinstance(e, (tuple, list)):
        e = tuple(e)
        return None if not e else e[0] if len(e) == 1 else e
    return e


P = PartitionSpec


def entry_axes(entry) -> Tuple[str, ...]:
    """The axis names of one spec entry (None: none)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


class MeshShape:
    """A mesh as the rules see it: axis names and their sizes, no
    devices."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str]):
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {tuple(shape)} does not match axis "
                             f"names {tuple(axis_names)}")
        self.axis_names: Tuple[str, ...] = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names,
                                              (int(s) for s in shape)))

    @property
    def size(self) -> int:
        n = 1
        for s in self.shape.values():
            n *= s
        return n

    @property
    def axis_sizes(self) -> Tuple[int, ...]:
        return tuple(self.shape[a] for a in self.axis_names)

    def __repr__(self):
        return f"MeshShape({self.shape})"


# ---------------------------------------------------------------------------
# sharding profiles
#   "tp" (default) — FSDP over ("pod","data") + tensor-parallel over "model".
#   "dp"           — pure data parallel: batch over ALL mesh axes, params
#                    replicated (small archs, e.g. xlstm-125m, where TP
#                    makes every layer boundary a collective).
#   "fsdp"         — flat fully-sharded data parallel: batch AND
#                    parameters sharded over all mesh axes; no tensor
#                    parallelism (big dense archs at long sequences).
#   "moe"          — as fsdp, with the experts laid over "model".
# ---------------------------------------------------------------------------

_PROFILE = contextvars.ContextVar("sharding_profile", default="tp")
_SEQ_SHARDABLE = contextvars.ContextVar("seq_shardable", default=True)


def set_seq_shardable(flag: bool):
    """Sequence (context-parallel) sharding is only valid for attention
    stacks; recurrent blocks (Mamba2/xLSTM) scan sequentially over the
    sequence, and sharding it forces a reshard per chunk."""
    _SEQ_SHARDABLE.set(bool(flag))


def set_profile(profile: str):
    assert profile in ("tp", "dp", "fsdp", "moe"), profile
    _PROFILE.set(profile)


def get_profile() -> str:
    return _PROFILE.get()


@contextlib.contextmanager
def profile_ctx(profile: str):
    tok = _PROFILE.set(profile)
    try:
        yield
    finally:
        _PROFILE.reset(tok)


@contextlib.contextmanager
def seq_shardable_ctx(flag: bool):
    tok = _SEQ_SHARDABLE.set(bool(flag))
    try:
        yield
    finally:
        _SEQ_SHARDABLE.reset(tok)


@contextlib.contextmanager
def config_rules(cfg):
    """The rules a model config shards by: its profile, and sequence
    sharding only for an attention-only stack (the reference's dry-run
    sets both so)."""
    with profile_ctx(cfg.sharding_profile), \
            seq_shardable_ctx(set(cfg.layer_kinds()) == {"attn"}):
        yield


def axis_size(mesh, axis) -> int:
    """Size of a mesh axis, of a tuple of axes (their product), 1 for None
    or an axis the mesh does not have."""
    if axis is None:
        return 1
    if isinstance(axis, (tuple, list)):
        n = 1
        for a in axis:
            n *= axis_size(mesh, a)
        return n
    try:
        return mesh.shape[axis]
    except Exception:
        return 1


def fit_spec(shape: Sequence[int], spec, mesh) -> PartitionSpec:
    """Zero out spec entries whose mesh-axis size does not divide the
    dim; a compound entry keeps its longest prefix that divides."""
    entries = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for dim, ax in zip(shape, entries):
        if ax is None:
            out.append(None)
            continue
        if dim % max(1, axis_size(mesh, ax)) == 0:
            out.append(ax)
        elif isinstance(ax, (tuple, list)):
            kept = None
            for i in range(len(ax) - 1, 0, -1):
                sub = tuple(ax[:i])
                if dim % max(1, axis_size(mesh, sub)) == 0:
                    kept = sub
                    break
            out.append(kept)
        else:
            out.append(None)
    return P(*out)


def fsdp_axes(mesh):
    if "pod" in mesh.axis_names:
        return ("pod", "data")
    return ("data",)


def batch_axes(mesh):
    """Mesh axes carrying the batch dim.

    dp/fsdp single-pod: all axes (flat data parallelism). Multi-pod, a
    global batch of 256 cannot divide 512 chips, so fsdp shards the batch
    over ("pod", "data") and the SEQUENCE dim over "model" (context
    parallel); dp shards the batch over ("data", "model") and the pod
    axis carries only the gradient synchronization."""
    prof = get_profile()
    multi = "pod" in mesh.axis_names
    if prof in ("fsdp", "moe"):
        return ("pod", "data") if multi else ("data", "model")
    if prof == "dp":
        return ("data", "model")
    return fsdp_axes(mesh)


def seq_axis(mesh):
    """Mesh axis for the sequence dim of (B, S, ...) activations, if any.
    Only the multi-pod fsdp profile context-parallelizes; under moe the
    "model" axis is reserved for experts."""
    if (get_profile() == "fsdp" and "pod" in mesh.axis_names
            and _SEQ_SHARDABLE.get()):
        return "model"
    return None


def context_parallel(cfg, mesh):
    """`seq_axis` where the port keeps a step's batch cut by sequence: a
    dense attention-only stack, its vision prefix (a rank's block of
    patches and of tokens) and its encoder (a rank's block of frames)
    included; else None. An MoE stack's batch (a config whose profile is
    overridden to fsdp) is still gathered whole over it (ROADMAP A.19b):
    its routing groups are runs of consecutive tokens, which a rank's
    block of positions would cut into other groups than the
    reference's."""
    if cfg.moe:
        return None
    return seq_axis(mesh)


# ---------------------------------------------------------------------------
# parameter rules: (regex on the param path) -> spec template; "F" is the
# FSDP compound axis and "M" the model axis. First match wins; the result
# is rank-adjusted and divisibility-fitted.
# ---------------------------------------------------------------------------

_RULES = [
    # embeddings (vocab, d): vocab over "model", so tied-unembed logits
    # come out vocab-sharded; d replicated
    (r"embed$", ("M", None)),
    (r"unembed/kernel$", (None, "M")),
    # attention projections stored fused 2-D: (d, H*dh) / (H*dh, d)
    (r"(wq|wk|wv|wq_a|wq_b|w_dkv|w_uk|w_uv|w_kpe)/kernel$", ("F", "M")),
    (r"wo/kernel$", ("M", "F")),
    # mlp
    (r"(wi_gate|wi_up)$", ("F", "M")),
    (r"wo$", ("M", "F")),
    (r"wi/kernel$", ("F", "M")),
    # moe experts: (E, d, f) / (E, f, d) — experts over the model axis
    (r"experts_(gate|up)$", ("M", "F", None)),
    (r"experts_down$", ("M", None, "F")),
    (r"router/kernel$", ("F", None)),
    # mamba / ssm: in_proj (d, inner*...), out_proj (inner, d)
    (r"(in_proj|out_proj|x_proj|dt_proj|z_proj)/kernel$", ("F", "M")),
    (r"conv1d$", (None, "M")),
    (r"(A_log|D|dt_bias)$", ("M",)),
    # xlstm
    (r"(wq|wk|wv|wi|wf|wo_gate|up_proj|down_proj|w_cell)$", ("F", "M")),
    # cnn
    (r"conv\d/kernel$", (None, None, None, "M")),
    # norms / scalars / biases: replicate
    (r"(scale|bias)$", ()),
]

_EXPERT_PAT = re.compile(r"experts_(gate|up|down)$")


def spec_for_param(path: str, shape, mesh) -> PartitionSpec:
    """The spec of the parameter at `path` ("layers/attn/wq/kernel") with
    `shape` under the active profile."""
    shape = tuple(shape)
    if get_profile() == "dp":
        return P()
    if get_profile() in ("fsdp", "moe"):
        if not shape:
            return P()
        if re.search(r"embed$", path):
            return fit_spec(shape, P("model", None), mesh)
        if re.search(r"unembed/kernel$", path):
            return fit_spec(shape, P(None, "model"), mesh)
        if get_profile() == "moe" and _EXPERT_PAT.search(path):
            # expert parallelism: experts stay over "model"
            fa2 = ("pod", "data") if "pod" in mesh.axis_names else ("data",)
            tmpl = (("model",) + (fa2 if len(fa2) > 1 else (fa2[0],))
                    + (None,) * (len(shape) - 2))
            return fit_spec(shape, P(*tmpl), mesh)
        big = max(range(len(shape)), key=lambda i: shape[i])
        entries = [None] * len(shape)
        entries[big] = tuple(mesh.axis_names)
        return fit_spec(shape, P(*entries), mesh)
    fa = fsdp_axes(mesh)
    for pat, tmpl in _RULES:
        if re.search(pat, path):
            entries = []
            for t in tmpl[: len(shape)]:
                if t == "F":
                    entries.append(fa if len(fa) > 1 else fa[0])
                elif t == "M":
                    entries.append("model")
                else:
                    entries.append(t)
            entries += [None] * (len(shape) - len(entries))
            return fit_spec(shape, P(*entries), mesh)
    # default: shard the largest dim over FSDP if it divides
    if shape:
        big = max(range(len(shape)), key=lambda i: shape[i])
        entries = [None] * len(shape)
        entries[big] = fa if len(fa) > 1 else fa[0]
        return fit_spec(shape, P(*entries), mesh)
    return P()


_STACKED_RE = re.compile(r"(^|/)layers/")


def _paths(tree, prefix=""):
    """The tree with each leaf replaced by its (path, leaf) pair; the path
    joins dict keys and list indices with "/", as the reference joins a
    `tree_flatten_with_path` key path."""
    if isinstance(tree, dict):
        return {k: _paths(v, f"{prefix}{k}/") for k, v in tree.items()}
    if isinstance(tree, list):
        return [_paths(v, f"{prefix}{i}/") for i, v in enumerate(tree)]
    if tree is None:
        return None
    return (prefix[:-1], tree)


def tree_specs(params, mesh, prefix=""):
    """A tree of specs parallel to `params` (leaves with `.shape`).

    Parameters under a `layers/` path are stacked with a leading
    num_layers dim: the per-layer rules apply to shape[1:] and the stack
    dim stays unsharded (sharding it would turn every layer slice into a
    gather and misalign the expert and TP dims by one position)."""
    def spec(pair):
        path, leaf = pair
        full = prefix + path
        shape = tuple(leaf.shape)
        if _STACKED_RE.search(full) and len(shape) >= 2:
            inner = spec_for_param(full, shape[1:], mesh)
            return fit_spec(shape, P(None, *inner), mesh)
        return spec_for_param(full, shape, mesh)

    # a (path, leaf) pair and a spec are tuples, which the tree walk
    # treats as leaves
    return tree_map(spec, _paths(params))


class NamedSharding:
    """A spec laid over a mesh (the reference's `NamedSharding`, without
    devices). A dim whose entry names axes (a1, a2, ...) is cut into
    size(a1) * size(a2) * ... equal blocks, the first axis major; the
    rank at mesh coordinates `coords` holds the block its coordinates on
    those axes number, and every rank that differs only on axes the spec
    does not name holds the same block."""

    def __init__(self, mesh, spec):
        self.mesh = mesh
        self.spec = P(*spec)

    def _entries(self, ndim):
        if len(self.spec) > ndim:
            raise ValueError(f"spec {self.spec} has more entries than the "
                             f"array's {ndim} dims")
        return list(self.spec) + [None] * (ndim - len(self.spec))

    def axes(self) -> Tuple[str, ...]:
        """The mesh axes the spec names, in dim order."""
        return tuple(a for e in self.spec for a in entry_axes(e))

    def shard_shape(self, shape) -> Tuple[int, ...]:
        """The shape of one shard of a global array of `shape`."""
        out = []
        for dim, e in zip(shape, self._entries(len(shape))):
            n = axis_size(self.mesh, e)
            if dim % n:
                raise ValueError(f"dim {dim} of {tuple(shape)} does not "
                                 f"divide over {e!r} ({n}) in {self.spec}")
            out.append(dim // n)
        return tuple(out)

    def index(self, shape, coords) -> Tuple[slice, ...]:
        """The slice of a global array of `shape` held at mesh
        coordinates `coords` (axis name -> index)."""
        out = []
        for dim, size, e in zip(shape, self.shard_shape(shape),
                                self._entries(len(shape))):
            block = 0
            for a in entry_axes(e):
                block = block * self.mesh.shape[a] + coords[a]
            out.append(slice(block * size, (block + 1) * size))
        return tuple(out)

    def indices_map(self, shape) -> Dict[int, Tuple[slice, ...]]:
        """Rank -> its slice, the ranks laid over the mesh row-major (the
        reference's `addressable_devices_indices_map` with device i at
        the i-th coordinate of a row-major mesh)."""
        names, sizes = self.mesh.axis_names, self.mesh.axis_sizes
        out = {}
        for r, c in enumerate(itertools.product(*(range(n) for n in sizes))):
            out[r] = self.index(shape, dict(zip(names, c)))
        return out

    def __repr__(self):
        return f"NamedSharding({self.mesh!r}, {self.spec!r})"


def tree_shardings(params, mesh, prefix=""):
    """`tree_specs` with every spec laid over `mesh`."""
    return tree_map(lambda s: NamedSharding(mesh, s),
                    tree_specs(params, mesh, prefix))


# activation specs -----------------------------------------------------------

def act_spec_btd(mesh) -> PartitionSpec:
    """(batch, seq, d) activations."""
    ba = batch_axes(mesh)
    if get_profile() in ("dp", "fsdp"):
        return P(ba if len(ba) > 1 else ba[0], seq_axis(mesh), None)
    return P(ba if len(ba) > 1 else ba[0], None, "model")


def batch_spec(mesh) -> PartitionSpec:
    ba = batch_axes(mesh)
    return P(ba if len(ba) > 1 else ba[0])


# client-axis specs (the mesh-sharded fused executor, DESIGN.md §11) ---------
# The fused executor's trees carry a LEADING CLIENT AXIS (stacked
# federation params, dataset, per-round inputs). On the 1-D client mesh
# (`launch.mesh.make_client_mesh`) that axis — and only that axis — is
# laid over "data"; a client's parameters stay whole.

def client_stack_specs(tree, *, axis: str = "data", lead: int = 0):
    """Tree of specs laying dim `lead` of every leaf over `axis` (lead=0:
    the stacked federation state (C, ...); lead=1: per-round inputs
    (rounds, C, ...)). A leaf with no dim `lead` raises: a silent
    replicate would hide a mis-sharded carry."""
    def spec(leaf):
        ndim = getattr(leaf, "ndim", None)
        if ndim is None or ndim <= lead:
            raise ValueError(
                f"client_stack_specs: leaf of ndim {ndim} cannot shard "
                f"dim {lead} over {axis!r}")
        entries = [None] * ndim
        entries[lead] = axis
        return P(*entries)
    return tree_map(spec, tree)


def replicated_specs(tree):
    """Tree of empty specs (fully replicated leaves)."""
    return tree_map(lambda _: P(), tree)


def remap_act_spec(spec, mesh) -> PartitionSpec:
    """Translate a tp-profile activation spec to the active profile: under
    dp/fsdp, "data" (the batch dim) -> batch_axes(mesh), "model" (a
    feature dim) -> replicated; multi-pod fsdp also shards the sequence
    dim (position 1 of batch-first specs) over "model"."""
    prof = get_profile()
    if prof not in ("dp", "fsdp", "moe"):
        return P(*spec)
    if prof == "moe" and len(spec) and spec[0] == "model":
        return P(*spec)    # expert-parallel constraint (e over model): keep
    multi = "pod" in mesh.axis_names
    keep_model = prof == "moe" and multi   # "model" reserved for experts
    ba = batch_axes(mesh)
    out = []
    for e in spec:
        if e == "data" or (isinstance(e, (tuple, list)) and "data" in e):
            out.append(ba)
        elif e == "model":
            out.append("model" if keep_model else None)
        else:
            out.append(e)
    sa = seq_axis(mesh)
    if sa and len(out) >= 2 and out[0] == ba and out[1] is None:
        out[1] = sa
    return P(*out)



# ---------------------------------------------------------------------------
# compute layout: what a rank computes of each leaf (tensor parallelism)
#
# The reference's GSPMD splits compute over "model" where its activations
# keep "model" on their features (`remap_act_spec`): the tp profile, and the
# multi-pod moe profile. A rank there computes Megatron's layout: attention
# heads and MLP columns column-parallel, their output products row-parallel
# (one all-reduce over "model" each), MoE experts, Mamba2 heads and the
# vocabulary. Under the single-pod moe profile "model" carries rows and the
# experts (`ep_axis`): a rank computes only its experts, on every rank's
# tokens routed to them (the all-to-all of `models.moe`). A decode step
# cuts its tokens over the FSDP axes only, so the ranks along "model" hold
# the same rows under every profile: there a rank computes its "model"
# shard whatever the profile (`decode=True`), and its attention computes
# where its KV cache lies (`cache_cut`). A decode step's dense products
# whose weights are stored with one dim cut compute where the weight lies
# instead (`still_blocks`, the reference's compiled decode): the step moves
# the tokens' activations, not the weight. `compute_layout` says, for one
# leaf, which slice of it the rank computes with;
# `models.parallel.Parallel.take` makes that slice from the rank's stored
# shard, one layer at a time.
# ---------------------------------------------------------------------------

def tp_axis(mesh, decode: bool = False):
    """"model" where a rank computes its "model" shard of each layer: the
    tp profile and the multi-pod moe profile, and a decode step (`decode`)
    under every profile, on a mesh whose "model" axis has more than one
    rank; else None (every rank along "model" computes whole layers on its
    own rows)."""
    prof = get_profile()
    if not (decode or prof == "tp"
            or (prof == "moe" and "pod" in mesh.axis_names)):
        return None
    return "model" if axis_size(mesh, "model") > 1 else None


def ep_axis(mesh):
    """"model" where a rank holds its "model" shard of the MoE experts and
    runs only those: the single-pod moe profile (`spec_for_param` keeps
    the experts over "model"; the reference's dispatch crosses an
    all-to-all there), on a mesh whose "model" axis has more than one
    rank; else None."""
    if get_profile() != "moe" or "pod" in mesh.axis_names:
        return None
    return "model" if axis_size(mesh, "model") > 1 else None


def model_axis(mesh, decode: bool = False):
    """The axis a rank computes its "model" shard over, and whether only
    the experts are cut there: (`tp_axis`, False), else (`ep_axis`,
    True), else (None, False)."""
    name = tp_axis(mesh, decode)
    if name:
        return name, False
    name = ep_axis(mesh)
    return name, name is not None


def _mamba_heads(cfg) -> int:
    return cfg.mamba_expand * cfg.d_model // cfg.ssm_head_dim


def cut_kinds(cfg, M: int, experts_only: bool = False,
              decode: bool = False) -> Dict[str, bool]:
    """Which of the config's blocks a "model" axis of M ranks cuts: GQA
    attention and MLA by heads, the dense MLP and MoE's shared experts by
    columns, MoE by experts, Mamba2 by heads, the embedding and logits by
    the vocabulary. A block whose count does not divide over M is computed
    whole on every rank (gemma3-4b's 8 heads at M = 16), as are xLSTM, the
    encoder, cross-attention and the vision projection (ROADMAP A.19b).
    `experts_only` (the `ep_axis`): only MoE's experts. A decode step's
    GQA attention (`decode`) cuts its projections' columns evenly where
    they divide, whatever its head counts (`_decode_attn_layout`)."""
    out = {k: False for k in ("attn", "mla", "mlp", "moe", "mamba",
                              "vocab")}
    if M < 2:
        return out
    out["moe"] = bool(cfg.moe) and cfg.num_experts % M == 0
    if experts_only:
        return out
    ff = cfg.num_shared_experts * cfg.d_ff if cfg.moe else cfg.d_ff
    heads = cfg.num_heads % M == 0
    dh = cfg.head_dim
    attn = heads if not decode else (
        cfg.num_heads * dh % M == 0 and cfg.num_kv_heads * dh % M == 0)
    out.update(attn=cfg.attention_kind == "gqa" and attn,
               mla=cfg.attention_kind == "mla" and heads,
               mlp=ff > 0 and ff % M == 0,
               mamba=bool(cfg.ssm_state) and _mamba_heads(cfg) % M == 0,
               vocab=cfg.vocab_size % M == 0)
    return out


class Layout(tuple):
    """One leaf's compute layout: (kind, dim, ranges, partial). `kind` is
    column | row | vocab | expert | head | whole | still; the rank computes
    with the concatenation of `ranges` ((lo, hi) pairs) along `dim` (None:
    the whole leaf), or ("still") with its stored block, cut along `dim`
    (`still_blocks`). `partial` is true where the rank's gradient is a part
    of the leaf's (its slice, or a whole leaf it applies to its own heads
    only), to be summed over "model"; false where every rank along "model"
    computes the same gradient."""

    def __new__(cls, kind, dim=None, ranges=(), partial=False):
        return super().__new__(cls, (kind, dim, tuple(ranges), partial))

    kind = property(lambda s: s[0])
    dim = property(lambda s: s[1])
    ranges = property(lambda s: s[2])
    partial = property(lambda s: s[3])


WHOLE = Layout("whole")


def attn_heads(cfg, M: int, index: int):
    """(first query head, query heads, first kv head, kv heads) of rank
    `index` of M under head-parallel attention: its H/M query heads and
    the kv heads they read (under GQA several ranks may read one)."""
    H, Hk = cfg.num_heads, cfg.num_kv_heads
    hl = H // M
    q0 = index * hl
    G = H // Hk
    k0 = q0 // G
    return q0, hl, k0, (q0 + hl - 1) // G + 1 - k0


def compute_layout(cfg, mesh, path: str, shape, index: int,
                   whole=(), decode: bool = False, still=None) -> Layout:
    """The compute layout of the leaf at `path` (its per-layer `shape`, the
    stacked layer dim dropped) on the rank at index `index` of the
    "model" axis. `whole` names blocks computed whole all the same (a
    decode step's "mamba", whose state is cut across heads); `decode`:
    the layouts of a decode step (`tp_axis`, `_decode_attn_layout`);
    `still`: its stationary blocks (`still_blocks`), whose products take
    their stored blocks and whose other leaves are taken whole."""
    for prefix, leaves in (still or {}).items():
        if path.startswith(prefix + "/"):
            rest = path[len(prefix) + 1:]
            return Layout("still", leaves[rest]) if rest in leaves else WHOLE
    name, experts_only = model_axis(mesh, decode)
    M = axis_size(mesh, name) if name else 1
    cut = cut_kinds(cfg, M, experts_only, decode)
    seg = path.split("/")
    if (M < 2 or seg[0] in ("encoder", "vision_proj")
            or "cross_attn" in seg):
        return WHOLE
    if path == "embed/embed" or path == "unembed/kernel":
        if not cut["vocab"]:
            return WHOLE
        d = 0 if path == "embed/embed" else 1
        n = shape[d] // M
        return Layout("vocab", d, [(index * n, (index + 1) * n)], True)
    block = next((b for b in ("attn", "mlp", "mamba") if b in seg), None)
    leaf = "/".join(seg[seg.index(block) + 1:]) if block else ""
    if "attn" in seg and cfg.attention_kind == "mla":
        return _mla_layout(cfg, leaf, index, M) if cut["mla"] else WHOLE
    if "attn" in seg:
        if not cut["attn"]:
            return WHOLE
        if decode:
            return _decode_attn_layout(leaf, shape, index, M)
        dh = cfg.head_dim
        q0, hl, k0, kl = attn_heads(cfg, M, index)
        qr = [(q0 * dh, (q0 + hl) * dh)]
        kr = [(k0 * dh, (k0 + kl) * dh)]
        if leaf == "wq/kernel":
            return Layout("column", 1, qr, True)
        if leaf == "wq/bias":
            return Layout("column", 0, qr, True)
        if leaf in ("wk/kernel", "wv/kernel"):
            return Layout("column", 1, kr, True)
        if leaf in ("wk/bias", "wv/bias"):
            return Layout("column", 0, kr, True)
        if leaf == "wo/kernel":
            return Layout("row", 0, qr, True)
        if leaf in ("q_norm/scale", "k_norm/scale"):
            return Layout("whole", None, (), True)
        return WHOLE           # wo/bias: added after the all-reduce
    if "mlp" in seg:
        moe_block = cfg.moe and seg[0] != "shared_attn"
        if moe_block and re.match(r"experts_", leaf):
            if not cut["moe"]:
                return WHOLE
            n = shape[0] // M
            return Layout("expert", 0, [(index * n, (index + 1) * n)], True)
        if moe_block and not leaf.startswith("shared/"):
            return WHOLE       # the router: whole
        if moe_block:
            leaf = leaf[len("shared/"):]
            if not (cut["moe"] and cut["mlp"]):
                return WHOLE
        elif not cut["mlp"]:
            return WHOLE
        col = {"wi_gate": 1, "wi_up": 1, "wi/kernel": 1, "wi/bias": 0}
        if leaf in col:
            d = col[leaf]
            n = shape[d] // M
            return Layout("column", d, [(index * n, (index + 1) * n)], True)
        if leaf in ("wo", "wo/kernel"):
            n = shape[0] // M
            return Layout("row", 0, [(index * n, (index + 1) * n)], True)
        return WHOLE           # wo/bias: added after the all-reduce
    if "mamba" in seg:
        if not cut["mamba"] or "mamba" in whole:
            return WHOLE
        hm, dhs, N = _mamba_heads(cfg), cfg.ssm_head_dim, cfg.ssm_state
        di = hm * dhs
        hl = hm // M
        h0 = index * hl
        heads = (h0 * dhs, (h0 + hl) * dhs)
        if leaf == "in_proj/kernel":
            # z | x | B | C | dt: the rank's heads' z, x and dt, all of B, C
            return Layout("column", 1, [
                heads, (di + heads[0], di + heads[1]),
                (2 * di, 2 * di + 2 * N),
                (2 * di + 2 * N + h0, 2 * di + 2 * N + h0 + hl)], True)
        if leaf == "conv1d":
            return Layout("column", 1, [heads, (di, di + 2 * N)], True)
        if leaf in ("A_log", "D", "dt_bias"):
            return Layout("head", 0, [(h0, h0 + hl)], True)
        if leaf == "norm/scale":
            return Layout("head", 0, [heads], True)
        if leaf == "out_proj/kernel":
            return Layout("row", 0, [heads], True)
        return WHOLE
    return WHOLE


def _decode_attn_layout(leaf: str, shape, index: int, M: int) -> Layout:
    """A decode step's GQA attention: `wq`, `wk` and `wv` (and their
    biases) cut into M equal column blocks, `wo` into M equal row blocks.
    Where the kv heads divide over M a block is the rank's heads (its KV
    cache's); elsewhere the rank gathers the new token's q, k and v over
    "model" and attends over its block of cache positions
    (`models.attention`), then takes its rows of `wo`."""
    def block(d):
        n = shape[d] // M
        return [(index * n, (index + 1) * n)]
    if leaf in ("wq/kernel", "wk/kernel", "wv/kernel"):
        return Layout("column", 1, block(1), True)
    if leaf in ("wq/bias", "wk/bias", "wv/bias"):
        return Layout("column", 0, block(0), True)
    if leaf == "wo/kernel":
        return Layout("row", 0, block(0), True)
    if leaf in ("q_norm/scale", "k_norm/scale"):
        return Layout("whole", None, (), True)
    return WHOLE               # wo/bias: added after the all-reduce


def cache_cut(spec) -> str:
    """How a (B, cap, Hk, dh) KV cache's stored spec cuts it over "model":
    "heads" (its kv heads), "seq" (its positions) or "whole"
    (`launch.serve.decode_state_shardings`)."""
    entries = list(spec) + [None] * (4 - len(spec))
    if "model" in entry_axes(entries[2]):
        return "heads"
    if "model" in entry_axes(entries[1]):
        return "seq"
    return "whole"


def _mla_layout(cfg, leaf: str, index: int, M: int) -> Layout:
    """MLA cut by heads (`models.mla`): the rank's heads' columns of `wq`
    (nope + rope a head), `w_uk` (nope) and `w_uv` (v_head_dim), its rows
    of `wo`; `w_dkv` and `w_kpe` whole, their gradients the rank's heads'
    part. A decode step gathers its latent and rotary caches whole
    (ROADMAP A.19b), so its layouts are these."""
    hl = cfg.num_heads // M
    q0 = index * hl

    def heads(width):
        return [(q0 * width, (q0 + hl) * width)]
    cols = {"wq/kernel": cfg.qk_nope_dim + cfg.qk_rope_dim,
            "w_uk/kernel": cfg.qk_nope_dim, "w_uv/kernel": cfg.v_head_dim}
    if leaf in cols:
        return Layout("column", 1, heads(cols[leaf]), True)
    if leaf == "wo/kernel":
        return Layout("row", 0, heads(cfg.v_head_dim), True)
    if leaf in ("w_dkv/kernel", "w_kpe/kernel"):
        return Layout("whole", None, (), True)
    return WHOLE


def compute_layouts(cfg, mesh, params, index: int, whole=(),
                    decode: bool = False, still=None):
    """`compute_layout` over a parameter tree (leaves with `.shape`);
    a leaf stacked under `layers/` gets its per-layer layout."""
    def one(pair):
        path, leaf = pair
        shape = tuple(leaf.shape)
        if _STACKED_RE.search(path) and len(shape) >= 2:
            shape = shape[1:]
        return compute_layout(cfg, mesh, path, shape, index, whole, decode,
                              still)
    return tree_map(one, _paths(params))


# a block's dense products, by the block's name: one group of leaves per
# form the block takes (an MLP's input products first, its output last)
_PRODUCTS = {"attn": (("wq/kernel", "wk/kernel", "wv/kernel", "wo/kernel"),),
             "mlp": (("wi_gate", "wi_up", "wo"), ("wi/kernel", "wo/kernel")),
             "mamba": (("in_proj/kernel", "out_proj/kernel"),)}


def _block_of(cfg, path):
    """(the block's path, the leaf's path within it) of a leaf of a block
    whose products may compute where their weights lie, else
    None: GQA attention, a dense MLP (zamba2's shared block's too) and
    Mamba2; not MLA, MoE, xLSTM, cross-attention, the encoder or the
    vision projection (ROADMAP A.19b)."""
    seg = path.split("/")
    if seg[0] in ("encoder", "vision_proj"):
        return None
    i = next((j for j, b in enumerate(seg) if b in _PRODUCTS), None)
    if i is None:
        return None
    name = seg[i]
    if name == "attn" and cfg.attention_kind != "gqa":
        return None
    if name == "mlp" and cfg.moe and seg[0] != "shared_attn":
        return None
    return "/".join(seg[:i + 1]), "/".join(seg[i + 1:])


def still_blocks(cfg, mesh, params):
    """A decode step's stationary blocks (the reference's compiled decode:
    a product computes where its weight is stored, and the step moves its
    tokens' activations instead of the weight): block path ("layers/attn",
    "shared_attn/mlp", "blocks/3/mamba") -> {leaf within it: the dim of
    the product's (in, out) weight that its stored block cuts}. A block
    qualifies where every product's weight is stored with exactly one dim
    cut and an MLP's input products are cut on their outputs over the
    axes its output product is cut on its inputs over (its hidden
    columns: one sum a block). Other blocks keep their compute layouts."""
    if mesh.size < 2:
        return {}
    found: Dict[str, Dict[str, tuple]] = {}
    for path, leaf in tree_leaves(_paths(params)):
        where = _block_of(cfg, path)
        if where is None:
            continue
        shape = tuple(leaf.shape)
        if _STACKED_RE.search(path):
            shape = shape[1:]
        entries = list(spec_for_param(path, shape, mesh)) + [None] * 2
        cut = [d for d, e in enumerate(entries) if entry_axes(e)]
        found.setdefault(where[0], {})[where[1]] = (
            (cut[0], entry_axes(entries[cut[0]]))
            if len(shape) == 2 and len(cut) == 1 else None)
    out = {}
    for prefix, leaves in found.items():
        name = prefix.rsplit("/", 1)[-1]
        for group in _PRODUCTS[name]:
            cuts = [leaves.get(k) for k in group]
            if not all(cuts):
                continue
            if name == "mlp" and not (
                    all(c == (1, cuts[-1][1]) for c in cuts[:-1])
                    and cuts[-1][0] == 0):
                continue
            out[prefix] = {k: c[0] for k, c in zip(group, cuts)}
    return out
