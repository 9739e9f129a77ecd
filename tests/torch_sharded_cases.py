"""Rank-side halves of the zoo's sharded-step tests
(`test_torch_sharded_train.py`, `test_torch_fl_trainer_mesh.py`,
`test_torch_serve_shardings.py`) and of chip_smoke.py's phase 15:
functions a `launch.mesh.World` calls on every rank. Each builds its
model from a config name and overrides, takes its parameters from numpy
arrays or draws them from a seed (the same draw on every rank), cuts its
shards, runs the sharded step and returns numpy results with the rank's
collective counts and kernel launches. Imports torch and the port only,
so the ranks never load jax.

Large results (a rank's parameter shards, prefill logits) go through
files in `out_dir` when one is given (`load` reads them back): a pipe
moves a pickled array of hundreds of MB at a few MB/s."""
import functools
import os
import time

import numpy as np
import torch

from repro_torch import convert
from repro_torch.device import deterministic_f32, generator
from repro_torch.launch import mesh
from repro_torch.sharding.specs import MeshShape
from repro_torch.tree import tree_map


def build(arch, reduced=True, **kw):
    from repro_torch.configs.registry import get_config
    from repro_torch.models.model import build_model
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    return build_model(cfg.with_updates(**kw))


def card_init(model, seed, device):
    """The model's own random parameters (`Model.init`: its layouts and
    distributions) drawn on `device` from a generator there seeded with
    `seed`: the same tensors on every process of one card, other draws
    than a host generator's. A full-width MoE's host init takes ~25 s;
    this takes well under one."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return model.init(g, device)


def _params(model, params, seed, device, init="host"):
    if params is None:
        if init == "card":
            return card_init(model, seed, device)
        return model.init(generator(seed), device)
    return convert.params_from_jax(params, device)


# the share of a card the ranks drawing a whole tree at once may fill with
# their trees (each counted twice: a stacked leaf's layers are drawn, then
# stacked)
DRAW_CARD_USE = 0.6


def drawers(rank, model):
    """How many ranks draw a whole tree at once under a card init: as many
    of the ranks sharing the card as DRAW_CARD_USE of its memory holds
    (the same on every rank: the card's size, the tree's bytes)."""
    if rank.device.type != "cuda":
        return rank.size
    from repro_torch.tree import tree_leaves
    tree = sum(x.numel() * x.element_size()
               for x in tree_leaves(model.param_specs()))
    card = torch.cuda.get_device_properties(rank.device).total_memory
    on_card = -(-rank.size // torch.cuda.device_count())
    return max(1, min(on_card, int(DRAW_CARD_USE * card // (2 * tree))))


def _shards(rank, model, params, seed, sharding, rm, init="host"):
    """The rank's shards of the whole params. Under a card init the ranks
    draw the whole tree in groups of `drawers` at once, each keeping its
    shards, so the card holds that many whole trees at a time (the
    drawing ranks' allocators uncapped)."""
    if init != "card" or params is not None:
        return mesh.shard_tree(_params(model, params, seed, rank.device),
                               sharding, rm)
    mine = None
    n = drawers(rank, model)
    for first in range(0, rank.size, n):
        if first <= rank.rank < first + n:
            if rank.device.type == "cuda":     # lift `_compact`'s cap
                torch.cuda.set_per_process_memory_fraction(1.0, rank.device)
            mine = mesh.shard_tree(card_init(model, seed, rank.device),
                                   sharding, rm)
            _release(rank)
        rank.barrier()
    return mine


def _ship(rank, leaves, out_dir, name):
    """numpy `leaves` (a list) inline, or saved under `out_dir`, one raw
    `.npy` file a leaf (no archive: a zip's checksums over GBs took
    seconds each way), and named by their paths."""
    if out_dir is None:
        return leaves
    paths = []
    for i, x in enumerate(leaves):
        paths.append(os.path.join(out_dir, f"{name}-rank{rank.rank}-{i}.npy"))
        np.save(paths[-1], x)
    return {"npy": paths}


def stage(arrays, out_dir, name):
    """The numpy `arrays` (a dict) of a task's input as every rank takes
    them: each saved once under `out_dir` as a raw `.npy` file (`_ship`'s
    form), which the ranks map (`unstage`); without `out_dir` the arrays
    themselves. A task's arguments reach the ranks one after another
    through pipes at tens of MB/s on the card's host: a 57 MB vision
    prefix reached the eighth rank ~16 s after the first, which waited
    that long at the draw's barrier."""
    if out_dir is None:
        return arrays
    out = {}
    for k, v in arrays.items():
        path = os.path.join(out_dir, f"{name}-{k}.npy")
        np.save(path, v)
        out[k] = {"npy": [path]}
    return out


def unstage(arrays):
    """`stage`'s arrays, each mapped from its file (`load`)."""
    return {k: load(v)[0] if isinstance(v, dict) else v
            for k, v in arrays.items()}


def load(shipped):
    """The list of arrays `_ship` sent, its files mapped copy-on-write (a
    comparison reads them from the page cache: reading GBs into fresh
    arrays first took three times as long)."""
    if isinstance(shipped, dict):
        return [np.load(p, mmap_mode="c") for p in shipped["npy"]]
    return shipped


def max_abs_diff(a, b) -> float:
    """max |a - b| over two arrays of one shape (numpy or tensors), taken
    by torch on the host's threads (numpy takes one)."""
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    if a.numel() == 0:
        return 0.0
    return float((a.to(b.device) - b).abs().max())


def _np(tree):
    return tree_map(lambda t: t.detach().cpu().numpy()
                    if isinstance(t, torch.Tensor) else t, tree)


def warm(rank):
    """Import what the sharded cases run and make the rank's CUDA context
    (one small allocation, freed after the task): a world started early
    pays these before its first case. A draw on the meta device
    (`Model.param_specs`) imports torch._dynamo on its first call, which
    took 13-16 s in each of eight ranks at once."""
    import torch._dynamo  # noqa: F401

    import repro_torch.launch.serve  # noqa: F401
    import repro_torch.launch.train  # noqa: F401
    import repro_torch.models.model  # noqa: F401
    torch.zeros(1, device=rank.device)


def host_path_bytes(rank, nbytes):
    """Set the rank's `collectives.SMALL_GATHER_BYTES` (0: every gloo
    collective of a CUDA tensor takes gloo's own path) and return the
    value it had: an A/B of the host path within one world."""
    from repro_torch.core import collectives
    old, collectives.SMALL_GATHER_BYTES = (collectives.SMALL_GATHER_BYTES,
                                           nbytes)
    return old


def _launches():
    from repro_torch.kernels import flash_attention as fl
    from repro_torch.kernels import ssm_scan as ss
    return {"flash_attention": fl.launches, "ssm_scan": ss.launches}


def _report(rank, start, t0):
    dev = rank.device
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else None)
    reserved = (torch.cuda.max_memory_reserved(dev) if dev.type == "cuda"
                else None)
    return {"collectives": mesh.collective_counts(),
            "peak_reserved_bytes": reserved,
            "launches": {k: v - start[k] for k, v in _launches().items()},
            "peak_bytes": peak, "seconds": time.perf_counter() - t0}


def _sync(rank):
    if rank.device.type == "cuda":
        torch.cuda.synchronize(rank.device)


# the share of a card its ranks' allocators may hold together; the rest is
# left to the processes' CUDA contexts and to the main process
SHARED_CARD_USE = 0.85


def _compact(rank, init):
    """A full-width case (its weights drawn on the card): the rank's
    allocator splits no block above 256 MB, so that the whole-leaf
    gathers and gradients of eight ranks sharing the card leave no
    cached segment half used (fragmentation ran the card out of memory),
    and it holds at most its share of the card (SHARED_CARD_USE of it over
    the ranks on the card): past that it hands its own cached blocks back
    before it allocates, so one rank's cache cannot run another out of
    memory (eight ranks' caches at their peaks filled the card)."""
    if init == "card" and rank.device.type == "cuda":
        torch._C._accelerator_setAllocatorSettings("max_split_size_mb:256")
        cards = torch.cuda.device_count()
        mine = sum(1 for r in range(rank.size)
                   if r % cards == rank.device.index)
        torch.cuda.set_per_process_memory_fraction(SHARED_CARD_USE / mine,
                                                   rank.device)


def _release(rank):
    """Hand this rank's cached free blocks back to the card between a
    case's parts (its draw, its repeat, its last gathers): the ranks share
    it, and a full-width step's blocks cached in one rank are memory the
    others cannot use."""
    if rank.device.type == "cuda":
        torch.cuda.synchronize(rank.device)
        torch.cuda.empty_cache()


def _same(a, b):
    from repro_torch.tree import tree_leaves
    return all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                 tree_leaves(b)))


# `train`'s default: one SGD step (lr 1e-2), not repeated
SGD_STEP = (("sgd", 1e-2, 1, False),)


def train(rank, arch, cfg_kw, mesh_shape, names, batch, *, params=None,
          seed=0, runs=SGD_STEP, reduced=True, out_dir=None, init="host"):
    """Sharded train steps from the whole `params` (numpy, or drawn from
    `seed`: on the host, or by `card_init` with init="card") on the whole
    `batch` (numpy arrays, or `stage`'s files): each of `runs` ([(opt, lr, steps, repeat), ...],
    opt "sgd" or "adamw") runs its `steps` from the same starting shards,
    drawn once; with `repeat` it runs them again from those shards and
    reports whether the rank's shards and metrics repeat bit for bit.
    Returns a list, one (the rank's param shards after the steps, in tree
    order (`load`); the metrics of every step; the report, with each
    shard's place in its whole leaf: `gathered` joins the ranks' shards)
    a run."""
    deterministic_f32()
    t_build = time.perf_counter()
    dev = rank.device
    model = build(arch, reduced, **cfg_kw)
    rm = rank.mesh(MeshShape(mesh_shape, names))
    b = {k: torch.as_tensor(v, device=dev)
         for k, v in unstage(batch).items()}
    steps_ = [_train_step(model, rm, b, opt, lr) for opt, lr, *_ in runs]
    p_sh, _, b_sh = steps_[0][0].shardings
    build_s = time.perf_counter() - t_build
    t_draw = time.perf_counter()
    p = _shards(rank, model, params, seed, p_sh, rm, init)
    draw_s = time.perf_counter() - t_draw
    _compact(rank, init)
    from repro_torch.tree import tree_leaves
    # a full-width model's starting shards (GBs a rank) wait on the host
    # for the repeat and the next run, as its shards after the steps do
    # while the repeat runs
    park = (dev.type == "cuda" and sum(
        t.numel() * t.element_size() for t in tree_leaves(p)) > 2**30)
    b = mesh.shard_tree(b, b_sh, rm)
    # the step updates its shards in place (donated): a repeat and every
    # run after the first start from a copy of the starting shards
    stash = (tree_map(lambda t: t.cpu() if park else t.clone(), p)
             if len(runs) > 1 or any(r[3] for r in runs) else None)

    def fresh():
        return tree_map(lambda t: t.to(dev, copy=True), stash)
    out = []
    for k, ((_, _, n, again), (step, opt)) in enumerate(zip(runs, steps_)):
        got = _train_run(rank, step, opt, p if k == 0 else fresh(),
                         fresh if again else None, b, n, park, out_dir,
                         f"params-{k}")
        p = None
        got[2].update(build_seconds=build_s, draw_seconds=draw_s)
        out.append(got)
    return out


def _train_step(model, rm, b, opt, lr):
    """(the sharded train step of `opt` at `lr`, its optimizer)."""
    from repro_torch.launch.train import make_sharded_train_step
    from repro_torch.optim import optimizers
    o = (optimizers.sgd(lr) if opt == "sgd"
         else optimizers.adamw(lr, weight_decay=0.01))
    specs = {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
             for k, v in b.items()}
    return make_sharded_train_step(model, o, rm, specs), o


def _train_run(rank, step, o, p, fresh, b, steps, park, out_dir, name):
    """`steps` of `step` (optimizer `o`) from the shards `p` (updated in
    place), repeated from `fresh()` (a copy of them) unless it is None;
    then the rank's shards shipped. Returns one of `train`'s triples."""
    from repro_torch.tree import tree_leaves
    dev = rank.device
    p_sh = step.shardings[0]
    to_host = (lambda t: t.cpu()) if park else (lambda t: t)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    mesh.reset_collective_counts()
    start, metrics, times = _launches(), [], []
    t0 = time.perf_counter()
    s = o.init(p)
    # between steps the rank keeps its cache: a full-width rank's is
    # capped (`_compact`), and emptying it made every step allocate its
    # blocks anew on a card eight ranks share
    for _ in range(steps):
        t1 = time.perf_counter()
        p, s, m = step(p, s, b)
        _sync(rank)
        times.append(time.perf_counter() - t1)
        metrics.append({k: float(v) for k, v in m.items()})
    report = _report(rank, start, t0)
    report["step_seconds"] = times
    report["cut"] = sorted(step.parallel.ran)
    report["local_shapes"] = step.local_shapes
    report["expert_parallel"] = step.parallel.expert_parallel
    report["gathered_bytes"] = step.parallel.gathered_bytes()
    report["taken"] = dict(step.parallel.taken)
    t_repeat = time.perf_counter()
    if fresh is not None:
        p = tree_map(to_host, p)
        del s
        _release(rank)
        q = fresh()
        s = o.init(q)
        again = []
        for _ in range(steps):
            q, s, m = step(q, s, b)
            again.append({k: float(v) for k, v in m.items()})
        report["bitwise_repeat"] = (_same(p, tree_map(to_host, q))
                                    and again == metrics)
        del q, s
        p = tree_map(lambda t: t.to(dev), p)
    report["repeat_seconds"] = time.perf_counter() - t_repeat
    # every rank ships its own shards and where they sit in the whole
    # leaves (`gathered` joins them): no rank gathers a whole tree, which
    # on eight full-width ranks sharing a card overflowed it
    t_ship = time.perf_counter()
    s = None
    coords = step.parallel.rank_mesh.coords
    report["global_shapes"] = [tuple(w.shape) for w in
                               tree_leaves(step.parallel.param_specs)]
    report["shard_index"] = [
        [(d.start, d.stop) for d in sx.index(shape, coords)]
        for sx, shape in zip(tree_leaves(p_sh), report["global_shapes"])]
    shards = [x.detach().cpu().numpy() for x in tree_leaves(p)]
    del p
    _release(rank)
    shipped = _ship(rank, shards, out_dir, name)
    report["ship_seconds"] = time.perf_counter() - t_ship
    return shipped, metrics, report


def gathered(outs):
    """The whole params, in tree order, from every rank's result of
    `train` (its shipped shards and their places)."""
    whole = None
    for shipped, _, rep in outs:
        shards = load(shipped)
        if whole is None:
            whole = [np.empty(shape, dtype=x.dtype) for shape, x in
                     zip(rep["global_shapes"], shards)]
        for w, x, idx in zip(whole, shards, rep["shard_index"]):
            w[tuple(slice(lo, hi) for lo, hi in idx)] = x
    return whole


def fl(rank, arch, cfg_kw, fl_kw, mesh_shape, names, batches, weights,
       participate, *, client_params=None, global_params=None, seed=0,
       reduced=True, repeat=False):
    """One sharded `fl_train_step` per batch of `batches` (numpy (C, K, B,
    S) trees). Returns ((first, stop) of the rank's clients, its model
    index, those clients' whole params stacked as numpy, CFL's whole
    global params as numpy or None, the losses, the report); the report
    holds the served model's leaves ("served"); `repeat` runs the rounds
    again from the same state and reports whether they repeat bit for
    bit."""
    from repro_torch.core.fl_types import FLConfig
    from repro_torch.core.trainer import FederatedTrainer, fl_client_axes
    from repro_torch.sharding import specs as sh
    deterministic_f32()
    dev = rank.device
    model = build(arch, reduced, **cfg_kw)
    rm = rank.mesh(MeshShape(mesh_shape, names))
    tr = FederatedTrainer(model, FLConfig(**fl_kw), rm)
    cp = (None if client_params is None
          else convert.params_from_jax(client_params, dev))
    gp = (None if global_params is None
          else convert.params_from_jax(global_params, dev))
    state0 = tr.init_state(generator(seed), client_params=cp,
                           global_params=gp, device=dev)
    ca = fl_client_axes(rm.shape)
    w = torch.as_tensor(weights, device=dev)
    part = torch.as_tensor(participate, device=dev)
    shards = []
    for batch in batches:
        b = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        b_sh = tree_map(lambda x: sh.NamedSharding(rm.shape, sh.fit_spec(
            x.shape, sh.P(ca if len(ca) > 1 else ca[0]), rm.shape)), b)
        shards.append(mesh.shard_tree(b, b_sh, rm))

    def rounds():
        state, losses = state0, []
        for b in shards:
            state, m = tr.fl_train_step(state, b, w, part)
            losses.append(float(m["loss"]))
        return state, losses

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    mesh.reset_collective_counts()
    start = _launches()
    t0 = time.perf_counter()
    state, losses = rounds()
    _sync(rank)
    report = _report(rank, start, t0)
    report["cut"] = sorted(tr._view().ran)
    from repro_torch.tree import tree_leaves
    report["served"] = tree_leaves(_np(tr.served_model(state)))
    if repeat:
        again, again_losses = rounds()
        report["bitwise_repeat"] = (_same(state, again)
                                    and again_losses == losses)
    shardings = tr._mesh_shardings()
    mine = tr._client_view(state["client_params"],
                           shardings["client_params"])
    glob = (mesh.gather_tree(state["global_params"],
                             shardings["global_params"], rm)
            if "global_params" in state else None)
    coords = rm.coords
    clients = tr.local_clients
    return ((clients.start, clients.stop), coords.get("model", 0), _np(mine),
            None if glob is None else _np(glob), losses, report)


def _kernel_prefill():
    """Every mamba layer through `mamba2_forward(use_kernel=True)` for the
    call (`transformer.forward` looks the function up through the
    module), as chip_smoke.py's `kernel_prefill`."""
    import contextlib
    from repro_torch.models import ssm

    @contextlib.contextmanager
    def ctx():
        orig = ssm.mamba2_forward
        ssm.mamba2_forward = functools.partial(orig, use_kernel=True)
        try:
            yield
        finally:
            ssm.mamba2_forward = orig
    return ctx()


def _recording():
    """Record the shapes B5 and B6 launch at (q and k / xh and Bm) while
    the context is open: {"flash_attention": [...], "ssm_scan": [...]}."""
    import contextlib
    from repro_torch.kernels import flash_attention as fl
    from repro_torch.kernels import ssm_scan as ss

    @contextlib.contextmanager
    def ctx():
        seen = {"flash_attention": [], "ssm_scan": []}
        f0, s0 = fl.flash_attention, ss.ssm_scan

        def f(q, k, v, **kw):
            seen["flash_attention"].append(
                [list(q.shape), list(k.shape), str(q.dtype)])
            return f0(q, k, v, **kw)

        def s_(xh, a, dt, Bm, Cm, **kw):
            seen["ssm_scan"].append(
                [list(xh.shape), list(Bm.shape), str(xh.dtype)])
            return s0(xh, a, dt, Bm, Cm, **kw)
        fl.flash_attention, ss.ssm_scan = f, s_
        try:
            yield seen
        finally:
            fl.flash_attention, ss.ssm_scan = f0, s0
    return ctx()


def serve(rank, arch, cfg_kw, mesh_shape, names, tokens, decode_steps, *,
          params=None, seed=0, kernel=False, reduced=True, out_dir=None,
          init="host", frontend=None):
    """The sharded prefill of the whole `tokens` (numpy (B, S)) and
    `frontend` (numpy "vision_embeds" / "audio_frames", if any), then
    `decode_steps` sharded decode steps from an empty state fed the
    first tokens (params as `train` takes them). Returns (the rank's
    prefill rows (start, stop), [their logits] (`load`), its decode rows,
    their logits of every step (steps, rows, V), the report); `kernel`
    runs the kernel prefill. The report
    holds the block kinds that ran cut over "model" ("cut"), the shapes
    the kernels launched at ("kernel_shapes"), the prefill's block of
    token positions ("positions": all of them but under context
    parallelism) and the runs of the one-device prefill's positions its
    logits are, in order ("spans": a vision prefix's block of patches,
    then its block of tokens)."""
    from repro_torch.launch.serve import (gather_logits,
                                          make_sharded_prefill_step,
                                          make_sharded_serve_step)
    deterministic_f32()
    dev = rank.device
    model = build(arch, reduced, **cfg_kw)
    rm = rank.mesh(MeshShape(mesh_shape, names))
    tok = torch.as_tensor(tokens, device=dev).long()
    B, S = tok.shape
    whole = {"tokens": tok}
    for k, v in unstage(frontend or {}).items():
        whole[k] = torch.as_tensor(v, device=dev)
    specs = {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
             for k, v in whole.items()}
    prefill = make_sharded_prefill_step(model, rm, specs)
    p_sh, b_sh = prefill.shardings
    t_draw = time.perf_counter()
    p = _shards(rank, model, params, seed, p_sh, rm, init)
    draw_s = time.perf_counter() - t_draw
    _compact(rank, init)
    rows, cols = b_sh["tokens"].index((B, S), rm.coords)[:2]
    st_specs = model.decode_state_specs(B, decode_steps)
    serve_step = make_sharded_serve_step(
        model, rm, st_specs, model.decode_token_specs(B))
    _, st_sh, t_sh = serve_step.shardings
    state = mesh.shard_tree(
        model.init_decode_state(B, decode_steps, device=dev), st_sh, rm)
    drows = t_sh.index((B, 1), rm.coords)[0]
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    mesh.reset_collective_counts()
    start = _launches()
    t0 = time.perf_counter()
    batch = mesh.shard_tree(whole, b_sh, rm)
    with torch.no_grad(), _recording() as shapes:
        if kernel:
            with _kernel_prefill():
                logits = prefill(p, batch)
        else:
            logits = prefill(p, batch)
        _sync(rank)
        prefill_s = time.perf_counter() - t0
        outs = []
        for i in range(decode_steps):
            lg, state = serve_step(p, state,
                                   mesh.shard(tok[:, i:i + 1], t_sh, rm))
            outs.append(lg[:, 0])
        _sync(rank)
        decode_s = time.perf_counter() - t0 - prefill_s
        # the vocabulary's columns joined over "model" (outside the timing)
        logits = gather_logits(logits, prefill.parallel)
        outs = [gather_logits(lg, serve_step.parallel).float().cpu().numpy()
                for lg in outs]
        _sync(rank)
    report = _report(rank, start, t0)
    report["prefill_seconds"] = prefill_s
    report["draw_seconds"] = draw_s
    report["decode_seconds"] = decode_s
    report["cut"] = sorted(prefill.parallel.ran | serve_step.parallel.ran)
    report["positions"] = ((cols.start, cols.stop)
                           if prefill.parallel.seq_axis else (0, S))
    P = whole["vision_embeds"].shape[1] if "vision_embeds" in whole else 0
    spans = [tuple(P + c for c in report["positions"])]
    if P:
        pr = (b_sh["vision_embeds"].index(whole["vision_embeds"].shape,
                                          rm.coords)[1]
              if prefill.parallel.seq_axis else slice(0, P))
        spans.insert(0, (pr.start, pr.stop))
    report["spans"] = spans
    report["expert_parallel"] = prefill.parallel.expert_parallel
    report["kernel_shapes"] = shapes
    return ((rows.start, rows.stop),
            _ship(rank, [logits.float().cpu().numpy()], out_dir, "logits"),
            (drows.start, drows.stop), np.stack(outs), report)


def _memory():
    """The caching allocator's bytes by block state, from one
    `torch.cuda.memory_snapshot()`, with the allocated and reserved bytes
    and the segments."""
    import collections
    snap = torch.cuda.memory_snapshot()
    by = collections.Counter()
    for seg in snap:
        for b in seg["blocks"]:
            by[b["state"]] += b["size"]
    return {"allocated": torch.cuda.memory_allocated(),
            "reserved": torch.cuda.memory_reserved(),
            "segments": len(snap), **by}


def exchange_snapshot(rank, mb=64):
    """One card exchange (`collectives.card_gather`, the form of a layer's
    gather) of `mb` MB a rank between memory snapshots: the allocator's
    bytes by block state before it, with its result alive, after the
    result is freed, and after the rank collects its IPC blocks and
    empties its cache; with the peak allocated during the exchange."""
    from repro_torch.core import collectives
    from repro_torch.sharding.specs import NamedSharding, P
    dev = rank.device
    rm = rank.mesh(MeshShape((rank.size,), ("data",)))
    out = {"before": _memory()}
    torch.cuda.reset_peak_memory_stats(dev)
    x = torch.full((mb * 2**18,), float(rank.rank), device=dev)
    plan = mesh.card_plan(x, NamedSharding(rm.shape, P("data")), rm)
    full = collectives.card_gather([plan])[0]
    torch.cuda.synchronize(dev)
    out["peak_allocated"] = torch.cuda.max_memory_allocated(dev)
    out["with_result"] = _memory()
    ok = bool((full.view(rank.size, -1)[:, 0].cpu()
               == torch.arange(rank.size).float()).all())
    del full, x, plan
    out["freed"] = _memory()
    torch.cuda.ipc_collect()
    torch.cuda.empty_cache()
    out["collected"] = _memory()
    out["ok"] = ok
    return out


def tp_ops(rank):
    """`collectives.copy_to`, `reduce_from` and `gather_leaves` over a
    4-rank "model" axis of the (2, 4) mesh: values, gradients and counted
    kinds. Rank r on the axis holds x = arange(6) + r and weighs the
    result by r + 1; the gathered leaf is (8, 3), two rows a rank."""
    from repro_torch.core import collectives as co
    from repro_torch.sharding.specs import WHOLE, NamedSharding, P
    rm = rank.mesh(MeshShape((2, 4), ("data", "model")))
    ax = rm.axis("model")
    r = ax.index
    w = torch.full((6,), float(r + 1))
    out = {}
    mesh.reset_collective_counts()
    x = (torch.arange(6.0) + r).requires_grad_(True)
    y = co.copy_to(x, ax)
    (y * w).sum().backward()
    out["f"] = (_np(y.detach()), _np(x.grad))
    x = (torch.arange(6.0) + r).requires_grad_(True)
    y = co.reduce_from(x, ax)
    (y * w).sum().backward()
    out["g"] = (_np(y.detach()), _np(x.grad))
    shard = (torch.arange(6.0).reshape(2, 3) + 10 * r).requires_grad_(True)
    plan = mesh.leaf_plan((2, 3), NamedSharding(rm.shape, P("model")),
                          WHOLE, rm, sum_axes=("model",))
    full, = co.gather_leaves([plan], [shard])
    (full * torch.full((8, 3), float(r + 1))).sum().backward()
    out["gather"] = (_np(full.detach()), _np(shard.grad))
    out["kinds"] = mesh.collective_counts()["kinds"]
    return out


def layer_grads(rank, arch, cfg_kw, mesh_shape, names, batch, params,
                profile):
    """The loss and gradients of `model.loss` on the whole `batch` (numpy)
    from the whole `params` (numpy), computed on the rank's stored shards
    under `profile`'s rules, one layer gathered at a time
    (`models.parallel`), every rank on the whole batch: rank 0 returns
    (loss, the gradients gathered whole, numpy, in tree order, the block
    kinds that ran cut)."""
    from repro_torch.launch.train import value_and_grad
    from repro_torch.models import parallel
    from repro_torch.sharding import specs as sh
    from repro_torch.tree import tree_leaves
    model = build(arch, True, **cfg_kw)
    rm = rank.mesh(MeshShape(mesh_shape, names))
    with sh.profile_ctx(profile):
        specs = model.param_specs()
        p_sh = sh.tree_shardings(specs, rm.shape)
        view = parallel.Parallel(model.cfg, rm, p_sh, specs)
    p = mesh.shard_tree(convert.params_from_jax(params, rank.device), p_sh,
                        rm)
    b = {k: torch.as_tensor(v) for k, v in batch.items()}
    with parallel.use(view):
        (loss, _), g = value_and_grad(model.loss, p, b)
    whole = tree_leaves(_np(mesh.gather_tree(g, p_sh, rm)))
    return (float(loss), whole, sorted(view.ran)) if rank.rank == 0 else None


def ep_ops(rank):
    """`collectives.all_to_all` over the 4-rank "model" axis of the (2, 4)
    mesh: rank r on the axis holds x[p] = 10 r + p + arange(3) / 4 for
    p < 4 and weighs its result by r + 1; values, the gradient and the
    counted kinds and bytes."""
    from repro_torch.core import collectives as co
    rm = rank.mesh(MeshShape((2, 4), ("data", "model")))
    ax = rm.axis("model")
    r = ax.index
    mesh.reset_collective_counts()
    x = (10.0 * r + torch.arange(4.0)[:, None]
         + torch.arange(3.0)[None] / 4).requires_grad_(True)
    y = co.all_to_all(x, ax, 0, 1)
    (y * (r + 1)).sum().backward()
    counts = mesh.collective_counts()
    return {"y": _np(y.detach()), "grad": _np(x.grad),
            "kinds": counts["kinds"], "kind_bytes": counts["kind_bytes"]}


def ep_moe(rank, arch, cfg_kw, params, x, w):
    """`moe.moe_ffn` under the expert-parallel view on the (2, 4) mesh
    ("model" carrying rows and experts, `specs.ep_axis`): rank (d, m)
    holds row 4 d + m of the global `x` (numpy (8, S, D)) and the "model"
    block m of the experts of `params` (one layer's MoE leaves, numpy),
    and weighs its output by `w` (numpy, like `x`); the aux loss takes its
    token means over the global batch. Returns the rank's output, the aux
    loss, and the gradients of sum(out * w) + aux: its row of x, the
    router's summed over the world, its experts' summed over "data"."""
    from repro_torch.core import collectives as co
    from repro_torch.launch.train import _token_mean
    from repro_torch.models import moe
    from repro_torch.sharding import specs as sh
    cfg = build(arch, True, **cfg_kw).cfg
    rm = rank.mesh(MeshShape((2, 4), ("data", "model")))
    ax = rm.axis("model")
    row = rm.coords["data"] * 4 + ax.index
    with sh.profile_ctx("moe"):
        assert sh.ep_axis(rm.shape) == "model"
    E = params["experts_gate"].shape[0]
    n = E // ax.size
    p = {k: (v[ax.index * n:(ax.index + 1) * n]
             if k.startswith("experts_") else v) for k, v in params.items()}
    p = tree_map(lambda v: torch.tensor(v).requires_grad_(True), p)
    xr = torch.tensor(x[row:row + 1]).requires_grad_(True)

    class View:
        def all_to_all(self, t, split_dim, concat_dim):
            return co.all_to_all(t, ax, split_dim, concat_dim)

    world = rm.axis(rm.names)
    mean = functools.partial(_token_mean, share=1 / 8, j=0, slots=1,
                             axis=world)
    mesh.reset_collective_counts()
    out, aux = moe.moe_ffn(p, cfg, xr, mean, ep=View())
    ((out * torch.tensor(w[row:row + 1])).sum() + aux).backward()
    kinds = mesh.collective_counts()["kinds"]
    router = tree_map(lambda v: co.all_reduce_sum(v.grad.clone(), world),
                      p["router"])
    data = rm.axis("data")
    experts = {k: co.all_reduce_sum(p[k].grad.clone(), data)
               for k in p if k.startswith("experts_")}
    return {"row": row, "out": _np(out.detach()),
            "aux": float(aux.detach()),
            "x_grad": _np(xr.grad), "router_grad": _np(router),
            "expert_grads": _np(experts), "block": ax.index,
            "kinds": kinds}


def cp_attention(rank, arch, cfg_kw, params, x, w, window, runs=None):
    """`attention.attention` with the rank's block of positions (the
    "model" axis of the (4, 2) mesh carrying the sequence; every "data"
    rank the same): the sequence of `x` (numpy (B, S, D)) is the runs of
    lengths `runs` one after another (None: one run, the tokens; two: a
    vision prefix's patches, then the tokens), and rank m holds block m
    of each run (`parallel.SeqBlock`), weighing its output by those
    positions of `w`; the mask is causal with `window` (0: none) at the
    absolute positions. Returns the absolute positions the rank holds,
    its output, its positions' gradient of x and the parameters'
    gradients summed over "model"."""
    from repro_torch.core import collectives as co
    from repro_torch.models import attention as attn
    from repro_torch.models.parallel import SeqBlock
    cfg = build(arch, True, **cfg_kw).cfg
    rm = rank.mesh(MeshShape((4, 2), ("data", "model")))
    ax = rm.axis("model")
    B, S, _ = x.shape
    runs = runs or [S]

    class View:
        seq_axis = ax

        def gather_seq(self, *xs):
            return co.gather_seq(xs, ax, dim=1)

    blk = SeqBlock(View(), [n // ax.size for n in runs], "cpu")
    mine = blk.q_pos.numpy()
    n = len(mine)
    p = tree_map(lambda v: torch.tensor(v).requires_grad_(True), params)
    xr = torch.tensor(x[:, mine]).requires_grad_(True)
    positions = blk.q_pos.to(torch.int32)[None].expand(B, n)
    mask = (None if cfg.attn_impl == "chunked"
            else attn.make_attention_mask(n, S, window=window,
                                          q_pos=blk.q_pos, k_pos=blk.k_pos))
    mesh.reset_collective_counts()
    out = attn.attention(p, cfg, xr, positions=positions, mask=mask,
                         window=window if mask is None else 0, seq=blk)
    (out * torch.tensor(w[:, mine])).sum().backward()
    kinds = mesh.collective_counts()["kinds"]
    grads = tree_map(lambda v: co.all_reduce_sum(v.grad.clone(), ax), p)
    return {"block": mine.tolist(), "out": _np(out.detach()),
            "x_grad": _np(xr.grad), "grads": _np(grads), "kinds": kinds}


def donated(rank, arch, cfg_kw, mesh_shape, names, batch, params, opt):
    """One sharded train step on the rank's shards of `params` (numpy)
    under `opt` ("sgd" with momentum or "adamw"), its optimizer recording
    the gradient leaves the step hands it: whether the returned params
    and optimizer state are the very tensors given, and whether they
    equal, bit for bit, the functional update (`opt.update` then
    `apply_updates`) of copies of the shards taken before the step with
    those gradients."""
    from repro_torch.launch.train import make_sharded_train_step
    from repro_torch.optim import optimizers
    from repro_torch.tree import tree_leaves, tree_unflatten
    deterministic_f32()
    model = build(arch, True, **cfg_kw)
    rm = rank.mesh(MeshShape(mesh_shape, names))
    base = (optimizers.sgd(1e-2, momentum=0.9) if opt == "sgd"
            else optimizers.adamw(3e-4, weight_decay=0.01))
    seen = []

    def update(g, state, p):
        seen.append(g.clone())
        return base.update(g, state, p)

    o = optimizers.Optimizer(base.init, update)
    b = {k: torch.as_tensor(v) for k, v in batch.items()}
    specs = {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
             for k, v in b.items()}
    step = make_sharded_train_step(model, o, rm, specs)
    p_sh, _, b_sh = step.shardings
    p = mesh.shard_tree(convert.params_from_jax(params, rank.device), p_sh,
                        rm)
    s = o.init(p)
    # a first step, so AdamW's moments and SGD's momentum are not zeros
    p, s, _ = step(p, s, mesh.shard_tree(b, b_sh, rm))
    seen.clear()
    p0, s0 = tree_map(torch.clone, p), tree_map(torch.clone, s)
    p1, s1, _ = step(p, s, mesh.shard_tree(b, b_sh, rm))
    same = all(a is c for a, c in zip(tree_leaves(p1) + tree_leaves(s1),
                                      tree_leaves(p) + tree_leaves(s)))
    u, want_s = base.update(tree_unflatten(p0, seen), s0, p0)
    want_p = optimizers.apply_updates(p0, u)
    return {"same_tensors": same,
            "params_bitwise": _same(p1, want_p),
            "state_bitwise": _same(s1, want_s),
            "leaves": len(seen)}


def tp_mla(rank, arch, cfg_kw, params, x, w, ckv, kpe, index):
    """MLA cut by heads over the "model" axis of the (4, 2) mesh (every
    "data" rank the same): `mla.mla_attention` on the whole `x` (numpy
    (B, S, D)) weighted by `w`, with the rank's slices of one layer's MLA
    `params` (numpy) by `specs.compute_layout` under "tp"; then the
    absorbed `mla.mla_decode` of x[:, :1] against the caches `ckv` /
    `kpe` (numpy (B, cap, 1, r) / (B, cap, 1, rope)) at `index`. Returns
    the rank's output and x's gradient (both whole), each leaf's gradient
    (its slice; a whole leaf's summed over "model"), the layouts, the
    decode output and caches, and the counted kinds."""
    from repro_torch.core import collectives as co
    from repro_torch.models import mla
    from repro_torch.sharding import specs as sh
    cfg = build(arch, True, **cfg_kw).cfg
    rm = rank.mesh(MeshShape((4, 2), ("data", "model")))
    ax = rm.axis("model")
    with sh.profile_ctx("tp"):
        lay = {k: sh.compute_layout(cfg, rm.shape, f"layers/attn/{k}/kernel",
                                    v["kernel"].shape, ax.index)
               for k, v in params.items()}

    def cut(v, lay):
        if lay.dim is None:
            return v
        idx = [slice(None)] * v.ndim
        idx[lay.dim] = slice(*lay.ranges[0])
        return v[tuple(idx)]

    p = {k: {"kernel": torch.tensor(cut(v["kernel"], lay[k]))
             .requires_grad_(True)} for k, v in params.items()}

    class View:
        size, index = ax.size, ax.index

        def f(self, t):
            return co.copy_to(t, ax)

        def g(self, t):
            return co.reduce_from(t, ax)

    B, S, _ = x.shape
    xr = torch.tensor(x).requires_grad_(True)
    positions = torch.arange(S, dtype=torch.int32)[None].expand(B, S)
    mesh.reset_collective_counts()
    out = mla.mla_attention(p, cfg, xr, positions=positions, tp=View())
    (out * torch.tensor(w)).sum().backward()
    kinds = mesh.collective_counts()["kinds"]
    grads = {k: (v["kernel"].grad if lay[k].dim is not None
                 else co.all_reduce_sum(v["kernel"].grad.clone(), ax))
             for k, v in p.items()}
    with torch.no_grad():
        c, k_ = torch.tensor(ckv), torch.tensor(kpe)
        dec, c, k_ = mla.mla_decode(
            p, cfg, xr[:, :1].detach(), positions=torch.full(
                (B, 1), index, dtype=torch.int32), c_kv_cache=c,
            k_pe_cache=k_, cache_index=torch.tensor(index), tp=View())
    return {"out": _np(out.detach()), "x_grad": _np(xr.grad),
            "grads": _np(grads), "layouts": {k: tuple(v) for k, v in
                                             lay.items()},
            "decode": _np(dec), "ckv": _np(c), "kpe": _np(k_),
            "kinds": kinds}


def stand_in_state(model, B, cap, index, seed, device, card=False):
    """A decode state of B rows and `cap` positions at `index`: its KV
    caches ("layers" and "shared") hold standard normal entries at
    positions [0, index) and zeros beyond, drawn by numpy's
    `default_rng(seed)` (or, `card`, by a generator on `device` seeded
    with `seed`: the same draw on every process of one card); its other
    leaves are as `init_decode_state` makes them."""
    from repro_torch.tree import tree_leaves
    state = model.init_decode_state(B, cap, prefill_len=index,
                                    device=device)
    rng = None if card else np.random.default_rng(seed)
    g = None
    if card:
        g = torch.Generator(device=device)
        g.manual_seed(int(seed))
    for key in ("layers", "shared"):
        for leaf in tree_leaves([{n: st[n] for n in ("k", "v") if n in st}
                                 for st in state.get(key, [])]):
            shape = (leaf.shape[0], index) + tuple(leaf.shape[2:])
            draw = (torch.randn(shape, generator=g, device=device) if card
                    else torch.as_tensor(rng.standard_normal(shape,
                                                             np.float32)))
            leaf[:, :index] = draw.to(leaf.device, leaf.dtype)
    return state


def decode_cut(rank, arch, cfg_kw, mesh_shape, names, B, cap, index, tokens,
               *, params=None, seed=0, reduced=True, init="host",
               out_dir=None):
    """The sharded decode step (`launch.serve.make_sharded_serve_step`)
    fed `tokens` (numpy (steps, B)), one a step, from the stand-in state
    of B rows and `cap` positions at `index` (`stand_in_state`, seed
    `seed` + 1), twice from the same state (params as `train` takes
    them). Returns (the rank's rows (start, stop), their logits of every
    step (steps, rows, V), its KV cache shards after the steps as
    {state path: array} (`_ship`), the report): each step's seconds, the
    cut of each cache ("caches"), whether every state leaf had its stored
    shard's shape after each step and every cache was the tensor it was
    written in ("cache_in_place"), whether the repeat gave the same
    logits and caches bit for bit ("repeat_bitwise"), the bytes a `take`
    of each leaf gathers ("gathered_bytes") and the stationary blocks'
    products, each (form, whether the ranks holding its block split the
    batch) ("stills")."""
    from repro_torch.launch.serve import gather_logits, make_sharded_serve_step
    from repro_torch.tree import tree_leaves
    deterministic_f32()
    dev = rank.device
    model = build(arch, reduced, **cfg_kw)
    rm = rank.mesh(MeshShape(mesh_shape, names))
    st_specs = model.decode_state_specs(B, cap)
    step = make_sharded_serve_step(model, rm, st_specs,
                                   model.decode_token_specs(B))
    p_sh, st_sh, t_sh = step.shardings
    t_draw = time.perf_counter()
    p = _shards(rank, model, params, seed, p_sh, rm, init)
    _compact(rank, init)
    first = mesh.shard_tree(stand_in_state(model, B, cap, index, seed + 1,
                                           dev, card=init == "card"),
                            st_sh, rm)
    draw_s = time.perf_counter() - t_draw
    shapes = [s.shard_shape(tuple(x.shape)) for x, s in zip(
        tree_leaves(st_specs), tree_leaves(st_sh))]
    keys = [(k, n) for k in sorted(step.parallel.caches) for n in ("k", "v")]

    def leaf(st, key, n):
        kind, i = key.split("/")
        return st[kind][int(i)][n]
    toks = torch.as_tensor(tokens, device=dev).long()
    drows = t_sh.index((B, 1), rm.coords)[0]
    runs = []
    for run in range(2):
        # the first run steps a copy, the repeat the shards themselves
        state = (tree_map(lambda t: t.clone(), first) if run == 0
                 else first)
        _release(rank)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        mesh.reset_collective_counts()
        start, t_run = _launches(), time.perf_counter()
        in_place = True
        outs, secs = [], []
        with torch.no_grad():
            for i in range(toks.shape[0]):
                t0 = time.perf_counter()
                lg, new = step(p, state, mesh.shard(toks[i][:, None], t_sh,
                                                    rm))
                _sync(rank)
                secs.append(time.perf_counter() - t0)
                in_place &= all(leaf(new, k, n) is leaf(state, k, n)
                                for k, n in keys)
                in_place &= [tuple(x.shape) for x in tree_leaves(new)
                             if isinstance(x, torch.Tensor)] == [
                    s for x, s in zip(tree_leaves(new), shapes)
                    if isinstance(x, torch.Tensor)]
                state = new
                outs.append(lg[:, 0])
            report = _report(rank, start, t_run)
            logits = torch.stack([gather_logits(lg, step.parallel)
                                  for lg in outs]).float()
        caches = {f"{k}/{n}": leaf(state, k, n) for k, n in keys}
        runs.append((logits, caches, in_place, secs, report))
    (logits, caches, in_place, secs, report), again = runs[0], runs[1]
    report["repeat_bitwise"] = bool(torch.equal(logits, again[0]) and all(
        torch.equal(caches[k], again[1][k]) for k in caches))
    report["cache_in_place"] = bool(in_place and again[2])
    report["step_seconds"] = secs
    report["draw_seconds"] = draw_s
    report["caches"] = {k: (c.kind, c.offset, c.span, c.heads)
                        for k, c in step.parallel.caches.items()}
    report["cut"] = sorted(step.parallel.ran)
    report["gathered_bytes"] = step.parallel.gathered_bytes()
    report["stills"] = {
        prefix: {leaf: (st.form, st.split is not None)
                 for leaf, st in cuts.items()}
        for prefix, cuts in step.parallel.stills.items()}
    paths = sorted(caches)
    shipped = _ship(rank, [caches[k].float().cpu().numpy() for k in paths],
                    out_dir, "caches")
    return ((drows.start, drows.stop), logits.cpu().numpy(),
            (paths, shipped), report)
