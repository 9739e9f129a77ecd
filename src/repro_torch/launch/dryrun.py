"""Multi-pod dry-run on the meta device: run rank 0's program of every
(architecture x input shape) on the reference's production meshes, count
what it does, and derive the roofline terms (port of
`repro.launch.dryrun`).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-9b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh pod
    PYTHONPATH=src python -m repro_torch.launch.dryrun --fl hfl --arch phi3-mini-3.8b

The reference lowers and compiles each step for 256 or 512 placeholder
TPU devices and reads XLA's cost and memory analyses. Here the model is
built on the meta device (shapes, no storage), and rank 0 of the 16x16
or 2x16x16 mesh (`launch.mesh.dry_run_mesh`) runs the sharded step of
`launch/train.py` or `launch/serve.py`, or the mesh `fl_train_step` of
`core/trainer.py`, inside `collectives.dry_run()`: no collective touches
a process group, each counts its kind and result bytes. No card, no
process group and no `XLA_FLAGS` are needed. What the run measures:

* flops_per_device: `torch.utils.flop_counter.FlopCounterMode` over the
  step (matmuls, convolutions and attention, forward and backward).
* bytes_per_device: the operand and result bytes of every aten op that
  makes a tensor, summed. This is unfused traffic, an upper bound on what
  a fused program moves; the reference's XLA count is after fusion.
* memory: argument bytes are the rank's shards of the step's inputs,
  exactly; output bytes its results'; temp bytes the most bytes alive at
  once of the tensors the step made, each aten op's new outputs counted
  from creation until Python frees them (no allocator rounding); peak =
  argument + temp, as the reference's.
* collectives: from the rank's counts (`launch.roofline.collective_bytes`):
  each layer's weight all-gathers and gradient reduce-scatters and, under
  the tp profile, the activation all-reduces over "model" of Megatron's
  layout, as each rank computes its "model" shard of each layer
  (`models.parallel`); under the single-pod moe profile the experts'
  all-to-alls (each rank gathers its E/M experts of a layer); under the
  multi-pod fsdp profile the keys' and values' all-gathers over the
  sequence and the vision prefix's and encoder's positions (context
  parallelism: the rank computes its block of positions). A decode step
  keeps its KV caches cut as stored and computes each dense product whose
  weight is stored with one dim cut where the weight lies (GQA attention,
  the dense MLPs, Mamba2's projections under fsdp and moe): it moves the
  tokens' activations (the partial products' sums, the output columns'
  and attention outputs' all-gathers, Mamba2's all-to-all), not those
  weights. Still gathered whole or cut after a gather, ROADMAP A.19b:
  MoE experts in decode, MLA's projections and caches, xLSTM, the
  encoder, cross-attention and the vision projection.

`scan_cost_corrected` is always false and the reference's
`_extrapolate_costs` has no counterpart: it corrects XLA's cost analysis
counting a `lax.scan` body once, while the port's layers run as a Python
loop that the counters see in full. `lower_s` is the run's seconds;
`compile_s` is 0.0 (nothing is compiled). Results are written as JSON
under experiments/dryrun_torch/ (git-ignored).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
import weakref
from typing import Any, Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs.base import INPUT_SHAPES
from repro_torch.configs.registry import combos, get_config
from repro_torch.core import collectives
from repro_torch.launch import roofline as rl
from repro_torch.launch import serve as serve_mod
from repro_torch.launch import train as train_mod
from repro_torch.launch.mesh import (dry_run_mesh, make_production_mesh,
                                     shard_tree)
from repro_torch.models.model import build_model
from repro_torch.optim import optimizers
from repro_torch.sharding import specs as sh
from repro_torch.tree import tree_leaves, tree_map

# the reference's dry-run defaults: online-softmax (chunked) attention and
# chunked mLSTM, the production paths; --opt attn_impl=einsum etc. selects
# the quadratic forms
DEFAULT_OVERRIDES = {"attn_impl": "chunked", "mlstm_impl": "chunked"}

OUT_DIR = "experiments/dryrun_torch"


def _apply_overrides(cfg, opts: Optional[str]):
    cfg = cfg.with_updates(**DEFAULT_OVERRIDES)
    if not opts:
        return cfg
    upd = {}
    fields = {f.name: f for f in dataclasses.fields(cfg)}
    for kv in opts.split(","):
        k, v = kv.split("=")
        kind = fields[k].type
        if kind in ("bool", bool):
            upd[k] = v.lower() in ("1", "true")
        elif kind in ("int", int):
            upd[k] = int(v)
        elif kind in ("float", float):
            upd[k] = float(v)
        else:
            upd[k] = v
    return cfg.with_updates(**upd)


def _nbytes(tree) -> int:
    if isinstance(tree, tuple):
        tree = list(tree)
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def _storage(t):
    return t.untyped_storage()._cdata


class _Traffic(TorchDispatchMode):
    """Operand + result bytes of every aten op that makes a tensor, and
    the most bytes alive at once of the tensors made. An output that
    shares an input's storage (a view, `detach`) makes nothing: it is
    neither traffic nor a second copy alive (remat's recompute and the
    autograd engine detach what they keep)."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.live = 0
        self.peak = 0

    def _free(self, n):
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        ins = [t for t in tree_leaves(list(args) + list((kwargs or {})
                                                        .values()))
               if isinstance(t, torch.Tensor)]
        outs = [t for t in (out if isinstance(out, (tuple, list))
                            else (out,)) if isinstance(t, torch.Tensor)]
        shared = {_storage(t) for t in ins}
        made = [t for t in outs if t._base is None
                and _storage(t) not in shared]
        if made:
            self.bytes += _nbytes(ins) + _nbytes(outs)
            for t in made:
                n = t.numel() * t.element_size()
                self.live += n
                weakref.finalize(t, self._free, n)
            self.peak = max(self.peak, self.live)
        return out


def _measure(fn):
    """(result of `fn()`, {"flops", "bytes", "temp_bytes", "counts",
    "seconds"}) of a run under count-only collectives."""
    collectives.reset_collective_counts()
    flops = FlopCounterMode(display=False)
    traffic = _Traffic()
    t0 = time.perf_counter()
    with flops, traffic:
        out = fn()
    return out, {"flops": float(flops.get_total_flops()),
                 "bytes": float(traffic.bytes), "temp_bytes": traffic.peak,
                 "counts": collectives.collective_counts(),
                 "seconds": time.perf_counter() - t0}


def _mesh_name(multi_pod):
    return "2x16x16" if multi_pod else "16x16"


def run_step(cfg, kind: str, B: int, S: int, mesh) -> Dict[str, Any]:
    """Rank 0's sharded step of `kind` ("train", "prefill" or "decode")
    for a global (B, S) input on `mesh` (a `MeshShape`), on the meta
    device under count-only collectives: {"params" (the model's count),
    "argument_bytes", "output_bytes", "flops", "bytes", "temp_bytes",
    "counts", "seconds"}."""
    with collectives.dry_run():
        rank = dry_run_mesh(mesh)
        model = build_model(cfg)
        p_specs = model.param_specs()
        if kind == "train":
            opt = optimizers.adamw(1e-4)
            specs = model.train_batch_specs(B, S)
            step = train_mod.make_sharded_train_step(model, opt, rank, specs)
            p_sh, o_sh, b_sh = step.shardings
            args = (shard_tree(p_specs, p_sh, rank),
                    shard_tree(opt.init(p_specs), o_sh, rank),
                    shard_tree(specs, b_sh, rank))
        elif kind == "prefill":
            specs = model.train_batch_specs(B, S)
            specs.pop("labels")
            step = serve_mod.make_sharded_prefill_step(model, rank, specs)
            p_sh, b_sh = step.shardings
            args = (shard_tree(p_specs, p_sh, rank),
                    shard_tree(specs, b_sh, rank))
        else:
            state = model.decode_state_specs(B, S)
            tok = model.decode_token_specs(B)
            step = serve_mod.make_sharded_serve_step(model, rank, state, tok)
            p_sh, st_sh, t_sh = step.shardings
            args = (shard_tree(p_specs, p_sh, rank),
                    shard_tree(state, st_sh, rank),
                    shard_tree(tok, t_sh, rank))
        out, m = _measure(lambda: step(*args))
    m.update(params=sum(p.numel() for p in tree_leaves(p_specs)),
             argument_bytes=_nbytes(list(args)), output_bytes=_nbytes(out))
    return m


def lower_and_compile(arch: str, shape_name: str, *, multi_pod=False,
                      opts: Optional[str] = None, verbose=True
                      ) -> Dict[str, Any]:
    """Rank 0's step of `arch` at `shape_name` on the production mesh,
    measured on the meta device. Returns the reference's result keys."""
    cfg = _apply_overrides(get_config(arch), opts)
    shape = INPUT_SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod)
    chips = mesh.size
    B, S = shape.global_batch, shape.seq_len
    m = run_step(cfg, shape.kind, B, S, mesh)
    arg_bytes, temp = m["argument_bytes"], m["temp_bytes"]
    roof = rl.analyze(m["flops"], m["bytes"], m["counts"], chips,
                      float(arg_bytes + temp))
    n_params = m["params"]
    n_active = rl.active_param_count(cfg, n_params)
    tokens = B * S if shape.kind in ("train", "prefill") else B
    model_flops = (6.0 if shape.kind == "train" else 2.0) * n_active * tokens
    result = {
        "arch": arch, "shape": shape_name, "mesh": _mesh_name(multi_pod),
        "chips": chips, "opts": opts or "", "kind": shape.kind,
        "params": int(n_params), "active_params": int(n_active),
        "model_flops_total": float(model_flops),
        "model_flops_per_device": float(model_flops / chips),
        "scan_cost_corrected": False,
        "lower_s": round(m["seconds"], 2), "compile_s": 0.0,
        "memory": {"argument_bytes": int(arg_bytes),
                   "output_bytes": int(m["output_bytes"]),
                   "temp_bytes": int(temp),
                   "peak_bytes": int(arg_bytes + temp)},
        "roofline": roof.to_dict(),
        "useful_flops_ratio": float(model_flops / chips
                                    / max(1.0, roof.flops_per_device)),
        "ok": True,
    }
    if verbose:
        _print(result, f"[{arch} x {shape_name} x {result['mesh']}"
                       f"{' ' + opts if opts else ''}]")
    return result


def lower_fl(arch: str, strategy: str, *, multi_pod=False, seq_len=512,
             per_client_batch=4, local_steps=1, afl_mode="fedavg",
             verbose=True) -> Dict[str, Any]:
    """Rank 0's `fl_train_step` of `strategy` over `arch`, one client on
    each "data" (x "pod") slice of the production mesh, measured on the
    meta device. As the reference's, it takes the config as registered
    (no overrides) under the default "tp" profile."""
    from repro_torch.core.fl_types import FLConfig
    from repro_torch.core.trainer import FederatedTrainer, fl_client_axes

    cfg = get_config(arch)
    mesh = make_production_mesh(multi_pod=multi_pod)
    chips = mesh.size
    ca = fl_client_axes(mesh)
    clients = sh.axis_size(mesh, ca)
    fl = FLConfig(strategy=strategy, num_clients=clients,
                  num_groups=mesh.shape["pod"] if multi_pod else 2,
                  local_steps=local_steps, lr=0.01, afl_mode=afl_mode)
    with sh.profile_ctx("tp"), collectives.dry_run():
        rank = dry_run_mesh(mesh)
        trainer = FederatedTrainer(build_model(cfg), fl, rank)
        state = trainer.shard_state(trainer.state_specs())
        specs = trainer.fl_batch_specs(seq_len, per_client_batch)
        b_sh = tree_map(lambda s: sh.NamedSharding(mesh, sh.fit_spec(
            s.shape, sh.P(ca if len(ca) > 1 else ca[0]), mesh)), specs)
        batch = shard_tree(specs, b_sh, rank)
        weights = torch.empty((clients,), dtype=torch.float32, device="meta")
        part = torch.empty((clients,), dtype=torch.bool, device="meta")
        _, m = _measure(
            lambda: trainer.fl_train_step(state, batch, weights, part))
    arg_bytes = _nbytes([state, batch, weights, part])
    roof = rl.analyze(m["flops"], m["bytes"], m["counts"], chips,
                      float(arg_bytes + m["temp_bytes"]))
    result = {
        "arch": arch,
        "fl_strategy": (strategy if afl_mode == "fedavg"
                        else f"{strategy}-{afl_mode}"),
        "mesh": _mesh_name(multi_pod), "chips": chips, "clients": clients,
        "seq_len": seq_len, "per_client_batch": per_client_batch,
        "lower_s": round(m["seconds"], 2), "compile_s": 0.0,
        "memory": {"peak_bytes": int(arg_bytes + m["temp_bytes"])},
        "roofline": roof.to_dict(),
        "ok": True,
    }
    if verbose:
        _print(result, f"[FL {result['fl_strategy']} x {arch} x "
                       f"{result['mesh']} clients={clients}]")
    return result


def _print(result, head):
    r = result["roofline"]
    print(head)
    print(f"  run={result['lower_s']:.1f}s per-device: "
          f"flops={r['flops_per_device'] / 1e12:.3f}T "
          f"bytes={r['bytes_per_device'] / 1e9:.2f}GB "
          f"coll={r['collective_bytes_per_device'] / 1e9:.3f}GB "
          f"({r['collective_count']} ops)")
    print(f"  terms: compute={r['compute_s'] * 1e3:.2f}ms "
          f"memory={r['memory_s'] * 1e3:.2f}ms "
          f"collective={r['collective_s'] * 1e3:.2f}ms "
          f"-> {r['dominant']}-bound; "
          f"peak/device={result['memory']['peak_bytes'] / 1e9:.2f}GB",
          flush=True)


def _out_path(outdir, result, tag=""):
    if "fl_strategy" in result:
        name = f"fl_{result['fl_strategy']}_{result['arch']}_{result['mesh']}"
    else:
        name = f"{result['arch']}_{result['shape']}_{result['mesh']}"
    if tag:
        name += f"_{tag}"
    return os.path.join(outdir, name.replace("/", "-") + ".json")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", choices=["pod", "multipod", "both"],
                    default="pod")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--fl", choices=["hfl", "afl", "cfl"])
    ap.add_argument("--fl-mode", default="fedavg",
                    choices=["fedavg", "gossip"])
    ap.add_argument("--fl-local-steps", type=int, default=1)
    ap.add_argument("--opt", help="cfg overrides k=v,k=v")
    ap.add_argument("--tag", default="")
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)

    meshes = {"pod": [False], "multipod": [True], "both": [False, True]}
    if args.fl:
        jobs = [("fl", args.arch, args.fl, mp) for mp in meshes[args.mesh]]
    elif args.all:
        jobs = [("std", a, s, mp) for a, s in combos()
                for mp in meshes[args.mesh]]
    else:
        jobs = [("std", args.arch, args.shape, mp)
                for mp in meshes[args.mesh]]

    failures = 0
    for kind, arch, what, mp in jobs:
        if kind == "fl":
            fs = what if args.fl_mode == "fedavg" else f"{what}-{args.fl_mode}"
            probe = {"arch": arch, "fl_strategy": fs, "mesh": _mesh_name(mp)}
        else:
            probe = {"arch": arch, "shape": what, "mesh": _mesh_name(mp)}
        ppath = _out_path(args.out, probe, args.tag)
        if not args.force and os.path.exists(ppath):
            try:
                with open(ppath) as f:
                    if json.load(f).get("ok"):
                        print(f"skip (cached): {ppath}", flush=True)
                        continue
            except (OSError, ValueError):
                pass
        try:
            if kind == "fl":
                result = lower_fl(arch, what, multi_pod=mp,
                                  afl_mode=args.fl_mode,
                                  local_steps=args.fl_local_steps)
            else:
                result = lower_and_compile(arch, what, multi_pod=mp,
                                           opts=args.opt)
        except Exception as e:
            traceback.print_exc()
            result = dict(probe, ok=False, error=str(e)[:2000])
            failures += 1
        path = _out_path(args.out, result, args.tag)
        if result.get("ok") or not os.path.exists(path) or args.force:
            with open(path, "w") as f:
                json.dump(result, f, indent=1)
        print(f"  -> {path}\n", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
