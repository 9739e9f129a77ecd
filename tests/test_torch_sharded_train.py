"""The zoo's sharded training step (`repro_torch.launch.train`'s mesh half)
on the CPU.

* Shardings: every `specs.tree_shardings`, `train.train_state_shardings`
  and `train.batch_shardings` of every zoo config's `reduced()` tree
  under its profile, on a 4x2 and a 2x2x2 mesh, equal the reference's
  `NamedSharding`s: the spec, the shard shape and the slice each device
  holds (the reference's run in a subprocess with 8 fake devices, as
  tests/test_sharding_and_dryrun.py:63 runs it).
* The step: `make_sharded_train_step` on 8 gloo ranks laid out (data 4,
  model 2) equals the port's single-device `make_train_step` and, from
  the reference's init (`convert.params_from_jax`), the reference's: loss
  and grad-norm within 1e-5 relative, params after one SGD step within
  1e-6 absolute, for phi3-mini under "tp" and zamba2 under "fsdp"
  (reduced, float32); qwen3-moe's aux loss is the global batch's; and
  under grad_accum each rank's rows weigh as the single-device step's
  micro-batches do, with labels padded unevenly, with micro-batches
  smaller than a rank's rows, with a rank's rows straddling two
  micro-batches (12 rows under grad_accum 3), and with MoE's aux loss.
  Each issues all-gathers and reduce-scatters. Under "tp" each rank
  computes its "model" shard of every layer (`models.parallel`), Mamba2's
  heads too, with remat and without it (the backward pass then gathers
  each layer again).

The reference's Mamba2 gradient is NaN where a chunk's decay overflows
(tests/test_torch_train.py); zamba2 is held to it with that module's
mended `ssd_chunked`. One `launch.mesh.World` of 8 CPU ranks serves the
module (~4 s to start); the ranks run `torch_sharded_cases.train`."""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.configs.registry import get_config as ref_get_config  # noqa: E402
from repro.launch import train as ref_train  # noqa: E402
from repro.models import ssm as ref_ssm  # noqa: E402
from repro.models.model import build_model as ref_build  # noqa: E402
from repro.optim import optimizers as ref_opt  # noqa: E402
from repro_torch.configs.registry import ARCH_IDS, get_config  # noqa: E402
from repro_torch.convert import params_from_jax, params_to_numpy  # noqa: E402,E501
from repro_torch.device import generator  # noqa: E402
from repro_torch.launch import mesh  # noqa: E402
from repro_torch.launch import train as port_train  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.optim import optimizers  # noqa: E402
from repro_torch.sharding import specs as sh  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

import torch_sharded_cases as cases  # noqa: E402
from test_torch_train import _ssd_masked_twice  # noqa: E402

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
REL = 1e-5
PARAM_ATOL = 1e-6
MESH = ((4, 2), ("data", "model"))
MESHES = {"4x2": MESH, "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
B, S = 8, 64

_REFERENCE = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import sys, json
    sys.path.insert(0, {src!r})
    import jax
    from repro.configs.registry import ARCH_IDS, get_config
    from repro.launch import mesh as mesh_mod, train as tm
    from repro.models.model import build_model
    from repro.optim import optimizers
    from repro.sharding import specs as sh

    def entry(e):
        return list(e) if isinstance(e, tuple) else e

    def one(ns, shape, slices):
        spec = [entry(e) for e in ns.spec]
        spec += [None] * (len(shape) - len(spec))
        out = [spec, list(ns.shard_shape(shape))]
        if slices:
            m = ns.addressable_devices_indices_map(shape)
            out.append([[[s.start or 0, d if s.stop is None else s.stop]
                         for s, d in zip(m[dev], shape)]
                        for dev in ns.mesh.devices.flat])
        return out

    meshes = {{"4x2": jax.make_mesh((4, 2), ("data", "model"),
                                    **mesh_mod.axis_types_kw(2)),
               "2x2x2": jax.make_mesh((2, 2, 2), ("pod", "data", "model"),
                                      **mesh_mod.axis_types_kw(3))}}
    res = {{}}
    for arch in ARCH_IDS:
        cfg = get_config(arch).reduced()
        sh.set_profile(cfg.sharding_profile)
        sh.set_seq_shardable(set(cfg.layer_kinds()) == {{"attn"}})
        model = build_model(cfg)
        ps = jax.eval_shape(model.init, jax.random.PRNGKey(0))
        ost = jax.eval_shape(optimizers.adamw(1e-3).init, ps)
        bs = model.train_batch_specs({B}, {S})
        for name, mesh in meshes.items():
            psh, osh = tm.train_state_shardings(ps, ost, mesh)
            bsh = tm.batch_shardings(bs, mesh)
            tsh = sh.tree_shardings(ps, mesh)
            res[arch + "/" + name] = {{
                "tree": [one(s, l.shape, True) for l, s in
                         zip(jax.tree.leaves(ps), jax.tree.leaves(tsh))],
                "params": [one(s, l.shape, False) for l, s in
                           zip(jax.tree.leaves(ps), jax.tree.leaves(psh))],
                "opt": [one(s, l.shape, False) for l, s in
                        zip(jax.tree.leaves(ost), jax.tree.leaves(osh))],
                "batch": [one(s, l.shape, True) for l, s in
                          zip(jax.tree.leaves(bs), jax.tree.leaves(bsh))]}}
    print(json.dumps(res))
""")


@pytest.fixture(scope="module")
def reference_shardings():
    code = _REFERENCE.format(src=SRC, B=B, S=S)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def _entry(e):
    return list(e) if isinstance(e, tuple) else e


def _port(ns, shape, slices):
    spec = [_entry(e) for e in ns.spec]
    spec += [None] * (len(shape) - len(spec))
    out = [spec, list(ns.shard_shape(shape))]
    if slices:
        m = ns.indices_map(shape)
        out.append([[[s.start, s.stop] for s in m[r]] for r in sorted(m)])
    return out


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_shardings_match_the_reference(reference_shardings, arch,
                                       mesh_name):
    want = reference_shardings[f"{arch}/{mesh_name}"]
    cfg = get_config(arch).reduced()
    mesh_shape = sh.MeshShape(*MESHES[mesh_name])
    model = build_model(cfg)
    ps = model.param_specs()
    ost = optimizers.adamw(1e-3).init(ps)
    bs = model.train_batch_specs(B, S)
    with sh.config_rules(cfg):
        psh, osh = port_train.train_state_shardings(ps, ost, mesh_shape)
        bsh = port_train.batch_shardings(bs, mesh_shape)
        tsh = sh.tree_shardings(ps, mesh_shape)
    got = {
        "tree": [_port(s, tuple(x.shape), True) for x, s in
                 zip(tree_leaves(ps), tree_leaves(tsh))],
        "params": [_port(s, tuple(x.shape), False) for x, s in
                   zip(tree_leaves(ps), tree_leaves(psh))],
        "opt": [_port(s, tuple(x.shape), False) for x, s in
                zip(tree_leaves(ost), tree_leaves(osh))],
        "batch": [_port(s, tuple(x.shape), True) for x, s in
                  zip(tree_leaves(bs), tree_leaves(bsh))]}
    for key in got:
        assert got[key] == want[key], key


# -- the step on 8 ranks -------------------------------------------------------

@pytest.fixture(scope="module")
def world():
    with mesh.World(8, device="cpu", timeout=120) as w:
        yield w


def _batch(cfg, seed=3, rows=B):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (rows, S), dtype=np.int64)
    labels = np.concatenate([toks[:, 1:], np.full((rows, 1), -1, np.int64)],
                            1)
    return {"tokens": toks, "labels": labels}


def _ref_step(arch, kw, rparams, batch, opt):
    model = ref_build(ref_get_config(arch).reduced(**kw))
    step = jax.jit(ref_train.make_train_step(model, opt))
    rb = {k: jnp.asarray(v.astype(np.int32)) for k, v in batch.items()}
    p, _, m = step(rparams, opt.init(rparams), rb)
    return jax.tree.map(np.asarray, p), {k: float(v) for k, v in m.items()}


def _port_step(arch, kw, params_np, batch, opt):
    model = build_model(get_config(arch).reduced(**kw))
    p = params_from_jax(params_np)
    pb = {k: torch.as_tensor(v) for k, v in batch.items()}
    p, _, m = port_train.make_train_step(model, opt)(p, opt.init(p), pb)
    return ([x.numpy() for x in tree_leaves(p)],
            {k: float(v) for k, v in m.items()})


def _check(got, want, what):
    (gp, gm), (wp, wm) = got, want
    for k in ("loss", "grad_norm"):
        assert abs(gm[k] - wm[k]) <= REL * abs(wm[k]), (what, k, gm, wm)
    for a, b in zip(gp, wp):
        np.testing.assert_allclose(a, b, rtol=0, atol=PARAM_ATOL,
                                   err_msg=what)


STEP_CASES = {
    "phi3-mini-3.8b-tp": ("phi3-mini-3.8b", dict(sharding_profile="tp")),
    "zamba2-1.2b-fsdp": ("zamba2-1.2b", dict(sharding_profile="fsdp")),
}


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_sharded_step_matches_single_device_and_reference(world, case,
                                                          monkeypatch):
    monkeypatch.setattr(ref_ssm, "ssd_chunked", _ssd_masked_twice)
    arch, kw = STEP_CASES[case]
    kw = dict(kw, dtype="float32")
    rparams = ref_build(ref_get_config(arch).reduced(**kw)).init(
        jax.random.PRNGKey(7))
    params_np = jax.tree.map(np.asarray, rparams)
    batch = _batch(get_config(arch).reduced())
    outs = [r[0] for r in world.run(cases.train, arch, kw, *MESH, batch,
                                    params=params_np)]
    full = cases.gathered(outs)
    _, metrics, report = outs[0]
    got = (full, metrics[0])
    # every rank reports the global batch's metrics
    assert all(o[1] == metrics for o in outs)
    _check(got, _port_step(arch, kw, params_np, batch, optimizers.sgd(1e-2)),
           "single device")
    ref_p, ref_m = _ref_step(arch, kw, rparams, batch, ref_opt.sgd(1e-2))
    _check(got, (jax.tree.leaves(ref_p), ref_m), "reference")
    kinds = report["collectives"]["kinds"]
    assert kinds.get("all-gather", 0) > 0 and kinds.get("reduce-scatter",
                                                        0) > 0, kinds
    assert not any(report["launches"].values())


def test_moe_aux_loss_is_the_global_batch(world):
    """qwen3-moe under "tp": each rank's 2 x 64 tokens are two routing
    groups of 64, the single-device step's groups, and the aux loss takes
    its token means over the whole batch."""
    arch, kw = "qwen3-moe-30b-a3b", dict(dtype="float32",
                                         sharding_profile="tp")
    model = build_model(get_config(arch).reduced(**kw))
    params_np = params_to_numpy(model.init(generator(0), "cpu"))
    batch = _batch(model.cfg)
    outs = [r[0] for r in world.run(cases.train, arch, kw, *MESH, batch,
                                    params=params_np)]
    full = cases.gathered(outs)
    _, metrics, _ = outs[0]
    want = _port_step(arch, kw, params_np, batch, optimizers.sgd(1e-2))
    assert metrics[0]["aux"] > 0
    assert abs(metrics[0]["aux"] - want[1]["aux"]) <= REL * want[1]["aux"]
    _check((full, metrics[0]), want, "single device")


def test_grad_accum_cuts_each_ranks_rows(world):
    """phi3-mini under "tp" with grad_accum = 2: each rank's 2 rows lie in
    one of the single-device step's 2 micro-batches of 4 rows, and the
    AdamW step's loss and grad-norm equal the single-device step's with
    grad_accum = 2."""
    arch = "phi3-mini-3.8b"
    kw = dict(dtype="float32", sharding_profile="tp", grad_accum=2)
    model = build_model(get_config(arch).reduced(**kw))
    params_np = params_to_numpy(model.init(generator(0), "cpu"))
    batch = _batch(model.cfg, seed=4)
    outs = [r[0] for r in world.run(
        cases.train, arch, kw, *MESH, batch, params=params_np,
        runs=[("adamw", 3e-4, 1, False)])]
    full = cases.gathered(outs)
    _, metrics, _ = outs[0]
    want = _port_step(arch, kw, params_np, batch,
                      optimizers.adamw(3e-4, weight_decay=0.01))
    for k in ("loss", "grad_norm"):
        assert abs(metrics[0][k] - want[1][k]) <= REL * abs(want[1][k])


ACCUM_CASES = {     # (arch, grad_accum, global rows)
    # micro-batches of 4 rows, 2 rows a rank: one piece a rank
    "phi3-mini-3.8b-accum2": ("phi3-mini-3.8b", 2, B),
    # micro-batches of 1 row, 2 rows a rank: two pieces a rank
    "phi3-mini-3.8b-accum8": ("phi3-mini-3.8b", 8, B),
    # the aux loss's token means over each micro-batch's 4 x 64 tokens
    "qwen3-moe-30b-a3b-accum2": ("qwen3-moe-30b-a3b", 2, B),
    # micro-batches of 4 rows, 3 rows a rank: ranks 1 and 2 straddle two
    # micro-batches, and each micro-batch is held by two ranks
    "phi3-mini-3.8b-accum3-straddling": ("phi3-mini-3.8b", 3, 12),
    # the same with token means: a rank holding no row of a round's
    # micro-batch issues its collectives with zeros
    "qwen3-moe-30b-a3b-accum3-straddling": ("qwen3-moe-30b-a3b", 3, 12),
    # Mamba2's heads over "model" under grad_accum
    "zamba2-1.2b-accum2": ("zamba2-1.2b", 2, B),
}


@pytest.mark.parametrize("case", sorted(ACCUM_CASES))
def test_grad_accum_weighs_rows_as_the_single_device_micro_batches(world,
                                                                   case):
    """Labels padded unevenly over the rows (a micro-batch's valid labels
    differ from another's and from a rank's share of them): the sharded
    SGD step under grad_accum equals the single-device step's loss,
    grad-norm, aux loss and params."""
    arch, accum, rows = ACCUM_CASES[case]
    kw = dict(dtype="float32", sharding_profile="tp", grad_accum=accum)
    model = build_model(get_config(arch).reduced(**kw))
    params_np = params_to_numpy(model.init(generator(0), "cpu"))
    batch = _batch(model.cfg, seed=5, rows=rows)
    rng = np.random.default_rng(6)
    for r in range(rows):
        # row r keeps a random number of its leading labels
        batch["labels"][r, int(rng.integers(1, S)):] = -1
    outs = [r[0] for r in world.run(cases.train, arch, kw, *MESH, batch,
                                    params=params_np)]
    full = cases.gathered(outs)
    _, metrics, _ = outs[0]
    want = _port_step(arch, kw, params_np, batch, optimizers.sgd(1e-2))
    _check((full, metrics[0]), want, "single device")
    assert abs(metrics[0]["aux"] - want[1]["aux"]) <= REL * max(
        want[1]["aux"], 1e-30)


@pytest.mark.parametrize("arch", ["phi3-mini-3.8b", "zamba2-1.2b"])
def test_tensor_parallel_step_without_remat(world, arch):
    """`remat=False` under "tp": the SGD step equals the single-device
    step's, and the backward pass gathers each layer again (at least as
    many all-gathers as remat's recompute makes)."""
    kw = dict(dtype="float32", sharding_profile="tp", remat=False)
    model = build_model(get_config(arch).reduced(**kw))
    params_np = params_to_numpy(model.init(generator(0), "cpu"))
    batch = _batch(model.cfg, seed=8)
    outs = [r[0] for r in world.run(cases.train, arch, kw, *MESH, batch,
                                    params=params_np)]
    full = cases.gathered(outs)
    _, metrics, report = outs[0]
    _check((full, metrics[0]),
           _port_step(arch, kw, params_np, batch, optimizers.sgd(1e-2)),
           "single device")
    with_remat = world.run(cases.train, arch, dict(kw, remat=True), *MESH,
                           batch, params=params_np)[0][0][2]
    assert (report["collectives"]["kinds"]["all-gather"]
            >= with_remat["collectives"]["kinds"]["all-gather"])
    assert "vocab" in report["cut"]


@pytest.mark.parametrize("opt", ["sgd", "adamw"])
def test_sharded_step_updates_its_shards_in_place(world, opt):
    """The step donates its params and optimizer state (ROADMAP C.7, the
    reference's `donate_argnums=(0, 1)`): it returns the tensors it was
    given, holding bit for bit the functional update of the gradients it
    took (SGD with momentum, AdamW's moments and step count), on every
    rank of phi3-mini under "tp"."""
    arch, kw = "phi3-mini-3.8b", dict(dtype="float32",
                                      sharding_profile="tp")
    model = build_model(get_config(arch).reduced(**kw))
    params_np = params_to_numpy(model.init(generator(0), "cpu"))
    outs = world.run(cases.donated, arch, kw, *MESH, _batch(model.cfg),
                     params_np, opt)
    n = len(tree_leaves(model.param_specs()))
    for got in outs:
        assert got == {"same_tensors": True, "params_bitwise": True,
                       "state_bitwise": True, "leaves": n}, got


def test_update_in_place_is_the_functional_update_bitwise():
    """`optimizers.update_in_place` on one device: the given tensors,
    bitwise `opt.update` then `apply_updates`, a scheduled learning rate
    read at the step count before the count is written."""
    gen = generator(3)
    params = {"a": torch.randn(5, 3, generator=gen),
              "b": [torch.randn(4, generator=gen),
                    torch.randn(2, 2, generator=gen)]}
    grads = torch.randn(5, 3, generator=gen), torch.randn(
        4, generator=gen), torch.randn(2, 2, generator=gen)
    for opt in (optimizers.sgd(optimizers.cosine_schedule(0.1, 2, 10),
                               momentum=0.9),
                optimizers.adamw(1e-2, weight_decay=0.01)):
        state = opt.init(params)
        for _ in range(2):
            want_u, want_s = opt.update(
                port_train.tree_unflatten(params, list(grads)), state,
                params)
            want_p = optimizers.apply_updates(params, want_u)
            leaves = tree_leaves(params) + tree_leaves(state)
            p, s = optimizers.update_in_place(opt, list(grads), state,
                                              params)
            assert all(x is y for x, y in zip(
                tree_leaves(p) + tree_leaves(s), leaves))
            for x, y in zip(tree_leaves(p) + tree_leaves(s),
                            tree_leaves(want_p) + tree_leaves(want_s)):
                assert torch.equal(x, y)
