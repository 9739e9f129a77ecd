"""Tensor-parallel compute on the mesh (`repro_torch.models.parallel`, the
compute layout of `sharding/specs.py`, the autograd operations of
`core/collectives.py` and the per-layer gather of `launch/mesh.py`) on the
CPU.

* The compute layout of every zoo config's reduced tree under "tp" on a
  4x2 mesh lines up with the reference's `tree_specs`: a leaf computed by
  columns, rows, vocabulary, experts or heads is cut over "model" in the
  reference's spec on the dim the rank computes, and the rank's slice is
  its stored block there, but for leaves stored whole over "model"
  (biases, the gated norm's scale) and those whose stored cut does not
  line up with the heads (Mamba2's packed `in_proj` and `conv1d`, its
  `out_proj`); the ranks' slices cover every column; under "fsdp"
  nothing is cut.
* `copy_to`, `reduce_from` and `gather_leaves` on 4 ranks: values,
  gradients and the reference's op kinds they are counted under.
* The gradients of the loss taken one layer at a time on the ranks' shards
  (under "fsdp": gathered whole; under "tp": each rank its "model" shard;
  the vocabulary-parallel cross-entropy fused with the unembedding, or
  under a softcap taken from the logits) equal the single-device
  gradients of the whole tree.
* The sharded train step under "tp" (phi3-mini, qwen3-moe, zamba2;
  reduced, float32) equals the reference's `make_train_step` from its
  init: loss and grad-norm within 1e-5 relative, SGD params within 1e-6.
* The dry-run's per-device FLOPs (`launch.dryrun.run_step`, meta device)
  on the 4x2 mesh (2x2x2 for the multi-pod fsdp pairs): the tp pairs,
  qwen3-moe under "moe" (expert parallelism, issuing an all-to-all) and
  phi3-mini's train step and prefill under multi-pod "fsdp" (context
  parallelism) within 0.7-1.15x the reference's compiled count (from a
  subprocess with 8 fake devices and `scan_layers=False`, as
  tests/test_sharding_and_dryrun.py compiles), the 4x2 fsdp and moe
  pairs within 5% of the count before tensor parallelism, and 8x the
  count within 0.99-1.15x the single-device step's, so no work is left
  out.

One `launch.mesh.World` of 8 CPU ranks serves the module; the ranks run
`torch_sharded_cases`."""
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
from repro.sharding import specs as ref_specs  # noqa: E402
from repro_torch.configs.registry import ARCH_IDS, get_config  # noqa: E402
from repro_torch.convert import params_to_numpy  # noqa: E402
from repro_torch.device import generator  # noqa: E402
from repro_torch.launch import dryrun, mesh  # noqa: E402
from repro_torch.launch import train as port_train  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.sharding import specs as sh  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

import torch_sharded_cases as cases  # noqa: E402
from test_torch_train import _ssd_masked_twice  # noqa: E402

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
MESH = ((4, 2), ("data", "model"))
MESH_SHAPE = sh.MeshShape(*MESH)
B, S = 8, 64
REL, PARAM_ATOL, GRAD_ATOL = 1e-5, 1e-6, 1e-6


@pytest.fixture(scope="module")
def world():
    with mesh.World(8, device="cpu", timeout=120) as w:
        yield w


# -- the compute layout against the reference's stored specs ------------------

class _FakeMesh:
    axis_names = ("data", "model")
    shape = {"data": 4, "model": 2}


# leaves stored cut over "model" by a block that is not the slice a rank
# computes with: Mamba2's packed projections and its out_proj (stored cut
# by its output columns, computed by the rank's heads' rows)
_MISALIGNED = ("mamba/in_proj/kernel", "mamba/conv1d",
               "mamba/out_proj/kernel")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_compute_layout_lines_up_with_the_reference_specs(arch):
    cfg = get_config(arch).reduced()
    params = build_model(cfg).param_specs()
    paths = [p for p, _ in tree_leaves(sh._paths(params))]
    shapes = [tuple(x.shape) for x in tree_leaves(params)]
    ref_params = jax.tree.map(lambda x: jax.ShapeDtypeStruct(
        tuple(x.shape), jnp.float32), params)
    with ref_specs.profile_ctx("tp"):
        ref_specs.set_seq_shardable(set(cfg.layer_kinds()) == {"attn"})
        want = jax.tree.leaves(ref_specs.tree_specs(ref_params, _FakeMesh()),
                               is_leaf=lambda s: isinstance(
                                   s, jax.sharding.PartitionSpec))
    with sh.profile_ctx("tp"):
        rows = [tree_leaves(sh.compute_layouts(cfg, MESH_SHAPE, params, i))
                for i in range(2)]
    cut = 0
    for k, (path, shape, spec) in enumerate(zip(paths, shapes, want)):
        stacked = sh._STACKED_RE.search(path) and len(shape) >= 2
        inner = shape[1:] if stacked else shape
        entries = list(spec)[1:] if stacked else list(spec)
        entries += [None] * (len(inner) - len(entries))
        lays = [rows[i][k] for i in range(2)]
        if lays[0].dim is None:
            continue
        cut += 1
        d = lays[0].dim
        n = inner[d]
        covered = sorted({c for lay in lays for lo, hi in lay.ranges
                          for c in range(lo, hi)})
        assert covered == list(range(n)), (path, lays)
        if "model" not in entries:
            continue            # stored whole over "model": cut from it
        if any(path.endswith(m) for m in _MISALIGNED):
            continue
        # the stored block along the computed dim is the rank's slice
        assert entries[d] == "model", (path, spec, lays)
        for i, lay in enumerate(lays):
            assert lay.ranges == ((i * n // 2, (i + 1) * n // 2),), (path,
                                                                      lay)
    kinds = sh.cut_kinds(cfg, 2)
    assert cut > 0 if any(kinds.values()) else cut == 0
    with sh.profile_ctx("fsdp"):
        assert all(lay.dim is None for lay in tree_leaves(
            sh.compute_layouts(cfg, MESH_SHAPE, params, 0)))


# -- the three autograd operations --------------------------------------------

def test_autograd_operations_over_a_model_axis(world):
    outs = world.run(cases.tp_ops)
    weights = sum(r + 1 for r in range(4))
    for rank, out in enumerate(outs):
        r = rank % 4
        fy, fg = out["f"]
        np.testing.assert_array_equal(fy, np.arange(6.0) + r)
        np.testing.assert_array_equal(fg, np.full(6, float(weights)))
        gy, gg = out["g"]
        np.testing.assert_array_equal(gy, 4 * np.arange(6.0) + 6)
        np.testing.assert_array_equal(gg, np.full(6, r + 1.0))
        full, grad = out["gather"]
        want = np.concatenate([np.arange(6.0).reshape(2, 3) + 10 * j
                               for j in range(4)])
        np.testing.assert_array_equal(full, want)
        np.testing.assert_array_equal(grad, np.full((2, 3), weights * 1.0))
        assert out["kinds"] == {"all-reduce": 2, "all-gather": 1,
                                "reduce-scatter": 1}, out["kinds"]


# -- gradients a layer at a time against the whole tree -----------------------

def _batch(cfg, seed=3, rows=B):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (rows, S), dtype=np.int64)
    labels = np.concatenate([toks[:, 1:], np.full((rows, 1), -1, np.int64)],
                            1)
    return {"tokens": toks, "labels": labels}


GRAD_CASES = {
    "phi3-mini-3.8b-fsdp": ("phi3-mini-3.8b", "fsdp", set()),
    # a softcap: the logits' log-sum-exp taken unfused over the vocabulary
    "phi3-mini-3.8b-tp-softcap": ("phi3-mini-3.8b", "tp",
                                  {"attn", "mlp", "vocab"}),
    "phi3-mini-3.8b-tp": ("phi3-mini-3.8b", "tp", {"attn", "mlp", "vocab"}),
    "qwen3-moe-30b-a3b-tp": ("qwen3-moe-30b-a3b", "tp",
                             {"attn", "moe", "vocab"}),
    "zamba2-1.2b-tp": ("zamba2-1.2b", "tp", {"mamba", "vocab"}),
    "seamless-m4t-large-v2-tp": ("seamless-m4t-large-v2", "tp",
                                 {"attn", "mlp", "vocab"}),
}


@pytest.mark.parametrize("case", sorted(GRAD_CASES))
def test_gradients_a_layer_at_a_time_equal_the_whole_tree(world, case):
    arch, profile, want_cut = GRAD_CASES[case]
    kw = dict(dtype="float32")
    if case.endswith("softcap"):
        kw["logits_softcap"] = 30.0
    model = build_model(get_config(arch).reduced(**kw))
    params = model.init(generator(0), "cpu")
    batch = _batch(model.cfg, rows=4)
    if model.cfg.encoder_layers:
        batch["audio_frames"] = np.random.default_rng(4).standard_normal(
            (4, model.cfg.num_frames, model.cfg.d_model)).astype(np.float32)
    (loss, _), g = port_train.value_and_grad(
        model.loss, params, {k: torch.as_tensor(v) for k, v in batch.items()})
    got_loss, got, cut = world.run(cases.layer_grads, arch, kw, *MESH, batch,
                                   params_to_numpy(params), profile)[0]
    assert abs(got_loss - float(loss)) <= REL * abs(float(loss))
    for a, b in zip(got, tree_leaves(g)):
        np.testing.assert_allclose(a, b.numpy(), rtol=0, atol=GRAD_ATOL)
    assert set(cut) == want_cut


# -- the sharded train step under tp against the reference --------------------

def _check(got, want, what):
    (gp, gm), (wp, wm) = got, want
    for k in ("loss", "grad_norm"):
        assert abs(gm[k] - wm[k]) <= REL * abs(wm[k]), (what, k, gm, wm)
    for a, b in zip(gp, wp):
        np.testing.assert_allclose(a, b, rtol=0, atol=PARAM_ATOL,
                                   err_msg=what)


@pytest.mark.parametrize("arch", ["phi3-mini-3.8b", "qwen3-moe-30b-a3b",
                                  "zamba2-1.2b"])
def test_tensor_parallel_train_step_matches_the_reference(world, arch,
                                                          monkeypatch):
    monkeypatch.setattr(ref_ssm, "ssd_chunked", _ssd_masked_twice)
    kw = dict(dtype="float32", sharding_profile="tp")
    rmodel = ref_build(ref_get_config(arch).reduced(**kw))
    rparams = rmodel.init(jax.random.PRNGKey(7))
    params_np = jax.tree.map(np.asarray, rparams)
    batch = _batch(get_config(arch).reduced())
    outs = [r[0] for r in world.run(cases.train, arch, kw, *MESH, batch,
                                    params=params_np)]
    full = cases.gathered(outs)
    _, metrics, report = outs[0]
    step = jax.jit(ref_train.make_train_step(rmodel, ref_opt.sgd(1e-2)))
    rb = {k: jnp.asarray(v.astype(np.int32)) for k, v in batch.items()}
    p, _, m = step(rparams, ref_opt.sgd(1e-2).init(rparams), rb)
    _check((full, metrics[0]),
           (jax.tree.leaves(jax.tree.map(np.asarray, p)),
            {k: float(v) for k, v in m.items()}), "reference")
    assert "vocab" in report["cut"] and len(report["cut"]) >= 2
    assert report["collectives"]["kinds"]["all-reduce"] > 0


# -- per-device FLOPs against the reference's compiled count ------------------

FLOP_PAIRS = [("phi3-mini-3.8b", "tp", "train"),
              ("phi3-mini-3.8b", "tp", "prefill"),
              ("qwen3-moe-30b-a3b", "tp", "train"),
              ("zamba2-1.2b", "tp", "train"),
              # expert parallelism: "model" carries rows and experts
              ("qwen3-moe-30b-a3b", "moe", "train"),
              # context parallelism: the sequence over "model"
              ("phi3-mini-3.8b", "fsdp", "train"),
              ("phi3-mini-3.8b", "fsdp", "prefill")]
# the mesh of each pair (4x2 unless named)
MULTI_POD = ((2, 2, 2), ("pod", "data", "model"))
PAIR_MESH = {("phi3-mini-3.8b", "fsdp", "train"): MULTI_POD,
             ("phi3-mini-3.8b", "fsdp", "prefill"): MULTI_POD}
# the port's per-device counts before tensor parallelism (every rank along
# "model" computed whole layers): each holds within 5%
BEFORE = {("phi3-mini-3.8b", "fsdp", "train"): 0.721e9,
          ("zamba2-1.2b", "fsdp", "train"): 0.477e9,
          ("qwen3-moe-30b-a3b", "moe", "train"): 1.433e9}

_REFERENCE_FLOPS = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import sys, json
    sys.path.insert(0, {src!r})
    import jax
    from repro.configs.registry import get_config
    from repro.launch import mesh as mesh_mod, roofline as rl
    from repro.launch import serve as sm, train as tm
    from repro.models.model import build_model
    from repro.optim import optimizers
    from repro.sharding import specs as sh

    def sds(tree, shardings):
        return jax.tree.map(lambda l, s: jax.ShapeDtypeStruct(
            l.shape, l.dtype, sharding=s), tree, shardings)

    out = {{}}
    for (arch, profile, kind), (shape, names) in {pairs!r}:
        mesh = jax.make_mesh(shape, names,
                             **mesh_mod.axis_types_kw(len(shape)))
        cfg = get_config(arch).reduced().with_updates(
            sharding_profile=profile, scan_layers=False)
        sh.set_profile(profile)
        sh.set_seq_shardable(set(cfg.layer_kinds()) == {{"attn"}})
        model = build_model(cfg)
        ps = jax.eval_shape(model.init, jax.random.PRNGKey(0))
        psds = sds(ps, sh.tree_shardings(ps, mesh))
        bs = model.train_batch_specs({B}, {S})
        if kind == "prefill":
            bs.pop("labels")
        bsds = sds(bs, tm.batch_shardings(bs, mesh))
        with mesh_mod.activate_mesh(mesh):
            if kind == "train":
                opt = optimizers.adamw(1e-4)
                ost = jax.eval_shape(opt.init, ps)
                _, osh = tm.train_state_shardings(ps, ost, mesh)
                fn = jax.jit(tm.make_train_step(model, opt))
                compiled = fn.lower(psds, sds(ost, osh), bsds).compile()
            else:
                fn = jax.jit(sm.make_prefill_step(model))
                compiled = fn.lower(psds, bsds).compile()
        out["/".join((arch, profile, kind))] = rl.analyze(
            compiled, 8).flops_per_device
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def reference_flops():
    pairs = [(p, PAIR_MESH.get(p, MESH)) for p in FLOP_PAIRS]
    code = _REFERENCE_FLOPS.format(src=SRC, pairs=pairs, B=B, S=S)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def _port_flops(arch, profile, kind, mesh_shape=MESH_SHAPE):
    cfg = get_config(arch).reduced().with_updates(sharding_profile=profile,
                                                  scan_layers=False)
    return dryrun.run_step(cfg, kind, B, S, mesh_shape)["flops"]


@pytest.mark.parametrize("pair", FLOP_PAIRS, ids="/".join)
def test_per_device_flops_match_the_reference(reference_flops, pair):
    got = _port_flops(*pair, sh.MeshShape(*PAIR_MESH.get(pair, MESH)))
    want = reference_flops["/".join(pair)]
    assert 0.7 <= got / want <= 1.15, (pair, got, want)
    # every rank's share of the single-device step, nothing left out
    one = _port_flops(*pair, sh.MeshShape((1, 1), ("data", "model")))
    assert 0.99 <= 8 * got / one <= 1.15, (pair, got, one)
    kinds = dryrun.run_step(get_config(pair[0]).reduced().with_updates(
        sharding_profile=pair[1], scan_layers=False), pair[2], B, S,
        sh.MeshShape(*PAIR_MESH.get(pair, MESH)))["counts"]["kinds"]
    if pair[1] == "moe":
        assert kinds.get("all-to-all", 0) > 0, kinds


@pytest.mark.parametrize("pair", sorted(BEFORE), ids="/".join)
def test_per_device_flops_where_nothing_is_cut(pair):
    got = _port_flops(*pair)
    assert abs(got / BEFORE[pair] - 1) <= 0.05, (pair, got)
    one = _port_flops(*pair, sh.MeshShape((1, 1), ("data", "model")))
    assert 0.99 <= 8 * got / one <= 1.15, (pair, got, one)
