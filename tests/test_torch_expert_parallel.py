"""Expert parallelism on the mesh (the single-pod moe profile: "model"
carries rows and the MoE experts, `specs.ep_axis`) on the CPU.

* `collectives.all_to_all` on the 4 ranks of a "model" axis: its values,
  its gradient (the inverse all-to-all) and its count under the
  reference's "all-to-all" with the bytes of its result.
* `moe.moe_ffn` under the expert-parallel view (each rank its row and
  its experts, one all-to-all each way) against the single-device
  `moe_ffn` on the global batch: output, aux loss (token means over the
  global batch) and the gradients of the input, the router and the
  experts within 1e-5.
* `make_sharded_train_step` for qwen3-moe-30b-a3b and deepseek-v2-lite
  (reduced, "moe", 4x2, float32) against the reference's
  `make_train_step` from its init: loss and grad-norm within 1e-5
  relative, SGD params within 1e-6. The step issues all-to-alls, and each
  rank gathers its E/2 experts of a layer over "data" only: no
  `experts_*` leaf is gathered over "model".
* The sharded prefill (the all-to-all) and decode (the ranks along
  "model" hold the same rows: each runs its experts, then a sum) under
  "moe" against one device within 1e-5.

One `launch.mesh.World` of 8 CPU ranks serves the module; the ranks run
`torch_sharded_cases`."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.configs.registry import get_config as ref_get_config  # noqa: E402
from repro.launch import train as ref_train  # noqa: E402
from repro.models.model import build_model as ref_build  # noqa: E402
from repro.optim import optimizers as ref_opt  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.convert import params_to_numpy  # noqa: E402
from repro_torch.device import generator  # noqa: E402
from repro_torch.core import collectives  # noqa: E402
from repro_torch.launch import mesh  # noqa: E402
from repro_torch.launch import serve as port_serve  # noqa: E402
from repro_torch.launch import train as port_train  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.optim import optimizers  # noqa: E402
from repro_torch.sharding import specs as sh  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

import torch_sharded_cases as cases  # noqa: E402

MESH = ((4, 2), ("data", "model"))
B, S = 8, 64
REL, PARAM_ATOL, TOL = 1e-5, 1e-6, 1e-5
ARCHS = ["qwen3-moe-30b-a3b", "deepseek-v2-lite-16b"]


@pytest.fixture(scope="module")
def world():
    with mesh.World(8, device="cpu", timeout=120) as w:
        yield w


def test_all_to_all_values_gradient_and_count(world):
    outs = world.run(cases.ep_ops)
    for rank, out in enumerate(outs):
        r = rank % 4            # the rank's index on "model"
        # block r of every rank q along the axis, in axis order
        want = np.concatenate([10.0 * q + r + np.arange(3.0)[None] / 4
                               for q in range(4)], 1)
        np.testing.assert_array_equal(out["y"], want)
        # row p went to rank p, which weighs it by p + 1
        np.testing.assert_array_equal(
            out["grad"], np.repeat(np.arange(1.0, 5.0)[:, None], 3, 1))
        assert out["kinds"] == {"all-to-all": 2}, out["kinds"]
        assert out["kind_bytes"] == {"all-to-all": 2 * 12 * 4}


def _close(got, want):
    """Within TOL of the largest magnitude of `want` (sums of 8 x 64
    tokens' products reach ~1e2 here)."""
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=TOL * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_expert_parallel_matches_one_device(world, arch):
    kw = dict(dtype="float32", num_experts=4, sharding_profile="moe")
    model = build_model(get_config(arch).reduced(**kw))
    cfg = model.cfg
    # layer 0's MoE leaves
    lp = tree_map(lambda a: a[0], model.init(generator(0), "cpu")[
        "layers"]["mlp"])
    rng = np.random.default_rng(3)
    x = rng.standard_normal((8, S, cfg.d_model)).astype(np.float32)
    w = rng.standard_normal((8, S, cfg.d_model)).astype(np.float32)
    p = tree_map(lambda v: v.detach().clone().requires_grad_(True), lp)
    xt = torch.tensor(x, requires_grad=True)
    out, aux = moe.moe_ffn(p, cfg, xt)
    ((out * torch.tensor(w)).sum() + aux).backward()
    outs = world.run(cases.ep_moe, arch, kw, params_to_numpy(lp), x, w)
    E = cfg.num_experts
    aux = float(aux.detach())
    for got in outs:
        row, m = got["row"], got["block"]
        _close(got["out"], out[row:row + 1].detach())
        assert abs(got["aux"] - aux) <= TOL * abs(aux)
        _close(got["x_grad"], xt.grad[row:row + 1])
        for a, b in zip(tree_leaves(got["router_grad"]),
                        tree_leaves(p["router"])):
            _close(a, b.grad)
        n = E // 4
        for k, g in got["expert_grads"].items():
            _close(g, p[k].grad[m * n:(m + 1) * n])
        assert got["kinds"]["all-to-all"] == 4, got["kinds"]


def _batch(cfg, seed=3, rows=B):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (rows, S), dtype=np.int64)
    labels = np.concatenate([toks[:, 1:], np.full((rows, 1), -1, np.int64)],
                            1)
    return {"tokens": toks, "labels": labels}


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_train_step_matches_the_reference(world, arch):
    kw = dict(dtype="float32", sharding_profile="moe")
    rmodel = ref_build(ref_get_config(arch).reduced(**kw))
    rparams = rmodel.init(jax.random.PRNGKey(7))
    batch = _batch(get_config(arch).reduced())
    outs = [r[0] for r in world.run(
        cases.train, arch, kw, *MESH, batch,
        params=jax.tree.map(np.asarray, rparams))]
    full = cases.gathered(outs)
    _, metrics, report = outs[0]
    step = jax.jit(ref_train.make_train_step(rmodel, ref_opt.sgd(1e-2)))
    rb = {k: jnp.asarray(v.astype(np.int32)) for k, v in batch.items()}
    p, _, m = step(rparams, ref_opt.sgd(1e-2).init(rparams), rb)
    for k in ("loss", "grad_norm"):
        assert abs(metrics[0][k] - float(m[k])) <= REL * abs(float(m[k]))
    for a, b in zip(full, jax.tree.leaves(p)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0,
                                   atol=PARAM_ATOL)
    cfg = get_config(arch).reduced(**kw)
    for _, _, rep in outs:
        assert rep["expert_parallel"] and rep["cut"] == ["moe"]
        assert rep["collectives"]["kinds"].get("all-to-all", 0) > 0
        # each rank gathers its E/2 experts of a layer, over "data" only
        experts = {k: v for k, v in rep["gathered_bytes"].items()
                   if "experts_" in k}
        assert experts
        for v in experts.values():
            assert v == cfg.num_experts // 2 * cfg.d_model * cfg.d_ff * 4
        assert rep["local_shapes"]["labels"] == (1, S)


DECODE_CUT = {"qwen3-moe-30b-a3b": ["attn", "moe", "vocab"],
              "deepseek-v2-lite-16b": ["mla", "moe", "vocab"]}


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_prefill_and_decode_under_moe_match_one_device(world, arch):
    kw = dict(dtype="float32", sharding_profile="moe")
    model = cases.build(arch, **kw)
    params = model.init(generator(0), "cpu")
    tokens = torch.randint(0, model.cfg.vocab_size, (B, S),
                           generator=generator(2))
    steps = 4
    with torch.no_grad():
        logits = port_serve.make_prefill_step(model)(params,
                                                     {"tokens": tokens})
        state = model.init_decode_state(B, steps, device="cpu")
        want = []
        for i in range(steps):
            lg, state = model.decode_step(params, state, tokens[:, i:i + 1])
            want.append(lg[:, 0])
    want = torch.stack(want).numpy()
    outs = world.run(cases.serve, arch, kw, *MESH, tokens.numpy(), steps,
                     params=params_to_numpy(params))
    for (a, b), lg, (c, d), dec, report in outs:
        np.testing.assert_allclose(cases.load(lg)[0], logits[a:b].numpy(),
                                   rtol=0, atol=TOL)
        np.testing.assert_allclose(dec, want[:, c:d], rtol=0, atol=TOL)
        # the prefill's experts; the decode step's ranks along "model" hold
        # the same rows, and cut its attention and vocabulary too
        assert report["expert_parallel"] and report["cut"] == DECODE_CUT[arch]
        kinds = report["collectives"]["kinds"]
        # the prefill's all-to-alls; the decode's sums over "model"
        assert kinds.get("all-to-all", 0) > 0 and kinds.get("all-reduce", 0)
    # the prefill's rows lie over both axes
    assert len({o[0] for o in outs}) == 8


def _dry_step(rows, accum):
    model = build_model(get_config("qwen3-moe-30b-a3b").reduced(
        dtype="float32", sharding_profile="moe", grad_accum=accum))
    with collectives.dry_run():
        rm = mesh.dry_run_mesh(sh.MeshShape(*MESH))
        return port_train.make_sharded_train_step(
            model, optimizers.sgd(1e-2), rm,
            model.train_batch_specs(rows, S))


def test_expert_parallelism_follows_the_rows_along_model():
    """The all-to-all where the ranks along "model" hold other rows (16
    rows, 2 a rank, under grad_accum 8); the tp form (each rank's experts,
    then a sum) where 12 rows do not divide over the 8 ranks and lie over
    "data" only; a layout whose peers along "model" hold pieces of other
    sizes (24 rows, 3 a rank, straddling grad_accum 3's micro-batches of
    8) raises, as the all-to-all swaps equal blocks."""
    assert _dry_step(16, 8).parallel.expert_parallel
    view = _dry_step(12, 3).parallel
    assert not view.expert_parallel and view.tp("moe") is view
    with pytest.raises(ValueError, match="differ along it"):
        _dry_step(24, 3)
