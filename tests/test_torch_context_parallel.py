"""Context parallelism on the mesh (the multi-pod fsdp profile: the batch
stays cut by sequence over "model", `specs.context_parallel`) on the
CPU.

* `attention.attention` with a rank's block of positions (2 ranks along
  "model"; each gathers every rank's keys and values, whose backward
  reduce-scatters) against whole attention: causal, a 16-token window
  that crosses the ranks' blocks, GQA (4 query heads on 2 kv heads),
  under the einsum and the chunked paths; the output, the input's
  gradient and the parameters' gradients within 1e-5.
* `make_sharded_train_step` for phi3-mini-3.8b and gemma3-4b
  (`sliding_window` 16 in both packages) reduced under "fsdp" on 2x2x2,
  against the reference's `make_train_step` from its init: loss and
  grad-norm within 1e-5 relative, SGD params within 1e-6; each rank's
  batch stays 2 rows x 32 positions.
* The sharded prefill on 2x2x2 (each rank its rows' block of positions)
  and decode against one device within 1e-5.
* Which stacks keep the sequence cut (`specs.context_parallel`): the
  dense token-only ones on the multi-pod mesh under fsdp; not a vision
  prefix, an encoder or an MoE stack, nor a single-pod mesh.

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
from repro_torch.launch import mesh  # noqa: E402
from repro_torch.launch import serve as port_serve  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

import torch_sharded_cases as cases  # noqa: E402

MESH = ((2, 2, 2), ("pod", "data", "model"))
B, S = 8, 64
REL, PARAM_ATOL, TOL = 1e-5, 1e-6, 1e-5
WINDOW = 16
CASES = {"phi3-mini-3.8b": dict(dtype="float32", sharding_profile="fsdp"),
         "gemma3-4b": dict(dtype="float32", sharding_profile="fsdp",
                           sliding_window=WINDOW)}


@pytest.fixture(scope="module")
def world():
    with mesh.World(8, device="cpu", timeout=120) as w:
        yield w


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=TOL * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("impl", ["einsum", "chunked"])
@pytest.mark.parametrize("window", [0, WINDOW])
def test_context_parallel_attention_matches_whole(world, window, impl):
    kw = dict(dtype="float32", num_heads=4, num_kv_heads=2, attn_impl=impl,
              attn_chunk=16)
    cfg = build_model(get_config("yi-9b").reduced(**kw)).cfg
    params = attn.init_attention(generator(0), cfg)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    w = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    p = tree_map(lambda v: v.clone().requires_grad_(True), params)
    xt = torch.tensor(x, requires_grad=True)
    positions = torch.arange(S, dtype=torch.int32)[None].expand(2, S)
    mask = (None if impl == "chunked"
            else attn.make_attention_mask(S, S, window=window))
    out = attn.attention(p, cfg, xt, positions=positions, mask=mask,
                         window=window if mask is None else 0)
    (out * torch.tensor(w)).sum().backward()
    outs = world.run(cases.cp_attention, "yi-9b", kw,
                     params_to_numpy(params), x, w, window)
    for got in outs:
        lo, hi = got["block"]
        _close(got["out"], out[:, lo:hi].detach())
        _close(got["x_grad"], xt.grad[:, lo:hi])
        for a, b in zip(tree_leaves(got["grads"]), tree_leaves(p)):
            _close(a, b.grad)
        kinds = got["kinds"]
        # K and V gathered forward, reduce-scattered backward
        assert kinds == {"all-gather": 2, "reduce-scatter": 2}, kinds
    assert sorted({o["block"] for o in outs}) == [(0, S // 2), (S // 2, S)]


def _batch(cfg, seed=3, rows=B):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (rows, S), dtype=np.int64)
    labels = np.concatenate([toks[:, 1:], np.full((rows, 1), -1, np.int64)],
                            1)
    return {"tokens": toks, "labels": labels}


@pytest.mark.parametrize("arch", sorted(CASES))
def test_sharded_train_step_matches_the_reference(world, arch):
    kw = CASES[arch]
    rmodel = ref_build(ref_get_config(arch).reduced(**kw))
    assert rmodel.cfg.sliding_window == kw.get("sliding_window", 0)
    rparams = rmodel.init(jax.random.PRNGKey(7))
    batch = _batch(get_config(arch).reduced())
    outs = world.run(cases.train, arch, kw, *MESH, batch,
                     params=jax.tree.map(np.asarray, rparams))
    full, metrics, _ = outs[0]
    step = jax.jit(ref_train.make_train_step(rmodel, ref_opt.sgd(1e-2)))
    rb = {k: jnp.asarray(v.astype(np.int32)) for k, v in batch.items()}
    p, _, m = step(rparams, ref_opt.sgd(1e-2).init(rparams), rb)
    for k in ("loss", "grad_norm"):
        assert abs(metrics[0][k] - float(m[k])) <= REL * abs(float(m[k]))
    for a, b in zip(cases.load(full), jax.tree.leaves(p)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0,
                                   atol=PARAM_ATOL)
    for _, got, rep in outs:
        assert got == metrics
        # the rank's batch stays cut by sequence: 2 rows x 32 positions
        assert rep["local_shapes"] == {"tokens": (2, S // 2),
                                       "labels": (2, S // 2)}
        assert rep["cut"] == ["seq"]
        kinds = rep["collectives"]["kinds"]
        assert kinds["all-gather"] > 0 and kinds["reduce-scatter"] > 0


@pytest.mark.parametrize("arch", sorted(CASES))
def test_sharded_prefill_and_decode_match_single_device(world, arch):
    kw = CASES[arch]
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
    blocks = set()
    for (a, b), lg, (c, d), dec, report in outs:
        lo, hi = report["positions"]
        blocks.add((a, b, lo, hi))
        got = cases.load(lg)[0]
        assert got.shape[:2] == (2, S // 2)
        np.testing.assert_allclose(got, logits[a:b, lo:hi].numpy(),
                                   rtol=0, atol=TOL)
        np.testing.assert_allclose(dec, want[:, c:d], rtol=0, atol=TOL)
    # every (rows, positions) block once
    assert len(blocks) == 8


@pytest.mark.parametrize("arch,want", [
    ("phi3-mini-3.8b", "model"), ("yi-9b", "model"), ("qwen3-32b", "model"),
    ("gemma3-4b", "model"),
    # the vision prefix's and the encoder's sequences stay gathered whole
    ("phi-3-vision-4.2b", None), ("seamless-m4t-large-v2", None),
    # routing groups are runs of tokens: an MoE stack under fsdp too
    ("qwen3-moe-30b-a3b", None)])
def test_context_parallel_takes_token_only_dense_stacks(arch, want):
    from repro_torch.sharding import specs as sh
    cfg = get_config(arch).with_updates(sharding_profile="fsdp")
    with sh.config_rules(cfg):
        assert sh.context_parallel(cfg, sh.MeshShape(*MESH)) == want
        assert sh.context_parallel(cfg, sh.MeshShape(
            (4, 2), ("data", "model"))) is None
