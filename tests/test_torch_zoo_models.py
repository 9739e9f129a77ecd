"""The port's model zoo serving path against the reference, for zamba2-1.2b
and yi-9b reduced, from the reference's parameters (carried across with
`convert.params_from_jax`) and the same numpy tokens: `Model.apply`
logits under every `attn_impl`, the prefill with the scan kernel's path,
teacher-forced `decode_step`, `greedy_generate`, `make_decode_dispatch`
and `loss_fn`; the tree helpers against `jax.tree.leaves` on a model's
parameters and decode state; the model kinds the port does not build.

Traps in `reduced()`: zamba2's gives 2 layers with `shared_attn_every=2`,
so the shared block (i > 0 and i % 2 == 0) never runs; the tests take 4
layers. yi-9b's gives 4 heads and 4 key/value heads, so no grouping; the
tests pass `num_kv_heads=2`. S = 128, the shortest sequence the flash
path tiles.

Tolerance: float32 logits within 1e-4 (30 layers of float32 arithmetic
in another order); generated tokens and correctness equal."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.configs.registry import get_config as ref_get_config  # noqa: E402
from repro.launch import serve as ref_serve  # noqa: E402
from repro.models import decode as ref_decode  # noqa: E402
from repro.models import transformer as ref_tf  # noqa: E402
from repro.models.model import build_model as ref_build  # noqa: E402
from repro_torch.configs.registry import ARCH_IDS  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.launch import serve as port_serve  # noqa: E402
from repro_torch.models import decode as port_decode  # noqa: E402
from repro_torch.models import ssm as port_ssm  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.models.model import synthetic_train_batch  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

TOL = 1e-4
S = 128
ARCHS = {
    "zamba2-1.2b": dict(dtype="float32", num_layers=4,
                        block_pattern=("mamba",) * 4),
    "yi-9b": dict(dtype="float32", num_kv_heads=2),
}


def _cfgs(arch, **kw):
    upd = dict(ARCHS[arch], **kw)
    return (ref_get_config(arch).reduced(**upd),
            get_config(arch).reduced(**upd))


@pytest.fixture(scope="module", params=sorted(ARCHS))
def zoo(request):
    """(arch, reference params, port params, tokens, reference einsum
    logits) for one reduced model, made once per module."""
    arch = request.param
    rcfg, _ = _cfgs(arch)
    rparams = ref_build(rcfg).init(jax.random.PRNGKey(7))
    pparams = params_from_jax(jax.tree.map(np.asarray, rparams))
    toks = np.random.default_rng(11).integers(0, rcfg.vocab_size, (2, S),
                                              dtype=np.int32)
    logits, _ = jax.jit(ref_build(rcfg).apply)(rparams,
                                               {"tokens": jnp.asarray(toks)})
    return arch, rparams, pparams, toks, np.asarray(logits)


def _port_logits(arch, pparams, toks, **kw):
    _, pcfg = _cfgs(arch, **kw)
    logits, aux = build_model(pcfg).apply(
        pparams, {"tokens": torch.as_tensor(toks).long()})
    assert logits.dtype == torch.float32 and float(aux) == 0.0
    return logits.numpy()


@pytest.mark.parametrize("impl", ["einsum", "flash", "chunked"])
def test_apply_matches_reference(zoo, impl):
    arch, rparams, pparams, toks, ref_einsum = zoo
    want = ref_einsum
    if impl != "einsum":
        rcfg, _ = _cfgs(arch, attn_impl=impl)
        want = np.asarray(ref_build(rcfg).apply(
            rparams, {"tokens": jnp.asarray(toks)})[0])
    got = _port_logits(arch, pparams, toks, attn_impl=impl)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_flash_prefill_launches_the_flash_path(zoo, monkeypatch):
    """attn_impl="flash" reaches ops.flash_attention once per attention
    layer run: zamba2's shared block once (4 layers, cadence 2), yi's 2
    layers twice."""
    arch, _, pparams, toks, _ = zoo
    from repro_torch.kernels import ops
    calls = []
    real = ops.flash_attention

    def spy(*a, **k):
        calls.append(a[0].shape)
        return real(*a, **k)
    monkeypatch.setattr(ops, "flash_attention", spy)
    _port_logits(arch, pparams, toks, attn_impl="flash")
    assert len(calls) == {"zamba2-1.2b": 1, "yi-9b": 2}[arch]


def test_kernel_prefill_matches_reference(zoo, monkeypatch):
    """The prefill with every mamba layer on the scan kernel's path
    against the reference's default prefill (`ssd_chunked`)."""
    arch, _, pparams, toks, ref_einsum = zoo
    if arch != "zamba2-1.2b":
        pytest.skip("no mamba layers")
    _, pcfg = _cfgs(arch, attn_impl="flash")
    from repro_torch.kernels import ops
    calls = []
    real = ops.ssm_scan
    monkeypatch.setattr(ops, "ssm_scan",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    # transformer.forward looks mamba2_forward up through the module
    monkeypatch.setattr(port_ssm, "mamba2_forward", functools.partial(
        port_ssm.mamba2_forward, use_kernel=True))
    prefill = port_serve.make_prefill_step(build_model(pcfg))
    logits = prefill(pparams, {"tokens": torch.as_tensor(toks).long()})
    assert len(calls) == pcfg.num_layers
    np.testing.assert_allclose(logits.numpy(), ref_einsum, rtol=0, atol=TOL)


def test_decode_steps_match_reference(zoo):
    arch, rparams, pparams, toks, _ = zoo
    rcfg, pcfg = _cfgs(arch)
    n = 8
    rstate = ref_decode.init_decode_state(rcfg, 2, n)
    pstate = build_model(pcfg).init_decode_state(2, n, device="cpu")
    rstep = jax.jit(ref_decode.decode_step, static_argnums=1)
    for t in range(n):
        rl, rstate = rstep(rparams, rcfg, rstate,
                           jnp.asarray(toks[:, t:t + 1]))
        pl, pstate = port_decode.decode_step(
            pparams, pcfg, pstate, torch.as_tensor(toks[:, t:t + 1]).long())
        np.testing.assert_allclose(pl.numpy(), np.asarray(rl), rtol=0,
                                   atol=TOL)
    assert pstate["index"] == n == int(rstate["index"])
    for p, r in zip(tree_leaves(pstate), jax.tree.leaves(rstate)):
        np.testing.assert_allclose(np.asarray(p), np.asarray(r), rtol=0,
                                   atol=TOL)


def test_greedy_generate_and_dispatch_match_reference(zoo, monkeypatch):
    arch, rparams, pparams, toks, _ = zoo
    rcfg, pcfg = _cfgs(arch)
    # the reference's own step, compiled once: the same computation as
    # its eager loop, in a fraction of the time
    monkeypatch.setattr(ref_decode, "decode_step",
                        jax.jit(ref_decode.decode_step, static_argnums=1))
    prompts = toks[:, :4]
    want = np.asarray(ref_decode.greedy_generate(rparams, rcfg,
                                                 jnp.asarray(prompts), 4))
    got = port_decode.greedy_generate(pparams, pcfg,
                                      torch.as_tensor(prompts).long(), 4)
    np.testing.assert_array_equal(got.numpy(), want)
    corpus, nxt = prompts, want[:, 4].copy()
    nxt[1] = (nxt[1] + 1) % rcfg.vocab_size        # one wrong answer
    idx = np.array([1, 0, 1])
    rd = ref_serve.make_decode_dispatch(rcfg, corpus, nxt)(rparams, idx)
    pd = port_serve.make_decode_dispatch(pcfg, corpus, nxt)(pparams, idx)
    np.testing.assert_array_equal(pd, np.asarray(rd))
    assert pd.tolist() == [False, True, False]


def test_loss_and_serve_steps_match_reference(zoo):
    arch, rparams, pparams, toks, ref_einsum = zoo
    rcfg, pcfg = _cfgs(arch)
    labels = np.concatenate([toks[:, 1:], np.full((2, 1), -1, np.int32)], 1)
    labels[0, :10] = -1
    rl, raux = ref_tf.loss_fn(rparams, rcfg, {"tokens": jnp.asarray(toks),
                                              "labels": jnp.asarray(labels)})
    model = build_model(pcfg)
    pl, paux = model.loss(pparams, {"tokens": torch.as_tensor(toks).long(),
                                    "labels": torch.as_tensor(labels).long()})
    np.testing.assert_allclose(float(pl), float(rl), rtol=0, atol=TOL)
    np.testing.assert_allclose(float(paux["nll"]), float(raux["nll"]),
                               rtol=0, atol=TOL)
    prefill = port_serve.make_prefill_step(model)
    np.testing.assert_allclose(
        prefill(pparams, {"tokens": torch.as_tensor(toks).long()}).numpy(),
        ref_einsum, rtol=0, atol=TOL)
    step = port_serve.make_serve_step(model)
    lg, st = step(pparams, model.init_decode_state(2, 4, device="cpu"),
                  torch.as_tensor(toks[:, :1]).long())
    np.testing.assert_allclose(lg.numpy(), ref_einsum[:, :1], rtol=0,
                               atol=TOL)
    assert st["index"] == 1
    assert model.param_count(pparams) == sum(
        a.size for a in jax.tree.leaves(rparams))


def test_tree_leaves_follow_jax_order_on_zoo_trees(zoo):
    """Parameters (scanned "layers", zamba2's "shared_attn") and the decode
    state (lists of per-layer dicts, zamba2's "shared" list) list their
    leaves as `jax.tree.leaves` does; None holds no leaf."""
    arch, rparams, pparams, _, _ = zoo
    rcfg, pcfg = _cfgs(arch)
    for p, r in zip(tree_leaves(pparams), jax.tree.leaves(rparams)):
        np.testing.assert_array_equal(p.numpy(), np.asarray(r))
    assert len(tree_leaves(pparams)) == len(jax.tree.leaves(rparams))
    rstate = ref_decode.init_decode_state(rcfg, 1, 4, prefill_len=2)
    pstate = port_decode.init_decode_state(pcfg, 1, 4, prefill_len=2,
                                           device="cpu")
    shapes = [tuple(np.shape(x)) for x in jax.tree.leaves(rstate)]
    assert [tuple(np.shape(x)) for x in tree_leaves(pstate)] == shapes
    blocks = {"blocks": [{"a": np.ones(2)}, None, {"b": np.zeros(3)}],
              "c": None, "d": [np.ones(1)]}
    assert [a.shape for a in tree_leaves(blocks)] == \
        [a.shape for a in jax.tree.leaves(blocks)]
    moved = tree_map(torch.as_tensor, params_from_jax(blocks))
    assert moved["blocks"][1] is None and moved["c"] is None
    assert isinstance(moved["blocks"], list)


def test_synthetic_batch_and_random_init_run():
    _, pcfg = _cfgs("zamba2-1.2b")
    g = torch.Generator().manual_seed(0)
    model = build_model(pcfg)
    params = model.init(g, device="cpu")
    batch = synthetic_train_batch(g, pcfg, 2, S, device="cpu")
    assert (batch["labels"][:, :-1] == batch["tokens"][:, 1:]).all()
    assert (batch["labels"][:, -1] == -1).all()
    logits, _ = model.apply(params, batch)
    assert logits.shape == (2, S, pcfg.vocab_size)
    assert torch.isfinite(logits).all()


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    _, pcfg = _cfgs("zamba2-1.2b")
    g = torch.Generator().manual_seed(0)
    model = build_model(pcfg)
    for call in (lambda: model.init(g), lambda: model.init_decode_state(1, 4),
                 lambda: synthetic_train_batch(g, pcfg, 1, 8)):
        with pytest.raises(RuntimeError, match="cuda"):
            call()


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_unported_kinds_raise_naming_the_roadmap(arch):
    cfg = get_config(arch)
    kinds = set(cfg.layer_kinds())
    if (not cfg.moe and cfg.attention_kind == "gqa" and cfg.modality == "text"
            and not cfg.encoder_layers and kinds <= {"attn", "mamba"}):
        assert build_model(cfg.reduced()).cfg is not None
        return
    with pytest.raises(NotImplementedError, match="A.17"):
        build_model(cfg)


def test_gemma3_flash_mirrors_the_reference_window_fault():
    """In a scanned local/global stack the reference passes the window
    only through the additive mask, which the flash path ignores, so under
    attn_impl="flash" gemma3's local layers attend globally (ROADMAP §C).
    The port holds to the reference: its flash logits equal the
    reference's flash logits, and both stand apart from the einsum path's
    (by 4.85 on this input, against max |logits| 4.43)."""
    kw = dict(dtype="float32", attn_impl="flash", head_dim=64,
              sliding_window=32, num_layers=2, global_every=2)
    rcfg = ref_get_config("gemma3-4b").reduced(**kw)
    pcfg = get_config("gemma3-4b").reduced(**kw)
    rparams = ref_build(rcfg).init(jax.random.PRNGKey(0))
    pparams = params_from_jax(jax.tree.map(np.asarray, rparams))
    toks = np.array(jax.random.randint(jax.random.PRNGKey(1), (1, S), 0,
                                        rcfg.vocab_size))
    want = np.asarray(ref_build(rcfg).apply(
        rparams, {"tokens": jnp.asarray(toks)})[0])
    got = build_model(pcfg).apply(
        pparams, {"tokens": torch.as_tensor(toks).long()})[0].numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    einsum = build_model(pcfg.with_updates(attn_impl="einsum")).apply(
        pparams, {"tokens": torch.as_tensor(toks).long()})[0].numpy()
    assert float(np.abs(got - einsum).max()) > 1.0
