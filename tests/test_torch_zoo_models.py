"""The port's model zoo serving path against the reference, for every
config of the zoo's families reduced, from the reference's parameters
(carried across with `convert.params_from_jax`) and the same numpy
inputs: `Model.apply` logits and aux loss under every `attn_impl`, the
prefill with the scan kernel's path, teacher-forced `decode_step`,
`greedy_generate`, `make_decode_dispatch` and `loss_fn`; the tree
helpers against `jax.tree.leaves` on a model's parameters and decode
state; every config building and prefilling; the reference behaviours
the port mirrors (ROADMAP, "Known reference caveats").

Traps in `reduced()`: zamba2's gives 2 layers with `shared_attn_every=2`,
so the shared block (i > 0 and i % 2 == 0) never runs; the tests take 4
layers. yi-9b's gives 4 heads and 4 key/value heads, so no grouping; the
tests pass `num_kv_heads=2`. xlstm-125m's keeps the first two entries of
its pattern, ("mlstm", "mlstm"), so no sLSTM would run; the tests pass
("mlstm", "slstm"). The MoE configs keep their default capacity factor
1.25, so the prefill drops tokens (4 experts, top 2, groups of 64).
S = 128 positions, the shortest sequence the flash path tiles:
phi-3-vision's 8 patches + 120 tokens; seamless decodes 128 tokens
against 16 encoder frames.

Decode and greedy generation hold the port to the reference for every
config. For seamless and phi-3-vision they are not held to the prefill:
in both packages decode attends to zero cross-attention K/V (seamless)
and sees no patch prefix (phi-3-vision); see the mirror tests below.

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
MOE, MLA, XLSTM = "qwen3-moe-30b-a3b", "deepseek-v2-lite-16b", "xlstm-125m"
SEAMLESS, VISION = "seamless-m4t-large-v2", "phi-3-vision-4.2b"
ARCHS_VOCAB = 512          # every reduced config's vocabulary
ARCHS = {
    "zamba2-1.2b": dict(dtype="float32", num_layers=4,
                        block_pattern=("mamba",) * 4),
    "yi-9b": dict(dtype="float32", num_kv_heads=2),
    MOE: dict(dtype="float32"),
    MLA: dict(dtype="float32"),
    XLSTM: dict(dtype="float32", block_pattern=("mlstm", "slstm")),
    SEAMLESS: dict(dtype="float32"),
    VISION: dict(dtype="float32"),
}


def _cfgs(arch, **kw):
    upd = dict(ARCHS[arch], **kw)
    return (ref_get_config(arch).reduced(**upd),
            get_config(arch).reduced(**upd))


def _np_batch(cfg, seed=11, B=2):
    """Tokens (and the frontend's inputs) from a numpy seed, S positions
    in all: the vision prefix takes num_patches of them."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size,
                                    (B, S - cfg.num_patches),
                                    dtype=np.int32)}
    if cfg.modality == "vision":
        batch["vision_embeds"] = rng.standard_normal(
            (B, cfg.num_patches, cfg.d_model)).astype(np.float32)
    if cfg.encoder_layers:
        batch["audio_frames"] = rng.standard_normal(
            (B, cfg.num_frames, cfg.d_model)).astype(np.float32)
    return batch


def _rb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _pb(batch):
    return {k: (torch.as_tensor(v).long() if k in ("tokens", "labels")
                else torch.as_tensor(v)) for k, v in batch.items()}


@pytest.fixture(scope="module", params=sorted(ARCHS))
def zoo(request):
    """(arch, reference params, port params, numpy batch, reference
    einsum logits, reference aux loss) for one reduced model, made once
    per module."""
    arch = request.param
    rcfg, _ = _cfgs(arch)
    rparams = ref_build(rcfg).init(jax.random.PRNGKey(7))
    pparams = params_from_jax(jax.tree.map(np.asarray, rparams))
    batch = _np_batch(rcfg)
    logits, aux = jax.jit(ref_build(rcfg).apply)(rparams, _rb(batch))
    return arch, rparams, pparams, batch, np.asarray(logits), float(aux)


def _port_logits(arch, pparams, batch, **kw):
    _, pcfg = _cfgs(arch, **kw)
    logits, aux = build_model(pcfg).apply(pparams, _pb(batch))
    assert logits.dtype == torch.float32 and aux.dtype == torch.float32
    assert (float(aux) != 0.0) == pcfg.moe
    return logits.numpy(), float(aux)


@pytest.mark.parametrize("impl", ["einsum", "flash", "chunked"])
def test_apply_matches_reference(zoo, impl):
    arch, rparams, pparams, batch, ref_einsum, ref_aux = zoo
    want, want_aux = ref_einsum, ref_aux
    if impl != "einsum":
        rcfg, _ = _cfgs(arch, attn_impl=impl)
        want, want_aux = ref_build(rcfg).apply(rparams, _rb(batch))
        want, want_aux = np.asarray(want), float(want_aux)
    got, aux = _port_logits(arch, pparams, batch, attn_impl=impl)
    assert got.shape == want.shape == (2, S, ARCHS_VOCAB)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    np.testing.assert_allclose(aux, want_aux, rtol=0, atol=TOL)


def test_flash_prefill_launches_the_flash_path(zoo, monkeypatch):
    """attn_impl="flash" reaches ops.flash_attention once per attention
    layer run on 128 positions: zamba2's shared block once (4 layers,
    cadence 2), 2 layers of yi, qwen3-moe, phi-3-vision (patches and
    tokens) and seamless' decoder (its 16 encoder frames do not tile,
    its cross-attention never takes flash); none for MLA and xLSTM."""
    arch, _, pparams, batch, _, _ = zoo
    from repro_torch.kernels import ops
    calls = []
    real = ops.flash_attention

    def spy(*a, **k):
        calls.append(a[0].shape)
        return real(*a, **k)
    monkeypatch.setattr(ops, "flash_attention", spy)
    _port_logits(arch, pparams, batch, attn_impl="flash")
    assert len(calls) == {"zamba2-1.2b": 1, "yi-9b": 2, MOE: 2, MLA: 0,
                          XLSTM: 0, SEAMLESS: 2, VISION: 2}[arch]


def test_kernel_prefill_matches_reference(zoo, monkeypatch):
    """The prefill with every mamba layer on the scan kernel's path
    against the reference's default prefill (`ssd_chunked`)."""
    arch, _, pparams, batch, ref_einsum, _ = zoo
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
    logits = prefill(pparams, _pb(batch))
    assert len(calls) == pcfg.num_layers
    np.testing.assert_allclose(logits.numpy(), ref_einsum, rtol=0, atol=TOL)


def test_decode_steps_match_reference(zoo):
    """8 teacher-forced steps, logits and every leaf of the state (KV,
    MLA latents, Mamba2, mLSTM and sLSTM states, seamless' zero "cross"
    K/V)."""
    arch, rparams, pparams, batch, _, _ = zoo
    toks = batch["tokens"]
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
    assert len(tree_leaves(pstate)) == len(jax.tree.leaves(rstate))
    for p, r in zip(tree_leaves(pstate), jax.tree.leaves(rstate)):
        np.testing.assert_allclose(np.asarray(p), np.asarray(r), rtol=0,
                                   atol=TOL)


def test_greedy_generate_and_dispatch_match_reference(zoo, monkeypatch):
    arch, rparams, pparams, batch, _, _ = zoo
    rcfg, pcfg = _cfgs(arch)
    # the reference's own step, compiled once: the same computation as
    # its eager loop, in a fraction of the time
    monkeypatch.setattr(ref_decode, "decode_step",
                        jax.jit(ref_decode.decode_step, static_argnums=1))
    prompts = batch["tokens"][:, :4]
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
    """`loss_fn` (logits sliced to the token positions, plus
    aux_loss_weight x the MoE aux), the prefill step, and one serve step
    against the reference's decode step and, where decode sees what the
    prefill sees (no encoder, no patch prefix), the prefill's first row."""
    arch, rparams, pparams, batch, ref_einsum, _ = zoo
    rcfg, pcfg = _cfgs(arch)
    toks = batch["tokens"]
    labels = np.concatenate([toks[:, 1:], np.full((2, 1), -1, np.int32)], 1)
    labels[0, :10] = -1
    lbatch = dict(batch, labels=labels)
    rl, raux = jax.jit(ref_tf.loss_fn, static_argnums=1)(rparams, rcfg,
                                                         _rb(lbatch))
    model = build_model(pcfg)
    pl, paux = model.loss(pparams, _pb(lbatch))
    for got, want in ((pl, rl), (paux["nll"], raux["nll"]),
                      (paux["aux"], raux["aux"])):
        np.testing.assert_allclose(float(got), float(want), rtol=0, atol=TOL)
    assert (float(paux["aux"]) > 0) == pcfg.moe
    prefill = port_serve.make_prefill_step(model)
    np.testing.assert_allclose(prefill(pparams, _pb(batch)).numpy(),
                               ref_einsum, rtol=0, atol=TOL)
    step = port_serve.make_serve_step(model)
    lg, st = step(pparams, model.init_decode_state(2, 4, device="cpu"),
                  torch.as_tensor(toks[:, :1]).long())
    rlg, _ = jax.jit(ref_decode.decode_step, static_argnums=1)(
        rparams, rcfg, ref_decode.init_decode_state(rcfg, 2, 4),
        jnp.asarray(toks[:, :1]))
    np.testing.assert_allclose(lg.numpy(), np.asarray(rlg), rtol=0, atol=TOL)
    if arch not in (SEAMLESS, VISION):
        np.testing.assert_allclose(lg.numpy(), ref_einsum[:, :1], rtol=0,
                                   atol=TOL)
    assert st["index"] == 1
    assert model.param_count(pparams) == sum(
        a.size for a in jax.tree.leaves(rparams))


def test_tree_leaves_follow_jax_order_on_zoo_trees(zoo):
    """Parameters (scanned "layers", "blocks" lists and seamless'
    "blocks": None, zamba2's "shared_attn", MoE expert stacks) and the
    decode state (lists of per-layer dicts, zamba2's "shared" and
    seamless' "cross" lists) list their leaves as `jax.tree.leaves` does;
    None holds no leaf."""
    arch, rparams, pparams, _, _, _ = zoo
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
    """The port's own init and batch: seamless' batch carries bfloat16
    audio frames, phi-3-vision's bfloat16 patch embeddings."""
    g = torch.Generator().manual_seed(0)
    for arch in ("zamba2-1.2b", SEAMLESS, VISION):
        _, pcfg = _cfgs(arch)
        model = build_model(pcfg)
        params = model.init(g, device="cpu")
        batch = synthetic_train_batch(g, pcfg, 2, S, device="cpu")
        assert (batch["labels"][:, :-1] == batch["tokens"][:, 1:]).all()
        assert (batch["labels"][:, -1] == -1).all()
        extra = {SEAMLESS: ("audio_frames", pcfg.num_frames),
                 VISION: ("vision_embeds", pcfg.num_patches)}.get(arch)
        assert sorted(batch) == sorted(["tokens", "labels"]
                                       + ([extra[0]] if extra else []))
        if extra:
            assert batch[extra[0]].shape == (2, extra[1], pcfg.d_model)
            assert batch[extra[0]].dtype == torch.bfloat16
        logits, _ = model.apply(params, batch)
        assert logits.shape == (2, S + pcfg.num_patches, pcfg.vocab_size)
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
    """No layer kind, attention kind, FFN or frontend of the zoo is left
    unported, so no config raises any more: each of the 10 configs,
    reduced (xlstm with an sLSTM), builds from the port's own init and
    runs one prefill through `make_prefill_step` to finite logits over
    every position (phi-3-vision's patches included)."""
    cfg = get_config(arch).reduced(dtype="float32")
    if arch == XLSTM:
        cfg = cfg.with_updates(block_pattern=("mlstm", "slstm"))
    model = build_model(cfg)
    g = torch.Generator().manual_seed(0)
    params = model.init(g, device="cpu")
    batch = synthetic_train_batch(g, cfg, 1, 16, device="cpu")
    logits = port_serve.make_prefill_step(model)(params, batch)
    assert logits.shape == (1, 16 + cfg.num_patches, cfg.vocab_size)
    assert torch.isfinite(logits).all()


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


def _both_decodes(rcfg, pcfg, rparams, pparams, toks):
    """Teacher-forced decode over toks (B, n) in both packages -> (port
    logits, reference logits, port state)."""
    B, n = toks.shape
    rstate = ref_decode.init_decode_state(rcfg, B, n)
    pstate = port_decode.init_decode_state(pcfg, B, n, device="cpu")
    rstep = jax.jit(ref_decode.decode_step, static_argnums=1)
    pout, rout = [], []
    for t in range(n):
        rl, rstate = rstep(rparams, rcfg, rstate, jnp.asarray(toks[:, t:t + 1]))
        pl, pstate = port_decode.decode_step(
            pparams, pcfg, pstate, torch.as_tensor(toks[:, t:t + 1]).long())
        rout.append(np.asarray(rl))
        pout.append(pl.numpy())
    return np.concatenate(pout, 1), np.concatenate(rout, 1), pstate


def _built(arch, seed=0, **kw):
    rcfg, pcfg = _cfgs(arch, **kw)
    rparams = ref_build(rcfg).init(jax.random.PRNGKey(seed))
    return rcfg, pcfg, rparams, params_from_jax(
        jax.tree.map(np.asarray, rparams))


def test_seamless_flash_mirrors_the_reference_causal_encoder():
    """The encoder passes a bidirectional zero mask, but under
    attn_impl="flash" `attention` calls the flash path with its default
    causal=True, which ignores the mask (and the chunked path is causal
    too), so the encoder attends causally (ROADMAP §C). With 128 frames
    (the encoder tiles) the port's flash logits equal the reference's,
    its chunked logits equal its flash logits, and both stand apart from
    the einsum path's (by 1.71 on this input, against max |logits|
    3.52)."""
    rcfg, pcfg, rparams, pparams = _built(SEAMLESS, num_frames=128,
                                          attn_impl="flash")
    batch = _np_batch(rcfg, seed=3, B=1)
    want = np.asarray(ref_build(rcfg).apply(rparams, _rb(batch))[0])
    got = build_model(pcfg).apply(pparams, _pb(batch))[0].numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    chunked, einsum = (build_model(pcfg.with_updates(attn_impl=i)).apply(
        pparams, _pb(batch))[0].numpy() for i in ("chunked", "einsum"))
    np.testing.assert_allclose(chunked, got, rtol=0, atol=TOL)
    assert float(np.abs(got - einsum).max()) > 1.0


def test_seamless_decode_mirrors_the_reference_zero_cross_kv():
    """`init_decode_state` makes the cross-attention K/V zeros and nothing
    fills them from the encoder, in either package, so seamless decodes
    against zero K/V: the port's 16 teacher-forced steps equal the
    reference's, "cross" stays zero, and both stand apart from the
    prefill, which attends to the encoder (by 2.99 on this input, against
    max |logits| 3.52)."""
    rcfg, pcfg, rparams, pparams = _built(SEAMLESS)
    batch = _np_batch(rcfg, seed=3, B=1)
    toks = batch["tokens"][:, :16]
    got, want, pstate = _both_decodes(rcfg, pcfg, rparams, pparams, toks)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    assert all(float(t.abs().max()) == 0.0
               for t in tree_leaves(pstate["cross"]))
    prefill = build_model(pcfg).apply(pparams, _pb(batch))[0].numpy()
    assert float(np.abs(got - prefill[:, :16]).max()) > 1.0


def test_phi_vision_decode_mirrors_the_reference_missing_prefix():
    """`decode_step` takes tokens only, so phi-3-vision decodes without its
    patch prefix in either package: the port's 16 teacher-forced steps
    equal the reference's and stand apart from the prefill's token rows,
    which follow the 8 patches (by 4.97 on this input, against max
    |logits| 4.48)."""
    rcfg, pcfg, rparams, pparams = _built(VISION)
    batch = _np_batch(rcfg, seed=3, B=1)
    toks = batch["tokens"][:, :16]
    got, want, _ = _both_decodes(rcfg, pcfg, rparams, pparams, toks)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    P = pcfg.num_patches
    prefill = build_model(pcfg).apply(pparams, _pb(batch))[0].numpy()
    assert float(np.abs(got - prefill[:, P:P + 16]).max()) > 1.0


@pytest.mark.parametrize("cf", [1.25, 4.0])
def test_moe_decode_mirrors_the_reference_drop_free_only(cf):
    """A single-token decode never drops a token, but the parallel pass
    drops those that overflow an expert's capacity. At the default
    capacity factor 1.25 (B = 2 x 128 tokens, 4 experts, top 2, groups of
    64) the port's prefill and decode equal the reference's, and decode
    stands apart from the prefill (by 3.74 on this input, against max
    |logits| 5.12); drop-free (capacity_factor = E = 4) decode equals the
    prefill (5.2e-6 here)."""
    rcfg, pcfg, rparams, pparams = _built(MOE, seed=7, capacity_factor=cf)
    batch = _np_batch(rcfg)
    got, want, _ = _both_decodes(rcfg, pcfg, rparams, pparams,
                                 batch["tokens"])
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    prefill = build_model(pcfg).apply(pparams, _pb(batch))[0].numpy()
    ref_prefill = np.asarray(ref_build(rcfg).apply(rparams, _rb(batch))[0])
    np.testing.assert_allclose(prefill, ref_prefill, rtol=0, atol=TOL)
    gap = float(np.abs(got - prefill).max())
    assert gap > 1.0 if cf < pcfg.num_experts else gap <= TOL
