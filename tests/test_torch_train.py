"""The port's zoo training (`repro_torch.launch.train`) against the
reference's (`repro.launch.train`), from the reference's parameters
(carried across with `convert.params_from_jax`) and the same numpy
batches, in float32: one `make_train_step` for four families (phi-3-mini;
zamba2 with the shared block; qwen3-moe with drops and the aux loss;
xlstm with an sLSTM), `grad_accum=2`, `train_loop`'s history on
`MarkovLM`; remat against no remat in the port; the reference's smoke
tests' twins over every config; the flash and scan kernels refusing
autograd as the reference's Pallas calls do; the dry-run specs.

The reference's Mamba2 gradient is NaN wherever a chunk's decay overflows:
`ssd_chunked` masks `exp(L)` with one `jnp.where`, and exp(L) of the
masked (future) pairs is inf, whose gradient through the where is
0 x inf (`repro/models/ssm.py:115`). The port masks L before the exp as
well (`repro_torch/models/ssm.py`), the same forward values with a finite
gradient. zamba2's steps are held to the reference with that one line
mended in a test-local copy (`_ssd_masked_twice`); the fault itself is
recorded by `test_reference_mamba2_gradient_overflows_where_the_port_does_not`.

Tolerances: loss and grad-norm within 1e-5 relative; params after one SGD
step within 1e-6 absolute (the update is lr x the clipped gradient, so a
gradient off by 1e-6 of its norm moves a parameter by 1e-7); the
`train_loop` history (AdamW, whose first steps move every parameter by
about lr whatever its gradient's size) within 1e-4; remat equal to no
remat bit for bit (it recomputes the same arithmetic)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.configs.registry import get_config as ref_get_config  # noqa: E402
from repro.kernels import ops as ref_kops  # noqa: E402
from repro.launch import train as ref_train  # noqa: E402
from repro.models import ssm as ref_ssm  # noqa: E402
from repro.models.model import build_model as ref_build  # noqa: E402
from repro.optim import optimizers as ref_opt  # noqa: E402
from repro_torch.configs.registry import ARCH_IDS, get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.device import generator  # noqa: E402
from repro_torch.kernels import flash_attention as port_flash  # noqa: E402
from repro_torch.kernels import ssm_scan as port_ssm_scan  # noqa: E402
from repro_torch.launch import train as port_train  # noqa: E402
from repro_torch.models import transformer as port_tf  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.models.model import synthetic_train_batch  # noqa: E402
from repro_torch.optim import optimizers  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

REL = 1e-5
PARAM_ATOL = 1e-6
HISTORY_TOL = 1e-4
LR = 0.1
S = 32
MOE, XLSTM, ZAMBA = "qwen3-moe-30b-a3b", "xlstm-125m", "zamba2-1.2b"
ARCHS = {
    "phi3-mini-3.8b": dict(dtype="float32"),
    ZAMBA: dict(dtype="float32", num_layers=4, block_pattern=("mamba",) * 4),
    MOE: dict(dtype="float32"),
    XLSTM: dict(dtype="float32", block_pattern=("mlstm", "slstm")),
}


def _ssd_masked_twice(xh, a_log, dt, Bm, Cm, chunk=128, h0=None):
    """The reference's `ssd_chunked` with L masked before the exp as well
    as after it (the port's form): the same values, a finite gradient."""
    Bsz, S, H, dh = xh.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    while S % Q:
        Q -= 1
    nc = S // Q
    f32 = jnp.float32
    xc = xh.reshape(Bsz, nc, Q, H, dh).astype(f32)
    ac = a_log.reshape(Bsz, nc, Q, H).astype(f32)
    dc = dt.reshape(Bsz, nc, Q, H).astype(f32)
    Bc = Bm.reshape(Bsz, nc, Q, N).astype(f32)
    Cc = Cm.reshape(Bsz, nc, Q, N).astype(f32)
    mask = (jnp.arange(Q)[:, None] >= jnp.arange(Q)[None, :])[None, :, :,
                                                               None]

    def step(h, inp):
        x_c, a_c, d_c, B_c, C_c = inp
        cs = jnp.cumsum(a_c, axis=1)
        G = jnp.einsum("bin,bjn->bij", C_c, B_c)
        L = cs[:, :, None, :] - cs[:, None, :, :]
        L = jnp.where(mask, jnp.exp(jnp.where(mask, L, 0.0)), 0.0)
        y_intra = jnp.einsum("bij,bijh,bjh,bjhd->bihd", G, L, d_c, x_c)
        y_inter = jnp.einsum("bqn,bqh,bhdn->bqhd", C_c, jnp.exp(cs), h)
        decay_end = jnp.exp(cs[:, -1:, :] - cs)
        S_c = jnp.einsum("bqh,bqh,bqn,bqhd->bhdn", decay_end, d_c, B_c, x_c)
        return jnp.exp(cs[:, -1, :])[:, :, None, None] * h + S_c, \
            y_intra + y_inter

    init = (jnp.zeros((Bsz, H, dh, N), f32) if h0 is None
            else h0.astype(f32))
    chunked = tuple(jnp.moveaxis(t, 1, 0) for t in (xc, ac, dc, Bc, Cc))
    hT, ys = jax.lax.scan(step, init, chunked)
    y = jnp.moveaxis(ys, 0, 1).reshape(Bsz, S, H, dh)
    return y.astype(xh.dtype), hT


@pytest.fixture(autouse=True)
def _mended_reference_ssd(monkeypatch):
    monkeypatch.setattr(ref_ssm, "ssd_chunked", _ssd_masked_twice)


def _cfgs(arch, **kw):
    upd = dict(ARCHS[arch], **kw)
    return (ref_get_config(arch).reduced(**upd),
            get_config(arch).reduced(**upd))


def _np_batch(cfg, B=2, seed=3, seq=S):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, seq), dtype=np.int32)
    labels = np.concatenate([toks[:, 1:], np.full((B, 1), -1, np.int32)], 1)
    labels[0, :5] = -1
    return {"tokens": toks, "labels": labels}


def _rb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _pb(batch):
    return port_train.device_batch(batch, "cpu")


def _ref_init(cfg, seed=7):
    params = ref_build(cfg).init(jax.random.PRNGKey(seed))
    return params, params_from_jax(jax.tree.map(np.asarray, params))


def _ref_step(cfg, rparams, batch, opt):
    model = ref_build(cfg)
    step = jax.jit(ref_train.make_train_step(model, opt))
    p, _, m = step(rparams, opt.init(rparams), _rb(batch))
    return [np.asarray(x) for x in jax.tree.leaves(p)], {
        k: float(v) for k, v in m.items()}


def _port_step(cfg, pparams, batch, opt):
    model = build_model(cfg)
    p, _, m = port_train.make_train_step(model, opt)(
        pparams, opt.init(pparams), _pb(batch))
    return [x.numpy() for x in tree_leaves(p)], {
        k: float(v) for k, v in m.items()}


def _assert_step(got, want):
    gp, gm = got
    wp, wm = want
    assert sorted(gm) == sorted(wm) == ["aux", "grad_norm", "loss", "nll"]
    for k in wm:
        np.testing.assert_allclose(gm[k], wm[k], rtol=REL, atol=1e-7)
    assert len(gp) == len(wp)
    for a, b in zip(gp, wp):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=0, atol=PARAM_ATOL)


@pytest.fixture(scope="module", params=sorted(ARCHS))
def zoo(request):
    arch = request.param
    rcfg, pcfg = _cfgs(arch)
    rparams, pparams = _ref_init(rcfg)
    return arch, rcfg, pcfg, rparams, pparams


def test_train_step_matches_reference(zoo):
    """One SGD step (clipped to global norm 1): loss, grad-norm, aux and
    every parameter."""
    arch, rcfg, pcfg, rparams, pparams = zoo
    batch = _np_batch(rcfg)
    want = _ref_step(rcfg, rparams, batch, ref_opt.sgd(LR))
    got = _port_step(pcfg, pparams, batch, optimizers.sgd(LR))
    _assert_step(got, want)
    if arch == MOE:
        assert got[1]["aux"] > 0 and got[1]["loss"] > got[1]["nll"]
    assert got[1]["grad_norm"] > 1.0        # the clip acted


def test_grad_accum_matches_reference(zoo):
    """grad_accum = 2 over a global batch of 4: micro-batches as the
    reference's reshape cuts them, float32 sums, mean loss and aux."""
    arch, _, _, rparams, pparams = zoo
    rcfg, pcfg = _cfgs(arch, grad_accum=2)
    batch = _np_batch(rcfg, B=4)
    want = _ref_step(rcfg, rparams, batch, ref_opt.sgd(LR))
    got = _port_step(pcfg, pparams, batch, optimizers.sgd(LR))
    _assert_step(got, want)


def test_remat_equals_no_remat_and_recomputes(zoo, monkeypatch):
    """cfg.remat recomputes each checkpointed unit in the backward pass
    (one forward of it more) and changes no bit of the step."""
    arch, _, _, _, pparams = zoo
    calls = []
    real = port_tf._apply_kind
    monkeypatch.setattr(port_tf, "_apply_kind",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    out = {}
    for remat in (True, False):
        _, pcfg = _cfgs(arch, remat=remat)
        batch = _np_batch(pcfg)
        calls.clear()
        out[remat] = _port_step(pcfg, pparams, batch, optimizers.sgd(LR))
        out[remat] = out[remat] + (len(calls),)
    layers = pcfg.num_layers
    assert out[True][2] == 2 * layers and out[False][2] == layers
    for a, b in zip(out[True][0], out[False][0]):
        np.testing.assert_array_equal(a, b)
    assert out[True][1] == out[False][1]


def test_remat_off_the_backward_pass():
    """No checkpoint when no backward pass can run: the prefill path is
    unchanged."""
    _, pcfg = _cfgs(ZAMBA)
    assert pcfg.remat
    model = build_model(pcfg)
    params = model.init(generator(0), "cpu")
    assert not port_tf._remat(pcfg, params)
    leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
    assert port_tf._remat(pcfg, params)
    with torch.no_grad():
        assert not port_tf._remat(pcfg, params)
    assert not port_tf._remat(pcfg.with_updates(remat=False), params)
    assert leaves


def test_train_loop_history_matches_reference(capsys):
    """train_loop on MarkovLM from the reference's init (seed 0): the
    logged losses of 4 AdamW steps."""
    rcfg, pcfg = _cfgs("phi3-mini-3.8b")
    rparams, pparams = _ref_init(rcfg, seed=0)
    kw = dict(steps=4, batch=2, seq_len=S, lr=3e-3, seed=0, log_every=1)
    _, want = ref_train.train_loop(ref_build(rcfg), **kw)
    _, got = port_train.train_loop(build_model(pcfg), params=pparams,
                                   device="cpu", **kw)
    assert [i for i, _ in got] == [i for i, _ in want] == [0, 1, 2, 3]
    np.testing.assert_allclose([v for _, v in got], [v for _, v in want],
                               rtol=0, atol=HISTORY_TOL)
    assert got[-1][1] < got[0][1]
    assert "step    3" in capsys.readouterr().out


def test_train_cli_runs_reduced(monkeypatch, capsys):
    monkeypatch.setattr("sys.argv", ["train", "--arch", "phi3-mini-3.8b",
                                     "--steps", "2", "--batch", "2",
                                     "--seq-len", "16", "--device", "cpu"])
    port_train.main()
    assert "step    1" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_train_step_no_nans(arch):
    """Twin of tests/test_smoke_archs.py::test_train_step_no_nans: every
    config reduced at its published dtypes, the port's own init."""
    cfg = get_config(arch).reduced()
    model = build_model(cfg)
    params = model.init(generator(0), "cpu")
    opt = optimizers.adamw(1e-3)
    batch = synthetic_train_batch(generator(1), cfg, 2, 32, device="cpu")
    params, _, metrics = port_train.make_train_step(model, opt)(
        params, opt.init(params), batch)
    assert bool(torch.isfinite(metrics["loss"])), f"{arch}: NaN loss"
    assert float(metrics["loss"]) > 0
    for leaf in tree_leaves(params):
        assert bool(torch.isfinite(leaf).all()), f"{arch}: NaN params"


def test_two_train_steps_reduce_loss():
    """Twin of tests/test_smoke_archs.py::test_two_train_steps_reduce_loss:
    8 AdamW steps on one repeated batch."""
    cfg = get_config("phi3-mini-3.8b").reduced()
    model = build_model(cfg)
    params = model.init(generator(0), "cpu")
    opt = optimizers.adamw(5e-3)
    opt_state = opt.init(params)
    batch = synthetic_train_batch(generator(0), cfg, 4, 64, device="cpu")
    step = port_train.make_train_step(model, opt)
    losses = []
    for _ in range(8):
        params, opt_state, m = step(params, opt_state, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] * 0.9, losses


# -- the kernels refuse autograd, as the reference's Pallas calls do ----------

def test_flash_backward_raises_in_both_packages():
    """model.loss(...).backward() under attn_impl="flash" at S = 128
    (zamba2's shared block takes the flash path): the reference's
    jax.grad through its interpret-mode kernel raises, the port's flash
    wrapper raises before any work."""
    rcfg, pcfg = _cfgs(ZAMBA, attn_impl="flash")
    rparams, pparams = _ref_init(rcfg)
    batch = _np_batch(rcfg, seq=128)
    with pytest.raises(AssertionError):
        jax.grad(lambda p: ref_build(rcfg).loss(p, _rb(batch))[0])(rparams)
    leaves = [p.requires_grad_(True) for p in tree_leaves(pparams)]
    with pytest.raises(RuntimeError, match="no backward pass"):
        build_model(pcfg).loss(pparams, _pb(batch))[0].backward()
    # the same loss without grad runs, and the einsum path trains
    with torch.no_grad():
        build_model(pcfg).loss(pparams, _pb(batch))
    build_model(_cfgs(ZAMBA)[1]).loss(pparams, _pb(batch))[0].backward()
    assert all(p.grad is not None for p in leaves)


def _ssm_inputs(rng, B=1, S=128, H=2, dh=32, N=16):
    return (rng.standard_normal((B, S, H, dh)).astype(np.float32),
            -np.abs(rng.standard_normal((B, S, H))).astype(np.float32),
            np.abs(rng.standard_normal((B, S, H))).astype(np.float32),
            rng.standard_normal((B, S, N)).astype(np.float32),
            rng.standard_normal((B, S, N)).astype(np.float32))


@pytest.mark.parametrize("argnum", range(5))
def test_ssm_scan_backward_raises_in_both_packages(argnum):
    """jax.grad through the reference's scan kernel (interpret mode)
    raises for each of its five inputs; so does the port's wrapper when
    that input requires grad. The plain version stays differentiable."""
    xs = _ssm_inputs(np.random.default_rng(argnum))
    with pytest.raises(AssertionError):
        jax.grad(lambda *a: ref_kops.ssm_scan(*a, interpret=True)[0].sum(),
                 argnums=argnum)(*map(jnp.asarray, xs))
    ts = [torch.as_tensor(x) for x in xs]
    ts[argnum].requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward pass"):
        port_ssm_scan.ssm_scan(*ts)
    with pytest.raises(RuntimeError, match="no backward pass"):
        port_ssm_scan.ssm_chunk_states(*ts)
    with torch.no_grad():
        port_ssm_scan.ssm_scan(*ts)
    port_ssm_scan.ssm_scan_torch(*ts).sum().backward()
    assert ts[argnum].grad is not None


@pytest.mark.parametrize("argnum", range(3))
def test_flash_attention_backward_raises_per_input(argnum):
    rng = np.random.default_rng(argnum)
    qkv = [rng.standard_normal((1, 128, 2, 32)).astype(np.float32)
           for _ in range(3)]
    with pytest.raises(AssertionError):
        jax.grad(lambda *a: ref_kops.flash_attention(
            *a, interpret=True).sum(), argnums=argnum)(*map(jnp.asarray, qkv))
    ts = [torch.as_tensor(x) for x in qkv]
    ts[argnum].requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward pass"):
        port_flash.flash_attention(*ts)
    port_flash.flash_attention_torch(*ts).sum().backward()
    assert ts[argnum].grad is not None


def test_reference_mamba2_gradient_overflows_where_the_port_does_not(
        monkeypatch):
    """The reference's own `ssd_chunked` gives NaN gradients on zamba2's
    first step (its masked exp(L) overflows); the mended copy and the port
    give the same finite ones, from the same forward values."""
    rcfg, pcfg = _cfgs(ZAMBA)
    rparams, pparams = _ref_init(rcfg)
    batch = _np_batch(rcfg)
    monkeypatch.undo()
    assert ref_ssm.ssd_chunked is not _ssd_masked_twice

    def grads(p):
        return jax.jit(jax.value_and_grad(lambda q: ref_build(rcfg).loss(
            q, _rb(batch))[0]))(p)
    loss, g = grads(rparams)
    bad = [x for x in jax.tree.leaves(g) if not bool(jnp.isfinite(x).all())]
    assert bad and np.isfinite(float(loss))
    monkeypatch.setattr(ref_ssm, "ssd_chunked", _ssd_masked_twice)
    loss2, g2 = grads(rparams)
    assert float(loss2) == pytest.approx(float(loss), rel=1e-6)
    assert all(bool(jnp.isfinite(x).all()) for x in jax.tree.leaves(g2))
    (ploss, _), pg = port_train.value_and_grad(build_model(pcfg).loss,
                                               pparams, _pb(batch))
    np.testing.assert_allclose(float(ploss), float(loss), rtol=REL)
    for a, b in zip(tree_leaves(pg), jax.tree.leaves(g2)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=PARAM_ATOL / LR)


def test_mamba2_kernel_path_backward_raises():
    """mamba2_forward(use_kernel=True) under autograd raises in both
    packages (the reference's through its interpret-mode kernel)."""
    from repro_torch.models import ssm as port_ssm
    rcfg, pcfg = _cfgs(ZAMBA)
    rparams, pparams = _ref_init(rcfg)
    rlp = jax.tree.map(lambda a: a[0], rparams["layers"]["mamba"])
    plp = port_tf.layer_params(pparams, 0)["mamba"]
    x = np.random.default_rng(0).standard_normal(
        (1, 128, rcfg.d_model)).astype(np.float32)
    with pytest.raises(AssertionError):
        jax.grad(lambda p: ref_ssm.mamba2_forward(
            p, rcfg, jnp.asarray(x), use_kernel=True).sum())(rlp)
    plp = {k: (v.requires_grad_(True) if k == "A_log" else v)
           for k, v in plp.items()}
    with pytest.raises(RuntimeError, match="no backward pass"):
        port_ssm.mamba2_forward(plp, pcfg, torch.as_tensor(x),
                                use_kernel=True)


# -- dry-run specs ------------------------------------------------------------

_DTYPES = {"int32": torch.int64, "bfloat16": torch.bfloat16,
           "float32": torch.float32}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_dry_run_specs_match_reference(arch):
    """train_batch_specs, decode_state_specs and decode_token_specs carry
    the reference's shapes and dtypes (int32 -> int64), on the meta
    device, for every config at its published size."""
    rm, pm = ref_build(ref_get_config(arch)), build_model(get_config(arch))
    want = rm.train_batch_specs(8, 4096)
    got = pm.train_batch_specs(8, 4096)
    assert sorted(got) == sorted(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape
        assert got[k].dtype == _DTYPES[str(want[k].dtype)]
        assert got[k].device.type == "meta"
    rstate = rm.decode_state_specs(2, 256)
    pstate = pm.decode_state_specs(2, 256)
    rleaves = [x for x in jax.tree.leaves(rstate) if x.ndim]
    pleaves = [x for x in tree_leaves(pstate) if x.ndim]
    assert [tuple(p.shape) for p in pleaves] == [r.shape for r in rleaves]
    assert [p.dtype for p in pleaves] == [_DTYPES[str(r.dtype)]
                                          for r in rleaves]
    assert all(p.device.type == "meta" for p in tree_leaves(pstate))
    # the index is the reference's scalar int32 spec: a 0-d int32 tensor
    # on the meta device, which holds no value to read
    assert tuple(pstate["index"].shape) == rstate["index"].shape == ()
    assert pstate["index"].dtype == torch.int32
    assert str(rstate["index"].dtype) == "int32"
    tok = pm.decode_token_specs(2)
    assert tuple(tok.shape) == rm.decode_token_specs(2).shape == (2, 1)
