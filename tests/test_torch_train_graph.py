"""The train step bound to its params and optimizer state and, on the
card, captured as one CUDA graph (`launch.train.make_graphed_train_step`,
the port's form of the reference's `jax.jit(make_train_step(...))`).

On the CPU its in-place body runs eagerly: two steps from successive
states equal two `make_train_step` steps bit for bit (params, optimizer
state, metrics), for SGD with momentum and AdamW, grad_accum 1 and 2,
remat on and off, on phi3-mini and on zamba2 (4 Mamba2 layers and the
shared block) reduced, in float32, and for every zoo config reduced (its
vision or audio inputs too). The step writes into the buffers it
was made with (the same tensor objects and storage), refuses other params
or state, and runs a second batch shape. The card cases (capture
and replay, every zoo config among them, a second shape in the first
graph's pool, a capture that fails) skip without a card; none imports
jax.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.configs.registry import ARCH_IDS, get_config  # noqa: E402
from repro_torch.device import generator  # noqa: E402
from repro_torch.launch.train import (make_graphed_train_step,  # noqa: E402
                                      make_train_step)
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.models.model import synthetic_train_batch  # noqa: E402
from repro_torch.optim import optimizers  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

B, S = 2, 32
ARCHS = {
    "phi3-mini-3.8b": {},
    "zamba2-1.2b": dict(num_layers=4, block_pattern=("mamba",) * 4),
}
# every zoo config reduced; xlstm with an sLSTM (reduced() keeps two mLSTMs)
ZOO_KW = {"xlstm-125m": dict(block_pattern=("mlstm", "slstm"))}
OPTS = {
    "sgd": lambda: optimizers.sgd(0.1, momentum=0.9),
    "adamw": lambda: optimizers.adamw(3e-3, weight_decay=0.01),
}


def _cfg(arch, **kw):
    return get_config(arch).reduced(dtype="float32", **dict(ARCHS[arch],
                                                            **kw))


def _batch(cfg, rows=B, seq=S, seed=3, device="cpu"):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (rows, seq), dtype=np.int64)
    labels = np.concatenate([toks[:, 1:], np.full((rows, 1), -1, np.int64)],
                            1)
    labels[0, :5] = -1
    return {"tokens": torch.as_tensor(toks, device=device),
            "labels": torch.as_tensor(labels, device=device)}


def _same(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def _both(cfg, opt, batches, device="cpu"):
    """The eager steps and the graphed steps over `batches` from one init:
    [(eager params, state, metrics), ...] and [(graphed ...), ...], each
    entry copied out after its step; and the graphed step."""
    model = build_model(cfg)
    params = model.init(generator(0), device)
    p, s = tree_map(torch.clone, params), opt.init(params)
    gp, gs = tree_map(torch.clone, params), opt.init(params)
    eager = make_train_step(model, opt)
    step = make_graphed_train_step(model, opt, gp, gs, batches[0])
    want, got = [], []
    for b in batches:
        p, s, m = eager(p, s, b)
        want.append(tree_map(torch.clone, [p, s, m]))
        rp, rs, gm = step(gp, gs, b)
        assert rp is gp and rs is gs
        got.append(tree_map(torch.clone, [gp, gs, gm]))
    return want, got, step


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no-remat"])
@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("opt", sorted(OPTS))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_in_place_body_equals_the_eager_step(arch, opt, accum, remat):
    cfg = _cfg(arch, grad_accum=accum, remat=remat)
    batch = _batch(cfg)
    want, got, _ = _both(cfg, OPTS[opt](), [batch, batch])
    for w, g in zip(want, got):
        assert _same(w, g)
    # the second step moved the params again
    assert not _same(want[0][0], want[1][0])


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_zoo_config(arch):
    """Every zoo config reduced (float32, AdamW; its vision or audio
    inputs too; xlstm with an sLSTM): the in-place body equals the eager
    step."""
    cfg = get_config(arch).reduced(dtype="float32", **ZOO_KW.get(arch, {}))
    b = synthetic_train_batch(generator(1), cfg, B, 16, device="cpu")
    want, got, _ = _both(cfg, OPTS["adamw"](), [b, b])
    for w, g in zip(want, got):
        assert _same(w, g)


def test_step_keeps_its_buffers():
    cfg = _cfg("phi3-mini-3.8b")
    opt = OPTS["adamw"]()
    model = build_model(cfg)
    params = model.init(generator(0), "cpu")
    state = opt.init(params)
    leaves = tree_leaves([params, state])
    ptrs = [t.data_ptr() for t in leaves]
    before = tree_map(torch.clone, params)
    step = make_graphed_train_step(model, opt, params, state, _batch(cfg))
    p, s, _ = step(params, state, _batch(cfg))
    assert p is params and s is state
    after = tree_leaves([p, s])
    assert all(a is b for a, b in zip(after, leaves))
    assert [t.data_ptr() for t in after] == ptrs
    assert float(state["count"]) == 1.0
    assert not _same(before, params)


def test_step_refuses_other_params_or_state():
    cfg = _cfg("phi3-mini-3.8b")
    opt = OPTS["sgd"]()
    model = build_model(cfg)
    params = model.init(generator(0), "cpu")
    state = opt.init(params)
    batch = _batch(cfg)
    step = make_graphed_train_step(model, opt, params, state, batch)
    with pytest.raises(ValueError, match="made with"):
        step(tree_map(torch.clone, params), state, batch)
    with pytest.raises(ValueError, match="made with"):
        step(params, tree_map(torch.clone, state), batch)


def test_a_second_batch_shape_runs():
    """Steps on (2, 32), then (4, 16), then (2, 32) batches equal the
    eager steps."""
    cfg = _cfg("zamba2-1.2b")
    batches = [_batch(cfg), _batch(cfg, rows=4, seq=16, seed=4),
               _batch(cfg, seed=5)]
    want, got, _ = _both(cfg, OPTS["adamw"](), batches)
    for w, g in zip(want, got):
        assert _same(w, g)


# -- on the card ------------------------------------------------------------

@pytest.fixture
def cuda():
    # decided at run time, never at import or collection time
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (a CUDA graph has no CPU mode)")
    from repro_torch.device import deterministic_f32
    deterministic_f32()
    return torch.device("cuda")


@pytest.mark.parametrize("opt", sorted(OPTS))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_cuda_graph_replays_equal_eager_steps(cuda, arch, opt):
    """On the card: replays of the captured step from successive states
    equal the eager steps bit for bit, under grad_accum 2 with remat."""
    cfg = _cfg(arch, grad_accum=2)
    batch = _batch(cfg, device=cuda)
    want, got, step = _both(cfg, OPTS[opt](), [batch] * 3, cuda)
    assert len(step.graphs) == 1
    for w, g in zip(want, got):
        assert _same(w, g)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cuda_graph_every_zoo_config(cuda, arch):
    """Every zoo config reduced captures (no host read, no shape from the
    data) and replays the eager steps bit for bit."""
    cfg = get_config(arch).reduced(dtype="float32", **ZOO_KW.get(arch, {}))
    b = synthetic_train_batch(generator(1), cfg, B, 16, device=cuda)
    want, got, _ = _both(cfg, OPTS["adamw"](), [b, b], cuda)
    for w, g in zip(want, got):
        assert _same(w, g)


def test_cuda_graph_per_batch_shape(cuda):
    """A second batch shape is captured as a second graph, in the first
    graph's memory pool; replaying either still equals the eager steps."""
    cfg = _cfg("zamba2-1.2b")
    batches = [_batch(cfg, device=cuda),
               _batch(cfg, rows=4, seq=16, seed=4, device=cuda),
               _batch(cfg, seed=5, device=cuda)]
    want, got, step = _both(cfg, OPTS["adamw"](), batches, cuda)
    assert len(step.graphs) == 2
    for w, g in zip(want, got):
        assert _same(w, g)


def test_cuda_capture_that_fails_raises(cuda, monkeypatch):
    """A step that reads a device value on the host cannot be captured:
    RuntimeError, no eager fallback."""
    cfg = _cfg("phi3-mini-3.8b")
    model = build_model(cfg)
    real = model.loss

    def syncing(params, batch, token_mean=None):
        loss, aux = real(params, batch, token_mean)
        if float(loss.detach()) < 0:    # a host read of a device value
            raise AssertionError
        return loss, aux

    monkeypatch.setattr(model, "loss", syncing)
    opt = OPTS["sgd"]()
    params = model.init(generator(0), cuda)
    with pytest.raises(RuntimeError, match="could not be captured"):
        make_graphed_train_step(model, opt, params, opt.init(params),
                                _batch(cfg, device=cuda))
