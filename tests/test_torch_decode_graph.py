"""The decode state's "index" as the reference's 0-d int32 tensor, and
the serve step that runs `decode_step` in place (captured as one CUDA
graph on the card, `launch.serve.make_graphed_serve_step`).

From the reference's init (`convert.params_from_jax`) and the same numpy
tokens, the port's teacher-forced `decode_step` equals the reference's
within 1e-5 (float32 logits; every state leaf within 1e-5 absolute plus
1e-5 of its magnitude, as sLSTM's normalizer grows), for more steps than
the window ring holds, for each kind of decode state: full KV, a window
ring that wraps, the MLA latent cache, MoE, Mamba2 with zamba2's shared
block, mLSTM / sLSTM and seamless' cross K/V. The in-place step, run
eagerly on the CPU, equals the functional step bit for bit. The card
case (capture, replay, bitwise against eager) skips without a card; the
reference is imported only by the cases that compare with it, so the
card case runs where jax is absent.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.device import generator  # noqa: E402
from repro_torch.launch.serve import make_graphed_serve_step  # noqa: E402
from repro_torch.models import decode as port_decode  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

TOL = 1e-5
B = 2
STEPS = 12          # past the window ring's 8 slots
INPLACE_STEPS = 16
# one reduced config per kind of decode state (float32 for parity)
KINDS = {
    "full-kv": ("yi-9b", dict(num_kv_heads=2)),
    "window-ring": ("gemma3-4b", dict(num_layers=3, sliding_window=8,
                                      global_every=3)),
    "mla": ("deepseek-v2-lite-16b", {}),
    "moe": ("qwen3-moe-30b-a3b", {}),
    "mamba2-shared": ("zamba2-1.2b", dict(num_layers=4,
                                          block_pattern=("mamba",) * 4)),
    "xlstm": ("xlstm-125m", dict(block_pattern=("mlstm", "slstm"))),
    "cross-kv": ("seamless-m4t-large-v2", {}),
}


def _cfg(kind):
    arch, kw = KINDS[kind]
    return get_config(arch).reduced(dtype="float32", **kw)


def _tokens(cfg, n, seed=3):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (B, n), dtype=np.int32)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_decode_matches_reference_with_tensor_index(kind):
    jax = pytest.importorskip("jax")
    jnp = pytest.importorskip("jax.numpy")
    from repro.configs.registry import get_config as ref_get_config
    from repro.models import decode as ref_decode
    from repro.models.model import build_model as ref_build

    arch, kw = KINDS[kind]
    rcfg = ref_get_config(arch).reduced(dtype="float32", **kw)
    pcfg = _cfg(kind)
    rparams = ref_build(rcfg).init(jax.random.PRNGKey(7))
    pparams = params_from_jax(jax.tree.map(np.asarray, rparams))
    toks = _tokens(pcfg, STEPS)
    rstate = ref_decode.init_decode_state(rcfg, B, STEPS)
    pstate = port_decode.init_decode_state(pcfg, B, STEPS, device="cpu")
    if kind == "window-ring":      # the ring holds fewer slots than steps
        assert pstate["layers"][0]["k"].shape[1] == 8 < STEPS
        assert pstate["layers"][2]["k"].shape[1] == STEPS
    rstep = jax.jit(ref_decode.decode_step, static_argnums=1)
    for t in range(STEPS):
        rl, rstate = rstep(rparams, rcfg, rstate, jnp.asarray(toks[:, t:t + 1]))
        pl, pstate = port_decode.decode_step(
            pparams, pcfg, pstate, torch.as_tensor(toks[:, t:t + 1]).long())
        np.testing.assert_allclose(pl.numpy(), np.asarray(rl), rtol=0,
                                   atol=TOL)
        index = pstate["index"]
        assert isinstance(index, torch.Tensor) and index.dim() == 0
        assert index.dtype == torch.int32
        assert np.asarray(rstate["index"]).dtype == np.int32
        assert int(index) == int(rstate["index"]) == t + 1
    assert len(tree_leaves(pstate)) == len(jax.tree.leaves(rstate))
    for p, r in zip(tree_leaves(pstate), jax.tree.leaves(rstate)):
        # relative as well: sLSTM's normalizer n grows past 1
        np.testing.assert_allclose(p.numpy(), np.asarray(r), rtol=TOL,
                                   atol=TOL)


def _run_both(cfg, params, toks, device):
    """Teacher-forced steps through the functional `decode_step` and
    through the graphed serve step (in place) -> ([logits], state) each,
    logits cloned every step."""
    model = build_model(cfg)
    n = toks.shape[1]
    fstate = model.init_decode_state(B, n, device=device)
    gstate = model.init_decode_state(B, n, device=device)
    step = make_graphed_serve_step(model, params, gstate, toks[:, :1])
    fl, gl = [], []
    for t in range(n):
        lg, fstate = model.decode_step(params, fstate, toks[:, t:t + 1])
        fl.append(lg)
        lg, st = step(params, gstate, toks[:, t:t + 1])
        assert st is gstate
        gl.append(lg.clone())
    return (fl, fstate), (gl, gstate)


def _assert_same(a, b):
    (fl, fstate), (gl, gstate) = a, b
    for x, y in zip(fl, gl):
        assert torch.equal(x, y)
    assert len(tree_leaves(fstate)) == len(tree_leaves(gstate))
    for x, y in zip(tree_leaves(fstate), tree_leaves(gstate)):
        assert x.dtype == y.dtype and torch.equal(x, y)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_in_place_step_equals_functional_step_bitwise(kind):
    cfg = _cfg(kind)
    params = build_model(cfg).init(generator(0), "cpu")
    toks = torch.as_tensor(_tokens(cfg, INPLACE_STEPS, seed=5)).long()
    functional, in_place = _run_both(cfg, params, toks, "cpu")
    _assert_same(functional, in_place)
    assert int(in_place[1]["index"]) == INPLACE_STEPS


def test_graphed_step_refuses_other_params_or_state():
    cfg = _cfg("full-kv")
    model = build_model(cfg)
    params = model.init(generator(0), "cpu")
    state = model.init_decode_state(B, 4, device="cpu")
    tok = torch.zeros((B, 1), dtype=torch.long)
    step = make_graphed_serve_step(model, params, state, tok)
    with pytest.raises(ValueError, match="made with"):
        step(params, tree_map(torch.clone, state), tok)
    with pytest.raises(ValueError, match="made with"):
        step(tree_map(torch.clone, params), state, tok)


@pytest.fixture
def cuda():
    # decided at run time, never at import or collection time
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (a CUDA graph has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_cuda_graph_replays_equal_eager_steps(cuda, kind):
    """On the card: one captured step replayed INPLACE_STEPS times gives
    the eager steps' logits and state bit for bit."""
    from repro_torch.device import deterministic_f32
    deterministic_f32()
    cfg = _cfg(kind)
    params = build_model(cfg).init(generator(0), cuda)
    toks = torch.as_tensor(_tokens(cfg, INPLACE_STEPS, seed=5)).long().to(
        cuda)
    functional, graphed = _run_both(cfg, params, toks, cuda)
    _assert_same(functional, graphed)
