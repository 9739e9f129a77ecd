"""The port's MoE layer (`repro_torch.models.moe`) against the reference's
(`repro.models.moe`), from the same numpy inputs and the reference's
parameters (carried across with `convert.params_from_jax`): the router,
the GShard dispatch/combine tensor with and without dropped tokens, the
load-balance loss and the whole FFN with and without shared experts.

Tolerance: float32, 1e-5 (the same arithmetic, sums in another order);
routing choices, kept slots and the combine tensor's zeros equal. A tie
between two gates could make `torch.topk` and `jax.lax.top_k` pick
different experts; these float32 inputs have none, and a test that met
one would fail on the expert indices rather than hide it."""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.configs.registry import get_config as ref_get_config  # noqa: E402
from repro.models import moe as ref_moe  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import moe as port_moe  # noqa: E402

TOL = 1e-5


def _cfgs(arch, **kw):
    upd = dict(dtype="float32", **kw)
    return ref_get_config(arch).reduced(**upd), get_config(arch).reduced(**upd)


def _params(rcfg, seed=0):
    rp = ref_moe.init_moe(jax.random.PRNGKey(seed), rcfg)
    return rp, params_from_jax(jax.tree.map(np.asarray, rp))


def _x(*shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _routing(G, S, E, K, seed=2):
    """Gates and experts with a skew towards expert 0, so that expert
    overflows at capacity_factor 1.25: K distinct experts per token."""
    rng = np.random.default_rng(seed)
    p = np.arange(E, 0, -1, dtype=np.float64) ** 2
    idx = np.stack([np.stack([rng.choice(E, K, replace=False, p=p / p.sum())
                              for _ in range(S)]) for _ in range(G)])
    vals = rng.uniform(0.1, 1.0, (G, S, K)).astype(np.float32)
    vals /= vals.sum(-1, keepdims=True)
    return vals, idx.astype(np.int32)


def test_route_matches_reference():
    rcfg, _ = _cfgs("qwen3-moe-30b-a3b")
    rp, pp = _params(rcfg)
    x = _x(2, 64, rcfg.d_model)
    rv, ri, rg = ref_moe.route(rp["router"], jnp.asarray(x),
                               rcfg.num_experts, rcfg.top_k)
    pv, pi, pg = port_moe.route(pp["router"], torch.as_tensor(x),
                                rcfg.num_experts, rcfg.top_k)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ri))
    np.testing.assert_allclose(pv.numpy(), np.asarray(rv), rtol=0, atol=TOL)
    np.testing.assert_allclose(pg.numpy(), np.asarray(rg), rtol=0, atol=TOL)


@pytest.mark.parametrize("cf", [1.25, 8.0])
def test_dispatch_combine_masks_match_reference(cf):
    """At capacity_factor 1.25 the skewed routing overflows expert 0 and
    tokens are dropped (k-major, s-minor priority); at cf = E = 8 nothing
    is dropped. The combine tensors are equal value for value."""
    G, S, E, K = 2, 64, 8, 2
    vals, idx = _routing(G, S, E, K)
    C = ref_moe._capacity(S, K, E, cf)
    assert port_moe._capacity(S, K, E, cf) == C
    want = np.asarray(ref_moe.dispatch_combine_masks(
        jnp.asarray(vals), jnp.asarray(idx), E, C))
    got = port_moe.dispatch_combine_masks(
        torch.as_tensor(vals), torch.as_tensor(idx).long(), E, C).numpy()
    assert got.shape == want.shape == (G, S, E, C)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got > 0, want > 0)
    kept = int((want > 0).sum())
    if cf < E:
        assert kept < G * S * K          # tokens were dropped
    else:
        assert kept == G * S * K


def test_capacity_and_load_balance_loss_match_reference():
    for tokens, k, e, cf in ((64, 2, 4, 1.25), (512, 8, 128, 1.25),
                             (64, 8, 128, 128.0), (1, 6, 64, 1.25)):
        want = ref_moe._capacity(tokens, k, e, cf)
        assert port_moe._capacity(tokens, k, e, cf) == want
        assert want == max(8, 8 * math.ceil(
            math.ceil(tokens * k / e * cf) / 8))
    gates = np.random.default_rng(3).dirichlet(np.ones(8), (2, 64)).astype(
        np.float32)
    _, idx = _routing(2, 64, 8, 2)
    want = ref_moe.load_balance_loss(jnp.asarray(gates), jnp.asarray(idx), 8)
    got = port_moe.load_balance_loss(torch.as_tensor(gates),
                                     torch.as_tensor(idx).long(), 8)
    np.testing.assert_allclose(float(got), float(want), rtol=0, atol=TOL)


@pytest.mark.parametrize("arch,cf", [("qwen3-moe-30b-a3b", 1.25),
                                     ("qwen3-moe-30b-a3b", 4.0),
                                     ("deepseek-v2-lite-16b", 1.25)])
def test_moe_ffn_matches_reference(arch, cf):
    """qwen3-moe reduced (4 experts, top 2, no shared expert) with drops
    and drop-free; deepseek reduced (4 experts, top 2, 2 shared experts).
    B = 2 x S = 96: 192 tokens in groups of 64."""
    rcfg, pcfg = _cfgs(arch, capacity_factor=cf)
    assert bool(rcfg.num_shared_experts) == (arch != "qwen3-moe-30b-a3b")
    rp, pp = _params(rcfg)
    x = _x(2, 96, rcfg.d_model, seed=4)
    rout, raux = ref_moe.moe_ffn(rp, rcfg, jnp.asarray(x))
    pout, paux = port_moe.moe_ffn(pp, pcfg, torch.as_tensor(x))
    assert pout.shape == (2, 96, rcfg.d_model)
    np.testing.assert_allclose(pout.numpy(), np.asarray(rout), rtol=0,
                               atol=TOL)
    np.testing.assert_allclose(float(paux), float(raux), rtol=0, atol=TOL)
