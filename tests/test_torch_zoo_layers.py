"""The port's zoo layers against the reference's, from the same numpy
inputs and the reference's parameters: norms, RoPE, masks, grouped-query
and chunked attention, the causal depthwise conv, the Mamba2 block's
prefill (with and without the scan kernel's path) and decode step, the
KV cache's ring writes, and the config registry.

Tolerance: float32, 1e-5 (the same arithmetic; sums in another order),
except the Mamba2 block, 1e-5 relative to the largest output (its scan
sums chunk products the size of the output in another order)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.configs import registry as ref_registry  # noqa: E402
from repro.models import attention as ref_attn  # noqa: E402
from repro.models import kvcache as ref_kv  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro.models import ssm as ref_ssm  # noqa: E402
from repro_torch.configs import registry as port_registry  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import attention as port_attn  # noqa: E402
from repro_torch.models import kvcache as port_kv  # noqa: E402
from repro_torch.models import layers as port_layers  # noqa: E402
from repro_torch.models import ssm as port_ssm  # noqa: E402

TOL = 1e-5


def _np(*shape, seed=0, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _close(port, ref, atol=TOL):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref),
                               rtol=0, atol=atol)


def _params(tree):
    return params_from_jax(jax.tree.map(np.asarray, tree))


# -- norms, embeddings, RoPE, MLPs -------------------------------------------

@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_norms_match_reference(kind):
    x = _np(2, 5, 48, seed=1, scale=3.0)
    p = {"scale": _np(48, seed=2), "bias": _np(48, seed=3)}
    if kind == "rmsnorm":
        p.pop("bias")
    want = ref_layers.apply_norm(kind, jax.tree.map(jnp.asarray, p),
                                 jnp.asarray(x), 1e-6)
    got = port_layers.apply_norm(kind, params_from_jax(p), torch.as_tensor(x),
                                 1e-6)
    _close(got, want)


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_rope_matches_reference(theta):
    x = _np(2, 7, 3, 32, seed=4)
    pos = np.broadcast_to(np.arange(7, dtype=np.int32) + 5, (2, 7))
    want = ref_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = port_layers.apply_rope(torch.as_tensor(x),
                                 torch.as_tensor(np.array(pos)), theta)
    _close(got, want)


def test_embed_unembed_and_mlps_match_reference():
    key = jax.random.PRNGKey(0)
    emb = ref_layers.init_embedding(key, 50, 32)
    sw = ref_layers.init_swiglu_mlp(jax.random.PRNGKey(1), 32, 64)
    ge = ref_layers.init_gelu_mlp(jax.random.PRNGKey(2), 32, 64)
    toks = np.random.default_rng(5).integers(0, 50, (2, 6))
    x = _np(2, 6, 32, seed=6)
    _close(port_layers.embed(_params(emb), torch.as_tensor(toks),
                             torch.float32),
           ref_layers.embed(emb, jnp.asarray(toks), jnp.float32))
    _close(port_layers.unembed(_params(emb), torch.as_tensor(x)),
           ref_layers.unembed(emb, jnp.asarray(x)))
    _close(port_layers.swiglu_mlp(_params(sw), torch.as_tensor(x)),
           ref_layers.swiglu_mlp(sw, jnp.asarray(x)))
    _close(port_layers.gelu_mlp(_params(ge), torch.as_tensor(x)),
           ref_layers.gelu_mlp(ge, jnp.asarray(x)))


# -- attention ---------------------------------------------------------------

@pytest.mark.parametrize("q_len,kv_len,causal,window,q_offset", [
    (8, 8, True, 0, 0), (8, 8, True, 3, 0), (4, 12, True, 0, 8),
    (6, 6, False, 2, 0), (5, 9, False, 0, 0)])
def test_attention_mask_matches_reference(q_len, kv_len, causal, window,
                                          q_offset):
    want = ref_attn.make_attention_mask(q_len, kv_len, causal=causal,
                                        window=window, q_offset=q_offset)
    got = port_attn.make_attention_mask(q_len, kv_len, causal=causal,
                                        window=window, q_offset=q_offset)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("H,Hk,mask_kind", [(4, 2, "causal"), (4, 4, "window"),
                                            (6, 1, "batched"), (2, 2, None)])
def test_gqa_attention_matches_reference(H, Hk, mask_kind):
    B, S, dh = 2, 10, 16
    q, k, v = (_np(B, S, n, dh, seed=s) for s, n in ((7, H), (8, Hk), (9, Hk)))
    mask = None
    if mask_kind == "causal":
        mask = np.array(ref_attn.make_attention_mask(S, S))
    elif mask_kind == "window":
        mask = np.array(ref_attn.make_attention_mask(S, S, window=4))
    elif mask_kind == "batched":
        mask = np.broadcast_to(np.asarray(ref_attn.make_attention_mask(S, S)),
                               (B, 1, S, S)).copy()
    want = ref_attn.gqa_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None if mask is None else jnp.asarray(mask))
    got = port_attn.gqa_attention(
        *(torch.as_tensor(a) for a in (q, k, v)),
        None if mask is None else torch.as_tensor(mask))
    _close(got, want)


@pytest.mark.parametrize("causal,window,chunk", [(True, 0, 16), (True, 7, 12),
                                                 (False, 0, 64), (True, 0, 7)])
def test_chunked_attention_matches_reference(causal, window, chunk):
    q, k, v = _np(2, 48, 4, 16, seed=10), _np(2, 48, 2, 16, seed=11), \
        _np(2, 48, 2, 16, seed=12)
    want = ref_attn.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), causal=causal,
                                      window=window, chunk=chunk)
    got = port_attn.chunked_attention(*(torch.as_tensor(a) for a in (q, k, v)),
                                      causal=causal, window=window,
                                      chunk=chunk)
    _close(got, want)


# -- Mamba2 ------------------------------------------------------------------

def _zamba_cfgs():
    kw = dict(dtype="float32", num_layers=4, block_pattern=("mamba",) * 4)
    return (ref_registry.get_config("zamba2-1.2b").reduced(**kw),
            port_registry.get_config("zamba2-1.2b").reduced(**kw))


def test_causal_depthwise_conv_matches_reference():
    x, w = _np(2, 9, 20, seed=13), _np(4, 20, seed=14)
    _close(port_ssm._causal_depthwise_conv(torch.as_tensor(x),
                                           torch.as_tensor(w)),
           ref_ssm._causal_depthwise_conv(jnp.asarray(x), jnp.asarray(w)))


@pytest.mark.parametrize("use_kernel", [False, True])
def test_mamba2_forward_matches_reference(use_kernel):
    rcfg, pcfg = _zamba_cfgs()
    rp = ref_ssm.init_mamba2(jax.random.PRNGKey(3), rcfg)
    x = _np(2, 128, rcfg.d_model, seed=15)
    want = np.asarray(jax.jit(ref_ssm.mamba2_forward, static_argnums=1)(
        rp, rcfg, jnp.asarray(x)))
    got = port_ssm.mamba2_forward(_params(rp), pcfg, torch.as_tensor(x),
                                  use_kernel=use_kernel)
    _close(got, want, atol=TOL * float(np.abs(want).max()))


def test_mamba2_step_matches_reference_over_a_sequence():
    rcfg, pcfg = _zamba_cfgs()
    rp = ref_ssm.init_mamba2(jax.random.PRNGKey(4), rcfg)
    pp = _params(rp)
    B = 2
    H = ref_ssm.ssm_heads(rcfg)
    conv = np.zeros((B, rcfg.conv_dim - 1, ref_ssm.conv_channels(rcfg)),
                    np.float32)
    st = np.zeros((B, H, rcfg.ssm_head_dim, rcfg.ssm_state), np.float32)
    rconv, rst = jnp.asarray(conv), jnp.asarray(st)
    pconv, pst = torch.as_tensor(conv), torch.as_tensor(st)
    for t in range(5):
        x = _np(B, 1, rcfg.d_model, seed=20 + t)
        ry, rconv, rst = ref_ssm.mamba2_step(rp, rcfg, jnp.asarray(x),
                                             rconv, rst)
        py, pconv, pst = port_ssm.mamba2_step(pp, pcfg, torch.as_tensor(x),
                                              pconv, pst)
        _close(py, ry)
        _close(pconv, rconv)
        _close(pst, rst)


# -- KV cache ----------------------------------------------------------------

@pytest.mark.parametrize("window", [0, 4])
def test_kvcache_ring_writes_and_valid_mask_match_reference(window):
    cap = 4 if window else 6
    ck = np.zeros((1, cap, 2, 3), np.float32)
    rk, rv = jnp.asarray(ck), jnp.asarray(ck)
    pk, pv = torch.tensor(ck), torch.tensor(ck)    # two buffers
    for index in range(7):           # wraps the ring; clamps the full cache
        nk, nv = _np(1, 1, 2, 3, seed=30 + index), _np(1, 1, 2, 3,
                                                       seed=40 + index)
        rk, rv = ref_kv.update_layer(rk, rv, index, jnp.asarray(nk),
                                     jnp.asarray(nv), window=window)
        pk2, pv2 = port_kv.update_layer(pk, pv, index, torch.as_tensor(nk),
                                        torch.as_tensor(nv), window=window)
        assert pk2 is pk and pv2 is pv              # written in place
        np.testing.assert_array_equal(pk.numpy(), np.asarray(rk))
        np.testing.assert_array_equal(pv.numpy(), np.asarray(rv))
        np.testing.assert_array_equal(
            port_kv.valid_mask(index, cap, window=window,
                               device="cpu").numpy(),
            np.asarray(ref_kv.valid_mask(index, cap, window=window)))
    cache = port_kv.init_cache(2, 1, cap, 2, 3, window=window,
                               prefill_len=3, device="cpu")
    assert cache.capacity == cap and cache.index == 3
    assert port_kv.cache_layer(cache, 1)[0].shape == (1, cap, 2, 3)


# -- configs -----------------------------------------------------------------

def _fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


@pytest.mark.parametrize("arch", sorted(ref_registry._ARCH_MODULES))
def test_registry_configs_equal_reference(arch):
    ref_cfg, port_cfg = (ref_registry.get_config(arch),
                         port_registry.get_config(arch))
    assert _fields(port_cfg) == _fields(ref_cfg)
    if arch != "paper-cnn":
        assert _fields(port_cfg.reduced()) == _fields(ref_cfg.reduced())
        assert port_cfg.layer_kinds() == ref_cfg.layer_kinds()
        assert port_cfg.activation_dtype == getattr(
            torch, np.dtype(ref_cfg.activation_dtype).name)
        assert port_cfg.parameter_dtype == torch.float32
    assert port_registry.ARCH_IDS == ref_registry.ARCH_IDS
    assert port_registry.combos() == ref_registry.combos()
