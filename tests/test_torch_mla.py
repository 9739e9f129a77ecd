"""The port's Multi-head Latent Attention (`repro_torch.models.mla`) against
the reference's (`repro.models.mla`), from the same numpy inputs and the
reference's parameters: the prefill under the einsum and the chunked
(online-softmax over concatenated heads) paths, and the absorbed decode
step by step, caches included.

deepseek-v2-lite reduced: 4 heads, kv_lora_rank 64, qk_nope 32, qk_rope
16, v_head 32. Tolerance: float32, 1e-5 (the same arithmetic, sums in
another order)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.configs.registry import get_config as ref_get_config  # noqa: E402
from repro.models import mla as ref_mla  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import mla as port_mla  # noqa: E402

TOL = 1e-5
B, S = 2, 48
ARCH = "deepseek-v2-lite-16b"


@pytest.fixture(scope="module")
def mla_case():
    rcfg = ref_get_config(ARCH).reduced(dtype="float32")
    pcfg = get_config(ARCH).reduced(dtype="float32")
    rp = ref_mla.init_mla(jax.random.PRNGKey(0), rcfg)
    pp = params_from_jax(jax.tree.map(np.asarray, rp))
    x = np.random.default_rng(1).standard_normal(
        (B, S, rcfg.d_model)).astype(np.float32)
    return rcfg, pcfg, rp, pp, x


@pytest.mark.parametrize("impl", ["einsum", "chunked", "flash"])
def test_mla_attention_matches_reference(mla_case, impl):
    """"flash" takes the einsum path in both packages (MLA has no flash
    call); "chunked" runs 3 key chunks of 16."""
    rcfg, pcfg, rp, pp, x = mla_case
    rcfg = rcfg.with_updates(attn_impl=impl, attn_chunk=16)
    pcfg = pcfg.with_updates(attn_impl=impl, attn_chunk=16)
    pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    want = np.asarray(ref_mla.mla_attention(rp, rcfg, jnp.asarray(x),
                                            positions=jnp.asarray(pos)))
    got = port_mla.mla_attention(pp, pcfg, torch.as_tensor(x),
                                 positions=torch.as_tensor(pos)).numpy()
    assert got.shape == (B, S, rcfg.d_model)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_mla_decode_steps_match_reference(mla_case):
    """8 absorbed decode steps into caches of capacity 8: each step's
    output and both latent caches (B, cap, 1, r) / (B, cap, 1, rope)."""
    rcfg, pcfg, rp, pp, x = mla_case
    cap = 8
    rc = jnp.zeros((B, cap, 1, rcfg.kv_lora_rank))
    rk = jnp.zeros((B, cap, 1, rcfg.qk_rope_dim))
    pc, pk = torch.zeros(tuple(rc.shape)), torch.zeros(tuple(rk.shape))
    step = jax.jit(ref_mla.mla_decode, static_argnums=1)
    for t in range(cap):
        pos = np.full((B, 1), t, np.int32)
        ro, rc, rk = step(rp, rcfg, jnp.asarray(x[:, t:t + 1]),
                          positions=jnp.asarray(pos), c_kv_cache=rc,
                          k_pe_cache=rk, cache_index=t)
        po, pc, pk = port_mla.mla_decode(
            pp, pcfg, torch.as_tensor(x[:, t:t + 1]),
            positions=torch.as_tensor(pos), c_kv_cache=pc, k_pe_cache=pk,
            cache_index=t)
        np.testing.assert_allclose(po.numpy(), np.asarray(ro), rtol=0,
                                   atol=TOL)
    np.testing.assert_allclose(pc.numpy(), np.asarray(rc), rtol=0, atol=TOL)
    np.testing.assert_allclose(pk.numpy(), np.asarray(rk), rtol=0, atol=TOL)


def test_mla_decode_matches_its_prefill(mla_case):
    """The absorbed form computes the expanded form's attention: decode
    step t equals prefill row t (1e-5)."""
    _, pcfg, _, pp, x = mla_case
    pos = torch.arange(S, dtype=torch.int32)[None].expand(B, S)
    full = port_mla.mla_attention(pp, pcfg, torch.as_tensor(x),
                                  positions=pos)
    pc = torch.zeros((B, S, 1, pcfg.kv_lora_rank))
    pk = torch.zeros((B, S, 1, pcfg.qk_rope_dim))
    for t in range(S):
        out, pc, pk = port_mla.mla_decode(
            pp, pcfg, torch.as_tensor(x[:, t:t + 1]),
            positions=pos[:, t:t + 1], c_kv_cache=pc, k_pe_cache=pk,
            cache_index=t)
        np.testing.assert_allclose(out[:, 0].numpy(), full[:, t].numpy(),
                                   rtol=0, atol=TOL)
