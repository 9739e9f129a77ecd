"""The port's xLSTM blocks (`repro_torch.models.xlstm`) against the
reference's (`repro.models.xlstm`), from the same numpy inputs and the
reference's parameters: the stabilized parallel and chunked mLSTM, the
mLSTM block under both, the mLSTM decode step, and the sLSTM over a
sequence and step by step, states included.

xlstm-125m reduced: d_model 256, 4 heads (mLSTM heads of 128 after the
2x up-projection, sLSTM heads of 64). Gate pre-activations are drawn
with spread 3, so the max-stabilizer switches between the input and
forget terms along the sequence. Tolerance: float32, 1e-5 (the same
arithmetic, sums and exponents in another order); for the bare mLSTM
cells 1e-5 of the largest output, since their normalizer
max(|sum_j W_tj|, exp(-m_t)) divides by a sum that can cancel (outputs
reach 410 on these inputs, where the two packages' float32 results
differ by up to 2.3e-4). A decode step against the parallel form is another
algorithm (the recurrence): 1e-4."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.configs.registry import get_config as ref_get_config  # noqa: E402
from repro.models import xlstm as ref_x  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import xlstm as port_x  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

TOL = 1e-5
B, S = 2, 48
ARCH = "xlstm-125m"


def _np(*shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _close(port, ref, atol=TOL):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), rtol=0,
                               atol=atol)


def _close_scaled(port, ref):
    ref = np.asarray(ref)
    _close(port, ref, atol=TOL * max(1.0, float(np.abs(ref).max())))


@pytest.fixture(scope="module")
def case():
    rcfg = ref_get_config(ARCH).reduced(dtype="float32")
    pcfg = get_config(ARCH).reduced(dtype="float32")
    rm = ref_x.init_mlstm(jax.random.PRNGKey(0), rcfg)
    rs = ref_x.init_slstm(jax.random.PRNGKey(1), rcfg)
    conv = lambda p: params_from_jax(jax.tree.map(np.asarray, p))  # noqa: E731
    x = _np(B, S, rcfg.d_model, seed=2)
    return rcfg, pcfg, rm, conv(rm), rs, conv(rs), x


def _qkvif(H=4, dh=32):
    q, k, v = (_np(B, S, H, dh, seed=s) for s in (3, 4, 5))
    i_raw = _np(B, S, H, seed=6, scale=3.0)
    f_raw = _np(B, S, H, seed=7, scale=3.0) + 2.0
    return q, k / np.sqrt(dh), v, i_raw, f_raw


def test_mlstm_parallel_matches_reference():
    args = _qkvif()
    want = ref_x.mlstm_parallel(*map(jnp.asarray, args))
    _close_scaled(port_x.mlstm_parallel(*map(torch.as_tensor, args)), want)


@pytest.mark.parametrize("chunk", [16, 48, 20])
def test_mlstm_chunked_matches_reference(chunk):
    """3 chunks of 16, one chunk, and 20 shrunk to 16 (S % chunk)."""
    args = _qkvif()
    want = ref_x.mlstm_chunked(*map(jnp.asarray, args), chunk=chunk)
    got = port_x.mlstm_chunked(*map(torch.as_tensor, args), chunk=chunk)
    _close_scaled(got, want)
    # and the chunked form is the parallel form
    _close_scaled(got, port_x.mlstm_parallel(*map(torch.as_tensor, args)))


@pytest.mark.parametrize("impl", ["parallel", "chunked"])
def test_mlstm_block_matches_reference(case, impl):
    rcfg, pcfg, rm, pm, _, _, x = case
    upd = dict(mlstm_impl=impl, mlstm_chunk=16)
    want = ref_x.mlstm_block(rm, rcfg.with_updates(**upd), jnp.asarray(x))
    got = port_x.mlstm_block(pm, pcfg.with_updates(**upd),
                             torch.as_tensor(x))
    assert got.shape == (B, S, rcfg.d_model)
    _close(got, want)


def test_mlstm_steps_match_reference(case):
    """16 decode steps: outputs and the (C, n, m) state; the outputs also
    meet the parallel block's rows."""
    rcfg, pcfg, rm, pm, _, _, x = case
    rst = ref_x.init_mlstm_state(rcfg, B)
    pst = port_x.init_mlstm_state(pcfg, B, device="cpu")
    step = jax.jit(ref_x.mlstm_step, static_argnums=1)
    full = port_x.mlstm_block(pm, pcfg, torch.as_tensor(x))
    for t in range(16):
        ry, rst = step(rm, rcfg, jnp.asarray(x[:, t:t + 1]), rst)
        py, pst = port_x.mlstm_step(pm, pcfg, torch.as_tensor(x[:, t:t + 1]),
                                    pst)
        _close(py, ry)
        _close(py[:, 0], full[:, t], atol=1e-4)
    for p, r in zip(tree_leaves(pst), jax.tree.leaves(rst)):
        _close(p, r)


def test_slstm_forward_matches_reference(case):
    rcfg, pcfg, _, _, rs, ps, x = case
    ry, rst = ref_x.slstm_forward(rs, rcfg, jnp.asarray(x))
    py, pst = port_x.slstm_forward(ps, pcfg, torch.as_tensor(x))
    assert py.shape == (B, S, rcfg.d_model)
    _close(py, ry)
    assert sorted(pst) == sorted(rst)
    for key in rst:
        _close(pst[key], rst[key])


def test_slstm_steps_match_reference(case):
    """Step by step from the initial state: each step's output equals the
    reference's step and the port's own sequence pass."""
    rcfg, pcfg, _, _, rs, ps, x = case
    rst = ref_x.init_slstm_state(rcfg, B)
    pst = port_x.init_slstm_state(pcfg, B, device="cpu")
    full, _ = port_x.slstm_forward(ps, pcfg, torch.as_tensor(x))
    step = jax.jit(ref_x.slstm_step, static_argnums=1)
    for t in range(16):
        ry, rst = step(rs, rcfg, jnp.asarray(x[:, t:t + 1]), rst)
        py, pst = port_x.slstm_step(ps, pcfg, torch.as_tensor(x[:, t:t + 1]),
                                    pst)
        _close(py, ry)
        _close(py[:, 0], full[:, t])
    for key in rst:
        _close(pst[key], rst[key])
