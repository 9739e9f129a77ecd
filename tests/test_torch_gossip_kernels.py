"""The port's `gossip_mix_agg` wrapper: its plain version against the
reference's masked-mix kernel in interpret mode and its CPU form
(`gossip_mix_jnp`), the CPU routing, the argument checks, and — on a
machine with a card — the CUDA kernel against its plain version.

Tolerances: float32 1e-6 abs and rel (the same products, summed in
another order), bfloat16 2e-2 (one bf16 rounding of the result). A dead
client's identity row must return its own row bit for bit.

The card's machine has no jax: there the reference comparisons skip and

    PYTHONPATH=src python -m pytest -q --noconftest \
        tests/test_torch_gossip_kernels.py -k cuda

runs the kernel tests (tests/conftest.py imports jax)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.core import membership, topology  # noqa: E402
from repro_torch.kernels import gossip_mix as port_gm  # noqa: E402
from repro_torch.kernels import ops as port_ops  # noqa: E402


def _reference():
    jnp = pytest.importorskip("jax.numpy")
    ref_gm = pytest.importorskip("repro.kernels.gossip_mix")
    return jnp, ref_gm


def _inputs(C, N, seed, p_dead=0.3, degree=4):
    """(C, N) normal stack and a masked row-stochastic mix from a ring
    under churn: dead rows identity, detected neighbors pruned."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(C, N)).astype(np.float32)
    alive = rng.random(C) >= p_dead
    mix = membership.masked_mix_matrix(
        topology.ring_neighbors(C, min(degree, max(C - 1, 0))), alive,
        ~alive)
    return x, mix, alive


def _tol(dtype):
    return 1e-6 if dtype == torch.float32 else 2e-2


@pytest.mark.parametrize("N", [1, 37, 300])
@pytest.mark.parametrize("C", [1, 2, 3, 8, 33])
def test_plain_matches_reference_kernel_and_jnp(C, N):
    jnp, ref_gm = _reference()
    x, mix, alive = _inputs(C, N, 10 * C + N)
    port = port_gm.gossip_mix_agg(torch.as_tensor(x), torch.as_tensor(mix))
    assert port.dtype == torch.float32 and tuple(port.shape) == (C, N)
    kernel = ref_gm.gossip_mix_agg(jnp.asarray(x), jnp.asarray(mix),
                                   block=128, interpret=True)
    plain = ref_gm.gossip_mix_jnp(jnp.asarray(x), jnp.asarray(mix))
    for ref in (kernel, plain):
        np.testing.assert_allclose(port.numpy(), np.asarray(ref),
                                   atol=1e-6, rtol=1e-6)
    dead = np.flatnonzero(~alive)
    np.testing.assert_array_equal(port.numpy()[dead], x[dead])


def test_bf16_matches_reference():
    jnp, ref_gm = _reference()
    x, mix, alive = _inputs(8, 5000, 4)
    tx = torch.as_tensor(x).to(torch.bfloat16)
    port = port_gm.gossip_mix_agg(tx, torch.as_tensor(mix))
    assert port.dtype == torch.bfloat16
    ref = ref_gm.gossip_mix_agg(jnp.asarray(x, jnp.bfloat16),
                                jnp.asarray(mix), interpret=True)
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(ref, np.float32), atol=2e-2)
    dead = torch.as_tensor(np.flatnonzero(~alive))
    assert torch.equal(port[dead], tx[dead])


def test_cpu_tensor_takes_plain_path_without_launch():
    x, mix, _ = _inputs(6, 100, 0)
    before = port_gm.launches
    out = port_ops.masked_gossip_aggregate(torch.as_tensor(x),
                                           torch.as_tensor(mix))
    assert port_gm.launches == before
    np.testing.assert_allclose(out.numpy(), mix @ x, atol=1e-6)


@pytest.mark.parametrize("case", ["x_rank", "mix_shape", "x_dtype",
                                  "mix_dtype", "noncontiguous",
                                  "too_many_clients", "empty"])
def test_wrapper_rejects_bad_arguments(case):
    x, mix = torch.randn(4, 64), torch.eye(4)
    exc = ValueError
    if case == "x_rank":
        x = x.reshape(4, 8, 8)
    elif case == "mix_shape":
        mix = torch.eye(5)
    elif case == "x_dtype":
        x, exc = x.double(), TypeError
    elif case == "mix_dtype":
        mix, exc = mix.bfloat16(), TypeError
    elif case == "noncontiguous":
        x = torch.randn(64, 4).t()
    elif case == "too_many_clients":
        n = port_gm.MAX_CLIENTS + 1
        x, mix = torch.randn(n, 2), torch.eye(n)
    else:
        x = torch.randn(4, 0)
    before = port_gm.launches
    with pytest.raises(exc):
        port_gm.gossip_mix_agg(x, mix)
    assert port_gm.launches == before


@pytest.fixture
def cuda():
    # decided at run time, never at import or collection time
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False     # plain version in f32
    return torch.device("cuda")


@pytest.mark.parametrize("C,N,dtype", [
    (8, 7900, torch.float32), (32, 7900, torch.float32),
    (1, 7900, torch.float32), (2, 37, torch.float32),
    (5, 4097, torch.float32), (33, 4097, torch.float32),
    (256, 7900, torch.float32), (1024, 300, torch.float32),
    (16, 1 << 20, torch.float32), (32, 7900, torch.bfloat16)])
def test_cuda_kernel_matches_plain(cuda, C, N, dtype):
    x, mix, alive = _inputs(C, N, C + N)
    x = torch.as_tensor(x, device=cuda).to(dtype)
    mix = torch.as_tensor(mix, device=cuda)
    before = port_gm.launches
    out = port_gm.gossip_mix_agg(x, mix)
    torch.cuda.synchronize()
    assert port_gm.launches == before + 1
    exp = port_gm.gossip_mix_torch(x, mix)
    assert out.dtype == dtype and tuple(out.shape) == (C, N)
    np.testing.assert_allclose(out.float().cpu().numpy(),
                               exp.float().cpu().numpy(), atol=_tol(dtype),
                               rtol=_tol(dtype))
    dead = torch.as_tensor(np.flatnonzero(~alive), device=cuda)
    assert torch.equal(out[dead], x[dead])


# the row tile is sized to C (8 rows up to C = 8, 32 up to C = 32, the
# 32 x 64 tiled kernel above): each side of both limits, 16-byte loads
# (N % 4 == 0 in float32, N % 8 == 0 in bfloat16) and element loads
@pytest.mark.parametrize("C,N,dtype", [
    (8, 7901, torch.float32), (9, 7900, torch.float32),
    (32, 7902, torch.float32), (32, 64, torch.float32),
    (8, 7900, torch.bfloat16), (8, 7903, torch.bfloat16),
    (31, 4100, torch.bfloat16), (33, 7900, torch.bfloat16)])
def test_cuda_kernel_edges_match_plain(cuda, C, N, dtype):
    test_cuda_kernel_matches_plain(cuda, C, N, dtype)


@pytest.mark.parametrize("C", [8, 32])
def test_cuda_kernel_bits_do_not_depend_on_the_load_path(cuda, C):
    """Every output is one chain of multiply-adds over j = 0 .. C - 1,
    whether x comes in 16-byte or element loads (a view 4 bytes off
    alignment), and on repeat; a dead client's row comes back bit for
    bit."""
    x, mix, alive = _inputs(C, 7900, 5 * C)
    x = torch.as_tensor(x, device=cuda)
    mix = torch.as_tensor(mix, device=cuda)
    out = port_gm.gossip_mix_agg(x, mix)
    flat = torch.empty(x.numel() + 1, device=cuda)
    shifted = flat[1:].view(x.shape)
    shifted.copy_(x)
    assert shifted.data_ptr() % 16 != 0
    assert torch.equal(port_gm.gossip_mix_agg(shifted, mix), out)
    assert torch.equal(port_gm.gossip_mix_agg(x, mix), out)
    dead = torch.as_tensor(np.flatnonzero(~alive), device=cuda)
    assert torch.equal(out[dead], x[dead])
