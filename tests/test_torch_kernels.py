"""The port's `fedavg_agg` wrapper: its plain version against the
reference kernel in interpret mode over the reference's sweep
(tests/test_kernels.py), the CPU routing, the argument checks, and — on
a machine with a card — the CUDA kernel against its plain version.

The card's machine has no jax: there the reference comparisons skip and

    PYTHONPATH=src python -m pytest -q --noconftest \
        tests/test_torch_kernels.py -k cuda

runs the kernel tests (tests/conftest.py imports jax)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.kernels import fedavg_agg as port_fa  # noqa: E402
from repro_torch.kernels import ops as port_ops  # noqa: E402


def _inputs(C, N, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(C, N)).astype(np.float32)
    w = rng.uniform(0.1, 1.0, size=(C,)).astype(np.float32)
    return x, w / w.sum()


def _both(x, w, bf16):
    """(reference kernel in interpret mode, port plain version) as f32."""
    jnp = pytest.importorskip("jax.numpy")
    ref_fa = pytest.importorskip("repro.kernels.fedavg_agg")
    jx = jnp.asarray(x, jnp.bfloat16 if bf16 else jnp.float32)
    tx = torch.as_tensor(x).to(torch.bfloat16 if bf16 else torch.float32)
    ref = ref_fa.fedavg_agg(jx, jnp.asarray(w), block=4096, interpret=True)
    port = port_fa.fedavg_agg(tx, torch.as_tensor(w))
    assert port.dtype == tx.dtype and tuple(port.shape) == (x.shape[1],)
    return (np.asarray(ref, np.float32), port.float().numpy())


@pytest.mark.parametrize("C,N", [(2, 128), (3, 1000), (8, 50000), (16, 4097)])
@pytest.mark.parametrize("bf16", [False, True])
def test_plain_matches_reference_kernel(C, N, bf16):
    x, w = _inputs(C, N, C * N)
    ref, port = _both(x, w, bf16)
    np.testing.assert_allclose(port, ref, atol=2e-2 if bf16 else 1e-6)


@pytest.mark.parametrize("C,N", [(1, 4096), (1, 37), (3, 8191), (2, 8192),
                                 (5, 4097), (4, 7900)])
def test_plain_matches_reference_edges(C, N):
    x, w = _inputs(C, N, N)
    ref, port = _both(x, w, False)
    np.testing.assert_allclose(port, ref, atol=1e-6)


def test_cpu_tensor_takes_plain_path_without_launch():
    x, w = _inputs(4, 100, 0)
    before = port_fa.launches
    out = port_ops.fedavg_aggregate(torch.as_tensor(x), torch.as_tensor(w))
    assert port_fa.launches == before
    np.testing.assert_allclose(out.numpy(), w @ x, atol=1e-6)


@pytest.mark.parametrize("case", ["dtype", "weight_dtype", "rank",
                                  "noncontiguous", "weights_len", "empty"])
def test_wrapper_rejects_bad_arguments(case):
    x = torch.randn(4, 64)
    w = torch.full((4,), 0.25)
    if case == "dtype":
        args, exc = (x.double(), w), TypeError
    elif case == "weight_dtype":
        args, exc = (x, w.double()), TypeError
    elif case == "rank":
        args, exc = (x.reshape(4, 8, 8), w), ValueError
    elif case == "noncontiguous":
        args, exc = (torch.randn(64, 4).t(), w), ValueError
    elif case == "weights_len":
        args, exc = (x, torch.full((3,), 0.25)), ValueError
    else:
        args, exc = (torch.randn(4, 0), w), ValueError
    before = port_fa.launches
    with pytest.raises(exc):
        port_fa.fedavg_agg(*args)
    assert port_fa.launches == before


def test_zero_weight_client_drops_out():
    x = torch.randn(3, 1000)
    out = port_fa.fedavg_agg(x, torch.tensor([0.5, 0.0, 0.5]))
    np.testing.assert_allclose(out.numpy(), (0.5 * x[0] + 0.5 * x[2]).numpy(),
                               atol=1e-6)


@pytest.fixture
def cuda():
    # decided at run time, never at import or collection time
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("C,N,dtype", [
    (2, 7900, torch.float32), (4, 7900, torch.float32),
    (8, 7900, torch.float32), (1, 1, torch.float32),
    (3, 37, torch.float32), (5, 4097, torch.float32),
    (16, 1 << 20, torch.float32), (4, 5000, torch.bfloat16)])
def test_cuda_kernel_matches_plain(cuda, C, N, dtype):
    x, w = _inputs(C, N, C + N)
    tx = torch.as_tensor(x, device=cuda).to(dtype)
    tw = torch.as_tensor(w, device=cuda)
    before = port_fa.launches
    out = port_fa.fedavg_agg(tx, tw)
    torch.cuda.synchronize()
    assert port_fa.launches == before + 1
    exp = port_fa.fedavg_agg_torch(tx, tw)
    tol = 1e-6 if dtype == torch.float32 else 2e-2
    np.testing.assert_allclose(out.float().cpu().numpy(),
                               exp.float().cpu().numpy(), atol=tol)
