"""The port's `trimmed_mean_agg` wrapper: its plain version against the
reference's selection kernel in interpret mode and its CPU network
(`trimmed_mean_jnp`), the CPU routing, the argument checks, and — on a
machine with a card — the CUDA kernel against its plain version.

Tolerances: float32 1e-6 absolute (the same order statistics, summed in
another order), bfloat16 2e-2 (one bf16 rounding of the result). A NaN
column must come back NaN under all three; ±inf are ordinary values.

The card's machine has no jax: there the reference comparisons skip and

    PYTHONPATH=src python -m pytest -q --noconftest \
        tests/test_torch_robust_kernels.py -k cuda

runs the kernel tests (tests/conftest.py imports jax)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.kernels import ops as port_ops  # noqa: E402
from repro_torch.kernels import robust_agg as port_ra  # noqa: E402


def _reference():
    jnp = pytest.importorskip("jax.numpy")
    ref_ra = pytest.importorskip("repro.kernels.robust_agg")
    return jnp, ref_ra


def _inputs(C, N, seed, kind=""):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(C, N)).astype(np.float32)
    if kind == "ties":
        x = rng.integers(0, 3, size=(C, N)).astype(np.float32)
    elif kind == "inf":
        x[0, : N // 2] = np.inf
        x[C - 1, N // 3:] = -np.inf
    elif kind == "nan":
        x[C // 2, N // 2] = np.nan
    return x


def _assert_same(port, ref, atol):
    port = np.asarray(port, np.float32)
    ref = np.asarray(ref, np.float32)
    np.testing.assert_array_equal(np.isnan(port), np.isnan(ref))
    np.testing.assert_allclose(port, ref, atol=atol, equal_nan=True)


def _trims(C):
    return sorted({0, (C - 1) // 2, min(1, (C - 1) // 2)})


@pytest.mark.parametrize("N", [1, 37, 300])
@pytest.mark.parametrize("C", [1, 2, 3, 5, 8, 9, 16, 33])
def test_plain_matches_reference_kernel_and_network(C, N):
    jnp, ref_ra = _reference()
    for trim in _trims(C):
        x = _inputs(C, N, 100 * C + N + trim)
        port = port_ra.trimmed_mean_agg(torch.as_tensor(x), trim)
        assert port.dtype == torch.float32 and tuple(port.shape) == (N,)
        kernel = ref_ra.trimmed_mean_agg(jnp.asarray(x), trim, block=128,
                                         interpret=True)
        network = ref_ra.trimmed_mean_jnp(jnp.asarray(x), trim)
        _assert_same(port.numpy(), kernel, 1e-6)
        _assert_same(port.numpy(), network, 1e-6)


@pytest.mark.parametrize("kind", ["ties", "inf", "nan"])
@pytest.mark.parametrize("C", [5, 8])
def test_special_values_match_reference(kind, C):
    jnp, ref_ra = _reference()
    N = 300
    x = _inputs(C, N, C, kind)
    for trim in _trims(C):
        port = port_ra.trimmed_mean_torch(torch.as_tensor(x), trim).numpy()
        _assert_same(port, ref_ra.trimmed_mean_agg(
            jnp.asarray(x), trim, block=128, interpret=True), 1e-6)
        _assert_same(port, ref_ra.trimmed_mean_jnp(jnp.asarray(x), trim),
                     1e-6)
    if kind == "nan":
        # a NaN column is NaN whatever the trim; the other columns are not
        out = port_ra.median_agg(torch.as_tensor(x)).numpy()
        assert np.isnan(out[N // 2])
        assert np.isfinite(np.delete(out, N // 2)).all()


@pytest.mark.parametrize("C", [4, 5, 6, 7])
def test_median_averages_the_middle_pair(C):
    jnp, ref_ra = _reference()
    x = _inputs(C, 64, C)
    port = port_ra.median_agg(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(port, np.median(x, axis=0), atol=1e-6)
    _assert_same(port, ref_ra.median_agg(jnp.asarray(x), block=128,
                                         interpret=True), 1e-6)


def test_bf16_matches_reference():
    jnp, ref_ra = _reference()
    x = _inputs(4, 5000, 4)
    tx = torch.as_tensor(x).to(torch.bfloat16)
    port = port_ra.trimmed_mean_agg(tx, 1)
    assert port.dtype == torch.bfloat16
    ref = ref_ra.trimmed_mean_agg(jnp.asarray(x, jnp.bfloat16), 1,
                                  interpret=True)
    _assert_same(port.float().numpy(), np.asarray(ref, np.float32), 2e-2)


def test_cpu_tensor_takes_plain_path_without_launch():
    x = torch.as_tensor(_inputs(5, 100, 0))
    before = port_ra.launches
    out = port_ops.trimmed_mean_aggregate(x, 1)
    med = port_ops.median_aggregate(x)
    assert port_ra.launches == before
    s = np.sort(x.numpy(), axis=0)
    np.testing.assert_allclose(out.numpy(), s[1:4].mean(0), atol=1e-6)
    np.testing.assert_allclose(med.numpy(), s[2], atol=1e-6)


@pytest.mark.parametrize("case", ["trim_negative", "trim_too_large",
                                  "trim_half", "dtype", "rank",
                                  "noncontiguous", "too_many_clients",
                                  "empty"])
def test_wrapper_rejects_bad_arguments(case):
    x = torch.randn(4, 64)
    args, exc = (x, 1), ValueError
    if case == "trim_negative":
        args = (x, -1)
    elif case == "trim_too_large":
        args = (x, 3)
    elif case == "trim_half":
        args = (x, 2)                                 # 2*trim == C
    elif case == "dtype":
        args, exc = (x.double(), 1), TypeError
    elif case == "rank":
        args = (x.reshape(4, 8, 8), 1)
    elif case == "noncontiguous":
        args = (torch.randn(64, 4).t(), 1)
    elif case == "too_many_clients":
        args = (torch.randn(port_ra.MAX_CLIENTS + 1, 2), 1)
    else:
        args = (torch.randn(4, 0), 1)
    before = port_ra.launches
    with pytest.raises(exc):
        port_ra.trimmed_mean_agg(*args)
    if case.startswith("trim"):
        with pytest.raises(ValueError):
            port_ra.trimmed_mean_torch(*args)
    assert port_ra.launches == before


@pytest.fixture
def cuda():
    # decided at run time, never at import or collection time
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("C,N,trim,kind,dtype", [
    (32, 7900, 8, "", torch.float32), (32, 7900, 15, "", torch.float32),
    (8, 7900, 2, "", torch.float32), (8, 7900, 3, "", torch.float32),
    (4, 7900, 1, "", torch.float32), (1, 37, 0, "", torch.float32),
    (2, 37, 0, "", torch.float32), (5, 4097, 2, "", torch.float32),
    (33, 4097, 8, "", torch.float32), (256, 7900, 64, "", torch.float32),
    (600, 300, 100, "", torch.float32), (16, 1 << 20, 4, "", torch.float32),
    (9, 300, 2, "ties", torch.float32), (7, 300, 2, "inf", torch.float32),
    (6, 300, 1, "nan", torch.float32), (4, 5000, 1, "", torch.bfloat16),
    # the register kernel's padded column heights (C <= 64) and the
    # shared-memory kernel past them, at the main path's width, with ties,
    # inf, NaN and bfloat16 at 32 clients
    (16, 7900, 4, "", torch.float32), (33, 7900, 8, "", torch.float32),
    (64, 7900, 16, "", torch.float32), (64, 7900, 31, "", torch.float32),
    (65, 7900, 16, "", torch.float32),
    (32, 7900, 8, "ties", torch.float32), (32, 7900, 15, "nan",
                                           torch.float32),
    (32, 7900, 8, "inf", torch.float32), (32, 7900, 15, "",
                                          torch.bfloat16)])
def test_cuda_kernel_matches_plain(cuda, C, N, trim, kind, dtype):
    x = torch.as_tensor(_inputs(C, N, C + N, kind), device=cuda).to(dtype)
    before = port_ra.launches
    out = port_ra.trimmed_mean_agg(x, trim)
    torch.cuda.synchronize()
    assert port_ra.launches == before + 1
    exp = port_ra.trimmed_mean_torch(x, trim)
    assert out.dtype == dtype and tuple(out.shape) == (N,)
    _assert_same(out.float().cpu().numpy(), exp.float().cpu().numpy(),
                 1e-6 if dtype == torch.float32 else 2e-2)
