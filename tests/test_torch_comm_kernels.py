"""The port's `dequant_agg` wrapper (kernel B4): its plain version against
the reference's fused dequantize-aggregate kernel in interpret mode and
its CPU form (`dequant_agg_jnp`), the CPU routing, the argument checks,
and — on a machine with a card — the CUDA kernel against its plain
version.

Tolerance: float32, 1e-6 relative to sum_c |s_c * w_c * q[c, n]| per
column (the same products, summed in another order).

The card's machine has no jax: there the reference comparisons skip and

    PYTHONPATH=src python -m pytest -q --noconftest \
        tests/test_torch_comm_kernels.py -k cuda

runs the kernel tests (tests/conftest.py imports jax)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.kernels import comm_agg as port_ca  # noqa: E402
from repro_torch.kernels import ops as port_ops  # noqa: E402


def _inputs(C, N, seed, kind=""):
    """int8 uploads, positive scales, normalized weights; `kind` picks an
    edge case: all-zero uploads, +-127 everywhere, a zero scale, a zero
    weight."""
    rng = np.random.default_rng(seed)
    q = rng.integers(-127, 128, size=(C, N)).astype(np.int8)
    s = rng.uniform(1e-3, 2e-2, size=(C,)).astype(np.float32)
    w = rng.uniform(0.1, 1.0, size=(C,)).astype(np.float32)
    if kind == "zero":
        q[:] = 0
    elif kind == "pm127":
        q = np.where(rng.random((C, N)) < 0.5, 127, -127).astype(np.int8)
    elif kind == "zero_scale":
        s[0] = 0.0
    elif kind == "zero_weight":
        w[-1] = 0.0
    return q, s, (w / w.sum()).astype(np.float32)


def _scale(q, s, w):
    """Per column sum_c |s_c w_c q[c, n]|: what the tolerance is relative
    to (floored at 1 ulp-sized value so all-zero columns compare
    exactly)."""
    sw = (s * w).astype(np.float32)
    return np.abs(q.astype(np.float32) * sw[:, None]).sum(0)


def _assert_close(got, want, q, s, w):
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert (err <= 1e-6 * _scale(q, s, w) + 1e-30).all(), float(err.max())


@pytest.mark.parametrize("C,N", [
    (1, 300), (3, 1000), (5, 1024), (4, 16384), (4, 16383), (4, 16385),
    (8, 300), (8, 7900), (32, 7900), (7, 7901), (2, 7902)])
def test_plain_matches_reference_kernel_and_jnp(C, N):
    jnp = pytest.importorskip("jax.numpy")
    ref_ca = pytest.importorskip("repro.kernels.comm_agg")
    q, s, w = _inputs(C, N, C * N)
    port = port_ca.dequant_agg(torch.as_tensor(q), torch.as_tensor(s),
                               torch.as_tensor(w))
    assert port.dtype == torch.float32 and tuple(port.shape) == (N,)
    kernel = ref_ca.dequant_agg(jnp.asarray(q), jnp.asarray(s),
                                jnp.asarray(w), interpret=True)
    plain = ref_ca.dequant_agg_jnp(jnp.asarray(q), jnp.asarray(s),
                                   jnp.asarray(w))
    for ref in (kernel, plain):
        _assert_close(port.numpy(), np.asarray(ref), q, s, w)


@pytest.mark.parametrize("kind", ["zero", "pm127", "zero_scale",
                                  "zero_weight"])
def test_plain_matches_reference_on_edge_values(kind):
    jnp = pytest.importorskip("jax.numpy")
    ref_ca = pytest.importorskip("repro.kernels.comm_agg")
    q, s, w = _inputs(6, 2048, 3, kind)
    port = port_ca.dequant_agg(torch.as_tensor(q), torch.as_tensor(s),
                               torch.as_tensor(w)).numpy()
    ref = np.asarray(ref_ca.dequant_agg(jnp.asarray(q), jnp.asarray(s),
                                        jnp.asarray(w), interpret=True))
    _assert_close(port, ref, q, s, w)
    if kind == "zero":
        np.testing.assert_array_equal(port, np.zeros(2048, np.float32))


def test_plain_folds_scale_times_weight_first():
    """The plain version multiplies each int8 value by the float32 product
    s_c * w_c (as the reference and the kernel do), not by s_c then w_c."""
    q, s, w = _inputs(4, 500, 9)
    sw = torch.as_tensor(s) * torch.as_tensor(w)
    want = (torch.as_tensor(q).float() * sw[:, None]).sum(0)
    got = port_ca.dequant_agg_torch(torch.as_tensor(q), torch.as_tensor(s),
                                    torch.as_tensor(w))
    assert torch.equal(got, want)


def test_cpu_tensor_takes_plain_path_without_launch():
    q, s, w = _inputs(4, 100, 0)
    before = port_ca.launches
    out = port_ops.dequant_aggregate(torch.as_tensor(q), torch.as_tensor(s),
                                     torch.as_tensor(w))
    assert port_ca.launches == before
    _assert_close(out.numpy(), (q.astype(np.float32)
                                * (s * w)[:, None]).sum(0), q, s, w)


@pytest.mark.parametrize("case", ["rank", "values_dtype", "scales_dtype",
                                  "weights_shape", "noncontiguous",
                                  "too_many_clients", "empty"])
def test_wrapper_rejects_bad_arguments(case):
    q = torch.zeros((4, 64), dtype=torch.int8)
    s, w = torch.ones(4), torch.full((4,), 0.25)
    exc = ValueError
    if case == "rank":
        q = q.reshape(4, 8, 8)
    elif case == "values_dtype":
        q, exc = q.float(), TypeError
    elif case == "scales_dtype":
        s, exc = s.double(), TypeError
    elif case == "weights_shape":
        w = torch.ones(5)
    elif case == "noncontiguous":
        q = torch.zeros((64, 4), dtype=torch.int8).t()
    elif case == "too_many_clients":
        n = port_ca.MAX_CLIENTS + 1
        q = torch.zeros((n, 2), dtype=torch.int8)
        s, w = torch.ones(n), torch.ones(n)
    else:
        q = torch.zeros((4, 0), dtype=torch.int8)
    before = port_ca.launches
    with pytest.raises(exc):
        port_ca.dequant_agg(q, s, w)
    assert port_ca.launches == before


@pytest.fixture
def cuda():
    # decided at run time, never at import or collection time
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("C,N,kind", [
    (8, 7900, ""), (32, 7900, ""), (64, 7900, ""), (1, 7900, ""),
    (4, 1, ""), (7, 7901, ""), (7, 7902, ""), (1024, 300, ""),
    (16, 1 << 20, ""), (32, 7900, "zero"), (32, 7900, "pm127"),
    (32, 7900, "zero_scale"), (32, 7900, "zero_weight"),
    # row groups: past one batch of loads, many batches, the envelope's
    # top, and the byte path with rows split over the warps
    (65, 7900, ""), (1024, 7900, ""), (12288, 7900, ""), (33, 7901, ""),
    (33, 7902, "")])
def test_cuda_kernel_matches_plain(cuda, C, N, kind):
    q, s, w = _inputs(C, N, C + N, kind)
    tq, ts, tw = (torch.as_tensor(a, device=cuda) for a in (q, s, w))
    before = port_ca.launches
    out = port_ca.dequant_agg(tq, ts, tw)
    torch.cuda.synchronize()
    assert port_ca.launches == before + 1
    assert out.dtype == torch.float32 and tuple(out.shape) == (N,)
    _assert_close(out.cpu().numpy(),
                  port_ca.dequant_agg_torch(tq, ts, tw).cpu().numpy(),
                  q, s, w)


def test_cuda_unaligned_view_is_read_correctly(cuda):
    """A row-slice view whose data pointer is not 4-byte aligned takes the
    byte-wise path and reads nothing outside its rows."""
    q, s, w = _inputs(9, 7900, 5)
    base = torch.as_tensor(q, device=cuda).reshape(-1)
    view = base[1:1 + 8 * 7899].reshape(8, 7899)
    ts, tw = (torch.as_tensor(a[:8], device=cuda) for a in (s, w))
    out = port_ca.dequant_agg(view, ts, tw)
    want = port_ca.dequant_agg_torch(view, ts, tw)
    _assert_close(out.cpu().numpy(), want.cpu().numpy(),
                  view.cpu().numpy(), s[:8], w[:8])


def test_cuda_kernel_repeats_bitwise(cuda):
    """The row groups' partial sums are added in one fixed order, without
    atomics: one input gives one result, bit for bit."""
    q, s, w = _inputs(32, 7900, 11)
    tq, ts, tw = (torch.as_tensor(a, device=cuda) for a in (q, s, w))
    first = port_ca.dequant_agg(tq, ts, tw)
    for _ in range(3):
        assert torch.equal(port_ca.dequant_agg(tq, ts, tw), first)
