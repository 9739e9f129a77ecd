"""The port's zoo kernels B5 (`flash_attention`) and B6 (`ssm_scan`): their
plain versions against the reference's Pallas kernels in interpret mode
and the reference's oracles, the CPU routing, the argument checks, and —
on a machine with a card — each CUDA kernel against its plain version.

Tolerances (float32): B5's plain version is a masked softmax, the
reference kernel an online softmax over 128-key tiles: the same sums in
another order, 1e-5 absolute (|out| <= max |v|). B6's plain version
repeats the chunked arithmetic of the reference kernel and of
`ssd_chunked`: 1e-5 relative to max |y| (its products sum up to 128
terms of the size of |y|, up to ~130 here, in another order; measured
4.7e-6), and against the exact sequential recurrence `ssm_scan_ref`
5e-3 absolute, the reference's own bar (tests/test_kernels.py).

The card's machine has no jax: there the reference comparisons skip and

    PYTHONPATH=src python -m pytest -q --noconftest \
        tests/test_torch_zoo_kernels.py -k cuda

runs the kernel tests (tests/conftest.py imports jax)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.kernels import flash_attention as port_fl  # noqa: E402
from repro_torch.kernels import ops as port_ops  # noqa: E402
from repro_torch.kernels import ssm_scan as port_ss  # noqa: E402
from repro_torch.obs import telemetry  # noqa: E402


def _qkv(B, S, T, H, Hk, d, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, d)).astype(np.float32)
    k = rng.standard_normal((B, T, Hk, d)).astype(np.float32)
    v = rng.standard_normal((B, T, Hk, d)).astype(np.float32)
    return q, k, v


def _ssm_inputs(B, S, H, dh, N, seed):
    rng = np.random.default_rng(seed)
    xh = rng.standard_normal((B, S, H, dh)).astype(np.float32)
    a = -np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32)
    Bm = rng.standard_normal((B, S, N)).astype(np.float32)
    Cm = rng.standard_normal((B, S, N)).astype(np.float32)
    return xh, a, dt, Bm, Cm


def _t(*arrays, device="cpu"):
    return [torch.as_tensor(a, device=device) for a in arrays]


# -- B5 ----------------------------------------------------------------------

# (BH, S, T, d, causal, window): the zoo's tilings at small size, T != S,
# a window narrower than a tile, non-causal, head dims 32 / 64 / 128
FLASH_CASES = [
    (2, 128, 128, 64, True, 0), (2, 256, 256, 64, True, 0),
    (2, 256, 256, 64, True, 64), (2, 256, 256, 32, True, 200),
    (2, 256, 256, 64, False, 0), (1, 128, 256, 64, True, 0),
    (1, 256, 384, 128, False, 0), (3, 384, 384, 32, True, 0)]


@pytest.mark.parametrize("BH,S,T,d,causal,window", FLASH_CASES)
def test_flash_plain_matches_reference_kernel_and_oracle(BH, S, T, d, causal,
                                                         window):
    jnp = pytest.importorskip("jax.numpy")
    ref_fl = pytest.importorskip("repro.kernels.flash_attention")
    ref = pytest.importorskip("repro.kernels.ref")
    q, k, v = _qkv(BH, S, T, 1, 1, d, S + T + d)
    port = port_fl.flash_attention(*_t(q, k, v), causal=causal,
                                   window=window)
    assert port.dtype == torch.float32 and tuple(port.shape) == q.shape
    q3, k3, v3 = (jnp.asarray(a[:, :, 0]) for a in (q, k, v))
    kern = ref_fl.flash_attention(q3, k3, v3, causal=causal, window=window,
                                  interpret=True)
    oracle = ref.flash_attention_ref(q3, k3, v3, causal=causal,
                                     window=window)
    for want in (kern, oracle):
        np.testing.assert_allclose(port.numpy()[:, :, 0], np.asarray(want),
                                   rtol=0, atol=1e-5)


@pytest.mark.parametrize("H,Hk,window", [(4, 2, 0), (8, 2, 96), (4, 4, 0),
                                         (6, 1, 0)])
def test_flash_ops_gqa_matches_reference_ops(H, Hk, window):
    jnp = pytest.importorskip("jax.numpy")
    ref_ops = pytest.importorskip("repro.kernels.ops")
    q, k, v = _qkv(2, 128, 128, H, Hk, 32, H * 10 + Hk)
    port = port_ops.flash_attention(*_t(q, k, v), causal=True, window=window)
    want = ref_ops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal=True,
                                   window=window, interpret=True)
    np.testing.assert_allclose(port.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


def test_flash_cpu_tensor_takes_plain_path_without_launch():
    q, k, v = _t(*_qkv(1, 128, 128, 2, 1, 64, 0))
    before, counts = port_fl.launches, telemetry.dispatch_snapshot()
    out = port_ops.flash_attention(q, k, v, causal=True)
    assert port_fl.launches == before
    after = telemetry.dispatch_snapshot()
    assert (after.get("kernel.flash_attention", 0)
            == counts.get("kernel.flash_attention", 0) + 1)
    torch.testing.assert_close(
        out, port_fl.flash_attention_torch(q, k, v, causal=True),
        rtol=0, atol=0)


# S and T off the kernel's 64-row tiling and a head dim outside the
# float32 kernel's set are the CUDA kernel's envelope, not the function's:
# on the CPU they take the plain version (the refusal on the card is in
# test_cuda_bad_shapes_raise_without_launch)
CPU_TAKES = ("S", "T", "head_dim")


@pytest.mark.parametrize("case", ["rank", "S", "T", "head_dim", "heads",
                                  "dtype", "mixed_dtype", "noncontiguous",
                                  "batch", "window"])
def test_flash_wrapper_rejects_bad_arguments(case):
    q, k, v = _t(*_qkv(1, 128, 128, 4, 2, 64, 1))
    exc, window = ValueError, 0
    if case == "rank":
        q = q[0]
    elif case == "S":
        q = q[:, :96].contiguous()
    elif case == "T":
        k, v = k[:, :100].contiguous(), v[:, :100].contiguous()
    elif case == "head_dim":
        q, k, v = q[..., :48].contiguous(), k[..., :48].contiguous(), \
            v[..., :48].contiguous()
    elif case == "heads":
        q = q[:, :, :3].contiguous()
    elif case == "dtype":
        q, k, v, exc = q.half(), k.half(), v.half(), TypeError
    elif case == "mixed_dtype":
        q, exc = q.bfloat16(), TypeError
    elif case == "noncontiguous":
        q = q.transpose(1, 2).contiguous().transpose(1, 2)
    elif case == "batch":
        k, v = torch.cat([k, k]), torch.cat([v, v])
    else:
        window = -1
    before = port_fl.launches
    if case in CPU_TAKES:
        out = port_fl.flash_attention(q, k, v, window=window)
        assert tuple(out.shape) == tuple(q.shape)
        torch.testing.assert_close(
            out, port_fl.flash_attention_torch(q, k, v, window=window),
            rtol=0, atol=0)
    else:
        with pytest.raises(exc):
            port_fl.flash_attention(q, k, v, window=window)
    assert port_fl.launches == before


@pytest.mark.parametrize("d", [80, 48])
@pytest.mark.parametrize("window", [0, 96])
def test_flash_head_dims_off_the_f32_kernel_match_reference(d, window):
    """Head dims the reference's gate sends to its kernel (dh % 8 == 0)
    but the float32 CUDA kernel does not take: the CPU runs them."""
    jnp = pytest.importorskip("jax.numpy")
    ref_ops = pytest.importorskip("repro.kernels.ops")
    q, k, v = _qkv(1, 256, 256, 4, 2, d, d + window)
    port = port_fl.flash_attention(*_t(q, k, v), causal=True, window=window)
    want = ref_ops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal=True,
                                   window=window, interpret=True)
    np.testing.assert_allclose(port.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


# -- B6 ----------------------------------------------------------------------

# (S, chunk, N, dh): the reference's sweep, S below the chunk, zamba2's
# head and state widths
SSM_CASES = [(128, 64, 16, 32), (256, 128, 64, 32), (192, 64, 16, 32),
             (64, 128, 16, 64), (256, 128, 64, 64)]


@pytest.mark.parametrize("S,chunk,N,dh", SSM_CASES)
def test_ssm_plain_matches_reference_kernel_and_oracles(S, chunk, N, dh):
    jnp = pytest.importorskip("jax.numpy")
    ref_ss = pytest.importorskip("repro.kernels.ssm_scan")
    ref = pytest.importorskip("repro.kernels.ref")
    ref_ssm = pytest.importorskip("repro.models.ssm")
    arrays = _ssm_inputs(2, S, 3, dh, N, S + N + dh)
    port = port_ss.ssm_scan(*_t(*arrays), chunk=chunk)
    assert port.dtype == torch.float32 and tuple(port.shape) == \
        arrays[0].shape
    j = [jnp.asarray(a) for a in arrays]
    kern, _ = ref_ss.ssm_scan(*j, chunk=chunk, interpret=True)
    model, _ = ref_ssm.ssd_chunked(*j, chunk=chunk)
    exact, _ = ref.ssm_scan_ref(*j)
    scale = float(np.abs(np.asarray(exact)).max())
    for want in (kern, model):
        np.testing.assert_allclose(port.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-5 * scale)
    np.testing.assert_allclose(port.numpy(), np.asarray(exact), rtol=0,
                               atol=5e-3)


def test_ssm_ops_returns_pair_and_counts_without_launch():
    xh, a, dt, Bm, Cm = _t(*_ssm_inputs(1, 128, 2, 32, 16, 3))
    before, counts = port_ss.launches, telemetry.dispatch_snapshot()
    y, none = port_ops.ssm_scan(xh, a, dt, Bm, Cm)
    assert none is None and port_ss.launches == before
    assert (telemetry.dispatch_snapshot().get("kernel.ssm_scan", 0)
            == counts.get("kernel.ssm_scan", 0) + 1)
    torch.testing.assert_close(y, port_ss.ssm_scan_torch(xh, a, dt, Bm, Cm),
                               rtol=0, atol=0)


# head dims, state widths and shared-memory sizes off the CUDA kernel's
# envelope take the plain version on the CPU (the refusal on the card is
# in test_cuda_bad_shapes_raise_without_launch); S % chunk stays refused,
# as in the reference
SSM_CPU_TAKES = ("head_dim", "state", "smem")


@pytest.mark.parametrize("case", ["chunk", "head_dim", "state", "dtype",
                                  "mixed_dtype", "shape", "noncontiguous",
                                  "smem"])
def test_ssm_wrapper_rejects_bad_arguments(case):
    xh, a, dt, Bm, Cm = _t(*_ssm_inputs(1, 256, 2, 32, 16, 4))
    chunk, exc = 128, ValueError
    if case == "chunk":
        chunk = 96
    elif case == "head_dim":
        xh = torch.zeros((1, 256, 2, 48))
    elif case == "state":
        Bm = Cm = torch.zeros((1, 256, 200))
    elif case == "dtype":
        xh, Bm, Cm, exc = xh.half(), Bm.half(), Cm.half(), TypeError
    elif case == "mixed_dtype":
        Bm, exc = Bm.bfloat16(), TypeError
    elif case == "shape":
        dt = dt[:, :128]
    elif case == "noncontiguous":
        xh = xh.transpose(2, 3).contiguous().transpose(2, 3)
    else:
        xh = torch.zeros((1, 256, 2, 64))
        Bm = Cm = torch.zeros((1, 256, 128))
    before = port_ss.launches
    if case in SSM_CPU_TAKES:
        y = port_ss.ssm_scan(xh, a, dt, Bm, Cm, chunk=chunk)
        assert tuple(y.shape) == tuple(xh.shape)
        torch.testing.assert_close(
            y, port_ss.ssm_scan_torch(xh, a, dt, Bm, Cm, chunk=chunk),
            rtol=0, atol=0)
    else:
        with pytest.raises(exc):
            port_ss.ssm_scan(xh, a, dt, Bm, Cm, chunk=chunk)
    assert port_ss.launches == before


@pytest.mark.parametrize("S,chunk,N,dh", [(256, 128, 64, 128),
                                          (128, 64, 200, 32)])
def test_ssm_widths_off_the_kernel_match_reference(S, chunk, N, dh):
    """A head dim and a state width the CUDA kernel does not take: the
    reference's kernel computes them, and so does the CPU path."""
    jnp = pytest.importorskip("jax.numpy")
    ref_ss = pytest.importorskip("repro.kernels.ssm_scan")
    arrays = _ssm_inputs(2, S, 3, dh, N, S + N + dh)
    port = port_ss.ssm_scan(*_t(*arrays), chunk=chunk)
    kern, _ = ref_ss.ssm_scan(*(jnp.asarray(a) for a in arrays),
                              chunk=chunk, interpret=True)
    scale = float(np.abs(np.asarray(kern)).max())
    np.testing.assert_allclose(port.numpy(), np.asarray(kern), rtol=0,
                               atol=1e-5 * scale)


# -- on the card -------------------------------------------------------------

@pytest.fixture
def cuda():
    # decided at run time, never at import or collection time
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


FLASH_CUDA = [
    (2, 512, 512, 4, 4, 64, True, 0), (1, 512, 512, 8, 2, 128, True, 0),
    (1, 256, 256, 2, 1, 64, True, 100), (1, 256, 384, 2, 2, 32, False, 0),
    (1, 128, 256, 2, 2, 256, True, 0), (1, 192, 192, 3, 1, 96, True, 64)]
# the bfloat16 tensor-core kernel only: head dims off the float32 set
# (d = 160 and 192 take the 192-column tiles), S % 128 == 64 (a half query
# tile), 8 query heads per key/value head
FLASH_CUDA_BF16 = [
    (1, 256, 256, 4, 2, 80, True, 0), (1, 256, 256, 4, 2, 48, True, 96),
    (1, 256, 256, 4, 2, 192, True, 96), (1, 256, 256, 4, 2, 160, True, 128),
    (2, 192, 192, 4, 4, 64, True, 0), (1, 192, 320, 4, 1, 128, False, 0),
    (1, 512, 512, 16, 2, 128, True, 0)]


@pytest.mark.parametrize(
    "dtype,B,S,T,H,Hk,d,causal,window",
    [(dt, *c) for c in FLASH_CUDA for dt in ("float32", "bfloat16")]
    + [("bfloat16", *c) for c in FLASH_CUDA_BF16])
def test_cuda_flash_matches_plain(cuda, dtype, B, S, T, H, Hk, d, causal,
                                  window):
    dt = getattr(torch, dtype)
    q, k, v = (t.to(dt) for t in _t(*_qkv(B, S, T, H, Hk, d, S + d),
                                     device=cuda))
    before = port_fl.launches
    out = port_fl.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert port_fl.launches == before + 1
    want = port_fl.flash_attention_torch(q, k, v, causal=causal,
                                         window=window)
    assert out.dtype == dt and out.shape == q.shape
    diff = (out.float() - want.float()).abs()
    if dtype == "float32":      # the same sums in another order
        assert float(diff.max()) <= 1e-5
    else:   # both round float32 results within 1e-5: one bf16 ulp apart
        assert bool((diff <= 2.0 ** -7 * want.float().abs() + 1e-5).all())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,dh,N,chunk", [
    (2, 512, 4, 64, 64, 128), (1, 128, 2, 32, 16, 128),
    (1, 64, 2, 32, 16, 128), (2, 384, 3, 64, 16, 64)])
def test_cuda_ssm_scan_matches_plain(cuda, dtype, B, S, H, dh, N, chunk):
    dt_ = getattr(torch, dtype)
    xh, a, dt, Bm, Cm = _t(*_ssm_inputs(B, S, H, dh, N, S + N), device=cuda)
    xh, Bm, Cm = xh.to(dt_), Bm.to(dt_), Cm.to(dt_)
    before = port_ss.launches
    y = port_ss.ssm_scan(xh, a, dt, Bm, Cm, chunk=chunk)
    torch.cuda.synchronize()
    assert port_ss.launches == before + 1
    want = port_ss.ssm_scan_torch(xh, a, dt, Bm, Cm, chunk=chunk)
    scale = float(want.float().abs().max())
    tol = 1e-4 if dtype == "float32" else 2e-2
    assert y.dtype == dt_ and y.shape == xh.shape
    assert float((y.float() - want.float()).abs().max()) <= tol * scale


def test_cuda_flash_grid_limits_follow_the_dtype(cuda):
    """B * H = 66,560 is past the float32 kernel's grid.y (65535) but on
    the bfloat16 kernel's grid.x: float32 raises before any launch,
    bfloat16 launches and holds its gate."""
    q, k, v = (t.to(torch.bfloat16) for t in _t(
        *_qkv(1024, 64, 64, 65, 65, 32, 7), device=cuda))
    before = port_fl.launches
    with pytest.raises(ValueError, match="B \\* H <= 65535"):
        port_fl.flash_attention(q.float(), k.float(), v.float())
    assert port_fl.launches == before
    out = port_fl.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert port_fl.launches == before + 1
    want = port_fl.flash_attention_torch(q, k, v).float()
    assert bool(((out.float() - want).abs()
                 <= 2.0 ** -7 * want.abs() + 1e-5).all())


def test_cuda_bad_shapes_raise_without_launch(cuda):
    """Shapes off the CUDA kernels' envelopes raise before any launch: S
    off the 64-row tiling, a float32 head dim outside the SIMT kernel's
    set, a bfloat16 head dim that is not a multiple of 8; an SSM sequence
    off the chunk, a head dim and a state width the scan does not take."""
    q = torch.zeros((1, 96, 2, 64), device=cuda)
    q48 = torch.zeros((1, 128, 2, 48), device=cuda)
    q20 = torch.zeros((1, 128, 2, 20), device=cuda, dtype=torch.bfloat16)
    before = port_fl.launches
    for bad in (q, q48, q20):
        with pytest.raises(ValueError, match="CUDA kernel"):
            port_fl.flash_attention(bad, bad, bad)
    assert port_fl.launches == before
    before = port_ss.launches
    xh = torch.zeros((1, 200, 2, 64), device=cuda)
    a = torch.zeros((1, 200, 2), device=cuda)
    Bm = torch.zeros((1, 200, 16), device=cuda)
    with pytest.raises(ValueError):
        port_ss.ssm_scan(xh, a, a, Bm, Bm)
    a = torch.zeros((1, 256, 2), device=cuda)
    for xh, Bm in ((torch.zeros((1, 256, 2, 48), device=cuda),
                    torch.zeros((1, 256, 16), device=cuda)),
                   (torch.zeros((1, 256, 2, 32), device=cuda),
                    torch.zeros((1, 256, 200), device=cuda))):
        with pytest.raises(ValueError, match="CUDA kernel"):
            port_ss.ssm_scan(xh, a, a, Bm, Bm)
    assert port_ss.launches == before
