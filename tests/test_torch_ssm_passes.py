"""B6's three-pass design (`csrc/ssm_scan.cu`: each chunk's own state, the
states passed from chunk to chunk, each chunk's output) in its plain
rendering `ssm_scan_passes_torch`, against the port's chunked plain
version `ssm_scan_torch`, the reference's Pallas kernel in interpret mode
and the reference's exact sequential recurrence; the CPU routing of
`ssm_chunk_states`; the kernels' envelope and scratch helpers; and, on a
machine with a card, the card's passes against the plain rendering.

Tolerances (float32): the passes reorder the chunked arithmetic (the
states are summed per chunk, then passed), so y agrees within 1e-5 of
max |y|, as the plain version does with the reference kernel
(tests/test_torch_zoo_kernels.py). The states entering each chunk agree
with the exact recurrence's states at the chunk boundaries within 1e-5 of
their largest magnitude (the chunked form sums the same terms in another
order; measured below 1e-6). On the card: float32 1e-4 and bfloat16 2e-2
of max |y| (chip_smoke.py's gates), the states 1e-4 (float32) and 2e-2
(bfloat16: x o u is rounded to bf16 once, h_in stored in bf16) of
max |h|.

The card's machine has no jax: there the reference comparisons skip and

    PYTHONPATH=src python -m pytest -q --noconftest \
        tests/test_torch_ssm_passes.py -k cuda

runs the card tests (tests/conftest.py imports jax)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.kernels import ssm_scan as port_ss  # noqa: E402


def _inputs(B, S, H, dh, N, seed, decay=1.0):
    """x, B, C normal; dt = softplus(normal); a = -decay * softplus(normal)
    (decay = 20 makes a strongly decaying state: exp(cs) underflows within
    a chunk)."""
    rng = np.random.default_rng(seed)
    xh = rng.standard_normal((B, S, H, dh)).astype(np.float32)
    a = (-decay * np.log1p(np.exp(rng.standard_normal((B, S, H))))
         ).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32)
    Bm = rng.standard_normal((B, S, N)).astype(np.float32)
    Cm = rng.standard_normal((B, S, N)).astype(np.float32)
    return xh, a, dt, Bm, Cm


def _t(*arrays, device="cpu"):
    return [torch.as_tensor(a, device=device) for a in arrays]


# (S, chunk, N, dh, decay): S = Q, S = 4Q, S below the chunk, N != dh,
# dh = 32, a strongly decaying a, a chunk that is not a multiple of 16
PASS_CASES = [(128, 128, 16, 32, 1.0), (256, 64, 64, 64, 1.0),
              (64, 128, 16, 32, 1.0), (128, 32, 48, 64, 1.0),
              (256, 128, 64, 32, 1.0), (128, 32, 16, 32, 20.0),
              (120, 40, 20, 32, 1.0)]


@pytest.mark.parametrize("S,chunk,N,dh,decay", PASS_CASES)
def test_passes_match_plain_and_reference_kernel(S, chunk, N, dh, decay):
    jnp = pytest.importorskip("jax.numpy")
    ref_ss = pytest.importorskip("repro.kernels.ssm_scan")
    arrays = _inputs(2, S, 3, dh, N, S + N + dh, decay)
    y, h_in = port_ss.ssm_scan_passes_torch(*_t(*arrays), chunk=chunk)
    Q = min(chunk, S)
    assert y.dtype == torch.float32 and tuple(y.shape) == arrays[0].shape
    assert tuple(h_in.shape) == (2, 3, S // Q, dh, N)
    assert bool(torch.isfinite(y).all())
    plain = port_ss.ssm_scan_torch(*_t(*arrays), chunk=chunk)
    kern, _ = ref_ss.ssm_scan(*(jnp.asarray(a) for a in arrays),
                              chunk=chunk, interpret=True)
    scale = float(plain.abs().max())
    for want in (plain.numpy(), np.asarray(kern)):
        np.testing.assert_allclose(y.numpy(), want, rtol=0,
                                   atol=1e-5 * scale)


@pytest.mark.parametrize("S,chunk,N,dh,decay", [(256, 64, 16, 32, 1.0),
                                                (128, 32, 16, 32, 20.0)])
def test_chunk_states_match_exact_recurrence(S, chunk, N, dh, decay):
    """h_in[c] is the exact recurrence's state after the first c chunks;
    h_in[0] is zero."""
    jnp = pytest.importorskip("jax.numpy")
    ref = pytest.importorskip("repro.kernels.ref")
    arrays = _inputs(2, S, 3, dh, N, 7 * S + N, decay)
    _, h_in = port_ss.ssm_scan_passes_torch(*_t(*arrays), chunk=chunk)
    assert float(h_in[:, :, 0].abs().max()) == 0.0
    scale = float(h_in.abs().max())
    for c in range(1, S // chunk):
        _, hT = ref.ssm_scan_ref(*(jnp.asarray(a[:, :c * chunk])
                                   for a in arrays))
        np.testing.assert_allclose(h_in[:, :, c].numpy(), np.asarray(hT),
                                   rtol=0, atol=1e-5 * scale)


def test_chunk_states_cpu_tensor_takes_plain_rendering_without_launch():
    xh, a, dt, Bm, Cm = _t(*_inputs(1, 256, 2, 32, 16, 3))
    before = port_ss.launches
    h_in = port_ss.ssm_chunk_states(xh, a, dt, Bm, Cm, chunk=64)
    assert port_ss.launches == before
    torch.testing.assert_close(
        h_in, port_ss.ssm_scan_passes_torch(xh, a, dt, Bm, Cm, chunk=64)[1],
        rtol=0, atol=0)
    with pytest.raises(ValueError):          # S off the chunk, as ssm_scan
        port_ss.ssm_chunk_states(xh, a, dt, Bm, Cm, chunk=96)


# shared memory of the larger chunk pass (the output pass) at zamba2's
# widths (dh = N = 64, Q = 128): bfloat16 (C staged) and float32; the
# widest shape of the envelope (dh = 64, N = Q = 128) in float32; a small
# one
SMEM = [(64, 64, 128, torch.bfloat16,
         2 * (256 * 72 + 128 * 72 + 64 * 72) + 8 * 128),
        (64, 64, 128, torch.float32,
         4 * (128 * 72 + 128 * 68 + 64 * 72) + 8 * 128),
        (64, 128, 128, torch.float32,
         4 * (128 * 136 + 128 * 68 + 64 * 136) + 8 * 128),
        (32, 16, 64, torch.float32, 4 * (64 * 24 + 64 * 36 + 32 * 24)
         + 8 * 64)]


@pytest.mark.parametrize("dh,N,Q,dtype,want", SMEM)
def test_smem_bytes(dh, N, Q, dtype, want):
    assert port_ss.smem_bytes(dh, N, Q, dtype) == want


def test_every_shape_of_the_envelope_fits_one_block():
    for dtype in (torch.float32, torch.bfloat16):
        for dh in port_ss.HEAD_DIMS:
            for N in range(1, port_ss.MAX_STATE + 1):
                for Q in range(1, port_ss.MAX_CHUNK + 1):
                    assert port_ss.smem_bytes(dh, N, Q, dtype) \
                        <= port_ss.MAX_SMEM


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_envelope(dtype):
    """The chunk passes take the widest shape the first port refused for
    its shared memory (dh = 64, N = Q = 128) and still refuse head dims
    off HEAD_DIMS and state widths above 128."""
    def check(dh, N, Q, S=256):
        port_ss._check_kernel(torch.zeros((1, S, 2, dh), dtype=dtype),
                              torch.zeros((1, S, N), dtype=dtype), Q)
    check(64, 128, 128)
    check(32, 1, 1, S=3)
    for dh, N in ((48, 16), (128, 16), (64, 129)):
        with pytest.raises(ValueError, match="CUDA kernel"):
            check(dh, N, 128)


def test_scratch_bytes():
    """A float32 (dh, N) state and a float32 decay per (batch, head,
    chunk), plus the bfloat16 state entering the chunk for bfloat16
    inputs: 67 MB and 101 MB at zamba2-1.2b's prefill (B 2, S 4096, H 64,
    dh = N = 64, Q 128)."""
    assert port_ss.scratch_bytes(2, 4096, 64, 64, 64, 128) == \
        4 * 2 * 64 * 32 * (64 * 64 + 1) == 67125248
    assert port_ss.scratch_bytes(2, 4096, 64, 64, 64, 128, torch.bfloat16) \
        == 67125248 + 2 * 2 * 64 * 32 * 64 * 64 == 100679680
    assert port_ss.scratch_bytes(1, 64, 2, 32, 16, 64) == 4 * 2 * (512 + 1)


# -- on the card -------------------------------------------------------------

@pytest.fixture
def cuda():
    # decided at run time, never at import or collection time
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False     # plain version in f32
    return torch.device("cuda")


# (B, S, H, dh, N, chunk, decay): zamba2's widths at a short sequence, a
# chunk off 16 with an odd state width, S below the chunk, the widest
# shape of the envelope, a one-wide state, a strongly decaying a
CUDA_CASES = [(2, 512, 4, 64, 64, 128, 1.0), (1, 200, 3, 32, 17, 40, 1.0),
              (1, 48, 2, 64, 16, 128, 1.0), (1, 256, 2, 64, 128, 128, 1.0),
              (2, 128, 2, 32, 1, 64, 1.0), (1, 384, 3, 64, 64, 128, 20.0)]


def _card_inputs(case, dtype, device):
    B, S, H, dh, N, chunk, decay = case
    xh, a, dt, Bm, Cm = _t(*_inputs(B, S, H, dh, N, S + N + dh, decay),
                           device=device)
    return (xh.to(dtype), a, dt, Bm.to(dtype), Cm.to(dtype)), chunk


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CUDA_CASES)
def test_cuda_scan_and_states_match_passes(cuda, dtype, case):
    dt_ = getattr(torch, dtype)
    args, chunk = _card_inputs(case, dt_, cuda)
    before = port_ss.launches
    y = port_ss.ssm_scan(*args, chunk=chunk)
    h_in = port_ss.ssm_chunk_states(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert port_ss.launches == before + 2
    want_y, want_h = port_ss.ssm_scan_passes_torch(*args, chunk=chunk)
    tol = 1e-4 if dtype == "float32" else 2e-2
    assert y.dtype == dt_ and y.shape == args[0].shape
    assert bool(torch.isfinite(y).all())
    assert float((y.float() - want_y.float()).abs().max()) \
        <= tol * float(want_y.float().abs().max())
    assert h_in.shape == want_h.shape
    assert float((h_in - want_h).abs().max()) \
        <= tol * max(float(want_h.abs().max()), 1e-30)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_scan_repeats_bitwise_and_takes_unaligned_views(cuda, dtype):
    """No atomics: a second call gives the same bits; a view whose data is
    not 16-byte aligned is copied by the wrapper and gives them too."""
    dt_ = getattr(torch, dtype)
    (xh, a, dt, Bm, Cm), chunk = _card_inputs(CUDA_CASES[0], dt_, cuda)
    y = port_ss.ssm_scan(xh, a, dt, Bm, Cm, chunk=chunk)
    assert torch.equal(port_ss.ssm_scan(xh, a, dt, Bm, Cm, chunk=chunk), y)
    flat = torch.empty(Bm.numel() + 1, dtype=dt_, device=cuda)
    shifted = flat[1:].view(Bm.shape)
    shifted.copy_(Bm)
    assert shifted.data_ptr() % 16 != 0
    assert torch.equal(port_ss.ssm_scan(xh, a, dt, shifted, Cm,
                                        chunk=chunk), y)
