"""B2's order of operations, rendered in plain PyTorch on the CPU.

The card's kernel for C <= 64 (`csrc/trimmed_mean_agg.cu`,
`trimmed_reg_kernel`) pads each column to Cp = 4, 8, 16, 32 or 64 rows
with +inf, sorts it with a bitonic network of fminf / fmaxf
compare-exchanges (a NaN loses every compare and is dropped, as fmin and
fmax drop it; the column's NaN flag returns NaN anyway), adds ranks
lo..hi-1 in ascending order as one float32 chain from 0 and divides by
hi - lo. `trimmed_render` repeats that order. It must equal the port's
plain version `trimmed_mean_torch` bit for bit, which adds the same
sorted values in the same order: the 32-client acceptance family is
chaotic, and a reassociated sum moved its no-attack run's macro-F1 from
0.554 to 0.934. Against the reference (its kernel in interpret mode and
`trimmed_mean_jnp`): 1e-6 absolute in float32, the same order statistics
summed in another order."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.kernels import robust_agg as port_ra  # noqa: E402


def trimmed_render(x, trim):
    """x: (C, N) float32 or bfloat16, C <= 64 -> (N,) in x's dtype."""
    C, N = x.shape
    cp = 4
    while cp < C:
        cp *= 2
    v = [x[i].float() if i < C else torch.full((N,), float("inf"))
         for i in range(cp)]
    has_nan = torch.isnan(x.float()).any(0)
    k = 2
    while k <= cp:                       # merge phase k, distance j
        j = k // 2
        while j > 0:
            for i in range(cp):
                l = i ^ j
                if l <= i:
                    continue
                lo_v, hi_v = torch.fmin(v[i], v[l]), torch.fmax(v[i], v[l])
                v[i], v[l] = (lo_v, hi_v) if (i & k) == 0 else (hi_v, lo_v)
            j //= 2
        k *= 2
    acc = torch.zeros(N)
    for r in range(trim, C - trim):      # ascending ranks, one chain
        acc = acc + v[r]
    acc = acc / (C - 2 * trim)
    out = torch.where(has_nan, torch.full_like(acc, float("nan")), acc)
    return out.to(x.dtype)


def _inputs(C, N, seed, kind=""):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(C, N)).astype(np.float32)
    if kind == "ties":
        x = rng.integers(-1, 2, size=(C, N)).astype(np.float32)
    elif kind == "zeros":                # +0 and -0, ranked as equals
        x = np.where(rng.random((C, N)) < 0.5, 0.0, -0.0).astype(np.float32)
        x[:, ::3] = rng.normal(size=(C, (N + 2) // 3))
    elif kind == "inf":
        x[0, : N // 2] = np.inf
        x[C - 1, N // 3:] = -np.inf
        x[C // 2, ::5] = np.inf
    elif kind == "nan":
        x[C // 2, N // 2] = np.nan
        x[0, :3] = np.nan
    return x


def _bits(t):
    return t.float().view(torch.int32)


def _trims(C):
    return sorted({0, min(1, (C - 1) // 2), (C - 1) // 4, (C - 1) // 2})


@pytest.mark.parametrize("C", [1, 2, 3, 4, 5, 8, 9, 16, 31, 32, 33, 64])
@pytest.mark.parametrize("kind", ["", "ties", "zeros", "inf", "nan"])
def test_render_equals_plain_version_bitwise(C, kind):
    x = torch.from_numpy(_inputs(C, 301, C * 7 + len(kind), kind))
    for trim in _trims(C):
        got, want = trimmed_render(x, trim), port_ra.trimmed_mean_torch(x,
                                                                       trim)
        assert torch.equal(_bits(got), _bits(want)), (C, kind, trim)


@pytest.mark.parametrize("C", [4, 8, 31, 32, 33, 64])
def test_render_equals_plain_version_bitwise_bf16(C):
    x = torch.from_numpy(_inputs(C, 301, C, "ties")).bfloat16() \
        + torch.from_numpy(_inputs(C, 301, C + 1)).bfloat16()
    for trim in _trims(C):
        assert torch.equal(_bits(trimmed_render(x, trim)),
                           _bits(port_ra.trimmed_mean_torch(x, trim)))


@pytest.mark.parametrize("C", [1, 2, 3, 4, 5, 8, 9, 16, 31, 32, 33, 64])
@pytest.mark.parametrize("kind", ["", "ties", "inf", "nan"])
def test_render_matches_reference(C, kind):
    jnp = pytest.importorskip("jax.numpy")
    ref_ra = pytest.importorskip("repro.kernels.robust_agg")
    x = _inputs(C, 301, C * 7 + len(kind), kind)
    for trim in sorted({(C - 1) // 4, (C - 1) // 2}):   # trimmed, median
        got = trimmed_render(torch.from_numpy(x), trim).numpy()
        wants = [ref_ra.trimmed_mean_jnp(jnp.asarray(x), trim)]
        if kind in ("", "nan"):
            wants.append(ref_ra.trimmed_mean_agg(jnp.asarray(x), trim,
                                                 interpret=True))
        for want in wants:
            want = np.asarray(want)
            np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
