"""B5's float32 kernel arithmetic (3xTF32 on the tensor cores), rendered in
plain PyTorch on the CPU and held against the reference's flash attention
(its `ref.py` oracle, and its Pallas kernel in interpret mode).

The card's kernel (`csrc/flash_attention.cu`, namespace tf32x3) runs each
product as three TF32 products. `split_tf32` renders its split bit for
bit: hi is x rounded to TF32 (10 mantissa bits, to nearest, ties away
from zero: the bits of `cvt.rna.tf32.f32`), lo = x - hi exactly, and the
tensor core reads lo's top 19 bits (truncation). `flash_tf32_render`
repeats the kernel's order: per key tile, Q K^T as the hi product plus
the two small ones summed on their own, the mask at -1e30, exp2 with
scale * log2(e) folded in, P split as it leaves the score accumulator,
this tile's P V, then o = o * alpha + that; whole key tiles that the
masks remove for the block's query rows are skipped. What it cannot
render is the tensor core's own rounding inside a product, so it is held
to the gate the card is held to: 1e-5 absolute (|out| <= max |v|).

One TF32 product (hi only) keeps 11 bits of each operand and misses
that gate, which is why the kernel runs three."""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

NEG = -1.0e30
LOG2E = 1.4426950408889634
MASK = -8192                         # 0xFFFFE000 as an int32


def split_tf32(x):
    """(hi, lo) of a float32 tensor, each exactly a TF32 value: hi rounded
    to nearest with ties away from zero, lo = x - hi truncated."""
    bits = x.contiguous().view(torch.int32)
    hi = ((bits.to(torch.int64) + 0x1000) & 0xFFFFE000).to(
        torch.uint32).view(torch.int32).view(torch.float32)
    lo = ((x - hi).view(torch.int32) & MASK).view(torch.float32)
    return hi, lo


def _mm3(a, b):
    """a @ b as the kernel's three TF32 products: the small terms summed
    on their own, then added to the hi product."""
    ah, al = split_tf32(a)
    bh, bl = split_tf32(b)
    return ah @ bh + (al @ bh + ah @ bl)


def _mm1(a, b):
    """a @ b as one TF32 product."""
    return split_tf32(a)[0] @ split_tf32(b)[0]


def _tiles(D):
    """(query rows, keys) a block and a tile: the kernel's Cfg<D>."""
    return (128, 64) if D <= 128 else (64, 32)


def flash_tf32_render(q, k, v, *, causal=True, window=0, mm=_mm3):
    """q: (B, S, H, d), k, v: (B, T, Hk, d) float32 -> (B, S, H, d)."""
    B, S, H, d = q.shape
    T, Hk = k.shape[1], k.shape[2]
    BQ, BK = _tiles(d)
    c = LOG2E / math.sqrt(d)
    out = torch.zeros_like(q)
    for b in range(B):
        for h in range(H):
            kh, vh = k[b, :, h // (H // Hk)], v[b, :, h // (H // Hk)]
            for q0 in range(0, S, BQ):
                qs = q[b, q0:q0 + BQ, h]
                rows = qs.shape[0]
                qpos = torch.arange(q0, q0 + rows)[:, None]
                q_last = q0 + rows - 1
                kt_hi = min(T // BK, q_last // BK + 1) if causal else T // BK
                first = q0 - window + 1
                kt_lo = first // BK if window > 0 and first > 0 else 0
                m = torch.full((rows, 1), NEG)
                l = torch.zeros((rows, 1))
                o = torch.zeros((rows, d))
                for kt in range(kt_lo, kt_hi):
                    k0 = kt * BK
                    s = mm(qs, kh[k0:k0 + BK].T) * c
                    kpos = torch.arange(k0, k0 + BK)[None, :]
                    ok = torch.ones((rows, BK), dtype=torch.bool)
                    if causal:
                        ok &= kpos <= qpos
                    if window > 0:
                        ok &= kpos > qpos - window
                    s = torch.where(ok, s, torch.tensor(NEG))
                    mx = torch.maximum(m, s.max(1, keepdim=True).values)
                    alpha = torch.exp2(m - mx)
                    p = torch.exp2(s - mx)
                    l = l * alpha + p.sum(1, keepdim=True)
                    m = mx
                    o = o * alpha + mm(p, vh[k0:k0 + BK])
                out[b, q0:q0 + rows, h] = o / torch.clamp(l, min=1e-30)
    return out


def _qkv(B, S, T, H, Hk, d, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, d)).astype(np.float32)
    k = rng.standard_normal((B, T, Hk, d)).astype(np.float32)
    v = rng.standard_normal((B, T, Hk, d)).astype(np.float32)
    return q, k, v


def _fold(a, G):
    """(B, L, heads, d) -> (B * heads * G, L, d), each head repeated G
    times."""
    a = np.repeat(a, G, axis=2)
    B, L, heads, d = a.shape
    return a.transpose(0, 2, 1, 3).reshape(B * heads, L, d)


def _oracle(q, k, v, causal, window):
    """The reference's ref.py oracle, heads folded into the batch and the
    key/value heads repeated for grouped-query attention."""
    jnp = pytest.importorskip("jax.numpy")
    ref = pytest.importorskip("repro.kernels.ref")
    B, S, H, d = q.shape
    G = H // k.shape[2]
    want = ref.flash_attention_ref(
        jnp.asarray(_fold(q, 1)), jnp.asarray(_fold(k, G)),
        jnp.asarray(_fold(v, G)), causal=causal, window=window)
    return np.asarray(want).reshape(B, H, S, d).transpose(0, 2, 1, 3)


def test_split_tf32_rounds_to_nearest_ties_away():
    one = 1.0 + 2.0 ** -10                    # a TF32 value: kept as is
    half_up = 1.0 + 2.0 ** -11                # the tie: away from zero
    below = 1.0 + 2.0 ** -11 - 2.0 ** -23     # just below the tie: down
    x = torch.tensor([one, half_up, -half_up, below, 3.0e-39, 0.0, -0.0])
    hi, lo = split_tf32(x)
    want = torch.tensor([one, 1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10), 1.0])
    assert torch.equal(hi[:4], want)
    assert torch.equal((hi.view(torch.int32) & 0x1FFF),
                       torch.zeros(7, dtype=torch.int32))
    assert torch.equal((lo.view(torch.int32) & 0x1FFF),
                       torch.zeros(7, dtype=torch.int32))
    # hi + lo keeps x to within lo's truncation: 2^-21 of |x| at most
    y = torch.randn(4096) * torch.exp(torch.randn(4096) * 4)
    hi, lo = split_tf32(y)
    assert float(((hi.double() + lo.double() - y.double()).abs()
                  / y.double().abs()).max()) < 2.0 ** -21


# (B, S, T, H, Hk, d, causal, window): every head dim of the kernel's set,
# a window narrower than a key tile, grouped-query attention, T != S both
# ways, no mask, S off the 128-row query tile (S % 128 == 64)
CASES = [(1, 128, 128, 2, 1, 32, True, 0), (1, 256, 256, 2, 2, 64, True, 0),
         (1, 192, 192, 2, 1, 96, True, 40), (1, 256, 256, 4, 2, 128, True, 0),
         (1, 128, 128, 2, 1, 256, True, 0), (1, 128, 256, 2, 2, 64, True, 0),
         (1, 256, 128, 4, 1, 64, False, 0), (2, 256, 256, 2, 2, 64, True, 96),
         (1, 192, 256, 2, 1, 128, False, 100)]


@pytest.mark.parametrize("B,S,T,H,Hk,d,causal,window", CASES)
def test_render_matches_reference_oracle(B, S, T, H, Hk, d, causal, window):
    q, k, v = _qkv(B, S, T, H, Hk, d, S + T + d + H)
    got = flash_tf32_render(*(torch.from_numpy(a) for a in (q, k, v)),
                            causal=causal, window=window)
    want = _oracle(q, k, v, causal, window)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_render_matches_reference_kernel_in_interpret_mode():
    jnp = pytest.importorskip("jax.numpy")
    ref_fl = pytest.importorskip("repro.kernels.flash_attention")
    q, k, v = _qkv(1, 256, 256, 2, 2, 64, 5)
    got = flash_tf32_render(*(torch.from_numpy(a) for a in (q, k, v)),
                            causal=True, window=96)
    want = ref_fl.flash_attention(*(jnp.asarray(_fold(a, 1))
                                    for a in (q, k, v)),
                                  causal=True, window=96, interpret=True)
    np.testing.assert_allclose(got.numpy()[0],
                               np.asarray(want).transpose(1, 0, 2),
                               rtol=0, atol=1e-5)


def test_one_tf32_pass_misses_the_gate():
    """Why three products: one keeps 11 bits an operand, ~1e-3 here."""
    q, k, v = _qkv(1, 256, 256, 2, 2, 64, 3)
    want = _oracle(q, k, v, True, 0)
    t = [torch.from_numpy(a) for a in (q, k, v)]
    one = flash_tf32_render(*t, causal=True, mm=_mm1)
    three = flash_tf32_render(*t, causal=True)
    err1 = float(np.abs(one.numpy() - want).max())
    err3 = float(np.abs(three.numpy() - want).max())
    assert err1 > 1e-4 > 1e-5 >= err3
