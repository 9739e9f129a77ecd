"""repro_torch.core.attacks against repro.core.attacks on the CPU.

The attacker draw and the label flip are numpy in both packages and must
agree bitwise. Corruption is held to the reference at 1e-6 (abs and
rel: the same float32 arithmetic, element by element). Gaussian noise
comes from one seam, `attacks.gauss_noise`; `jax.random` cannot be
reproduced in torch, so these tests replace the seam with the
reference's own draws and then require the same result."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.core import attacks as ref_attacks  # noqa: E402
from repro_torch.core import attacks as port_attacks  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

SHAPES = {"conv": {"kernel": (3, 3, 1, 4), "bias": (4,)},
          "head": {"kernel": (36, 10), "bias": (10,)}}


def ref_gauss_noise(seed, event, client_id, leaf_index, shape, device):
    """The reference's draw for one leaf of one client at one event."""
    key = jax.random.fold_in(jax.random.fold_in(
        ref_attacks.event_key(seed, event), client_id), leaf_index)
    return torch.as_tensor(np.array(jax.random.normal(
        key, tuple(shape), jnp.float32))).to(device)


@pytest.fixture
def ref_noise(monkeypatch):
    monkeypatch.setattr(port_attacks, "gauss_noise", ref_gauss_noise)


def _trees(C, seed, dtype=np.float32):
    """(stacked numpy tree of C clients, stacked base tree)."""
    rng = np.random.default_rng(seed)

    def tree():
        return {k: {kk: rng.normal(size=(C,) + s).astype(dtype)
                    for kk, s in d.items()} for k, d in SHAPES.items()}
    return tree(), tree()


def _ref(tree):
    return jax.tree.map(jnp.asarray, tree)


def _port(tree):
    return jax.tree.map(lambda a: torch.as_tensor(np.array(a)), tree)


def _close(ref_tree, port_tree, tol=1e-6):
    ref_leaves, port_leaves = jax.tree.leaves(ref_tree), tree_leaves(port_tree)
    assert len(ref_leaves) == len(port_leaves)
    for a, b in zip(ref_leaves, port_leaves):
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_allclose(b.float().numpy(),
                                   np.asarray(a, np.float32), atol=tol,
                                   rtol=tol)


@pytest.mark.parametrize("placement", ["random", "colluding"])
@pytest.mark.parametrize("n,fraction,seed", [
    (4, 0.25, 0), (8, 0.25, 3), (32, 0.25, 0), (10, 0.15, 7), (5, 0.9, 1),
    (6, 0.0, 0), (1, 0.5, 0)])
def test_attacker_draw_is_bitwise_the_reference(n, fraction, seed,
                                                placement):
    np.testing.assert_array_equal(
        port_attacks.attacker_ids(n, fraction, seed, placement),
        ref_attacks.attacker_ids(n, fraction, seed, placement))
    np.testing.assert_array_equal(
        port_attacks.attacker_mask(n, fraction, seed, placement),
        ref_attacks.attacker_mask(n, fraction, seed, placement))


def test_unknown_placement_raises():
    with pytest.raises(ValueError):
        port_attacks.attacker_ids(8, 0.25, 0, "clustered")


@pytest.mark.parametrize("dtype", [np.int64, np.int32, np.uint8])
def test_flip_labels_is_bitwise_the_reference(dtype):
    y = np.random.default_rng(0).integers(0, 10, size=200).astype(dtype)
    out = port_attacks.flip_labels(y)
    np.testing.assert_array_equal(out, ref_attacks.flip_labels(y))
    assert out.dtype == y.dtype
    np.testing.assert_array_equal(port_attacks.flip_labels(out), y)


@pytest.mark.parametrize("kind,scale", [
    ("sign_flip", 4.0), ("model_replace", 10.0), ("gauss", 0.5),
    ("none", 1.0), ("label_flip", 1.0)])
def test_corrupt_stacked_matches_reference(ref_noise, kind, scale):
    local, base = _trees(5, 1)
    flags = np.array([True, False, True, False, True])
    ids = [7, 2, 11, 0, 3]
    ref = ref_attacks.corrupt_stacked(
        _ref(local), _ref(base), flags,
        ref_attacks.client_keys(ref_attacks.event_key(3, 2), ids),
        kind=kind, scale=scale)
    port = port_attacks.corrupt_stacked(
        _port(local), _port(base), flags,
        port_attacks.client_keys(port_attacks.event_key(3, 2), ids),
        kind=kind, scale=scale)
    _close(ref, port)
    # honest rows pass through bitwise
    for a, b in zip(tree_leaves(port), tree_leaves(_port(local))):
        np.testing.assert_array_equal(a[~torch.as_tensor(flags)].numpy(),
                                      b[~torch.as_tensor(flags)].numpy())


@pytest.mark.parametrize("kind", ["sign_flip", "gauss"])
def test_corrupt_keeps_bf16_leaves(ref_noise, kind):
    local, base = _trees(3, 2)
    to_bf16 = lambda t: jax.tree.map(  # noqa: E731
        lambda a: torch.as_tensor(a).to(torch.bfloat16), t)
    flags = np.array([True, True, False])
    keys = port_attacks.client_keys((0, 1), [0, 1, 2])
    port = port_attacks.corrupt_stacked(to_bf16(local), to_bf16(base), flags,
                                        keys, kind=kind, scale=2.0)
    assert all(t.dtype == torch.bfloat16 for t in tree_leaves(port))
    ref = ref_attacks.corrupt_stacked(
        jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), local),
        jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), base), flags,
        ref_attacks.client_keys(ref_attacks.event_key(0, 1), [0, 1, 2]),
        kind=kind, scale=2.0)
    _close(ref, port, tol=2e-2)


@pytest.mark.parametrize("kind", ["sign_flip", "model_replace", "gauss"])
def test_corrupt_tree_and_clients_match_reference(ref_noise, kind):
    local, base = _trees(3, 4)
    one = lambda t, i: jax.tree.map(lambda a: a[i], t)  # noqa: E731
    key = ref_attacks.client_keys(ref_attacks.event_key(5, 1), [9])[0]
    ref = ref_attacks.corrupt_tree(_ref(one(local, 0)), _ref(one(base, 0)),
                                   True, key, kind=kind, scale=3.0)
    port = port_attacks.corrupt_tree(_port(one(local, 0)),
                                     _port(one(base, 0)), True, (5, 1, 9),
                                     kind=kind, scale=3.0)
    _close(ref, port)
    mask = np.array([False, True, True, False])
    ids = [1, 3, 2]
    ref_list = ref_attacks.corrupt_clients(
        [_ref(one(local, i)) for i in range(3)],
        [_ref(one(base, i)) for i in range(3)], ids, mask, kind=kind,
        scale=3.0, seed=5, event=4)
    port_list = port_attacks.corrupt_clients(
        [_port(one(local, i)) for i in range(3)],
        [_port(one(base, i)) for i in range(3)], ids, mask, kind=kind,
        scale=3.0, seed=5, event=4)
    for r, p in zip(ref_list, port_list):
        _close(r, p)


def test_gauss_noise_is_keyed_and_reproducible():
    draw = port_attacks.gauss_noise
    a = draw(0, 1, 2, 0, (64,), "cpu")
    np.testing.assert_array_equal(a.numpy(), draw(0, 1, 2, 0, (64,),
                                                  "cpu").numpy())
    assert a.dtype == torch.float32 and tuple(a.shape) == (64,)
    for other in (draw(1, 1, 2, 0, (64,), "cpu"),
                  draw(0, 2, 2, 0, (64,), "cpu"),
                  draw(0, 1, 3, 0, (64,), "cpu"),
                  draw(0, 1, 2, 1, (64,), "cpu")):
        assert not np.array_equal(a.numpy(), other.numpy())
    # standard normal
    big = draw(0, 0, 0, 0, (20000,), "cpu").numpy()
    assert abs(big.mean()) < 0.03 and abs(big.std() - 1) < 0.03


def test_unknown_attack_raises():
    local, base = _trees(2, 5)
    with pytest.raises(ValueError):
        port_attacks.corrupt_stacked(_port(local), _port(base), [True, True],
                                     [(0, 0, 0), (0, 0, 1)], kind="flip",
                                     scale=1.0)
    with pytest.raises(ValueError):
        port_attacks.corrupt_clients([_port(local)], [], [0], np.ones(1, bool),
                                     kind="gauss", scale=1.0, seed=0, event=0)
