"""Secure aggregation of repro_torch against the reference's
(`repro.core.secure_agg`): with the reference's pairwise masks passed in
through the port's one mask seam (`secure_agg.mask_like`), each masked
upload equals the reference's and the masked FedAvg equals plain FedAvg.

Tolerances: masked uploads 1e-5 abs (the masks are scale 10, so float32
rounding of a masked value is ~1e-6); the masked aggregate against plain
FedAvg 1e-4 abs (the masks cancel up to the rounding of sums of values
of size ~10 per pair); against the reference's masked aggregate 1e-5."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.core import aggregation as ref_agg  # noqa: E402
from repro.core import secure_agg as ref_secure  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import aggregation as port_agg  # noqa: E402
from repro_torch.core import secure_agg as port_secure  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402


def ref_mask_like(tree, seed, scale):
    """The reference's mask tree for a pair seed, as tensors."""
    np_tree = convert.params_to_numpy(tree)
    masks = ref_secure._mask_like(jax.tree.map(jnp.asarray, np_tree), seed,
                                  scale)
    return convert.params_from_jax(jax.tree.map(np.asarray, masks))


@pytest.fixture
def ref_masks(monkeypatch):
    monkeypatch.setattr(port_secure, "mask_like", ref_mask_like)


def _clients(n, seed=0):
    rng = np.random.default_rng(seed)
    return [{"conv": {"bias": rng.normal(size=(4,)).astype(np.float32),
                      "kernel": rng.normal(size=(3, 3, 1, 4))
                      .astype(np.float32)},
             "head": {"bias": rng.normal(size=(10,)).astype(np.float32)}}
            for _ in range(n)]


def _close(ref_tree, port_tree, atol):
    ref_leaves, port_leaves = jax.tree.leaves(ref_tree), tree_leaves(
        port_tree)
    assert len(ref_leaves) == len(port_leaves)
    for a, b in zip(ref_leaves, port_leaves):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=atol)


@pytest.mark.parametrize("i,j", [(0, 1), (3, 2), (5, 5), (100, 7)])
def test_pair_seed_matches_reference(i, j):
    for base in (0, 7, 123456):
        assert port_secure._pair_seed(base, i, j) == \
            ref_secure._pair_seed(base, i, j) == \
            port_secure._pair_seed(base, j, i)


def test_mask_update_matches_reference(ref_masks):
    clients = _clients(3)
    ref = ref_secure.mask_update(jax.tree.map(jnp.asarray, clients[1]), 1,
                                 [0, 1, 2], 5, weight=0.3)
    port = port_secure.mask_update(convert.params_from_jax(clients[1]), 1,
                                   [0, 1, 2], 5, weight=0.3)
    _close(ref, port, 1e-5)


@pytest.mark.parametrize("n,weights", [(2, None), (4, None),
                                       (5, [1.0, 2.0, 3.0, 1.0, 5.0])])
def test_secure_fedavg_equals_plain_fedavg_and_reference(ref_masks, n,
                                                         weights):
    clients = _clients(n, seed=n)
    port_trees = [convert.params_from_jax(c) for c in clients]
    got = port_secure.secure_fedavg(port_trees, weights, base_seed=3)
    w = np.ones(n) if weights is None else np.asarray(weights)
    plain = port_agg.fedavg(port_trees, list(w))
    for a, b in zip(tree_leaves(plain), tree_leaves(got)):
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=1e-4)
        assert b.dtype == a.dtype
    ref = ref_secure.secure_fedavg(
        [jax.tree.map(jnp.asarray, c) for c in clients], weights,
        base_seed=3)
    _close(ref, got, 1e-5)
    _close(ref_agg.fedavg([jax.tree.map(jnp.asarray, c) for c in clients],
                          list(w)), got, 1e-4)


def test_port_masks_hide_uploads_and_cancel():
    """With the port's own masks: each masked upload is far from the
    weighted update it hides, and the aggregate still equals FedAvg."""
    clients = [convert.params_from_jax(c) for c in _clients(4, seed=9)]
    masked = port_secure.mask_update(clients[0], 0, [0, 1, 2, 3], 1,
                                     weight=0.25)
    gap = max(float((m - 0.25 * c).abs().max()) for m, c in
              zip(tree_leaves(masked), tree_leaves(clients[0])))
    assert gap > 1.0
    got = port_secure.secure_fedavg(clients, base_seed=1)
    plain = port_agg.fedavg(clients, [1.0] * 4)
    for a, b in zip(tree_leaves(plain), tree_leaves(got)):
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=1e-4)
    again = port_secure.mask_like(clients[0], 17, 10.0)
    for a, b in zip(tree_leaves(port_secure.mask_like(clients[0], 17, 10.0)),
                    tree_leaves(again)):
        assert torch.equal(a, b)
