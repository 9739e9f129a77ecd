"""repro_torch.models.cnn and the ravel path against the reference.

The port gets the reference's parameters through
`convert.params_from_jax`; forward passes, losses and gradients then agree
at atol 1e-5 (float reassociation between XLA:CPU and ATen), and the
raveled (C, N) matrices agree exactly (the ravel is pure data movement).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.kernels import ops as ref_ops  # noqa: E402
from repro.models import cnn as ref_cnn  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.kernels import ops as port_ops  # noqa: E402
from repro_torch.models import cnn as port_cnn  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

ATOL = 1e-5


def _ref_params(seed, C=None):
    if C is None:
        return ref_cnn.init_cnn(jax.random.PRNGKey(seed))
    return jax.tree.map(lambda *ls: jnp.stack(ls),
                        *[ref_cnn.init_cnn(jax.random.PRNGKey(seed + i))
                          for i in range(C)])


def _port(tree):
    return convert.params_from_jax(jax.tree.map(np.asarray, tree))


def _batch(shape, seed):
    rng = np.random.default_rng(seed)
    imgs = rng.uniform(size=shape + (28, 28, 1)).astype(np.float32)
    labs = rng.integers(0, 10, size=shape).astype(np.int32)
    return ({"image": jnp.asarray(imgs), "label": jnp.asarray(labs)},
            {"image": torch.as_tensor(imgs), "label": torch.as_tensor(labs)})


def test_param_layout_and_count():
    p = _port(_ref_params(0))
    assert [tuple(t.shape) for t in tree_leaves(p)] == [
        (16,), (3, 3, 1, 16), (12,), (3, 3, 16, 12), (10,), (3, 3, 12, 10),
        (10,), (490, 10)]
    assert sum(t.numel() for t in tree_leaves(p)) == 7900
    g = port_cnn.init_cnn(torch.Generator().manual_seed(0))
    assert [t.shape for t in tree_leaves(g)] == \
        [t.shape for t in tree_leaves(p)]


def test_convert_roundtrip():
    ref = jax.tree.map(np.asarray, _ref_params(3))
    back = convert.params_to_numpy(convert.params_from_jax(ref))
    for a, b in zip(jax.tree.leaves(ref), jax.tree.leaves(back)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", [0, 1])
def test_cnn_apply_and_loss(seed):
    ref_p = _ref_params(seed)
    port_p = _port(ref_p)
    rb, pb = _batch((8,), seed)
    np.testing.assert_allclose(
        np.asarray(ref_cnn.cnn_apply(ref_p, rb["image"])),
        port_cnn.cnn_apply(port_p, pb["image"]).numpy(), atol=ATOL)
    rl, ra = ref_cnn.cnn_loss(ref_p, rb)
    pl, pa = port_cnn.cnn_loss(port_p, pb)
    np.testing.assert_allclose(float(rl), float(pl), atol=ATOL)
    assert float(ra) == float(pa)


def test_cnn_loss_grads():
    ref_p = _ref_params(2)
    port_p = _port(ref_p)
    rb, pb = _batch((8,), 2)
    ref_g = jax.grad(lambda p: ref_cnn.cnn_loss(p, rb)[0])(ref_p)
    leaves = [t.requires_grad_(True) for t in tree_leaves(port_p)]
    loss, _ = port_cnn.cnn_loss(port_p, pb)
    grads = torch.autograd.grad(loss, leaves)
    for a, b in zip(jax.tree.leaves(ref_g), grads):
        np.testing.assert_allclose(np.asarray(a), b.numpy(), atol=ATOL)


def test_cnn_stacked_apply_loss_and_grads():
    C, B = 3, 8
    ref_p = _ref_params(10, C=C)
    port_p = _port(ref_p)
    rb, pb = _batch((C, B), 4)
    np.testing.assert_allclose(
        np.asarray(ref_cnn.cnn_apply_stacked(ref_p, rb["image"])),
        port_cnn.cnn_apply_stacked(port_p, pb["image"]).numpy(), atol=ATOL)
    rl, ra = ref_cnn.cnn_loss_stacked(ref_p, rb)
    leaves = [t.requires_grad_(True) for t in tree_leaves(port_p)]
    pl, pa = port_cnn.cnn_loss_stacked(port_p, pb)
    np.testing.assert_allclose(np.asarray(rl), pl.detach().numpy(),
                               atol=ATOL)
    np.testing.assert_array_equal(np.asarray(ra), pa.numpy())
    ref_g = jax.grad(
        lambda p: jnp.sum(ref_cnn.cnn_loss_stacked(p, rb)[0]))(ref_p)
    grads = torch.autograd.grad(pl.sum(), leaves)
    for a, b in zip(jax.tree.leaves(ref_g), grads):
        np.testing.assert_allclose(np.asarray(a), b.numpy(), atol=ATOL)


def test_stacked_matches_per_client_apply():
    """The grouped-conv stacked path equals C independent forwards."""
    C = 3
    port_p = _port(_ref_params(5, C=C))
    _, pb = _batch((C, 4), 5)
    out = port_cnn.cnn_apply_stacked(port_p, pb["image"])
    for c in range(C):
        single = {k: {kk: v[c] for kk, v in d.items()}
                  for k, d in port_p.items()}
        np.testing.assert_allclose(
            out[c].detach().numpy(),
            port_cnn.cnn_apply(single, pb["image"][c]).detach().numpy(),
            atol=ATOL)


def test_stacked_ravel_matches_reference_exactly():
    ref_p = _ref_params(1, C=4)
    ref_mat = np.asarray(ref_ops.stacked_ravel(ref_p))
    port_mat = port_ops.stacked_ravel(_port(ref_p)).numpy()
    assert port_mat.shape == ref_mat.shape == (4, 7900)
    np.testing.assert_array_equal(port_mat, ref_mat)


def test_unravel_roundtrips():
    port_p = _port(_ref_params(6, C=3))
    mat = port_ops.stacked_ravel(port_p)
    back = port_ops.stacked_unravel(port_p, mat)
    for a, b in zip(tree_leaves(port_p), tree_leaves(back)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    # a template with another client count; row 1 through tree_unravel
    two = port_ops.stacked_unravel(port_p, mat[:2])
    assert tree_leaves(two)[0].shape[0] == 2
    row = port_ops.tree_unravel(port_p, mat[1])
    for a, b in zip(tree_leaves(port_p), tree_leaves(row)):
        np.testing.assert_array_equal(a[1].numpy(), b.numpy())
