"""repro_torch.core.aggregation against the reference's stacked operators
on the same inputs (the reference's kernel runs in interpret mode on the
CPU). Tolerance rtol 1e-5 (atol 1e-6 near zero): both sides accumulate
the same f32 products, in a different order."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.core import aggregation as ref_agg  # noqa: E402
from repro.core import topology  # noqa: E402
from repro.kernels import ops as ref_ops  # noqa: E402
from repro_torch.core import aggregation as port_agg  # noqa: E402
from repro_torch.core import engine as port_engine  # noqa: E402
from repro_torch.kernels import ops as port_ops  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

SHAPES = {"conv": {"kernel": (3, 3, 1, 4), "bias": (4,)},
          "head": {"kernel": (36, 10), "bias": (10,)}}


def _stack(C, seed):
    """The same stacked tree as (reference jnp tree, port torch tree)."""
    rng = np.random.default_rng(seed)
    arrs = {k: {kk: rng.normal(size=(C,) + s).astype(np.float32)
                for kk, s in d.items()} for k, d in SHAPES.items()}
    ref = jax.tree.map(jnp.asarray, arrs)
    port = {k: {kk: torch.as_tensor(v) for kk, v in d.items()}
            for k, d in arrs.items()}
    return ref, port


def _close(ref_tree, port_tree):
    ref_leaves, port_leaves = jax.tree.leaves(ref_tree), tree_leaves(port_tree)
    assert len(ref_leaves) == len(port_leaves)
    for a, b in zip(ref_leaves, port_leaves):
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5,
                                   atol=1e-6)


WEIGHTS = np.array([64, 64, 63, 65, 70, 58, 64, 64], np.float64)


@pytest.mark.parametrize("weights", [None, WEIGHTS])
def test_fedavg_stacked(weights):
    ref, port = _stack(8, 0)
    _close(ref_agg.fedavg_stacked(ref, weights),
           port_agg.fedavg_stacked(port, weights))


def test_hfl_tier1_and_two_tier():
    ref, port = _stack(8, 1)
    w = WEIGHTS.astype(np.float32)
    rg, rt = ref_agg.hfl_tier1_stacked(ref, 2, w)
    pg, pt = port_agg.hfl_tier1_stacked(port, 2, w)
    _close(rg, pg)
    np.testing.assert_allclose(pt.numpy(), np.asarray(rt), rtol=1e-6)
    _close(ref_agg.hfl_aggregate_stacked(ref, 2, w),
           port_agg.hfl_aggregate_stacked(port, 2, w))


def test_afl_with_participation_mask():
    ref, port = _stack(8, 2)
    mask = np.array([1, 0, 1, 1, 0, 0, 1, 0], np.float32)
    _close(ref_agg.afl_aggregate_stacked(ref, WEIGHTS, mask),
           port_agg.afl_aggregate_stacked(port, WEIGHTS, mask))


@pytest.mark.parametrize("alpha", [0.5, 0.3])
def test_cfl_merge_stacked(alpha):
    ref, port = _stack(2, 3)
    rg = jax.tree.map(lambda l: l[0], ref)
    rc = jax.tree.map(lambda l: l[1], ref)
    pg, pc = port_engine.unstack_forest(port)
    _close(ref_agg.cfl_merge_stacked(rg, rc, alpha),
           port_agg.cfl_merge_stacked(pg, pc, alpha))
    # the host merge of the loop engine computes the same function
    _close(ref_agg.cfl_merge(rg, rc, alpha), port_agg.cfl_merge(pg, pc, alpha))


def test_merge_aggregate_stacked():
    ref, port = _stack(4, 4)
    rbase = jax.tree.map(lambda l: l[0], _stack(1, 5)[0])
    pbase = port_engine.unstack_forest(_stack(1, 5)[1])[0]
    w = np.array([0.4, 0.1, 0.2, 0.2, 0.1], np.float32)
    _close(ref_ops.merge_aggregate_stacked(rbase, ref, jnp.asarray(w)),
           port_ops.merge_aggregate_stacked(pbase, port, torch.as_tensor(w)))


@pytest.mark.parametrize("degree", [2, 4])
def test_gossip_stacked_undefended(degree):
    ref, port = _stack(6, 6)
    nbrs = topology.ring_neighbors(6, degree)
    np.testing.assert_array_equal(ref_agg.gossip_mix_matrix(nbrs),
                                  port_agg.gossip_mix_matrix(nbrs))
    _close(ref_agg.gossip_stacked(ref, nbrs), port_agg.gossip_stacked(port, nbrs))


def test_all_zero_weights_degrade_to_uniform():
    ref, port = _stack(4, 7)
    zero = np.zeros(4, np.float32)
    w = port_agg._safe_normalize(torch.as_tensor(zero), 4)
    np.testing.assert_array_equal(w.numpy(), np.full(4, 0.25, np.float32))
    np.testing.assert_array_equal(
        w.numpy(), np.asarray(ref_agg._safe_normalize(jnp.asarray(zero), 4)))
    out = port_agg.afl_aggregate_stacked(port, None, zero)
    assert all(torch.isfinite(t).all() for t in tree_leaves(out))
    _close(ref_agg.afl_aggregate_stacked(ref, None, zero), out)


def test_host_operators_match_reference():
    ref, port = _stack(4, 8)
    rl = [jax.tree.map(lambda l, i=i: l[i], ref) for i in range(4)]
    pl = port_engine.unstack_forest(port)
    w = [3.0, 1.0, 2.0, 2.0]
    _close(ref_agg.fedavg(rl, w), port_agg.fedavg(pl, w))
    _close(ref_agg.fedavg(rl, w), port_agg.fedavg(pl, w, use_kernel=True))
    groups = topology.hierarchical_groups(4, 2)
    _close(ref_agg.hfl_aggregate(rl, groups, w),
           port_agg.hfl_aggregate(pl, groups, w))
    _close(ref_agg.afl_aggregate(rl, [0, 2], w),
           port_agg.afl_aggregate(pl, [0, 2], w))


def test_outside_slice_raises():
    _, port = _stack(4, 9)
    with pytest.raises(NotImplementedError):
        port_agg.defended_aggregate_stacked(port, defense="median")
    with pytest.raises(NotImplementedError):
        port_agg.gossip_stacked(port, topology.ring_neighbors(4),
                                defense="median")


def test_tree_where():
    _, a = _stack(2, 11)
    _, b = _stack(2, 12)
    for flag, want in ((True, a), (False, b)):
        out = port_agg.tree_where(flag, a, b)
        for x, y in zip(tree_leaves(out), tree_leaves(want)):
            np.testing.assert_array_equal(x.numpy(), y.numpy())


def test_stacking_utilities():
    _, port = _stack(3, 10)
    back = port_engine.stack_forest(port_engine.unstack_forest(port))
    for a, b in zip(tree_leaves(port), tree_leaves(back)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    one = port_engine.unstack_forest(port)[1]
    rep = port_engine.replicate_tree(one, 4)
    assert tree_leaves(rep)[0].shape[0] == 4
    assert all(t.is_contiguous() for t in tree_leaves(rep))
    per_client = port_engine.repeat_groups(port, 2)
    np.testing.assert_array_equal(per_client["head"]["kernel"][3].numpy(),
                                  port["head"]["kernel"][1].numpy())
