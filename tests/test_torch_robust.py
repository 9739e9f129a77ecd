"""repro_torch.core.robust and the defended operators of
repro_torch.core.aggregation against the reference on the same inputs
(the reference's kernels run as its CPU path: fedavg in interpret mode,
the selection network as jnp).

Tolerance 1e-5 relative / 1e-6 absolute: both sides compute the same f32
order statistics, norms and weighted sums, in another order. Krum is
held on well-separated clients, where its choice is not a near tie."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.core import aggregation as ref_agg  # noqa: E402
from repro.core import robust as ref_robust  # noqa: E402
from repro.core import topology  # noqa: E402
from repro_torch.core import aggregation as port_agg  # noqa: E402
from repro_torch.core import engine as port_engine  # noqa: E402
from repro_torch.core import robust as port_robust  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

SHAPES = {"conv": {"kernel": (3, 3, 1, 4), "bias": (4,)},
          "head": {"kernel": (36, 10), "bias": (10,)}}
DEFENSES = ("none", "median", "trimmed_mean", "norm_clip", "krum",
            "multi_krum")


def _clustered(C, N, seed, outliers=()):
    """(C, N) float32: honest rows near one point, `outliers` rows far."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(1, N)) + 0.1 * rng.normal(size=(C, N)))
    for i in outliers:
        x[i] += 5.0 + rng.normal(size=N)
    return x.astype(np.float32)


def _tree(mat):
    """(C, N) matrix -> the same stacked tree for (reference, port)."""
    C, out, off = mat.shape[0], {}, 0
    for k, d in SHAPES.items():
        out[k] = {}
        for kk, s in d.items():
            n = int(np.prod(s))
            out[k][kk] = mat[:, off:off + n].reshape((C,) + s)
            off += n
    return (jax.tree.map(jnp.asarray, out),
            jax.tree.map(lambda a: torch.as_tensor(np.array(a)), out))


N_TREE = sum(int(np.prod(s)) for d in SHAPES.values() for s in d.values())


def _close(ref, port, tol=1e-5, atol=1e-6):
    if isinstance(port, torch.Tensor):
        np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=tol,
                                   atol=atol)
        return
    ref_leaves, port_leaves = jax.tree.leaves(ref), tree_leaves(port)
    assert len(ref_leaves) == len(port_leaves)
    for a, b in zip(ref_leaves, port_leaves):
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=tol,
                                   atol=1e-6)


@pytest.mark.parametrize("f", [1, 2])
@pytest.mark.parametrize("defense", DEFENSES)
def test_robust_aggregate_matches_reference(defense, f):
    mat = _clustered(7, 300, 0, outliers=(1, 4))
    w = np.array([3, 1, 2, 2, 1, 4, 2], np.float32)
    center = mat.mean(0) + 0.05
    tau = 2.0                        # clips most deltas
    ref = ref_robust.robust_aggregate(
        jnp.asarray(mat), defense, weights=w, f=f, tau=tau,
        center=jnp.asarray(center))
    port = port_robust.robust_aggregate(
        torch.as_tensor(mat), defense, weights=w, f=f, tau=tau,
        center=torch.as_tensor(center))
    _close(ref, port)


def test_krum_scores_and_selection():
    mat = _clustered(8, 200, 1, outliers=(0, 5))
    # the Gram expansion cancels: distances are good to ~1e-6 of the
    # largest squared norm, not relative to each entry
    ref_d = np.asarray(ref_robust.pairwise_sq_dists(jnp.asarray(mat)))
    scale = 1e-6 * float((mat.astype(np.float64) ** 2).sum(1).max())
    _close(ref_d, port_robust.pairwise_sq_dists(torch.as_tensor(mat)),
           tol=1e-5, atol=scale)
    _close(ref_robust.krum_scores(jnp.asarray(mat), 2),
           port_robust.krum_scores(torch.as_tensor(mat), 2), tol=1e-5,
           atol=8 * scale)
    for m in (1, 3, 6):
        np.testing.assert_array_equal(
            port_robust.krum_select(torch.as_tensor(mat), 2, m).numpy(),
            np.asarray(ref_robust.krum_select(jnp.asarray(mat), 2, m)))
    # ties break by index, as jnp.argsort's stable sort does
    same = np.repeat(mat[:1], 4, axis=0)
    np.testing.assert_array_equal(
        port_robust.krum_select(torch.as_tensor(same), 1, 4).numpy(),
        np.asarray(ref_robust.krum_select(jnp.asarray(same), 1, 4)))


def test_norm_clip_factors_and_clip_update():
    mat = _clustered(5, N_TREE, 2, outliers=(3,))
    base = mat[0] + 0.3
    deltas = mat - base[None]
    _close(ref_robust.norm_clip_factors(jnp.asarray(deltas), 1.5),
           port_robust.norm_clip_factors(torch.as_tensor(deltas), 1.5))
    rt, pt = _tree(mat)
    rb, pb = _tree(base[None])
    rb0 = jax.tree.map(lambda a: a[0], rb)
    pb0 = port_engine.unstack_forest(pb)[0]
    _close(ref_robust.clip_deltas_stacked(rb0, rt, 1.5),
           port_robust.clip_deltas_stacked(pb0, pt, 1.5))
    _close(ref_robust.clip_update(rb0, jax.tree.map(lambda a: a[3], rt), 1.5),
           port_robust.clip_update(pb0, port_engine.unstack_forest(pt)[3],
                                   1.5))


@pytest.mark.parametrize("defense", DEFENSES)
def test_defended_aggregate_stacked_and_host_fedavg(defense):
    mat = _clustered(6, N_TREE, 3, outliers=(2,))
    rt, pt = _tree(mat)
    rc, pc = _tree(mat.mean(0, keepdims=True) - 0.02)
    rc0 = jax.tree.map(lambda a: a[0], rc)
    pc0 = port_engine.unstack_forest(pc)[0]
    w = np.array([64, 64, 63, 65, 70, 58], np.float64)
    kw = dict(defense=defense, f=1, tau=3.0)
    _close(ref_agg.defended_aggregate_stacked(rt, w, center=rc0, **kw),
           port_agg.defended_aggregate_stacked(pt, w, center=pc0, **kw))
    rl = [jax.tree.map(lambda a, i=i: a[i], rt) for i in range(6)]
    pl = port_engine.unstack_forest(pt)
    _close(ref_agg.defended_fedavg(rl, w, center=rc0, **kw),
           port_agg.defended_fedavg(pl, w, center=pc0, **kw))


@pytest.mark.parametrize("defense", ["median", "trimmed_mean", "norm_clip",
                                     "krum"])
def test_defended_hfl_tiers(defense):
    mat = _clustered(8, N_TREE, 4, outliers=(1, 6))
    rt, pt = _tree(mat)
    rc, pc = _tree(np.stack([mat[:4].mean(0), mat[4:].mean(0)]) + 0.01)
    w = np.array([64, 64, 63, 65, 70, 58, 64, 64], np.float32)
    kw = dict(defense=defense, f=1, tau=2.0)
    rg, rtot = ref_agg.hfl_tier1_stacked(rt, 2, w, centers=rc, **kw)
    pg, ptot = port_agg.hfl_tier1_stacked(pt, 2, w, centers=pc, **kw)
    _close(rg, pg)
    _close(rtot, ptot)
    _close(ref_agg.hfl_aggregate_stacked(rt, 2, w, centers=rc, **kw),
           port_agg.hfl_aggregate_stacked(pt, 2, w, centers=pc, **kw))
    groups = topology.hierarchical_groups(8, 2)
    rl = [jax.tree.map(lambda a, i=i: a[i], rt) for i in range(8)]
    pl = port_engine.unstack_forest(pt)
    rcl = [jax.tree.map(lambda a, i=i: a[i], rc) for i in range(2)]
    _close(ref_agg.hfl_aggregate(rl, groups, w, centers=rcl, **kw),
           port_agg.hfl_aggregate(pl, groups, w,
                                  centers=port_engine.unstack_forest(pc),
                                  **kw))


@pytest.mark.parametrize("degree", [2, 4])
@pytest.mark.parametrize("defense,f", [("median", 1), ("trimmed_mean", 1),
                                       ("trimmed_mean", 2)])
def test_defended_gossip(defense, f, degree):
    mat = _clustered(6, N_TREE, 5, outliers=(0,))
    rt, pt = _tree(mat)
    nbrs = topology.ring_neighbors(6, degree)
    _close(ref_agg.gossip_stacked(rt, nbrs, defense=defense, f=f),
           port_agg.gossip_stacked(pt, nbrs, defense=defense, f=f))
    rl = [jax.tree.map(lambda a, i=i: a[i], rt) for i in range(6)]
    pl = port_engine.unstack_forest(pt)
    for r, p in zip(ref_agg.gossip_round(rl, nbrs, defense=defense, f=f),
                    port_agg.gossip_round(pl, nbrs, defense=defense, f=f)):
        _close(r, p)


@pytest.mark.parametrize("tau", [0.5, 100.0])
@pytest.mark.parametrize("alpha", [0.5, 0.3])
def test_defended_cfl_merge(alpha, tau):
    mat = _clustered(2, N_TREE, 6, outliers=(1,))
    rt, pt = _tree(mat)
    rg, rc = (jax.tree.map(lambda a, i=i: a[i], rt) for i in range(2))
    pg, pc = port_engine.unstack_forest(pt)
    _close(ref_agg.defended_cfl_merge(rg, rc, alpha, tau),
           port_agg.defended_cfl_merge(pg, pc, alpha, tau))


def test_bad_defenses_raise():
    mat = _clustered(4, N_TREE, 7)
    _, pt = _tree(mat)
    with pytest.raises(ValueError, match="unknown defense"):
        port_robust.robust_aggregate(torch.as_tensor(mat), "mean")
    with pytest.raises(ValueError, match="center"):
        port_robust.robust_aggregate(torch.as_tensor(mat), "norm_clip")
    with pytest.raises(ValueError, match="median/trimmed_mean"):
        port_agg.gossip_stacked(pt, topology.ring_neighbors(4),
                                defense="krum")
