"""The port's fault schedules (`repro_torch.core.faults`, `.membership`)
against the reference's, bit for bit, and the fault seams of the port's
stacked operators against the reference's operators.

Schedules are host numpy built from one salted generator in one
consumption order, so every array must be EQUAL, not close: alive masks,
heartbeat ages, detections, rejoins and their staleness, moving-target
rings, per-event mixing matrices and gather indices, group quorums, the
fused executor's scan inputs and the schedule statistics. The operators
hold at 1e-6 (abs and rel): the same masked weights, summed in another
order."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.core import aggregation as ref_agg  # noqa: E402
from repro.core import faults as ref_faults  # noqa: E402
from repro.core import fl_types as ref_types  # noqa: E402
from repro.core import membership as ref_membership  # noqa: E402
from repro_torch.core import aggregation as port_agg  # noqa: E402
from repro_torch.core import faults as port_faults  # noqa: E402
from repro_torch.core import fl_types as port_types  # noqa: E402
from repro_torch.core import membership as port_membership  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

PROFILES = [p for p in ref_faults.FAULT_PROFILES if p != "none"]


def _schedules(profile, seed, mtd, C=12, R=7, degree=4, k=None):
    kw = dict(profile=profile, seed=seed, num_clients=C, n_events=R,
              churn_rate=0.35, quorum_frac=0.6, heartbeat_timeout=2,
              mtd=mtd, event_size=C if k is None else k,
              gossip_degree=degree)
    return ref_faults.FaultSchedule(**kw), port_faults.FaultSchedule(**kw)


@pytest.mark.parametrize("k", [12, 6], ids=["all", "sampled"])
@pytest.mark.parametrize("mtd", [False, True], ids=["static", "mtd"])
@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("profile", PROFILES)
def test_schedule_is_bitwise_the_reference(profile, seed, mtd, k):
    """k: the event's participant count — all 12 clients, or a sampled 6
    (AFL at participation 0.5 gossips over participant positions)."""
    ref, port = _schedules(profile, seed, mtd, k=k)
    for name in ("alive", "ages", "detected", "rejoined",
                 "rejoin_staleness"):
        a, b = getattr(ref, name), getattr(port, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(b, a, err_msg=name)
    assert port.rings == ref.rings
    C, R = ref.num_clients, ref.n_events
    rng = np.random.default_rng(seed)
    pids_l = [sorted(rng.choice(C, size=k, replace=False).tolist())
              for _ in range(R)]
    for ev, pids in enumerate(pids_l):
        for name in ("gossip_mix", "gossip_gather"):
            args = (ev, pids) + ((5,) if name == "gossip_gather" else ())
            a = getattr(ref, name)(*args)
            b = getattr(port, name)(*args)
            assert a.dtype == b.dtype and a.shape == b.shape, name
            np.testing.assert_array_equal(b, a, err_msg=name)
        fa, fb = ref.event_view(ev, pids), port.event_view(ev, pids)
        np.testing.assert_array_equal(fb.alive, fa.alive)
        assert (fb.n_alive, fb.qok, fb.rejoined, fb.rejoin_staleness) \
            == (fa.n_alive, fa.qok, fa.rejoined, fa.rejoin_staleness)
        for groups in (2, 3):
            np.testing.assert_array_equal(port.group_qok(ev, pids, groups),
                                          ref.group_qok(ev, pids, groups))
    for kw in (dict(num_groups=3), dict(gossip=True),
               dict(gossip=True, gossip_defended=True, gather_k=5)):
        xa, xb = ref.scan_xs(pids_l, **kw), port.scan_xs(pids_l, **kw)
        assert sorted(xa) == sorted(xb)
        for key in xa:
            assert xa[key].dtype == xb[key].dtype, key
            np.testing.assert_array_equal(xb[key], xa[key], err_msg=key)
    assert port.schedule_stats() == ref.schedule_stats()


@pytest.mark.parametrize("n,frac", [(1, 0.0), (4, 0.5), (5, 0.6), (32, 0.3),
                                    (7, 1.0)])
def test_quorum_threshold_matches(n, frac):
    assert port_faults.quorum_threshold(n, frac) == \
        ref_faults.quorum_threshold(n, frac)


def test_membership_primitives_match():
    rng = np.random.default_rng(3)
    alive = rng.random((9, 10)) >= 0.3
    ages = port_membership.heartbeat_ages(alive)
    np.testing.assert_array_equal(ages, ref_membership.heartbeat_ages(alive))
    for timeout in (1, 3):
        np.testing.assert_array_equal(
            port_membership.detected_failures(ages, timeout),
            ref_membership.detected_failures(ages, timeout))
    for a, b in zip(port_membership.rejoin_events(alive, ages),
                    ref_membership.rejoin_events(alive, ages)):
        np.testing.assert_array_equal(a, b)
    for degree in (2, 4):
        assert port_membership.moving_target_ring(
            10, degree, np.random.default_rng(5)) == \
            ref_membership.moving_target_ring(
                10, degree, np.random.default_rng(5))


def test_compile_schedule_none_and_profiles():
    fl = port_types.FLConfig(num_clients=4, num_groups=2)
    assert port_faults.compile_schedule(fl, 2, 4) is None
    kw = dict(num_clients=8, num_groups=2, rounds=3, fault_profile="churn",
              fault_mtd=True, afl_mode="gossip", seed=4)
    port = port_faults.compile_schedule(port_types.FLConfig(**kw), 3, 8)
    ref = ref_faults.compile_schedule(ref_types.FLConfig(**kw), 3, 8)
    np.testing.assert_array_equal(port.alive, ref.alive)
    assert port.rings == ref.rings
    with pytest.raises(ValueError, match="quake"):
        port_faults.FaultSchedule(
            profile="quake", seed=0, num_clients=4, n_events=2,
            churn_rate=0.3, quorum_frac=0.5, heartbeat_timeout=1,
            mtd=False, event_size=4, gossip_degree=2)


# -- fault seams of the stacked operators -----------------------------------

def _tree(rng, C):
    return {"conv": {"bias": rng.normal(size=(C, 3)).astype(np.float32),
                     "kernel": rng.normal(size=(C, 2, 2, 3)).astype(
                         np.float32)},
            "head": {"kernel": rng.normal(size=(C, 5)).astype(np.float32)}}


def _both(tree):
    return (jax.tree.map(jnp.asarray, tree),
            {k: {kk: torch.as_tensor(v) for kk, v in d.items()}
             for k, d in tree.items()})


def _close(ref, port, tol=1e-6):
    ra, pa = jax.tree.leaves(ref), tree_leaves(port)
    assert len(ra) == len(pa)
    for a, b in zip(ra, pa):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=tol,
                                   rtol=tol)


ALIVE = {"some-dead": [1, 0, 1, 1, 0, 1, 1, 1],
         "group-dead": [0, 0, 0, 0, 1, 0, 1, 1],
         "all-dead": [0] * 8}


@pytest.mark.parametrize("defense", ["none", "median", "trimmed_mean",
                                     "norm_clip", "krum"])
@pytest.mark.parametrize("alive", sorted(ALIVE))
def test_alive_seams_match_reference(defense, alive):
    """defended_aggregate_stacked, hfl_tier1_stacked (dead rows take the
    group center for every defense) and afl_aggregate_stacked with an
    alive mask, against the reference's operators."""
    rng = np.random.default_rng(len(alive) + len(defense))
    C = 8
    rs, ps = _both(_tree(rng, C))
    rc, pc = _both(jax.tree.map(lambda a: a[:2], _tree(rng, C)))
    r1, p1 = _both(jax.tree.map(lambda a: a[0], _tree(rng, C)))
    w = rng.uniform(1, 3, size=C).astype(np.float32)
    a = np.asarray(ALIVE[alive], np.float32)
    kw = dict(defense=defense, f=1, tau=0.8)
    _close(ref_agg.defended_aggregate_stacked(rs, w, center=r1, alive=a,
                                              **kw),
           port_agg.defended_aggregate_stacked(ps, w, center=p1, alive=a,
                                               **kw))
    rg, rw = ref_agg.hfl_tier1_stacked(rs, 2, w, centers=rc, alive=a, **kw)
    pg, pw = port_agg.hfl_tier1_stacked(ps, 2, w, centers=pc, alive=a, **kw)
    _close(rg, pg)
    np.testing.assert_allclose(pw.numpy(), np.asarray(rw), rtol=1e-6)
    if defense == "none":
        _close(ref_agg.afl_aggregate_stacked(rs, w, alive=a),
               port_agg.afl_aggregate_stacked(ps, w, alive=a))


def test_mask_rows_and_tree_where_rows_match_reference():
    rng = np.random.default_rng(11)
    rs, ps = _both(_tree(rng, 6))
    ro, po = _both(_tree(rng, 6))
    r1, p1 = _both(jax.tree.map(lambda a: a[0], _tree(rng, 6)))
    mask = np.array([1, 0, 0, 1, 1, 0], bool)
    _close(ref_agg.mask_rows(rs, mask.astype(np.float32), r1),
           port_agg.mask_rows(ps, mask.astype(np.float32), p1), 0)
    _close(ref_agg.tree_where_rows(mask, rs, ro),
           port_agg.tree_where_rows(mask, ps, po), 0)


@pytest.mark.parametrize("mtd", [False, True], ids=["static", "mtd"])
@pytest.mark.parametrize("defense", ["none", "median", "trimmed_mean"])
def test_masked_gossip_stacked_matches_reference(defense, mtd):
    """Masked gossip through the schedule's per-round arrays: the mixing
    matrix (undefended, the masked-mix kernel's plain version here) or
    the gathered neighborhoods (defended, one sort)."""
    ref_s, port_s = _schedules("churn", 2, mtd, C=8, R=3)
    rng = np.random.default_rng(5)
    rs, ps = _both(_tree(rng, 8))
    pids = list(range(8))
    for ev in range(3):
        kw = (dict(mix=port_s.gossip_mix(ev, pids)) if defense == "none"
              else dict(gather_idx=port_s.gossip_gather(ev, pids, 5),
                        defense=defense, f=1))
        out = port_agg.masked_gossip_stacked(ps, **kw)
        _close(ref_agg.masked_gossip_stacked(rs, **kw), out)
        if defense == "none":
            dead = np.flatnonzero(~port_s.alive[ev])
            for a, b in zip(tree_leaves(out), tree_leaves(ps)):
                assert torch.equal(a[dead], b[dead])       # identity rows
    with pytest.raises(ValueError, match="median/trimmed_mean"):
        port_agg.masked_gossip_stacked(
            ps, gather_idx=port_s.gossip_gather(0, pids, 5), defense="krum")
