"""The port's mesh launcher and mesh operators (`repro_torch.launch.mesh`,
the mesh section of `repro_torch.core.aggregation`; DESIGN.md §11) on the
CPU: 4 gloo ranks spawned once for the module (`World`), each case run on
every rank.

* Launch: `largest_divisor_at_most` and `make_host_mesh`'s divisor
  clamping (the reference's tests/test_fl_mesh_dryrun.py:226-260 cases),
  `make_client_mesh` refusing more ranks than the placement has, the
  backend rule, `World` placing its ranks on the card unless asked for
  the CPU, and a rank that raises failing the caller with its
  traceback within the group timeout.
* Operators: each mesh operator on 4 ranks against the reference's host
  aggregate of the gathered stack (`fedavg_stacked`, `hfl_aggregate`,
  `gossip_stacked`, `fedavg` + `cfl_merge`) at the reference tests'
  tolerances (replicated to 1e-5, error below 1e-4;
  test_fl_mesh_dryrun.py:142-215): HFL groups that nest in, equal and
  span shards, each with and without `force_fallback`; `mesh_hfl` single
  pod and on a 2 x 2 pod world; `mesh_afl_gossip` against three-client
  ring averaging; `mesh_afl_fedavg`; `mesh_cfl`. HFL's tier 1 issues no
  collective on any rank; tier 2 issues one.
* Executor: one HFL run of the mesh-sharded fused executor (8 clients, 4
  groups, 2 rounds on the 4 ranks) against the reference's single-device
  fused run from the reference's init, at test_torch_fused_ref.py's
  tolerances (the rest of the executor is in test_torch_mesh_fused.py).
"""
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import aggregation as ref_agg  # noqa: E402
from repro.core import fl_types as ref_types  # noqa: E402
from repro.core import simulation as ref_sim_mod  # noqa: E402
from repro.core import topology as ref_topo  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import aggregation as agg  # noqa: E402
from repro_torch.core import fl_types as port_types  # noqa: E402
from repro_torch.core import simulation as port_sim_mod  # noqa: E402
from repro_torch.core import topology  # noqa: E402
from repro_torch.data.synthetic import mnist_like  # noqa: E402
from repro_torch.launch import mesh  # noqa: E402

import torch_mesh_cases as cases  # noqa: E402

RANKS = 4
C, N = 16, 500
REPLICATED = 1e-5          # every rank holds the same global model
ERR = 1e-4                 # against the reference's host aggregate


@pytest.fixture(scope="module")
def world():
    with mesh.World(RANKS, device="cpu", timeout=60) as w:
        yield w


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    return (rng.normal(size=(C, N)).astype(np.float32),
            rng.uniform(10.0, 100.0, C).astype(np.float32))


def _replicated(outs, key="w"):
    first = outs[0][0][key]
    for out, _ in outs[1:]:
        np.testing.assert_allclose(out[key], first, atol=REPLICATED)
    return first


def _clients(stacked):
    return [{"w": jnp.asarray(row)} for row in stacked]


# -- launch ------------------------------------------------------------------

def test_largest_divisor_at_most():
    f = mesh.largest_divisor_at_most
    assert f(6, 4) == 3
    assert f(6, 6) == 6
    assert f(8, 5) == 4
    assert f(7, 3) == 1
    assert f(12, 0) == 1
    assert f(12, 99) == 12


@pytest.mark.parametrize("ndev,requests,want", [
    # 6 devices: data=4 does not divide -> 3 (largest divisor), NOT
    # min(4, 6) = 4, which 6 cannot factor
    (6, [(4, 1), (6, 1), (4, 4), (5, 5)], [(3, 1), (6, 1), (3, 2), (3, 2)]),
    (8, [(4, 2), (3, 1), (16, 1), (8, 8)], [(4, 2), (2, 1), (8, 1), (8, 1)]),
])
def test_make_host_mesh_clamps_to_divisors(ndev, requests, want):
    got = [mesh.make_host_mesh(d, m, devices=ndev).axis_sizes
           for d, m in requests]
    assert got == [tuple(w) for w in want]
    assert all(mesh.make_host_mesh(d, m, devices=ndev).axis_names
               == ("data", "model") for d, m in requests)


def test_mesh_shapes():
    assert mesh.make_production_mesh().shape == {"data": 16, "model": 16}
    assert mesh.make_production_mesh(multi_pod=True).axis_sizes == (2, 16, 16)
    assert mesh.make_fl_mesh(clients=8, model=2).shape == {"data": 8,
                                                           "model": 2}
    assert mesh.make_fl_mesh(multi_pod=True).axis_names == ("pod", "data",
                                                            "model")
    assert mesh.make_client_mesh(4, available=8).shape == {"data": 4}
    assert mesh.make_client_mesh(0, available=3).shape == {"data": 3}
    with pytest.raises(ValueError, match="exceeds"):
        mesh.make_client_mesh(9, available=8)


def test_backend_rule_on_the_cpu():
    assert mesh.resolve_backend(None, "cpu", 4) == "gloo"
    assert mesh.resolve_backend("gloo", "cpu", 1) == "gloo"
    with pytest.raises(ValueError, match="nccl"):
        mesh.resolve_backend("nccl", "cpu", 4)
    with pytest.raises(ValueError, match="nccl"):
        mesh.World(2, device="cpu", backend="nccl")
    with pytest.raises(ValueError, match="expected"):
        mesh.resolve_backend("mpi", "cpu", 2)


def test_world_places_its_ranks_on_the_card_by_default():
    import inspect
    assert inspect.signature(mesh.World).parameters["device"].default \
        == "cuda"
    if not torch.cuda.is_available():
        # the card is asked for and absent: refused before any rank starts
        with pytest.raises(RuntimeError, match="device='cpu'"):
            mesh.World(2)


def test_a_rank_that_raises_fails_the_caller_with_its_traceback():
    timeout = 30.0
    t0 = time.monotonic()
    w = mesh.World(2, device="cpu", timeout=timeout)
    try:
        with pytest.raises(mesh.RankError) as err:
            w.run(cases.fail_on, 1)
    finally:
        w.close()
    msg = str(err.value)
    assert "rank 1 raised" in msg
    assert "ValueError: rank 1 fails on purpose" in msg
    assert "Traceback" in msg and "fail_on" in msg
    assert time.monotonic() - t0 < timeout
    assert not any(p.is_alive() for p in w._procs)
    with pytest.raises(mesh.RankError, match="closed"):
        w.run(cases.fail_on, 1)


# -- stacked operators -------------------------------------------------------

def test_mesh_fedavg_stacked_matches_host(world, data):
    stacked, weights = data
    outs = world.run(cases.stacked_op, "fedavg", stacked, weights)
    got = _replicated(outs)
    want = np.asarray(ref_agg.fedavg_stacked(
        {"w": jnp.asarray(stacked)}, jnp.asarray(weights))["w"])
    assert np.max(np.abs(got - want)) < ERR
    assert all(c["calls"] == {"all_reduce": 1} for _, c in outs)


@pytest.mark.parametrize("groups,fallback", [
    (8, False), (8, True),      # groups nest inside a shard (2 of 4)
    (4, False), (4, True),      # group == shard (the executor's regime)
    (2, False), (2, True),      # groups span 2 shards: subgroup or one-hot
])
def test_mesh_hfl_stacked_matches_host(world, data, groups, fallback):
    stacked, weights = data
    outs = world.run(cases.stacked_op, "hfl", stacked, weights,
                     groups=groups, fallback=fallback)
    got = _replicated(outs)
    host = ref_agg.hfl_aggregate(_clients(stacked),
                                 ref_topo.hierarchical_groups(C, groups),
                                 weights=weights)
    assert np.max(np.abs(got - np.asarray(host["w"]))) < ERR


def test_mesh_gossip_stacked_matches_host(world, data):
    stacked, weights = data
    mix = agg.gossip_mix_matrix(topology.ring_neighbors(C, 2))
    outs = world.run(cases.stacked_op, "gossip", stacked, weights, mix=mix)
    got = np.concatenate([o["w"] for o, _ in outs])     # rank row blocks
    want = np.asarray(ref_agg.gossip_stacked(
        {"w": jnp.asarray(stacked)}, ref_topo.ring_neighbors(C, 2))["w"])
    assert got.shape == (C, N)
    assert np.max(np.abs(got - want)) < ERR
    assert all(c["calls"] == {"all_reduce": 1} for _, c in outs)


def test_hfl_tier1_issues_no_collective(world, data):
    stacked, weights = data
    outs = world.run(cases.stacked_op, "tier1", stacked, weights,
                     groups_local=2)
    for r, (out, counts) in enumerate(outs):
        assert counts["scopes"] == {"tier1": 1, "tier2": 1}
        assert not any(k.startswith("tier1/") for k in counts["calls"]), \
            (r, counts)
        assert counts["calls"]["tier2/all_reduce"] == 1, (r, counts)
        # the shard-local groups are the host reshape of the rank's rows
        lo = r * (C // RANKS)
        w = weights[lo:lo + C // RANKS].reshape(2, -1)
        x = stacked[lo:lo + C // RANKS].reshape(2, -1, N)
        want = (x * w[..., None]).sum(1) / w.sum(1)[:, None]
        np.testing.assert_allclose(out["w"], want, atol=1e-5)
        np.testing.assert_allclose(out["gw"], w.sum(1), rtol=1e-6)


@pytest.mark.parametrize("names", ["model", ("model", "data")])
def test_packed_gather_matches_all_gather(world, names):
    """A take's small leaves gathered in one host all_gather of their flat
    concatenation (`collectives.packed_gather`, the shared card's path)
    equal each leaf's own all-gather along its dim, in axis order (the
    second axis lists its ranks out of ascending order); one call stands
    for an all-gather a leaf."""
    rng = np.random.default_rng(3)
    n = 2 if names == "model" else 4
    fulls = [(rng.normal(size=(4 * n,)).astype(np.float32), 0),
             (rng.normal(size=(3, 2 * n)).astype(np.float32), 1),
             (rng.normal(size=(n, 5)).astype(np.float32), 0)]
    for got, want, counts in world.run(cases.packed_gather, fulls, names):
        for g, w, (full, _) in zip(got, want, fulls):
            np.testing.assert_array_equal(g, w)
            np.testing.assert_array_equal(g, full)
        assert counts["calls"] == {"all_gather": 1}
        assert counts["kinds"] == {"all-gather": 3}
        assert counts["kind_bytes"]["all-gather"] == sum(
            f.nbytes for f, _ in fulls)


# -- one model a rank --------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(groups=2), dict(groups=2, fallback=True), dict(groups=4),
    dict(pod=(2, 2)),                    # tier 1 in a pod, tier 2 over pods
], ids=["groups2", "groups2-fallback", "groups4", "pod2x2"])
def test_mesh_hfl_matches_host(world, data, kw):
    stacked, weights = data[0][:RANKS], data[1][:RANKS]
    outs = world.run(cases.model_op, "hfl", stacked, weights, **kw)
    got = _replicated(outs)
    G = kw.get("groups", kw.get("pod", (0,))[0])
    host = ref_agg.hfl_aggregate(_clients(stacked),
                                 ref_topo.hierarchical_groups(RANKS, G),
                                 weights=weights)
    assert np.max(np.abs(got - np.asarray(host["w"]))) < ERR


def test_mesh_afl_gossip_matches_ring_averaging(world, data):
    stacked, weights = data[0][:RANKS], data[1][:RANKS]
    outs = world.run(cases.model_op, "afl_gossip", stacked, weights)
    got = np.stack([o["w"] for o, _ in outs])
    want = (np.roll(stacked, 1, axis=0) + stacked
            + np.roll(stacked, -1, axis=0)) / 3.0
    assert np.max(np.abs(got - want)) < ERR
    assert all(c["calls"] == {"all_reduce": 1} for _, c in outs)


@pytest.mark.parametrize("pod", [None, (2, 2)])
def test_mesh_afl_fedavg_matches_host(world, data, pod):
    stacked, weights = data[0][:RANKS], data[1][:RANKS]
    participate = np.array([1, 0, 1, 1], np.float32)
    outs = world.run(cases.model_op, "afl_fedavg", stacked, weights,
                     participate=participate, pod=pod)
    got = _replicated(outs)
    host = ref_agg.afl_aggregate(_clients(stacked), [0, 2, 3],
                                 weights=weights)
    assert np.max(np.abs(got - np.asarray(host["w"]))) < ERR


def test_mesh_cfl_matches_host(world, data):
    stacked, weights = data[0][:RANKS], data[1][:RANKS]
    g0 = data[0][RANKS]
    alpha = 0.3
    outs = world.run(cases.model_op, "cfl", stacked, weights,
                     **{"global": g0, "alpha": alpha})
    got_global = _replicated(outs, "global")
    mean = ref_agg.fedavg(_clients(stacked), weights)
    want_global = ref_agg.cfl_merge({"w": jnp.asarray(g0)}, mean, alpha)
    assert np.max(np.abs(got_global - np.asarray(want_global["w"]))) < ERR
    for r, (out, _) in enumerate(outs):
        want = ref_agg.cfl_merge({"w": jnp.asarray(stacked[r])},
                                 want_global, alpha)
        assert np.max(np.abs(out["w"] - np.asarray(want["w"]))) < ERR


# -- the executor against the reference ---------------------------------------

def test_sharded_hfl_matches_the_reference_from_its_init(world):
    ds = mnist_like(seed=0, n_train=512, n_test=128)
    # 8 clients in 4 groups over 2 rounds: the reference's scan compiles
    # in a third of the 16-client time
    cfg = dict(num_clients=8, num_groups=4, rounds=2, local_epochs=1,
               local_batch_size=16, lr=0.05, seed=0, participation=1.0,
               engine="fused", strategy="hfl", telemetry=False)
    ref = ref_sim_mod.FederatedSimulation(ref_types.FLConfig(**cfg), ds)
    init = jax.tree.map(np.asarray, ref.init_params)
    port = port_sim_mod.FederatedSimulation(
        port_types.FLConfig(**dict(cfg, mesh_devices=RANKS)), ds,
        model_init=lambda g: convert.params_from_jax(init), device="cpu",
        mesh_world=world)
    r, p = ref.run_fused(), port.run()
    # test_torch_fused_ref.py's tolerances for HFL
    np.testing.assert_allclose(p.round_train_loss, r.round_train_loss,
                               atol=1e-3)
    np.testing.assert_allclose(p.round_train_acc, r.round_train_acc,
                               atol=0.02)
    np.testing.assert_allclose(p.round_test_acc, r.round_test_acc,
                               atol=0.02)
    assert abs(p.test_accuracy - r.test_accuracy) <= 0.02
    assert (ref.rng.bit_generator.state["state"]
            == port.rng.bit_generator.state["state"])
