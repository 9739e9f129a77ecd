"""The port's mesh-sharded fused executor (`FLConfig.mesh_devices`,
DESIGN.md §11) on the CPU: 4 gloo ranks, spawned once for the module and
fed every case, each running the fused round body on its 4 of 16 clients.

* The reference's 5 parity cases (tests/test_mesh_fused.py:57-67: HFL,
  AFL star, AFL gossip, HFL with a gaussian attacker, AFL chunked) at 16
  clients, 8 groups, 3 rounds hold to the port's UNCHUNKED single-device
  fused run at the reference's tolerances (:75-80): round accuracy 1e-5,
  loss 1e-4, test accuracy and final metrics 1e-5. As in the reference,
  the chunked case trains half a shard a chunk (there 1 of 2 clients,
  here 2 of 4) against the unchunked run.
* One known exception, held to the single-device run chunked alike:
  `fused_chunk=1`. A 1-client stack is a plain convolution, which the CPU
  sums in another order than the grouped one of every larger stack; on
  the reference's data (n_train=1024) the single-device chunk-1 run lands
  9.8e-4 round accuracy from the unchunked one (ROADMAP §C.4).
* HFL under churn (group quorum holds through `alive`, one below-quorum
  round) holds to the single-device run the same way.
* (One sharded HFL run held to the reference's own fused run from the
  reference's init is in test_torch_mesh.py, beside the operators, so
  that the reference's compile time falls in the lighter file.)
* HFL's tier 1 issues no collective on any rank (tier 2 issues some, the
  positive control); every precondition of the reference's `_mesh_wrap`
  raises with its message (tests/test_mesh_fused.py:150-205); nccl on a
  CPU placement raises; a run without a world starts and stops its own.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.core import fl_types as port_types  # noqa: E402
from repro_torch.core import simulation as port_sim_mod  # noqa: E402
from repro_torch.data.synthetic import mnist_like  # noqa: E402
from repro_torch.launch import mesh  # noqa: E402

RANKS = 4
CFG = dict(num_clients=16, rounds=3, num_groups=8, local_epochs=1,
           local_batch_size=16, lr=0.05, seed=0, participation=1.0,
           engine="fused", attack_fraction=0.25, attack_scale=0.5)
# the reference's tolerances (tests/test_mesh_fused.py:75-80)
TOL = {"round_train_acc": 1e-5, "round_train_loss": 1e-4,
       "round_test_acc": 1e-5, "test_accuracy": 1e-5,
       "train_accuracy": 1e-5, "f1": 1e-5}
CASES = {
    "hfl": dict(strategy="hfl"),         # local tier 1 + tier-2 reduce
    "afl-star": dict(strategy="afl"),    # one weighted all_reduce
    "afl-gossip": dict(strategy="afl", afl_mode="gossip"),   # masked mix
    "hfl-gauss": dict(strategy="hfl", attack="gauss"),  # per-client noise
    "afl-chunked": dict(strategy="afl", fused_chunk=2),
    "afl-chunked-1": dict(strategy="afl", fused_chunk=1),
    "hfl-churn": dict(strategy="hfl", fault_profile="churn",
                      churn_rate=0.4),   # group holds + a held round
}
# the single-device run each case is held to trains unchunked, but for the
# 1-client chunk (the known exception above)
SINGLE_CHUNK = {"afl-chunked-1": 1}


@pytest.fixture(scope="module")
def ds():
    return mnist_like(seed=0, n_train=512, n_test=128)


@pytest.fixture(scope="module")
def world():
    with mesh.World(RANKS, device="cpu", timeout=60) as w:
        yield w


def _sim(ds, world=None, mesh_devices=0, **kw):
    fl = port_types.FLConfig(**dict(CFG, mesh_devices=mesh_devices, **kw))
    return port_sim_mod.FederatedSimulation(fl, ds, device="cpu",
                                            mesh_world=world)


_RUNS = {}


def _pair(ds, world, label):
    """(single-device sim, result, mesh sim, result) of one case, run once
    for the module. AFL star runs without a world: the mesh run starts
    and stops its own."""
    if label not in _RUNS:
        kw = CASES[label]
        single = _sim(ds, **dict(kw, fused_chunk=SINGLE_CHUNK.get(label, 0)))
        rs = single.run()
        sharded = _sim(ds, None if label == "afl-star" else world,
                       mesh_devices=RANKS, **kw)
        rm = sharded.run()
        _RUNS[label] = (single, rs, sharded, rm)
    return _RUNS[label]


def _gaps(a, b):
    return {k: float(np.max(np.abs(np.asarray(getattr(a, k), np.float64)
                                   - np.asarray(getattr(b, k), np.float64))))
            for k in TOL}


@pytest.mark.parametrize("label", list(CASES))
def test_sharded_fused_matches_single_device(ds, world, label):
    single, rs, sharded, rm = _pair(ds, world, label)
    gaps = _gaps(rs, rm)
    assert all(gaps[k] <= TOL[k] for k in TOL), gaps
    assert len(rm.round_train_acc) == CFG["rounds"]
    report = sharded.mesh_report
    assert (report["ranks"], report["backend"], report["form"]) \
        == (RANKS, "gloo", "eager")
    # the caller's rng ends where the single-device run's does (§4)
    assert (sharded.rng.bit_generator.state["state"]
            == single.rng.bit_generator.state["state"])
    # the gathered carry serves the same model on the caller's device
    ma = single.strategy.round_model(single.final_state)
    mb = sharded.strategy.round_model(sharded.final_state)
    for key in ma:
        for leaf in ma[key]:
            torch.testing.assert_close(mb[key][leaf], ma[key][leaf],
                                       atol=1e-5, rtol=0)
    if label == "hfl-churn":
        assert rm.extra["faults"] == rs.extra["faults"]
        assert rm.extra["faults"]["quorum_failures"] == 1


def test_hfl_tier1_issues_no_collective_on_any_rank(ds, world):
    _, _, sharded, _ = _pair(ds, world, "hfl")
    for r, counts in enumerate(sharded.mesh_report["collectives"]):
        # R rounds + the warmup round
        assert counts["scopes"]["hfl.tier1"] == CFG["rounds"] + 1
        assert not [k for k in counts["calls"]
                    if k.startswith("hfl.tier1/")], (r, counts)
        assert counts["calls"]["hfl.tier2/all_reduce"] == CFG["rounds"] + 1
        # per round: tier 2 and the metrics' mean; two barriers
        assert counts["calls"]["all_reduce"] == 2 * (CFG["rounds"] + 1)
        assert counts["calls"]["barrier"] == 2


@pytest.mark.parametrize("label,kw,needle", [
    ("cfl", dict(strategy="cfl"), "supports_mesh"),
    ("defense", dict(defense="median"), "defense"),
    ("partial", dict(participation=0.5), "full participation"),
    ("indivisible", dict(mesh_devices=3), "equal shards"),
    ("groups", dict(strategy="hfl", num_groups=2), "aligned to shards"),
    ("chunk", dict(fused_chunk=3), "fused_chunk"),
    ("nccl-on-cpu", dict(mesh_backend="nccl"), "nccl"),
])
def test_mesh_preconditions_raise(ds, label, kw, needle):
    kw = dict(kw)
    backend = kw.pop("mesh_backend", None)
    base = dict(CFG, strategy="afl", rounds=1, mesh_devices=RANKS)
    base.update(kw)
    sim = port_sim_mod.FederatedSimulation(port_types.FLConfig(**base), ds,
                                           device="cpu", mesh_backend=backend)
    with pytest.raises(ValueError, match=needle):
        sim.run()


def test_mesh_world_must_match_the_config(ds, world):
    with pytest.raises(ValueError, match="ranks"):
        _sim(ds, world, mesh_devices=8, strategy="afl").run()
    # a world never turns a one-device config into a mesh run
    with pytest.raises(ValueError, match="ranks"):
        _sim(ds, world, mesh_devices=0, strategy="afl").run()
    with pytest.raises(ValueError, match="gloo"):
        port_sim_mod.FederatedSimulation(
            port_types.FLConfig(**dict(CFG, strategy="afl",
                                       mesh_devices=RANKS)),
            ds, device="cpu", mesh_backend="nccl", mesh_world=world).run()
