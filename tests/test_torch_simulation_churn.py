"""The churn-tolerant runtime as a whole: repro_torch's FederatedSimulation
beside the reference's under an active fault profile, event by event,
from the reference's initial parameters.

Tolerances as in test_torch_simulation.py: round models agree at 1e-4
(abs and rel) after every event, HFL at 1e-3 (its two-tier schedule
amplifies float reassociation in near-tied max-pool windows); per-round
losses likewise. The fault schedules themselves are bitwise the
reference's (test_torch_faults.py), so every hold, masked weight and
mixing matrix is the same in both packages."""
import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.core import fl_types as ref_types  # noqa: E402
from repro.core import scenarios as ref_scenarios  # noqa: E402
from repro.core import simulation as ref_sim_mod  # noqa: E402
from repro.data.synthetic import mnist_like  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import fl_types as port_types  # noqa: E402
from repro_torch.core import scenarios as port_scenarios  # noqa: E402
from repro_torch.core import simulation as port_sim_mod  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

CFG = dict(num_clients=4, num_groups=2, rounds=2, local_batch_size=32,
           lr=0.03, momentum=0.9, seed=0, participation=1.0)
# Each configuration's schedule (4 clients, 2 events unless stated):
#   churn 0.4, seed 0: alive [1,1,0,1] twice — a dead identity row in the
#     mix and a detected neighbor pruned from the others' supports;
#   churn 0.4, seed 0, 8 clients: [1,1,0,1,1,1,1,0] then
#     [1,1,0,1,1,1,1,1] — dead rows in both HFL groups of 4;
#   churn 0.4, seed 1: [0,0,1,1] then [0,1,0,0] — HFL group 0 below its
#     quorum at event 0, and event 1 below the event's quorum (a hold);
#   mid, seed 0, 8 clients: [0,1,1,0,1,1,1,1] then all alive — two dead
#     visitors in the sequential pass;
#   mid, seed 1, quorum 0.6: all alive, then [1,0,0,1] below quorum.
CHURN = {
    "afl-gossip-mtd": dict(strategy="afl", afl_mode="gossip",
                           fault_profile="churn", churn_rate=0.4,
                           fault_mtd=True),
    "afl-gossip-median": dict(strategy="afl", afl_mode="gossip",
                              attack="sign_flip", attack_scale=2.0,
                              defense="median", fault_profile="churn",
                              churn_rate=0.4, fault_mtd=True),
    "afl-star-median-hold": dict(strategy="afl", attack="sign_flip",
                                 attack_scale=2.0, defense="median",
                                 fault_profile="churn", churn_rate=0.4,
                                 seed=1),
    "hfl-quorum": dict(strategy="hfl", fault_profile="churn",
                       churn_rate=0.4, seed=1),
    # dead rows enter each group's median as the group's center
    "hfl-median": dict(strategy="hfl", num_clients=8, attack="sign_flip",
                       attack_scale=2.0, defense="median",
                       fault_profile="churn", churn_rate=0.4),
    "cfl-mid": dict(strategy="cfl", num_clients=8, fault_profile="mid"),
    "cfl-hold": dict(strategy="cfl", fault_profile="churn", churn_rate=0.4,
                     seed=1),
    "fedavgm-hold": dict(strategy="fedavgm", fault_profile="mid",
                         quorum_frac=0.6, seed=1, server_lr=0.7),
    # the other plugins inherit AFL's (FedProx) and FedAvgM's (FedAdam)
    # fault handling. FedAdam aggregates by median here, as in
    # test_torch_plugins.py: Adam divides by sqrt(v) + eps, so a weight
    # every client leaves unchanged turns a mean's rounding residue
    # (~1e-9, summed in another order than the reference's) into a step
    # of up to lr; a median returns such a weight exactly.
    "fedprox-hold": dict(strategy="fedprox", prox_mu=0.1,
                         fault_profile="mid", quorum_frac=0.6, seed=1),
    "fedadam-median-hold": dict(strategy="fedadam", server_lr=0.1,
                                attack="sign_flip", attack_scale=4.0,
                                defense="median", fault_profile="mid",
                                quorum_frac=0.6, seed=1),
}


@pytest.fixture(scope="module")
def ds():
    return mnist_like(seed=0, n_train=256, n_test=128)


def _pair(ds, **kw):
    """(reference sim, port sim) from one config and one initial model."""
    ref = ref_sim_mod.FederatedSimulation(ref_types.FLConfig(**kw), ds)
    init = jax.tree.map(np.asarray, ref.init_params)
    port = port_sim_mod.FederatedSimulation(
        port_types.FLConfig(**kw), ds,
        model_init=lambda g: convert.params_from_jax(init), device="cpu")
    return ref, port


def _assert_close(ref_model, port_model, tol):
    ref_leaves = jax.tree.leaves(ref_model)
    port_leaves = tree_leaves(port_model)
    assert len(ref_leaves) == len(port_leaves)
    for a, b in zip(ref_leaves, port_leaves):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=tol,
                                   rtol=tol)


@pytest.mark.parametrize("engine", ["loop", "vectorized"])
@pytest.mark.parametrize("name", sorted(CHURN))
def test_event_by_event_parity_under_faults(ds, name, engine):
    kw = dict(CFG, engine=engine)
    kw.update(CHURN[name])
    ref, port = _pair(ds, **kw)
    tol = 1e-3 if kw["strategy"] == "hfl" else 1e-4
    rs, ps = ref.strategy.init_state(ref), port.strategy.init_state(port)
    for ev in range(kw["rounds"]):
        rs, _, rloss = ref.strategy.run_event(ref, rs, ev)
        ps, _, ploss = port.strategy.run_event(port, ps, ev)
        _assert_close(ref.strategy.round_model(rs),
                      port.strategy.round_model(ps), tol)
        np.testing.assert_allclose(np.asarray(ploss, np.float64),
                                   np.asarray(rloss, np.float64), atol=tol)
        if kw["strategy"] == "hfl":
            _assert_close(rs["groups"], ps["groups"], tol)
    if kw["strategy"] != "cfl":
        _assert_close(ref.strategy.served_fn(ref, rs)(),
                      port.strategy.served_fn(port, ps)(), tol)
    assert sorted(port._fault_log) == sorted(ref._fault_log)
    for ev, fe in ref._fault_log.items():
        pe = port._fault_log[ev]
        assert (pe.n_alive, pe.qok, pe.rejoined) == (fe.n_alive, fe.qok,
                                                     fe.rejoined)
    holds = sum(not fe.qok for fe in port._fault_log.values())
    assert holds == (1 if name.endswith("hold") or name == "hfl-quorum"
                     else 0)


@pytest.mark.parametrize("name", ["afl-gossip-mtd", "hfl-quorum"])
def test_run_faults_block_and_dispatch_match_reference(ds, name):
    """Whole runs: the `faults` result block equals the reference's key
    for key, and the masked-mix dispatch count equals the reference's
    (one per undefended gossip event, the warmup's included)."""
    kw = dict(CFG, engine="vectorized")
    kw.update(CHURN[name])
    ref, port = _pair(ds, **kw)
    rr, pr = ref.run(), port.run()
    assert pr.extra["faults"] == rr.extra["faults"]
    rd, pd = (r.extra["telemetry"]["dispatch"] for r in (rr, pr))
    assert pd.get("kernel.gossip_mix", 0) == rd.get("kernel.gossip_mix", 0)
    assert pd.get("kernel.gossip_mix", 0) == (
        kw["rounds"] + 1 if kw.get("afl_mode") == "gossip" else 0)
    for key in ("faults.lost_uploads", "faults.rejoins",
                "faults.quorum_failures"):
        assert pr.extra["telemetry"]["counters"].get(key) == \
            rr.extra["telemetry"]["counters"].get(key), key
    assert pr.extra["kernel_launches"] == {               # CPU run
        "fedavg_agg": 0, "trimmed_mean_agg": 0, "gossip_mix_agg": 0,
        "dequant_agg": 0}
    np.testing.assert_allclose(pr.round_test_acc, rr.round_test_acc,
                               atol=0.02)


@pytest.mark.parametrize("kw", [
    dict(strategy="afl", afl_mode="gossip"), dict(strategy="afl"),
    dict(strategy="hfl"), dict(strategy="cfl", engine="loop"),
    dict(strategy="fedavgm")], ids=["afl-gossip", "afl-star", "hfl",
                                    "cfl-loop", "fedavgm"])
def test_fault_profile_none_is_inert(ds, kw):
    """fault_profile="none" compiles no schedule and logs nothing, and
    the masking algebra is exact when everyone is alive: a churn schedule
    at rate 0 (every client alive every round) gives the fault-free run
    bit for bit."""
    cfg = dict(CFG, engine="vectorized")
    cfg.update(kw)
    plain = port_sim_mod.FederatedSimulation(
        port_types.FLConfig(**cfg), ds, device="cpu")
    alive = port_sim_mod.FederatedSimulation(
        port_types.FLConfig(**cfg, fault_profile="churn", churn_rate=0.0),
        ds, device="cpu")
    assert plain.faults is None and alive.faults.alive.all()
    rp, ra = plain.run(), alive.run()
    assert "faults" not in rp.extra and plain._fault_log == {}
    assert ra.extra["faults"]["quorum_failures"] == 0
    for key in ("test_accuracy", "train_accuracy", "f1", "round_test_acc",
                "round_train_loss"):
        assert getattr(rp, key) == getattr(ra, key), key


def test_churn_registrations_equal_the_reference():
    for name in port_scenarios.CHURN_SCENARIOS:
        port = dataclasses.asdict(port_scenarios.get(name))
        ref = dataclasses.asdict(ref_scenarios.get(name))
        assert port == ref, name
    assert sorted(port_scenarios.CHURN_SCENARIOS) == sorted(
        n for n in ref_scenarios.names() if n.startswith("churn-"))


def test_fused_churn_scenario_raises_naming_its_slice():
    """The slice it waited for (§A.13, the fused executor) has come: the
    fused churn registration builds its simulation
    with the fault schedule the fused precompute turns into per-round
    inputs (its run is held to the reference in
    test_torch_fused_docs_axes.py)."""
    spec = port_scenarios.get("churn-afl-gossip-mtd")
    assert spec.engine == "fused"
    sim = port_scenarios.resolve(spec, device="cpu")
    assert sim.faults is not None and sim.fl.fault_mtd
    assert sim.strategy.fault_scan_kwargs() == {"gossip": True}
