"""The strategy plugins (FedProx, FedAvgM, FedAdam), the Adam optimizer
and the scenario runner of repro_torch against the reference.

Plugins run event by event beside the reference from its initial
parameters (tolerance 1e-4 abs and rel on the round models, as in
test_torch_simulation.py). Adam is held at 1e-6 on one step sequence.
The scenario registry must describe the same runs as the reference's:
every registered spec resolves to the same FLConfig fields."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.core import fl_types as ref_types  # noqa: E402
from repro.core import scenarios as ref_scenarios  # noqa: E402
from repro.core import simulation as ref_sim_mod  # noqa: E402
from repro.data.synthetic import mnist_like  # noqa: E402
from repro.optim import optimizers as ref_opt  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import fl_types as port_types  # noqa: E402
from repro_torch.core import scenarios as port_scenarios  # noqa: E402
from repro_torch.core import simulation as port_sim_mod  # noqa: E402
from repro_torch.optim import optimizers as port_opt  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

CFG = dict(num_clients=4, num_groups=2, rounds=2, local_batch_size=32,
           lr=0.03, momentum=0.9, seed=0, participation=1.0)


@pytest.fixture(scope="module")
def ds():
    return mnist_like(seed=0, n_train=256, n_test=128)


def _close(ref_tree, port_tree, tol=1e-4):
    ref_leaves, port_leaves = jax.tree.leaves(ref_tree), tree_leaves(port_tree)
    assert len(ref_leaves) == len(port_leaves)
    for a, b in zip(ref_leaves, port_leaves):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=tol,
                                   rtol=tol)


@pytest.mark.parametrize("kw", [
    dict(strategy="fedprox", engine="loop", prox_mu=0.1),
    dict(strategy="fedprox", engine="vectorized", prox_mu=0.1),
    dict(strategy="fedavgm", engine="vectorized", server_lr=0.7,
         server_momentum=0.9),
    dict(strategy="fedadam", engine="vectorized", server_lr=0.1,
         attack="sign_flip", attack_scale=4.0, defense="median"),
], ids=["fedprox-loop", "fedprox-vectorized", "fedavgm", "fedadam-median"])
def test_plugin_matches_reference(ds, kw):
    cfg = dict(CFG, **kw)
    ref = ref_sim_mod.FederatedSimulation(ref_types.FLConfig(**cfg), ds)
    init = jax.tree.map(np.asarray, ref.init_params)
    port = port_sim_mod.FederatedSimulation(
        port_types.FLConfig(**cfg), ds,
        model_init=lambda g: convert.params_from_jax(init), device="cpu")
    rs, ps = ref.strategy.init_state(ref), port.strategy.init_state(port)
    for ev in range(cfg["rounds"]):
        rs, _, rloss = ref.strategy.run_event(ref, rs, ev)
        ps, _, ploss = port.strategy.run_event(port, ps, ev)
        _close(ref.strategy.round_model(rs), port.strategy.round_model(ps))
        np.testing.assert_allclose(np.asarray(ploss, np.float64),
                                   np.asarray(rloss, np.float64), atol=1e-4)
    _close(ref.strategy.served_fn(ref, rs)(),
           port.strategy.served_fn(port, ps)())


def test_server_lr_one_without_momentum_is_fedavg(ds):
    """FedAvgM at server_lr 1 and momentum 0 is plain FedAvg: the same
    round models as AFL at full participation."""
    runs = {}
    for strategy in ("afl", "fedavgm"):
        fl = port_types.FLConfig(**dict(CFG, strategy=strategy,
                                        engine="vectorized", server_lr=1.0,
                                        server_momentum=0.0))
        sim = port_sim_mod.FederatedSimulation(fl, ds, device="cpu")
        st = sim.strategy.init_state(sim)
        st, _, _ = sim.strategy.run_event(sim, st, 0)
        runs[strategy] = sim.strategy.round_model(st)
    for a, b in zip(tree_leaves(runs["afl"]), tree_leaves(runs["fedavgm"])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)


@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
def test_adamw_matches_reference(weight_decay):
    rng = np.random.default_rng(0)
    params = {"a": rng.normal(size=(5, 3)).astype(np.float32),
              "b": {"c": rng.normal(size=(7,)).astype(np.float32)}}
    grads = [jax.tree.map(lambda p: rng.normal(size=p.shape).astype(
        np.float32), params) for _ in range(4)]
    r_opt = ref_opt.adamw(0.05, weight_decay=weight_decay)
    p_opt = port_opt.adamw(0.05, weight_decay=weight_decay)
    rp = jax.tree.map(jnp.asarray, params)
    pp = convert.params_from_jax(params)
    rs, ps = r_opt.init(rp), p_opt.init(pp)
    for g in grads:
        ru, rs = r_opt.update(jax.tree.map(jnp.asarray, g), rs, rp)
        pu, ps = p_opt.update(convert.params_from_jax(g), ps, pp)
        rp = ref_opt.apply_updates(rp, ru)
        pp = port_opt.apply_updates(pp, pu)
        _close(rp, pp, tol=1e-6)
    assert ps["count"] == len(grads)


def test_registered_scenarios_match_the_reference():
    assert set(port_scenarios.names()) <= set(ref_scenarios.names())
    for name in port_scenarios.names():
        port_spec = port_scenarios.get(name)
        ref_spec = ref_scenarios.get(name)
        assert dataclasses.asdict(port_spec) == dataclasses.asdict(ref_spec)
        assert (dataclasses.asdict(port_spec.to_fl_config())
                == dataclasses.asdict(ref_spec.to_fl_config()))
    assert set(port_scenarios.ACCEPTANCE_FAMILY) <= set(port_scenarios.names())


def test_scenario_runner_tiny_run():
    spec = dataclasses.replace(
        port_scenarios.get("attack-signflip-median-32c-vec"),
        num_clients=8, n_train=256, n_test=64, rounds=2)
    r = port_scenarios.run(spec, device="cpu")
    assert r.strategy == "afl" and r.extra["device"] == "cpu"
    assert len(r.round_test_acc) == 2
    assert all(np.isfinite([r.test_accuracy, r.f1, r.precision, r.recall]))
    # the CPU takes the kernels' plain versions: nothing is launched
    assert r.extra["kernel_launches"] == {"fedavg_agg": 0,
                                          "trimmed_mean_agg": 0,
                                          "gossip_mix_agg": 0,
                                          "dequant_agg": 0}
    assert r.extra["telemetry"]["dispatch"]["kernel.trimmed_mean"] > 0
    dirichlet = dataclasses.replace(port_scenarios.get("fedprox-dirichlet-vec"),
                                    rounds=1, n_train=512)
    sim = port_scenarios.resolve(dirichlet, device="cpu")
    assert sorted(np.concatenate(sim.parts).tolist()) == list(range(512))
    assert min(len(p) for p in sim.parts) >= dirichlet.local_batch_size


@pytest.mark.parametrize("kw,match", [
    (dict(strategy="cfl", topology="sequential", defense="median"),
     "does not apply"),
    (dict(topology="ring", strategy="fedprox"), "invalid"),
    (dict(engine="turbo"), "unknown engine"),
    (dict(partition="shards"), "partition"),
    (dict(strategy="nope"), "unknown strategy"),
    (dict(fault_profile="quake"), "unknown fault profile"),
    (dict(fault_profile="churn", fault_mtd=True), "needs topology='ring'"),
])
def test_scenario_spec_validation(kw, match):
    with pytest.raises(ValueError, match=match):
        port_scenarios.ScenarioSpec("bad", "a bad spec", **kw)


def test_scenarios_cli_lists_the_registry(capsys):
    port_scenarios.main(["--list"])
    out = capsys.readouterr().out
    for name in port_scenarios.names():
        assert name in out


def test_async_still_waits_for_its_slice(ds):
    """Async's slice (ROADMAP §A.8) has come: the strategy constructs on
    the per-round drivers. Its fused form is refused as the reference
    refuses it: the fused executor (§A.13) cannot hoist async's
    data-dependent tick batches (`supports_fused` is False)."""
    fl = port_types.FLConfig(**dict(CFG, strategy="async"))
    sim = port_sim_mod.FederatedSimulation(fl, ds, device="cpu")
    assert sim.strategy.name == "async"
    assert not sim.strategy.supports_fused
    fused = port_types.FLConfig(**dict(CFG, strategy="async",
                                       engine="fused"))
    with pytest.raises(ValueError, match="fused"):
        port_sim_mod.FederatedSimulation(fused, ds, device="cpu").run()
