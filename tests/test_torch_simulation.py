"""The slice as a whole, event by event: repro_torch's strategies driven
through `run_event` beside the reference's, for HFL, AFL and CFL under
the loop and vectorized engines, from the reference's initial parameters
(injected through `convert.params_from_jax`). `run()` end to end is in
test_torch_simulation_run.py.

Tolerances: round models agree at atol 1e-4 / rtol 1e-4 after every
event — float reassociation between XLA:CPU and ATen over 2 rounds of
momentum SGD. HFL is held at 1e-3: on this data the reference's own
jitted `_sgd_epoch` differs from its step-by-step eager math by ~1e-5 in
the conv layers behind max-pool after round 0 (one client; the port
matches the eager math at ~6e-8), and HFL's two-tier schedule amplifies
that to ~3e-4 after 2 rounds — the same gap as between the reference's
own loop and vectorized engines. Per-round losses agree at 1e-4 (HFL:
1e-3); test predictions agree on at least 98% of samples.
"""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.core import fl_types as ref_types  # noqa: E402
from repro.core import simulation as ref_sim_mod  # noqa: E402
from repro.data.synthetic import mnist_like  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import fl_types as port_types  # noqa: E402
from repro_torch.core import simulation as port_sim_mod  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

CFG = dict(num_clients=4, num_groups=2, rounds=2, local_batch_size=32,
           lr=0.03, momentum=0.9, seed=0)
STRATEGIES = ("hfl", "afl", "cfl")
ENGINES = ("loop", "vectorized")


@pytest.fixture(scope="module")
def ds():
    return mnist_like(seed=0, n_train=512, n_test=128)


def _pair(ds, strategy, engine):
    """(reference sim, port sim) from one config and one initial model."""
    ref = ref_sim_mod.FederatedSimulation(
        ref_types.FLConfig(strategy=strategy, engine=engine, **CFG), ds)
    init = jax.tree.map(np.asarray, ref.init_params)
    port = port_sim_mod.FederatedSimulation(
        port_types.FLConfig(strategy=strategy, engine=engine, **CFG), ds,
        model_init=lambda g: convert.params_from_jax(init), device="cpu")
    return ref, port


def _tol(strategy):
    return 1e-3 if strategy == "hfl" else 1e-4


def _assert_models_close(ref_model, port_model, tol=1e-4):
    ref_leaves = jax.tree.leaves(ref_model)
    port_leaves = tree_leaves(port_model)
    assert len(ref_leaves) == len(port_leaves)
    for a, b in zip(ref_leaves, port_leaves):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=tol,
                                   rtol=tol)


def _agreement(a, b):
    return float(np.mean(np.asarray(a) == np.asarray(b)))


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_event_by_event_parity(ds, strategy, engine):
    ref, port = _pair(ds, strategy, engine)
    rs = ref.strategy.init_state(ref)
    ps = port.strategy.init_state(port)
    for ev in range(CFG["rounds"]):
        rs, racc, rloss = ref.strategy.run_event(ref, rs, ev)
        ps, pacc, ploss = port.strategy.run_event(port, ps, ev)
        _assert_models_close(ref.strategy.round_model(rs),
                             port.strategy.round_model(ps), _tol(strategy))
        np.testing.assert_allclose(np.asarray(ploss, np.float64),
                                   np.asarray(rloss, np.float64),
                                   atol=_tol(strategy))
        # local accuracies on 128-sample shards: a borderline sample may
        # flip between the two float orders
        np.testing.assert_allclose(np.asarray(pacc, np.float64),
                                   np.asarray(racc, np.float64),
                                   atol=2 / 128)
    preds_ref = ref._eval(ref.strategy.round_model(rs))
    preds_port = port._eval(port.strategy.round_model(ps))
    assert _agreement(preds_ref, preds_port) >= 0.98


def test_afl_gossip_mode_parity(ds):
    cfg = dict(CFG, participation=1.0)
    ref = ref_sim_mod.FederatedSimulation(
        ref_types.FLConfig(strategy="afl", engine="vectorized",
                           afl_mode="gossip", **cfg), ds)
    init = jax.tree.map(np.asarray, ref.init_params)
    port = port_sim_mod.FederatedSimulation(
        port_types.FLConfig(strategy="afl", engine="vectorized",
                            afl_mode="gossip", **cfg), ds,
        model_init=lambda g: convert.params_from_jax(init), device="cpu")
    rs, ps = ref.strategy.init_state(ref), port.strategy.init_state(port)
    for ev in range(cfg["rounds"]):
        rs, _, _ = ref.strategy.run_event(ref, rs, ev)
        ps, _, _ = port.strategy.run_event(port, ps, ev)
        _assert_models_close(rs["global"], ps["global"])


def test_default_device_needs_a_card(ds):
    fl = port_types.FLConfig(strategy="afl", **CFG)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError):
        port_sim_mod.FederatedSimulation(fl, ds)


# configs the port admits since slice 2 (the adversarial axis and the
# strategy plugins), slice 3 (fault injection), slice 4 (upload codecs
# and the async runtime) and slice 10 (the fused executor and serving)
# keep their cases here and must now construct
_ADMITTED = {("attack", "sign_flip"), ("defense", "median"),
             ("strategy", "fedprox"), ("fault_profile", "churn"),
             ("codec", "topk"), ("strategy", "async"),
             ("engine", "fused"), ("serve", True)}


@pytest.mark.parametrize("field,value", [
    ("engine", "fused"), ("codec", "topk"), ("fault_profile", "churn"),
    ("attack", "sign_flip"), ("defense", "median"), ("serve", True),
    ("strategy", "fedprox"), ("strategy", "async")])
def test_configs_outside_the_slice_raise(ds, field, value):
    fl = port_types.FLConfig(**dict(CFG, **{"strategy": "afl",
                                            field: value}))
    if (field, value) in _ADMITTED:
        sim = port_sim_mod.FederatedSimulation(fl, ds, device="cpu")
        assert getattr(sim.fl, field) == value
        return
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        port_sim_mod.FederatedSimulation(fl, ds, device="cpu")
