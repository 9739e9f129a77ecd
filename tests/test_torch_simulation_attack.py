"""The adversarial axis as a whole: repro_torch's FederatedSimulation
beside the reference's under attack and defense, event by event, from
the reference's initial parameters, with the Gaussian noise of both
taken from the reference (the port's one noise seam,
`attacks.gauss_noise`, replaced by the reference's draws).

Tolerances as in test_torch_simulation.py: round models agree at 1e-4
(abs and rel) after every event, HFL at 1e-3 (its two-tier schedule
amplifies float reassociation in near-tied max-pool windows); per-round
losses likewise. The repairs to slice 1 each have a test here that
fails on a port whose AFL, HFL or CFL events drop the defense's
arguments."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.core import attacks as ref_attacks  # noqa: E402
from repro.core import fl_types as ref_types  # noqa: E402
from repro.core import simulation as ref_sim_mod  # noqa: E402
from repro.data.synthetic import mnist_like  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import attacks as port_attacks  # noqa: E402
from repro_torch.core import fl_types as port_types  # noqa: E402
from repro_torch.core import simulation as port_sim_mod  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

CFG = dict(num_clients=4, num_groups=2, rounds=2, local_batch_size=32,
           lr=0.03, momentum=0.9, seed=0, participation=1.0)
# the five attack/defense configurations chip_smoke.py also runs on the
# card (ADV_PARITY there; HFL at 8 clients so each group of 4 trims f = 1),
# and HFL at 4 clients, where each group of 2 trims f = 0 and the Gaussian
# upload enters the group model (chip_smoke.py's hfl4_phase)
ADV = {
    "hfl-gauss-trimmed-4c": dict(strategy="hfl", attack="gauss",
                                 attack_scale=0.5, defense="trimmed_mean"),
    "afl-signflip-median": dict(strategy="afl", attack="sign_flip",
                                attack_scale=2.0, defense="median"),
    "hfl-gauss-trimmed": dict(strategy="hfl", num_clients=8, attack="gauss",
                              attack_scale=0.5, defense="trimmed_mean"),
    "cfl-replace-clip": dict(strategy="cfl", attack="model_replace",
                             attack_scale=5.0, defense="norm_clip",
                             clip_tau=2.0),
    "afl-labelflip-trimmed": dict(strategy="afl", attack="label_flip",
                                  defense="trimmed_mean"),
    "afl-ring-signflip-median": dict(strategy="afl", afl_mode="gossip",
                                     attack="sign_flip", attack_scale=2.0,
                                     defense="median"),
}


def ref_gauss_noise(seed, event, client_id, leaf_index, shape, device):
    key = jax.random.fold_in(jax.random.fold_in(
        ref_attacks.event_key(seed, event), client_id), leaf_index)
    return torch.as_tensor(np.array(jax.random.normal(
        key, tuple(shape), jnp.float32))).to(device)


@pytest.fixture(autouse=True)
def ref_noise(monkeypatch):
    monkeypatch.setattr(port_attacks, "gauss_noise", ref_gauss_noise)


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


def _run_events(ref, port, tol, n=None):
    """Both sims through `n` events (default: all); round models and
    losses compared after each. Returns the two final states."""
    rs, ps = ref.strategy.init_state(ref), port.strategy.init_state(port)
    for ev in range(ref.fl.rounds if n is None else n):
        rs, _, rloss = ref.strategy.run_event(ref, rs, ev)
        ps, _, ploss = port.strategy.run_event(port, ps, ev)
        _assert_close(ref.strategy.round_model(rs),
                      port.strategy.round_model(ps), tol)
        np.testing.assert_allclose(np.asarray(ploss, np.float64),
                                   np.asarray(rloss, np.float64), atol=tol)
    return rs, ps


@pytest.mark.parametrize("engine", ["loop", "vectorized"])
@pytest.mark.parametrize("name", sorted(ADV))
def test_event_by_event_parity_under_attack(ds, name, engine):
    kw = dict(CFG, engine=engine, **ADV[name])
    ref, port = _pair(ds, **kw)
    np.testing.assert_array_equal(port.attack_mask, ref.attack_mask)
    for (xr, yr), (xp, yp) in zip(ref.client_data, port.client_data):
        np.testing.assert_array_equal(yp, yr)            # label_flip shards
    tol = 1e-3 if kw["strategy"] == "hfl" else 1e-4
    rs, ps = _run_events(ref, port, tol)
    if kw["strategy"] != "cfl":
        _assert_close(ref.strategy.served_fn(ref, rs)(),
                      port.strategy.served_fn(port, ps)(), tol)


# -- repairs to slice 1 ------------------------------------------------------

def test_afl_norm_clip_serves_the_reference_model(ds):
    """AFL's serving tuple carries the round-start model and the defense
    arguments: a norm_clip served model needs its center."""
    ref, port = _pair(ds, **dict(CFG, strategy="afl", engine="vectorized",
                                 attack="sign_flip", attack_scale=3.0,
                                 defense="norm_clip", clip_tau=0.5))
    rs, ps = _run_events(ref, port, 1e-4)
    _assert_close(ref.strategy.served_fn(ref, rs)(),
                  port.strategy.served_fn(port, ps)(), 1e-4)


def test_afl_trimmed_mean_uses_the_resolved_f(ds):
    """8 participants at attack_fraction 0.25 trim f = 2 per side, not
    the operator's default 1, in the round and in the served model."""
    ref, port = _pair(ds, **dict(CFG, num_clients=8, strategy="afl",
                                 engine="vectorized", attack="sign_flip",
                                 attack_scale=4.0, defense="trimmed_mean"))
    assert port.defense_kwargs(8)["f"] == 2
    rs, ps = _run_events(ref, port, 1e-4, n=1)
    _assert_close(ref.strategy.served_fn(ref, rs)(),
                  port.strategy.served_fn(port, ps)(), 1e-4)


def test_afl_ring_trimmed_mean_uses_the_resolved_f(ds):
    """Defended ring gossip over 5-model neighborhoods trims f = 2."""
    ref, port = _pair(ds, **dict(CFG, num_clients=8, strategy="afl",
                                 afl_mode="gossip", gossip_neighbors=4,
                                 engine="vectorized", attack="sign_flip",
                                 attack_scale=4.0, defense="trimmed_mean"))
    _run_events(ref, port, 1e-4, n=1)


def test_hfl_defends_tier1_with_group_centers(ds):
    """HFL's tier 1 runs the defense with the round-start group models as
    norm_clip centers, in the round and in the served model."""
    ref, port = _pair(ds, **dict(CFG, num_clients=8, strategy="hfl",
                                 engine="vectorized", attack="model_replace",
                                 attack_scale=5.0, defense="norm_clip",
                                 clip_tau=0.5))
    rs, ps = _run_events(ref, port, 1e-3)
    _assert_close(ref.strategy.served_fn(ref, rs)(),
                  port.strategy.served_fn(port, ps)(), 1e-3)


def test_cfl_noise_follows_the_event(ds):
    """The sequential round corrupts with keys of its own event: event 1's
    noise differs from event 0's."""
    ref, port = _pair(ds, **dict(CFG, strategy="cfl", engine="loop",
                                 attack="gauss", attack_scale=0.5))
    _run_events(ref, port, 1e-4)


# -- engines -----------------------------------------------------------------

@pytest.mark.parametrize("strategy,kw", [
    ("afl", dict(attack="sign_flip", attack_scale=2.0, defense="median")),
    ("hfl", dict(attack="gauss", attack_scale=0.5,
                 defense="trimmed_mean")),
    ("cfl", dict(attack="model_replace", attack_scale=5.0,
                 defense="norm_clip", clip_tau=2.0)),
])
def test_engine_parity_under_attack(strategy, kw):
    """Inside the port, loop and vectorized runs under attack agree
    (mirrors tests/test_attacks_robust.py::test_engine_parity_under_attack
    of the reference, with its tolerance)."""
    ds = mnist_like(seed=1, n_train=256, n_test=128)
    res = {}
    for eng in ("loop", "vectorized"):
        fl = port_types.FLConfig(
            strategy=strategy, num_clients=4, num_groups=2, rounds=2,
            local_epochs=1, local_batch_size=32, lr=0.05, seed=0,
            participation=1.0, engine=eng, attack_fraction=0.25, **kw)
        res[eng] = port_sim_mod.FederatedSimulation(fl, ds,
                                                    device="cpu").run()
    assert res["loop"].test_accuracy == pytest.approx(
        res["vectorized"].test_accuracy, abs=0.02)
    assert res["loop"].train_accuracy == pytest.approx(
        res["vectorized"].train_accuracy, abs=0.02)
    for r in res.values():
        assert r.extra["kernel_launches"] == {"fedavg_agg": 0,
                                              "trimmed_mean_agg": 0,
                                              "gossip_mix_agg": 0,
                                              "dequant_agg": 0}


def test_invalid_defense_for_the_event_raises(ds):
    with pytest.raises(ValueError, match="does not apply"):
        port_sim_mod.FederatedSimulation(
            port_types.FLConfig(**dict(CFG, strategy="cfl",
                                       defense="median")), ds, device="cpu")
