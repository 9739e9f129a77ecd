"""The async runtime of repro_torch against the reference's
(`repro.core.async_agg`): the timelines (host numpy, bitwise), the
batched staleness merge, and whole async simulations event by event
from the reference's initial parameters.

Tolerances: timelines, speeds and staleness bookkeeping bitwise; the
batch weights 1e-7 (a float32 cumulative product, reassociated); the
batched merge against k sequential merges 1e-6; round models 1e-4 abs
and rel after every event, as in test_torch_simulation.py. Gaussian
attack noise is the reference's, passed in through the port's one noise
seam (`attacks.gauss_noise`), as in test_torch_simulation_attack.py."""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.core import aggregation as ref_agg  # noqa: E402
from repro.core import async_agg as ref_async  # noqa: E402
from repro.core import attacks as ref_attacks  # noqa: E402
from repro.core import fl_types as ref_types  # noqa: E402
from repro.core import scenarios as ref_scenarios  # noqa: E402
from repro.core import simulation as ref_sim_mod  # noqa: E402
from repro.data.synthetic import mnist_like  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import aggregation as port_agg  # noqa: E402
from repro_torch.core import async_agg as port_async  # noqa: E402
from repro_torch.core import attacks as port_attacks  # noqa: E402
from repro_torch.core import fl_types as port_types  # noqa: E402
from repro_torch.core import scenarios as port_scenarios  # noqa: E402
from repro_torch.core import simulation as port_sim_mod  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

CFG = dict(strategy="async", num_clients=4, rounds=2, local_batch_size=32,
           lr=0.03, momentum=0.9, seed=0, participation=1.0,
           updates_per_client=2, tick=1.0)


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


# ---------------------------------------------------------------------------
# the timeline (host numpy)
# ---------------------------------------------------------------------------

TIMELINES = [
    dict(num_clients=8, seed=0, speed_model="uniform", tick=1.0,
         updates_per_client=2),
    dict(num_clients=8, seed=0, speed_model="straggler", tick=1.0,
         updates_per_client=2),
    dict(num_clients=8, seed=0, speed_model="uniform", tick=1.0,
         dropout=0.5, updates_per_client=3),
    dict(num_clients=8, seed=0, speed_model="lognormal", tick=0.0,
         updates_per_client=2),
    dict(num_clients=16, seed=3, speed_model="lognormal", tick=0.25,
         participation=0.5, dropout=0.3, updates_per_client=4),
    dict(num_clients=5, seed=7, speeds=[1.0, 2.5, 0.5, 3.0, 1.5],
         tick=0.5, updates_per_client=3),
    dict(num_clients=2, seed=1, speed_model="straggler", dropout=0.9,
         updates_per_client=5),
]


@pytest.mark.parametrize("kw", TIMELINES)
def test_timeline_bitwise_the_reference(kw):
    r = ref_async.build_timeline(**kw)
    p = port_async.build_timeline(**kw)
    np.testing.assert_array_equal(p.speeds, r.speeds)
    assert p.speeds.dtype == r.speeds.dtype
    assert p.participants == r.participants
    np.testing.assert_array_equal(p.n_updates, r.n_updates)
    assert p.dropped_clients == r.dropped_clients
    assert p.batches == r.batches


@pytest.mark.parametrize("model", port_async.SPEED_MODELS)
@pytest.mark.parametrize("quantize", [0.0, 0.5])
def test_make_speeds_and_staleness_alpha(model, quantize):
    r = ref_async.make_speeds(model, 9, np.random.default_rng(4),
                              quantize=quantize)
    p = port_async.make_speeds(model, 9, np.random.default_rng(4),
                               quantize=quantize)
    np.testing.assert_array_equal(p, r)
    for tau in range(6):
        assert port_async.staleness_alpha(0.6, tau, 0.5) == \
            ref_async.staleness_alpha(0.6, tau, 0.5)
    with pytest.raises(ValueError, match="unknown speed model"):
        port_async.make_speeds("gamma", 3, np.random.default_rng(0))


# ---------------------------------------------------------------------------
# the batched staleness merge
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("alphas", [[0.6], [0.6, 0.42, 0.35],
                                    [0.3, 0.0, 0.9, 0.1, 0.5]])
def test_batch_weights_match_reference(alphas):
    r = np.asarray(ref_agg.staleness_batch_weights(alphas))
    p = port_agg.staleness_batch_weights(alphas)
    assert p.dtype == torch.float32 and tuple(p.shape) == (len(alphas) + 1,)
    np.testing.assert_allclose(p.numpy(), r, atol=1e-7, rtol=1e-7)
    assert abs(float(p.sum()) - 1.0) < 1e-6


def _tree(rng, lead=()):
    return {"a": torch.as_tensor(rng.normal(size=lead + (3, 4))
                                 .astype(np.float32)),
            "b": {"bias": torch.as_tensor(rng.normal(size=lead + (5,))
                                          .astype(np.float32))}}


@pytest.mark.parametrize("k", [1, 3, 6])
def test_async_batch_merge_equals_sequential_merges(k):
    rng = np.random.default_rng(k)
    model, stacked = _tree(rng), _tree(rng, (k,))
    alphas = rng.uniform(0.05, 0.9, size=k).astype(np.float32)
    seq = model
    for i in range(k):
        arrival = {"a": stacked["a"][i],
                   "b": {"bias": stacked["b"]["bias"][i]}}
        seq = port_agg.cfl_merge(seq, arrival, float(alphas[i]))
    got = port_agg.async_batch_merge(model, stacked, alphas)
    for a, b in zip(tree_leaves(seq), tree_leaves(got)):
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=1e-6)


def test_async_batch_merge_k0_is_the_identity():
    rng = np.random.default_rng(0)
    model = _tree(rng)
    empty = {"a": torch.zeros((0, 3, 4)), "b": {"bias": torch.zeros((0, 5))}}
    assert port_agg.async_batch_merge(model, empty, []) is model
    assert port_agg.async_batch_merge(
        model, empty, np.zeros((0,), np.float32)) is model


# ---------------------------------------------------------------------------
# whole async simulations beside the reference
# ---------------------------------------------------------------------------

ASYNC_RUNS = {
    "uniform": dict(speed_model="uniform"),
    "straggler": dict(speed_model="straggler"),
    "topk": dict(speed_model="uniform", codec="topk", topk_frac=0.25),
    "gauss-clip": dict(speed_model="uniform", attack="gauss",
                       attack_scale=3.0, defense="norm_clip", clip_tau=3.0),
    "dropout": dict(speed_model="uniform", dropout=0.5,
                    updates_per_client=3),
}


def _pair(ds, **kw):
    ref = ref_sim_mod.FederatedSimulation(ref_types.FLConfig(**kw), ds)
    init = jax.tree.map(np.asarray, ref.init_params)
    port = port_sim_mod.FederatedSimulation(
        port_types.FLConfig(**kw), ds,
        model_init=lambda g: convert.params_from_jax(init), device="cpu")
    return ref, port


def _assert_close(ref_model, port_model, tol=1e-4):
    for a, b in zip(jax.tree.leaves(ref_model), tree_leaves(port_model)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=tol,
                                   rtol=tol)


@pytest.mark.parametrize("engine", ["loop", "vectorized"])
@pytest.mark.parametrize("name", ["uniform", "straggler", "topk",
                                  "gauss-clip"])
def test_event_by_event_parity_async(ds, name, engine):
    kw = dict(CFG, engine=engine, **ASYNC_RUNS[name])
    ref, port = _pair(ds, **kw)
    assert port.strategy.timeline.batches == ref.strategy.timeline.batches
    rs, ps = ref.strategy.init_state(ref), port.strategy.init_state(port)
    for ev in range(ref.strategy.num_events(ref)):
        rs, raccs, rloss = ref.strategy.run_event(ref, rs, ev)
        ps, paccs, ploss = port.strategy.run_event(port, ps, ev)
        _assert_close(rs["model"], ps["model"])
        np.testing.assert_allclose(np.asarray(ploss, np.float64),
                                   np.asarray(rloss, np.float64), atol=1e-4)
        assert ps["server_step"] == rs["server_step"]
        np.testing.assert_array_equal(ps["base_version"], rs["base_version"])
        assert ps["staleness"] == rs["staleness"]
        assert ps["makespan"] == rs["makespan"]
    if kw.get("codec", "none") != "none":
        assert port._comm_log == ref._comm_log
        np.testing.assert_allclose(
            port.codec_state["resid"].numpy(),
            np.asarray(ref.codec_state["resid"]), atol=1e-4)


def test_run_timeline_block_and_counters_match_reference(ds):
    """A whole run under dropout: the timeline block of `extra`, the async
    counters, the merge dispatches (one `fedavg_agg` pass per non-empty
    batch and per warmup batch size) and the final model."""
    kw = dict(CFG, engine="vectorized", **ASYNC_RUNS["dropout"])
    ref, port = _pair(ds, **kw)
    rr, pr = ref.run(), port.run()
    for key in ("merges", "batches", "mean_staleness", "makespan",
                "dropped_clients", "participants"):
        assert pr.extra[key] == rr.extra[key], key
    _assert_close(rr.extra["final_model"], pr.extra["final_model"])
    rc, pc = (r.extra["telemetry"]["counters"] for r in (rr, pr))
    for key in ("async.merges", "async.batches"):
        assert pc[key] == rc[key], key
    rd, pd = (r.extra["telemetry"]["dispatch"] for r in (rr, pr))
    assert pd["kernel.fedavg_agg"] == rd["kernel.fedavg_agg"] > 0
    assert pr.round_test_acc == [] and rr.round_test_acc == []
    assert pr.train_accuracy == pytest.approx(rr.train_accuracy, abs=0.02)
    assert pr.test_accuracy == pytest.approx(rr.test_accuracy, abs=0.02)


@pytest.mark.parametrize("engine", ["loop", "vectorized"])
def test_warmup_leaves_rng_codec_state_and_wire_log_as_reference(ds,
                                                                  engine):
    kw = dict(CFG, engine=engine, **ASYNC_RUNS["topk"])
    ref, port = _pair(ds, **kw)
    before = port.rng.bit_generator.state
    ref.strategy.warmup(ref)
    port.strategy.warmup(port)
    assert port.rng.bit_generator.state == before == \
        ref.rng.bit_generator.state
    assert port._comm_log == ref._comm_log
    np.testing.assert_allclose(port.codec_state["resid"].numpy(),
                               np.asarray(ref.codec_state["resid"]),
                               atol=1e-4)
    port._reset_codec()
    assert port._comm_log == [] and not port.codec_state["resid"].any()


def test_async_registrations_equal_the_reference():
    for name in port_scenarios.ASYNC_SCENARIOS:
        assert dataclasses.asdict(port_scenarios.get(name)) == \
            dataclasses.asdict(ref_scenarios.get(name)), name
    assert sorted(n for n in port_scenarios.ASYNC_SCENARIOS
                  if n.startswith("async-")) == sorted(
        n for n in ref_scenarios.names() if n.startswith("async-"))


def test_deprecated_async_simulation_wrapper(ds):
    kw = dict(CFG, engine="loop", strategy="afl")
    sim = port_sim_mod.FederatedSimulation(port_types.FLConfig(**kw), ds,
                                           device="cpu")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        wrapper = port_async.AsyncSimulation(sim, speed_model="uniform",
                                             updates_per_client=1, tick=1.0,
                                             engine="vectorized")
    assert any(issubclass(w.category, DeprecationWarning) for w in caught)
    assert wrapper.schedule() == [(1.0, [0, 1, 2, 3])]
    res = wrapper.run()
    assert (res.merges, res.batches) == (4, 1)
    assert sim.strategy.name == "afl" and sim.vec is None
    with pytest.raises(ValueError, match="unknown engine"):
        port_async.AsyncSimulation(sim, engine="fused")
    # explicit speeds replace the speed model's draw, as in the reference
    speeds = [1.0, 3.0, 2.0, 4.0]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        wrapper = port_async.AsyncSimulation(sim, alpha=0.9, speeds=speeds,
                                             updates_per_client=2)
    expected = ref_async.build_timeline(4, kw["seed"], speeds=speeds,
                                        updates_per_client=2)
    assert wrapper.schedule() == [(t, list(cs))
                                  for t, cs in expected.batches]
    # the wrapper's settings reach its strategy, not the wrapped config
    assert wrapper.strategy.alpha == 0.9 and sim.fl.staleness_alpha == 0.6
