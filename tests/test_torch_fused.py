"""The port's fused executor (`engine="fused"`, DESIGN.md §10) against the
port's own vectorized per-round driver, on the CPU, where the round body
runs eagerly round by round (the card captures the same body as a CUDA
graph; chip_smoke.py phase 11 holds the two together there).

Configurations and tolerances are the reference's `tests/test_fused.py`
(`_assert_fused_parity`): 8 clients x 32 images, round accuracies 1e-5,
losses 1e-4, final metrics 1e-5, confusion equal. Then the rng stream,
`fused_chunk`, the refusals, the in-round counters, and FedAdam over 4
rounds with a below-quorum round, whose served model must be the
vectorized run's bit for bit (Adam's step count rides the carry). The
card tests (skipped without one) hold the CUDA graph to the eager loop
bit for bit; this file imports no jax, so they run on the card's machine.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.core import fl_types as port_types  # noqa: E402
from repro_torch.core import simulation as port_sim_mod  # noqa: E402
from repro_torch.data.synthetic import mnist_like  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402


@pytest.fixture(scope="module")
def ds():
    # 8 clients x 32 samples, shard-divisible (the §4 parity regime)
    return mnist_like(seed=0, n_train=256, n_test=128)


def _cfg(engine, **kw):
    base = dict(num_clients=8, num_groups=2, rounds=2, local_epochs=1,
                local_batch_size=16, lr=0.05, seed=0, participation=1.0)
    base.update(kw)
    return port_types.FLConfig(engine=engine, **base)


def _sim(ds, engine, **kw):
    return port_sim_mod.FederatedSimulation(_cfg(engine, **kw), ds,
                                            device="cpu")


def _served(sim):
    return tree_leaves(sim.strategy.round_model(sim.final_state))


def _assert_fused_parity(ds, **kw):
    sv, sf = _sim(ds, "vectorized", **kw), _sim(ds, "fused", **kw)
    rv, rf = sv.run(), sf.run()
    np.testing.assert_allclose(rf.round_train_acc, rv.round_train_acc,
                               atol=1e-5)
    np.testing.assert_allclose(rf.round_train_loss, rv.round_train_loss,
                               atol=1e-4)
    np.testing.assert_allclose(rf.round_test_acc, rv.round_test_acc,
                               atol=1e-5)
    assert abs(rf.train_accuracy - rv.train_accuracy) <= 1e-5
    assert abs(rf.test_accuracy - rv.test_accuracy) <= 1e-5
    assert abs(rf.f1 - rv.f1) <= 1e-5
    np.testing.assert_array_equal(rf.confusion, rv.confusion)
    assert rf.extra["kernel_launches"] == rv.extra["kernel_launches"] == {
        "fedavg_agg": 0, "trimmed_mean_agg": 0, "gossip_mix_agg": 0,
        "dequant_agg": 0}                                   # CPU runs
    return sv, sf, rv, rf


@pytest.mark.parametrize("strategy,kw", [
    # rounds=3 spans a full HFL dissemination cycle: refine-only round,
    # scheduled global round, forced final global round
    ("hfl", dict(rounds=3)),
    ("afl", dict(participation=0.5)),       # per-round participant gather
    ("cfl", dict()),                        # the nested visit pass
    ("fedprox", dict(prox_mu=0.1)),         # extra="bases" proximal ref
    ("fedavgm", dict(server_lr=0.7, server_momentum=0.9)),
    ("fedadam", dict(server_lr=0.1)),       # Adam state rides the carry
])
def test_fused_matches_per_round(ds, strategy, kw):
    _assert_fused_parity(ds, strategy=strategy, **kw)


def test_fused_matches_per_round_gossip(ds):
    _assert_fused_parity(ds, strategy="afl", afl_mode="gossip")


def test_fused_matches_per_round_under_attack(ds):
    """Attack + defense inside the round: sign-flip corruption between
    training and the median aggregation event."""
    _assert_fused_parity(ds, strategy="afl", attack="sign_flip",
                         attack_scale=4.0, defense="median", rounds=3)


@pytest.mark.parametrize("kw", [
    dict(strategy="cfl", attack="gauss", attack_scale=0.5,
         fault_profile="mid", quorum_frac=0.6),
    dict(strategy="hfl", attack="gauss", attack_scale=0.5,
         defense="trimmed_mean", fault_profile="mid", quorum_frac=0.6),
    dict(strategy="afl", afl_mode="gossip", defense="median",
         attack="sign_flip", fault_profile="churn", churn_rate=0.3),
    dict(strategy="afl", codec="topk", topk_frac=0.25),
])
def test_fused_matches_per_round_on_the_hoisted_seams(ds, kw):
    """Gauss noise hoisted through `attacks.stacked_noise` (also per CFL
    visit), fault holds and dead visitors selected with `torch.where`,
    defended masked gossip on device gather indices, and error-feedback
    rows riding the carry: the served model is the vectorized run's."""
    sv, sf, _, _ = _assert_fused_parity(ds, rounds=3, **kw)
    for a, b in zip(_served(sf), _served(sv)):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
    assert sf._fault_log.keys() == sv._fault_log.keys()


def test_fedadam_bias_corrections_follow_the_step_count(ds):
    """FedAdam over 4 rounds under a fault profile with a below-quorum
    round: a bias correction frozen at round 1, or a count that advanced
    through the held round, would move the served model; it is the
    vectorized run's bit for bit, and the final step count is its."""
    kw = dict(strategy="fedadam", server_lr=0.1, rounds=4,
              fault_profile="mid", quorum_frac=0.9, seed=1)
    sv, sf, _, _ = _assert_fused_parity(ds, **kw)
    held = [ev for ev, fe in sv._fault_log.items() if not fe.qok]
    assert held and len(held) < 4            # one step held, some taken
    assert all(a.equal(b) for a, b in zip(_served(sf), _served(sv)))
    assert sf.final_state["opt_state"]["count"] == \
        sv.final_state["opt_state"]["count"] == 4 - len(held)
    count = sf.final_state["opt_state"]["count"]
    assert count.dtype == torch.float32 and count.shape == ()


def test_fused_rng_stream_matches_per_round(ds):
    """The hoisted precompute consumes the run rng exactly like the
    per-round driver (§4), so the post-run generator states coincide."""
    sv = _sim(ds, "vectorized", strategy="afl", participation=0.5)
    sf = _sim(ds, "fused", strategy="afl", participation=0.5)
    sv.run(), sf.run()
    assert (sv.rng.bit_generator.state["state"]
            == sf.rng.bit_generator.state["state"])


@pytest.mark.parametrize("strategy,chunk", [("afl", 4), ("afl", 2),
                                            ("hfl", 4), ("fedprox", 4)])
def test_fused_chunked_matches_unchunked(ds, strategy, chunk):
    """`fused_chunk` trains the participant stack in sub-stacks: equal to
    the unchunked run within 1e-5 (not bitwise: the convolutions of a
    smaller batch sum in another order; the reference's own "bitwise"
    claim fails too, ROADMAP §C)."""
    kw = dict(strategy=strategy, prox_mu=0.1)
    ra = _sim(ds, "fused", **kw).run()
    sc = _sim(ds, "fused", fused_chunk=chunk, **kw)
    rc = sc.run()
    np.testing.assert_allclose(rc.round_train_loss, ra.round_train_loss,
                               atol=1e-5)
    np.testing.assert_allclose(rc.round_train_acc, ra.round_train_acc,
                               atol=1e-5)
    assert abs(rc.test_accuracy - ra.test_accuracy) <= 1e-5
    # the per-phase proxy is skipped when chunked
    assert rc.extra["telemetry"]["fused_phase_proxy"] is None
    assert ra.extra["telemetry"]["fused_phase_proxy"] is not None


def test_fused_chunk_must_divide_the_stack(ds):
    with pytest.raises(ValueError, match="fused_chunk"):
        _sim(ds, "fused", strategy="afl", fused_chunk=3).run()


def test_fused_rejects_async(ds):
    with pytest.raises(ValueError, match="fused"):
        _sim(ds, "fused", strategy="async", speed_model="uniform").run()


def test_fused_scenario_spec_rejects_async():
    from repro_torch.core.scenarios import ScenarioSpec
    with pytest.raises(ValueError, match="fused"):
        ScenarioSpec("bad-fused", "async cannot fuse", strategy="async",
                     topology="event", engine="fused")


@pytest.mark.parametrize("kw", [
    dict(strategy="afl", attack="sign_flip", attack_fraction=0.25,
         participation=0.5, rounds=3),
    dict(strategy="hfl", rounds=3)])
def test_in_round_series_and_one_transfer(ds, kw):
    """The in-round counters come back as (R,) series: the attacker count
    equals the flag sums of the hoisted schedule, the model step is the
    L2 distance between consecutive global models, HFL adds the group
    spread; the fused run records no per-round `alive_clients` or span of
    its own rounds but one `fused_scan` window."""
    sf = _sim(ds, "fused", **kw)
    rf = sf.run()
    series = rf.extra["telemetry"]["series"]
    R = kw["rounds"]
    assert all(len(v) == R for k, v in series.items()
               if k.startswith("scan."))
    xs, pids_l = _sim(ds, "fused", **kw)._fused_inputs(
        sf.strategy.init_state(sf), R)
    assert series["scan.attackers"] == [
        float(sf.attack_mask[p].sum()) for p in pids_l]
    assert series["participants"] == [float(len(p)) for p in pids_l]
    assert all(np.isfinite(series["scan.model_delta_l2"]))
    if kw["strategy"] == "hfl":
        assert series["scan.group_spread_l2"][-1] == 0.0  # disseminated
    run = rf.extra["telemetry"]["run"]
    assert run["fused_scan"]["count"] == 1 and "round" not in run


@pytest.fixture
def cuda():
    # decided at run time, never at import or collection time
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the graph has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("kw", [
    dict(strategy="hfl", rounds=3),
    dict(strategy="afl", attack="sign_flip", attack_scale=4.0,
         defense="median", rounds=3),
    dict(strategy="fedadam", server_lr=0.1, rounds=3)])
def test_cuda_graph_equals_the_eager_loop(cuda, ds, kw):
    """One captured round replayed R times gives the eager loop's bits and
    launches the same round kernels in the build window, as a profile of
    that window counts them on the device; no wrapper is called in the
    graph run's window, so its replays launched them."""
    from repro_torch.obs import collectors

    runs = []
    for graph in (True, False):
        sim = port_sim_mod.FederatedSimulation(
            _cfg("fused", **kw), ds, device=cuda)
        box = {}
        sim.build_hook = collectors.device_window(box)
        r = sim.run_fused(graph=graph)
        runs.append((sim, r, box))
    (gs, gr, gbox), (es, er, ebox) = runs
    assert gr.round_train_loss == er.round_train_loss
    assert gr.round_test_acc == er.round_test_acc
    assert all(a.equal(b) for a, b in zip(_served(gs), _served(es)))
    assert gbox["kernels"] == ebox["kernels"] == ebox["wrapper_calls"]
    assert sum(gbox["kernels"].values()) > 0
    assert not any(gbox["wrapper_calls"].values())
