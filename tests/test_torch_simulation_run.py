"""The slice end to end: `FederatedSimulation.run()` of repro_torch
against the reference's, for HFL, AFL and CFL under the loop and
vectorized engines, from the reference's initial parameters; and the
port's own loop-vs-vectorized parity.

Tolerances as in test_torch_simulation.py: per-round losses at 1e-4
(HFL 1e-3, for the reason given there), test accuracy within 0.02 (a
2-sample flip on 128 test images), and `kernel.fedavg_agg` dispatch
counts equal to the reference's for HFL and AFL.
"""
import dataclasses

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


@pytest.fixture(scope="module")
def port_runs():
    """Port run() results shared by the end-to-end tests of this module."""
    return {}


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_run_end_to_end_parity(ds, port_runs, strategy, engine):
    ref, port = _pair(ds, strategy, engine)
    r = ref.run()
    p = port.run()
    port_runs[(strategy, engine)] = p
    assert ([f.name for f in dataclasses.fields(p)]
            == [f.name for f in dataclasses.fields(r)])
    assert (p.strategy, p.dataset) == (r.strategy, r.dataset)
    np.testing.assert_allclose(p.round_train_loss, r.round_train_loss,
                               atol=_tol(strategy))
    np.testing.assert_allclose(p.round_test_acc, r.round_test_acc,
                               atol=0.02)
    assert abs(p.test_accuracy - r.test_accuracy) <= 0.02
    assert p.confusion.shape == r.confusion.shape
    assert p.confusion.sum() == r.confusion.sum()
    for key in ("precision", "recall", "f1", "balanced_accuracy"):
        assert np.isfinite(getattr(p, key))
    assert p.extra["telemetry"].keys() == r.extra["telemetry"].keys()
    assert p.extra["kernel_launches"] == {"fedavg_agg": 0,    # CPU run
                                          "trimmed_mean_agg": 0,
                                          "gossip_mix_agg": 0,
                                          "dequant_agg": 0}
    got = p.extra["telemetry"]["dispatch"].get("kernel.fedavg_agg", 0)
    want = r.extra["telemetry"]["dispatch"].get("kernel.fedavg_agg", 0)
    if strategy == "cfl" and engine == "vectorized":
        # the reference's cfl_round_scan is jitted, so its counter counts
        # traces; the port merges once per visit: rounds + 1 warmup event
        # of num_clients visits each
        assert got == (CFG["rounds"] + 1) * CFG["num_clients"]
    else:
        assert got == want
        if strategy != "cfl":
            assert got > 0


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_port_loop_vectorized_parity(ds, port_runs, strategy):
    """Inside the port, both engines consume the rng identically and run
    the same SGD sequence (tests/test_engine.py holds the reference to
    the same)."""
    runs = {}
    for engine in ENGINES:
        runs[engine] = port_runs.get((strategy, engine))
        if runs[engine] is None:
            fl = port_types.FLConfig(strategy=strategy, engine=engine, **CFG)
            runs[engine] = port_sim_mod.FederatedSimulation(
                fl, ds, device="cpu").run()
    loop, vec = runs["loop"], runs["vectorized"]
    assert abs(loop.test_accuracy - vec.test_accuracy) <= 1e-3
    assert abs(loop.train_accuracy - vec.train_accuracy) <= 1e-3
    np.testing.assert_allclose(loop.round_test_acc, vec.round_test_acc,
                               atol=1e-3)
    np.testing.assert_allclose(loop.round_train_acc, vec.round_train_acc,
                               atol=1e-3)
    np.testing.assert_allclose(loop.round_train_loss, vec.round_train_loss,
                               atol=1e-3)
