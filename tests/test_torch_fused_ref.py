"""The port's fused executor against the reference's (`repro.core.
simulation.run_fused`, one compiled `lax.scan`), from the reference's
initial parameters, on the CPU: HFL over a full dissemination cycle,
AFL at participation 0.5, and CFL's nested visit pass (the adversarial,
churn and codec axes are in test_torch_fused_ref_axes.py).

8 clients x 32 images, as the reference's tests/test_fused.py. Tolerances
as in test_torch_simulation_run.py: per-round losses 1e-4 (HFL 1e-3, for
the reason given there), test accuracy within 0.02; the post-run rng
state and the in-round counter series are the reference's.
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

CFG = dict(num_clients=8, num_groups=2, rounds=2, local_epochs=1,
           local_batch_size=16, lr=0.05, seed=0, participation=1.0,
           engine="fused")


@pytest.fixture(scope="module")
def ds():
    return mnist_like(seed=0, n_train=256, n_test=128)


def fused_pair(ds, **kw):
    """(reference sim, port sim) of one fused config, one initial model."""
    cfg = dict(CFG, **kw)
    ref = ref_sim_mod.FederatedSimulation(ref_types.FLConfig(**cfg), ds)
    init = jax.tree.map(np.asarray, ref.init_params)
    port = port_sim_mod.FederatedSimulation(
        port_types.FLConfig(**cfg), ds,
        model_init=lambda g: convert.params_from_jax(init), device="cpu")
    return ref, port


def assert_runs_close(ref, port):
    """Run both and hold the port to the reference; returns both results."""
    r, p = ref.run(), port.run()
    tol = 1e-3 if port.fl.strategy == "hfl" else 1e-4
    np.testing.assert_allclose(p.round_train_loss, r.round_train_loss,
                               atol=tol)
    np.testing.assert_allclose(p.round_train_acc, r.round_train_acc,
                               atol=0.02)
    np.testing.assert_allclose(p.round_test_acc, r.round_test_acc,
                               atol=0.02)
    assert abs(p.test_accuracy - r.test_accuracy) <= 0.02
    assert p.confusion.sum() == r.confusion.sum()
    assert (ref.rng.bit_generator.state["state"]
            == port.rng.bit_generator.state["state"])
    rs, ps = (x.extra["telemetry"]["series"] for x in (r, p))
    assert sorted(ps) == sorted(rs)
    for key in rs:
        np.testing.assert_allclose(ps[key], rs[key], rtol=1e-3, atol=1e-3,
                                   err_msg=key)
    assert ps["scan.attackers"] == rs["scan.attackers"]
    for key in ("faults", "communication"):
        assert p.extra.get(key) == r.extra.get(key), key
    return r, p


@pytest.mark.parametrize("strategy,kw", [
    ("hfl", dict(rounds=3)),
    ("afl", dict(participation=0.5)),
    ("cfl", dict()),
])
def test_fused_matches_the_reference(ds, strategy, kw):
    assert_runs_close(*fused_pair(ds, strategy=strategy, **kw))
