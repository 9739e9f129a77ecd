"""The 32-client sign-flip acceptance family (the adversarial study's
main path) in the port against the reference on the CPU, from the
reference's initial parameters, cut to its first 2 rounds: the
no-attack baseline and the two defended runs whose macro-F1 ratio
chip_smoke.py gates (undefended FedAvg under attack collapses to one
class in both packages from the first round on).

Each run keeps the registered configuration (32 clients, all
participating, 25% attackers, lr 0.08, 2 local epochs) apart from the
rounds. The port's per-round test accuracy must follow the reference's
within 0.03 (15 of the 512 test images): the family's later rounds are
chaotic, but the first ones must agree, or the port trains differently.
The whole 10-round curves are a reading of
`tests/torch_reference_probe.py acc32`."""
import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro.core import scenarios as ref_scenarios  # noqa: E402
from repro.core import simulation as ref_sim_mod  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import scenarios as port_scenarios  # noqa: E402
from repro_torch.core import simulation as port_sim_mod  # noqa: E402

ROUNDS = 2
ACC_TOL = 0.03


@pytest.mark.parametrize("name", ["attack-none-32c-vec",
                                  "attack-signflip-median-32c-vec",
                                  "attack-signflip-trimmed-32c-vec"])
def test_acceptance_run_follows_the_reference(name):
    spec = dataclasses.replace(port_scenarios.get(name), rounds=ROUNDS)
    ref_spec = dataclasses.replace(ref_scenarios.get(name), rounds=ROUNDS)
    ds = port_scenarios.DATASETS[spec.dataset](
        seed=spec.seed, n_train=spec.n_train, n_test=spec.n_test)
    ref = ref_sim_mod.FederatedSimulation(ref_spec.to_fl_config(), ds)
    start = jax.tree.map(np.asarray, ref.init_params)
    port = port_sim_mod.FederatedSimulation(
        spec.to_fl_config(), ds,
        model_init=lambda g: convert.params_from_jax(start), device="cpu")
    np.testing.assert_array_equal(port.attack_mask, ref.attack_mask)
    rr, pr = ref.run(), port.run()
    assert len(pr.round_test_acc) == len(rr.round_test_acc) == ROUNDS
    np.testing.assert_allclose(pr.round_test_acc, rr.round_test_acc,
                               atol=ACC_TOL, rtol=0)
    assert abs(pr.test_accuracy - rr.test_accuracy) <= ACC_TOL
