"""The port's fused executor against the reference's on the hoisted
axes, from the reference's initial parameters, on the CPU: sign-flip
attackers against the median (the flags as device inputs), clean gossip
under 30% churn with the moving-target ring (the masked mixing matrices
as per-round inputs, `gossip_mix_agg`'s plain version), and qsgd HFL
with the reference's rounding uniforms injected through
`codecs.rounding_uniforms` (the draws hoisted before the run).
Tolerances as in test_torch_fused_ref.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.core import codecs as ref_codecs  # noqa: E402
from repro.data.synthetic import mnist_like  # noqa: E402
from repro_torch.core import codecs as port_codecs  # noqa: E402
from test_torch_fused_ref import assert_runs_close, fused_pair  # noqa: E402


@pytest.fixture(scope="module")
def ds():
    return mnist_like(seed=0, n_train=256, n_test=128)


def _ref_uniforms(seed, event, client_id, n, device):
    key = ref_codecs.upload_keys(seed, event, jnp.asarray([client_id]))[0]
    return torch.as_tensor(np.array(jax.random.uniform(key, (n,)))).to(
        device)


@pytest.mark.parametrize("kw", [
    dict(strategy="afl", attack="sign_flip", attack_scale=4.0,
         defense="median", rounds=3),
    dict(strategy="afl", afl_mode="gossip", fault_profile="churn",
         churn_rate=0.3, fault_mtd=True, rounds=3),
], ids=["signflip-median", "churn-gossip-mtd"])
def test_fused_axes_match_the_reference(ds, kw):
    _, p = assert_runs_close(*fused_pair(ds, **kw))
    if "fault_profile" in kw:
        assert p.extra["faults"]["events_logged"] == 3


def test_fused_qsgd_hfl_matches_the_reference(ds, monkeypatch):
    monkeypatch.setattr(port_codecs, "rounding_uniforms", _ref_uniforms)
    _, p = assert_runs_close(*fused_pair(ds, strategy="hfl", codec="qsgd",
                                         rounds=3))
    assert p.extra["communication"]["codec"] == "qsgd"
