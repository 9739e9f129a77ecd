"""Result documents (schema v2.5) of the fused registrations, run by the
port's fused executor, against the reference's `run_scenario`, from the
reference's initial parameters (qsgd with the reference's rounding
uniforms), on the CPU: `iid-hfl-fused` and `comm-qsgd-hfl-fused` here,
the adversarial and churn registrations in
test_torch_fused_docs_axes.py.

Held as test_torch_result_doc.py holds the per-round registrations:
every block but `metrics`, `timing` and `telemetry` equal, `metrics`
within 0.02, `timing` / `telemetry` the same keys; the fused run's
in-round counter series are within 1e-3 of the reference's.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.core import codecs as ref_codecs  # noqa: E402
from repro.core import scenarios as ref_scenarios  # noqa: E402
from repro.models import cnn as ref_cnn  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import codecs as port_codecs  # noqa: E402
from repro_torch.core import scenarios as port_scenarios  # noqa: E402

METRICS_TOL = 0.02
EQUAL_BLOCKS = ("schema_version", "scenario", "spec", "strategy", "attack",
                "communication", "async", "faults", "serving")
DOC_KEYS = ("schema_version", "scenario", "spec", "strategy", "metrics",
            "timing", "async", "attack", "communication", "telemetry",
            "serving", "faults")


def _ref_uniforms(seed, event, client_id, n, device):
    key = ref_codecs.upload_keys(seed, event, jnp.asarray([client_id]))[0]
    return torch.as_tensor(np.array(jax.random.uniform(key, (n,)))).to(
        device)


def _ref_init(seed):
    init = jax.tree.map(np.asarray, ref_cnn.init_cnn(jax.random.PRNGKey(seed)))
    return lambda g: convert.params_from_jax(init)


def doc_pair(name, **kw):
    """(reference document, port document) of one registration."""
    spec = port_scenarios.get(name)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_codecs, "rounding_uniforms", _ref_uniforms)
        port = port_scenarios.run_scenario(
            name, device="cpu", model_init=_ref_init(spec.seed), **kw)
    return ref_scenarios.run_scenario(name), port


def assert_doc_matches(ref, port):
    assert tuple(port) == DOC_KEYS and set(ref) == set(DOC_KEYS)
    for key in EQUAL_BLOCKS:
        assert port[key] == ref[key], key
    for key, want in ref["metrics"].items():
        assert abs(port["metrics"][key] - want) <= METRICS_TOL, key
    for key in ("timing", "telemetry"):
        assert port[key].keys() == ref[key].keys(), key
    assert port["timing"]["rounds_per_s"] > 0
    rs, ps = (d["telemetry"]["series"] for d in (ref, port))
    assert sorted(ps) == sorted(rs)
    for key in rs:
        np.testing.assert_allclose(ps[key], rs[key], rtol=1e-3, atol=1e-3,
                                   err_msg=key)
    assert (sorted(port["telemetry"]["run"])
            == sorted(ref["telemetry"]["run"]))
    text = json.dumps(port)             # every value a plain Python type
    assert ref_scenarios.load_result(json.loads(text)) == port
    assert port_scenarios.load_result(json.loads(text)) == port


@pytest.mark.parametrize("name", ["iid-hfl-fused", "comm-qsgd-hfl-fused"])
def test_fused_document_matches_the_reference(name):
    ref, port = doc_pair(name)
    assert_doc_matches(ref, port)
    assert port["spec"]["engine"] == "fused"
    assert port["telemetry"]["run"]["fused_scan"]["count"] == 1


def test_every_registration_is_runnable():
    assert len(port_scenarios.names()) == 41
    fused = [n for n in port_scenarios.names()
             if port_scenarios.get(n).engine == "fused"]
    assert sorted(fused) == sorted(port_scenarios.FUSED_SCENARIOS
                                   + ("serve-iid-fused",
                                      port_scenarios.TRACE_DEMO))
    assert set(port_scenarios.CI_SMOKE_GRID) <= set(port_scenarios.names())
