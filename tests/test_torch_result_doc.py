"""The scenario runner's result document (schema v2.5) of repro_torch
against the reference's (`repro.core.scenarios`): the registry and its
specs, the registrations that waited for the fused executor and the
serving side-car (now runnable), `load_result`,
`run_scenario` block by block, the Chrome trace, and the `--json`,
`--trace-out` and `--grid ci` CLI.

Parity runs start from the reference's initial parameters
(`model_init`), and qsgd rounds with the reference's uniforms (the
`codecs.rounding_uniforms` seam), so the two runs differ by float
arithmetic only. Tolerances: `metrics` each within 0.02, the run-level
tolerance of test_torch_simulation_run.py; `timing` and `telemetry` the
same keys, values not compared (times, RSS, and dispatch counts that
differ by design for vectorized CFL); every other block equal.
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
from repro_torch.core import strategies as port_strategies  # noqa: E402

METRICS_TOL = 0.02
EQUAL_BLOCKS = ("schema_version", "scenario", "spec", "strategy", "attack",
                "communication", "async", "faults", "serving")
# one parity run covers each optional block: async, faults,
# communication and attack
PARITY = ("iid-hfl-vec", "ring-gossip-vec", "async-straggler-vec",
          "comm-qsgd-signflip-median-vec", "churn-hfl-quorum")
# the registrations that waited for ROADMAP §A.13 (the fused executor)
# and §A.14 (serving and the trace) until slice 10, with the items each
# waited for
PENDING = {"iid-hfl-fused": ("§A.13",),
           "attack-signflip-median-fused": ("§A.13",),
           "obs-trace-fused-16c": ("§A.13", "§A.14"),
           "serve-iid-fused": ("§A.13", "§A.14"),
           "serve-hfl-burst": ("§A.14",),
           "churn-afl-gossip-mtd": ("§A.13",),
           "comm-qsgd-hfl-fused": ("§A.13",),
           "serve-qsgd-signflip-median": ("§A.14",)}
DOC_KEYS = ("schema_version", "scenario", "spec", "strategy", "metrics",
            "timing", "async", "attack", "communication", "telemetry",
            "serving", "faults")


def _ref_uniforms(seed, event, client_id, n, device):
    """The reference's qsgd rounding uniforms for (seed, event, client)."""
    key = ref_codecs.upload_keys(seed, event, jnp.asarray([client_id]))[0]
    return torch.as_tensor(np.array(jax.random.uniform(key, (n,)))).to(
        device)


def _ref_init(seed):
    """The reference's initial CNN for `seed`, as the port's tree."""
    params = ref_cnn.init_cnn(jax.random.PRNGKey(seed))
    init = jax.tree.map(np.asarray, params)
    return lambda g: convert.params_from_jax(init)


@pytest.fixture(scope="module")
def docs():
    """(reference document, port document) per parity scenario, run once
    for the module."""
    return {}


def _pair(docs, name):
    if name not in docs:
        spec = port_scenarios.get(name)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(port_codecs, "rounding_uniforms", _ref_uniforms)
            port = port_scenarios.run_scenario(
                name, device="cpu", model_init=_ref_init(spec.seed))
        docs[name] = (ref_scenarios.run_scenario(name), port)
    return docs[name]


@pytest.mark.parametrize("name", ref_scenarios.names())
def test_spec_asdict_equals_the_reference(name):
    assert port_scenarios.get(name).asdict() == \
        ref_scenarios.get(name).asdict()


def test_registry_equals_the_reference():
    assert port_scenarios.names() == ref_scenarios.names()
    assert len(port_scenarios.names()) == 41
    assert port_scenarios.CI_SMOKE_GRID == ref_scenarios.CI_SMOKE_GRID
    assert (port_scenarios.RESULT_SCHEMA_VERSION
            == ref_scenarios.RESULT_SCHEMA_VERSION)
    assert (port_strategies.STRATEGY_REGISTRY_VERSION
            == ref_scenarios.STRATEGY_REGISTRY_VERSION)


@pytest.mark.parametrize("name", sorted(PENDING))
def test_pending_registration_raises_before_any_training(name):
    """What these registrations waited for has been ported: each
    resolves to a simulation of its engine
    with the serving side-car when it serves; nothing raises and nothing
    trains here (their runs are held to the reference in
    test_torch_fused_docs.py and test_torch_serve.py)."""
    spec = port_scenarios.get(name)
    sim = port_scenarios.resolve(spec, device="cpu")
    assert (sim.fl.engine, sim.fl.serve) == (spec.engine, spec.serve)
    assert sim.strategy.supports_fused or spec.engine != "fused"
    assert sim.vec is not None


def _synthetic_doc(version):
    """A result document of schema `version` carrying only the blocks that
    version had."""
    doc = {"schema_version": version, "scenario": "iid-hfl-vec",
           "spec": {"name": "iid-hfl-vec", "strategy": "hfl"},
           "metrics": {"test_accuracy": 0.5, "f1": 0.4},
           "timing": {"build_time_s": 1.0, "rounds_per_s": 2.0},
           "async": None}
    blocks = ((2, "attack", {"attack": "sign_flip", "defense": "median"}),
              (2.1, "strategy", {"plugin": "hfl", "registry_version": 1}),
              (2.2, "communication", {"codec": "qsgd", "uplink_bytes": 64}),
              (2.3, "telemetry", {"enabled": False}),
              (2.4, "serving", {"qps": 64.0}),
              (2.5, "faults", {"profile": "mid", "quorum_failures": 1}))
    for since, key, block in blocks:
        if version >= since:
            doc[key] = block
    return doc


@pytest.mark.parametrize("version", [1, 2, 2.1, 2.2, 2.3, 2.4, 2.5])
def test_load_result_equals_the_reference(version):
    doc = _synthetic_doc(version)
    got = port_scenarios.load_result(json.loads(json.dumps(doc)))
    assert got == ref_scenarios.load_result(json.loads(json.dumps(doc)))
    assert got["schema_version"] == 2.5
    assert set(got) == set(DOC_KEYS)


@pytest.mark.parametrize("version", [3, 0, None, "2.5"])
def test_load_result_raises_on_an_unknown_version(version):
    doc = dict(_synthetic_doc(2.5), schema_version=version)
    for load in (port_scenarios.load_result, ref_scenarios.load_result):
        with pytest.raises(ValueError, match="schema_version"):
            load(doc)


@pytest.mark.parametrize("name", PARITY)
def test_run_scenario_matches_the_reference(docs, name):
    ref, port = _pair(docs, name)
    assert tuple(port) == DOC_KEYS and set(ref) == set(DOC_KEYS)
    for key in EQUAL_BLOCKS:
        assert port[key] == ref[key], key
    assert port["metrics"].keys() == ref["metrics"].keys()
    for key, want in ref["metrics"].items():
        assert abs(port["metrics"][key] - want) <= METRICS_TOL, key
    for key in ("timing", "telemetry"):
        assert port[key].keys() == ref[key].keys(), key
    assert port["timing"]["rounds_per_s"] > 0


def test_parity_runs_cover_every_optional_block(docs):
    covered = {key for name in PARITY
               for key in ("async", "attack", "communication", "faults")
               if _pair(docs, name)[1][key] is not None}
    assert covered == {"async", "attack", "communication", "faults"}


@pytest.mark.parametrize("name", PARITY)
def test_reference_load_result_reads_the_port_document(docs, name):
    _, port = _pair(docs, name)
    text = json.dumps(port)             # every value a plain Python type
    assert ref_scenarios.load_result(json.loads(text)) == port
    assert port_scenarios.load_result(json.loads(text)) == port


@pytest.mark.parametrize("name", [
    "iid-hfl-loop", "iid-afl-vec", "iid-cfl-vec", "dirichlet-hfl-loop",
    "dirichlet-afl-loop"])
def test_new_registration_runs_to_a_document(name):
    doc = port_scenarios.run_scenario(name, device="cpu")
    assert tuple(doc) == DOC_KEYS
    assert doc["schema_version"] == 2.5 and doc["scenario"] == name
    assert doc["spec"] == ref_scenarios.get(name).asdict()
    assert doc["strategy"] == {"plugin": port_scenarios.get(name).strategy,
                               "registry_version": 1}
    assert all(np.isfinite(v) for v in doc["metrics"].values())
    assert doc["attack"] is doc["communication"] is doc["async"] is None
    assert doc["faults"] is doc["serving"] is None
    assert json.loads(json.dumps(doc)) == doc


def test_trace_out_raises_naming_its_item(tmp_path):
    """`trace_out` (ROADMAP §A.14) no longer raises: it writes the run's
    Chrome trace, which both packages' validators accept."""
    from repro.obs import validate_chrome_trace as ref_validate
    from repro_torch.obs import validate_chrome_trace
    path = tmp_path / "trace.json"
    doc = port_scenarios.run_scenario("iid-cfl-vec", device="cpu",
                                      trace_out=str(path))
    trace = json.loads(path.read_text())
    assert validate_chrome_trace(trace) == [] == ref_validate(trace)
    names = {e["name"] for e in trace["traceEvents"] if e["ph"] == "B"}
    assert {"warmup", "round", "sequential_round", "classify"} <= names
    assert doc["telemetry"]["enabled"]


@pytest.mark.parametrize("argv,item", [
    (["--run", "iid-hfl-vec", "--trace-out", "t.json"], "§A.14"),
    (["--grid", "ci"], "§A.13")])
def test_cli_refuses_what_is_not_ported(argv, item, capsys, monkeypatch):
    """`--trace-out` and `--grid ci` waited for ROADMAP `item` and now
    run: the CLI hands `run_scenario` the trace path and the whole CI
    grid, in order, and refuses nothing."""
    calls = []

    def record(spec, device, trace_out=None):
        calls.append((spec.name, device, trace_out))
        doc = {"metrics": {"test_accuracy": 0.5, "f1": 0.5},
               "timing": {"build_time_s": 1.0, "rounds_per_s": 1.0},
               "faults": None, "communication": None}
        return doc

    monkeypatch.setattr(port_scenarios, "run_scenario", record)
    port_scenarios.main(argv + ["--device", "cpu"])
    captured = capsys.readouterr()
    assert item not in captured.err
    if "--grid" in argv:
        assert [c[0] for c in calls] == list(port_scenarios.CI_SMOKE_GRID)
        assert all(c[2] is None for c in calls)
    else:
        assert calls == [("iid-hfl-vec", "cpu", "t.json")]
        assert "trace -> t.json" in captured.out
    with pytest.raises(SystemExit):     # one trace names one run
        port_scenarios.main(["--grid", "ci", "--trace-out", "t.json"])


def test_cli_json_writes_one_document_per_run(tmp_path, monkeypatch,
                                              capsys):
    monkeypatch.setattr(port_scenarios, "OUTPUT_DIR", str(tmp_path / "out"))
    names = ["iid-cfl-vec", "ring-gossip-vec"]
    path = tmp_path / "docs.json"
    port_scenarios.main(["--run", *names, "--device", "cpu",
                         "--json", str(path)])
    docs = json.loads(path.read_text())
    assert [d["scenario"] for d in docs] == names
    for doc in docs:
        assert ref_scenarios.load_result(doc) == doc
    out = capsys.readouterr().out
    assert all(f"{n}: test_acc=" in out for n in names)
    assert "rounds_per_s=" in out
    # a bare filename lands under the output root's results/
    port_scenarios.main(["--run", "iid-cfl-vec", "--device", "cpu",
                         "--json", "bare.json"])
    bare = json.loads((tmp_path / "out" / "results" / "bare.json")
                      .read_text())
    assert [d["scenario"] for d in bare] == ["iid-cfl-vec"]
