"""The serving side-car (`repro_torch.serve`, DESIGN.md §14) and the
Chrome trace (`repro_torch.obs.export`) against the reference's
`repro.serve` and `repro.obs.export`, on the CPU.

The side-car is the port's own copy of the reference's numpy modules:
traffic traces, batcher ledgers, hot-swap staleness and the `serving`
block are equal to the reference's for the same inputs. The serving
registrations' result documents are held to the reference's (from its
initial parameters, qsgd with its uniforms) as test_torch_fused_docs.py
holds the fused ones — the `serving` block equal, served accuracy
included; `serve-iid-fused`'s block is byte for byte its vectorized
twin's; the trace demo's trace passes both packages' validators.
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro import serve as ref_serve  # noqa: E402
from repro.core import fl_types as ref_types  # noqa: E402
from repro.obs import export as ref_export  # noqa: E402
from repro.obs.telemetry import Telemetry as RefTelemetry  # noqa: E402
from repro_torch import serve as port_serve  # noqa: E402
from repro_torch.core import fl_types as port_types  # noqa: E402
from repro_torch.core import scenarios as port_scenarios  # noqa: E402
from repro_torch.obs import export as port_export  # noqa: E402
from repro_torch.obs.telemetry import Telemetry  # noqa: E402
from test_torch_fused_docs import assert_doc_matches, doc_pair  # noqa: E402


@pytest.mark.parametrize("arrival", ["poisson", "burst", "diurnal"])
@pytest.mark.parametrize("seed", [0, 3])
def test_traffic_equals_the_reference(arrival, seed):
    got = port_serve.traffic.generate(arrival, 64.0, 4.0, 256, seed)
    want = ref_serve.traffic.generate(arrival, 64.0, 4.0, 256, seed)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("kw", [
    dict(), dict(serve_arrival="burst", serve_qps=256.0, serve_batch=4,
                 serve_queue=8, serve_max_wait=0.02),
    dict(serve_arrival="diurnal", serve_round_duration=0.5)])
def test_session_block_equals_the_reference(kw):
    """One queueing session (no model calls) with a held round: the
    `serving` block, the telemetry counters and the batch-size series
    equal the reference's."""
    blocks = []
    for types, serve, tel_cls in ((port_types, port_serve, Telemetry),
                                  (ref_types, ref_serve, RefTelemetry)):
        fl = types.FLConfig(serve=True, seed=2, **kw)
        tel = tel_cls()
        sess = serve.ServeSession(fl, n_events=3, n_test=128,
                                  init_params={"w": 0}, telemetry=tel)
        sess.publish_round(1, {"w": 1})
        sess.hold_round(2)
        sess.publish_round(3, {"w": 3})
        blocks.append((sess.result_block(), tel.counters,
                       tel.series["serve.batch_sizes"]))
    assert blocks[0] == blocks[1]
    assert blocks[0][0]["swap_count"] == 2
    assert blocks[0][1]["serve.held_rounds"] == 1.0


def test_hot_swap_and_batcher_ledgers_equal_the_reference():
    """A batch dispatched before a publish keeps its version; the
    staleness ledger and every per-request ledger equal the
    reference's."""
    out = []
    for serve in (port_serve, ref_serve):
        buf = serve.ModelBuffer()
        buf.publish("v0", 0, 0.0)
        times = np.array([0.01, 0.02, 0.9, 1.05, 1.06, 2.5])
        b = serve.MicroBatcher(times, np.arange(6), max_batch=2,
                               max_wait=0.05, queue_depth=2,
                               service_base=0.004, service_per_item=0.001,
                               buffer=buf,
                               dispatch_fn=lambda p, ex: ex % 2 == 0)
        b.advance(1.0)
        buf.publish("v1", 1, 1.0)
        b.drain()
        assert b.accounted() and b.in_flight == 0
        out.append((b.done_rid, b.done_version, b.done_finish,
                    b.done_correct, b.shed_rid, b.batch_sizes,
                    serve.metrics.staleness_block(b, buf)))
    assert out[0] == out[1]


@pytest.mark.parametrize("name", ["serve-iid-fused", "serve-hfl-burst",
                                  "serve-qsgd-signflip-median"])
def test_serving_document_matches_the_reference(name):
    ref, port = doc_pair(name)
    assert_doc_matches(ref, port)             # the serving block included
    s = port["serving"]
    assert s["served_accuracy"] is not None
    assert s["completed"] + s["shed"] == s["requests"]
    assert s["swap_count"] == port["spec"]["rounds"]


def test_fused_serving_block_is_the_vectorized_runs_bytes():
    """The `serving` block is the same bytes under the fused, vectorized
    and loop engines (DESIGN.md §14: a virtual clock, publishes replayed
    after a fused run)."""
    spec = port_scenarios.get("serve-iid-fused")
    fused = port_scenarios.run_scenario(spec, device="cpu")
    for engine in ("vectorized", "loop"):
        twin = port_scenarios.run_scenario(
            dataclasses.replace(spec, engine=engine), device="cpu")
        assert json.dumps(fused["serving"]) == json.dumps(twin["serving"])
    assert fused["telemetry"]["run"]["fused_scan"]["count"] == 1


def test_trace_demo_matches_the_reference_and_validates(tmp_path):
    path = tmp_path / "trace.json"
    ref, port = doc_pair(port_scenarios.TRACE_DEMO, trace_out=str(path))
    assert_doc_matches(ref, port)
    trace = json.loads(path.read_text())
    assert port_export.validate_chrome_trace(trace) == []
    assert ref_export.validate_chrome_trace(trace) == []
    tracks = {e["args"]["name"] for e in trace["traceEvents"]
              if e["ph"] == "M" and e["name"] == "thread_name"}
    assert {"run", "proxy", "counters"} <= tracks
    counters = {e["name"] for e in trace["traceEvents"] if e["ph"] == "C"}
    assert {"scan.attackers", "scan.model_delta_l2"} <= counters


def test_chrome_trace_equals_the_reference_for_the_same_spans():
    """The exporter is the reference's: one set of spans (nested, a flow,
    a series) gives the same document under both packages, and a broken
    document fails both validators alike."""
    docs = []
    for tel_cls, export in ((Telemetry, port_export),
                            (RefTelemetry, ref_export)):
        tel = tel_cls()
        tel.spans = [
            {"name": "round", "cat": "run", "ts_us": 0.0, "dur_us": 10.0,
             "args": {"flow": "rounds"}},
            {"name": "local_train", "cat": "phase", "ts_us": 1.0,
             "dur_us": 5.0, "args": {"k": 4}},
            {"name": "aggregate", "cat": "phase", "ts_us": 6.0,
             "dur_us": 6.0, "args": {}},
            {"name": "round", "cat": "run", "ts_us": 12.0, "dur_us": 3.0,
             "args": {"flow": "rounds"}}]
        tel.series = {"participants": [4.0, 4.0]}
        docs.append(export.chrome_trace(tel))
    meta = [e for e in docs[0]["traceEvents"] if e["ph"] == "M"]
    assert meta[0]["args"]["name"] == "repro_torch.federated_run"
    strip = [[e for e in d["traceEvents"] if e.get("name") != "process_name"]
             for d in docs]
    assert strip[0] == strip[1]
    broken = {"traceEvents": docs[0]["traceEvents"][:-1] + [
        {"name": "x", "ph": "E", "pid": 1, "tid": 99, "ts": 0.0}]}
    assert port_export.validate_chrome_trace(broken) == \
        ref_export.validate_chrome_trace(broken) != []
