"""The upload codecs of repro_torch against the reference's
(`repro.core.codecs`): the registry, the encodings, the byte-count cost
model, and whole simulations with a codec on the wire, event by event.

Randomness: the port rounds with its own uniforms (`codecs.
rounding_uniforms`, a CPU torch.Generator), the reference with
`jax.random.uniform`. Parity tests pass the reference's draws in through
that one seam; given the same row and the same uniforms, qsgd's `q` and
`scale` are bitwise the reference's.

Tolerances. Encodings fed identical inputs: bitwise (top-k indices,
values and residuals included, ties too). Simulations: round models at
1e-4 abs and rel after every event (HFL 1e-3), as in
test_torch_simulation.py, with one allowance: the two packages' trained
uploads differ by ~1e-7, so where a uniform lies that close to a
coordinate's rounding threshold its int8 level can differ by one, which
moves the aggregate by w_c * scale_c (about 1e-3 here). Every coordinate
must lie within 1e-4 + the summed levels of the events so far; the
number of coordinates that needed the allowance is printed. Top-k has
the same allowance for a swap at the k-th boundary, sized by the k-th
largest |delta|.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.core import codecs as ref_codecs  # noqa: E402
from repro.core import fl_types as ref_types  # noqa: E402
from repro.core import scenarios as ref_scenarios  # noqa: E402
from repro.core import simulation as ref_sim_mod  # noqa: E402
from repro.data.synthetic import mnist_like  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import codecs as port_codecs  # noqa: E402
from repro_torch.core import fl_types as port_types  # noqa: E402
from repro_torch.core import scenarios as port_scenarios  # noqa: E402
from repro_torch.core import simulation as port_sim_mod  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

CFG = dict(num_clients=4, num_groups=2, rounds=2, local_batch_size=32,
           lr=0.03, momentum=0.9, seed=0, participation=1.0)


def ref_uniforms(seed, event, client_id, n, device):
    """The reference's rounding uniforms for (seed, event, client)."""
    key = ref_codecs.upload_keys(seed, event, jnp.asarray([client_id]))[0]
    return torch.as_tensor(np.array(jax.random.uniform(key, (n,)))).to(
        device)


@pytest.fixture
def ref_draws(monkeypatch):
    monkeypatch.setattr(port_codecs, "rounding_uniforms", ref_uniforms)


@pytest.fixture(scope="module")
def ds():
    return mnist_like(seed=0, n_train=256, n_test=128)


def _codecs(name, **kw):
    """(reference codec, port codec) built from one config."""
    cfg = dict(codec=name, **kw)
    return (ref_codecs.get_codec(name)(ref_types.FLConfig(**cfg)),
            port_codecs.get_codec(name)(port_types.FLConfig(**cfg)))


def _rows(k, n, seed):
    rng = np.random.default_rng(seed)
    mat = rng.normal(size=(k, n)).astype(np.float32)
    mat[0, :5] = 0.0                     # exact zeros on a level
    if k > 2:
        mat[2] = 0.0                     # an all-zero upload: scale floor
    return mat


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

def test_registry_matches_reference():
    assert port_codecs.codec_names() == ["none", "qsgd", "topk"]
    assert port_codecs.CODEC_REGISTRY_VERSION == \
        ref_codecs.CODEC_REGISTRY_VERSION == 1
    for name in port_codecs.codec_names():
        p, r = port_codecs.get_codec(name), ref_codecs.get_codec(name)
        for attr in ("defenses", "stateful", "needs_bases"):
            assert getattr(p, attr) == getattr(r, attr), (name, attr)
    with pytest.raises(ValueError, match="unknown codec"):
        port_codecs.get_codec("zstd")
    with pytest.raises(ValueError, match="already registered"):
        port_codecs.register_codec(
            type("Dup", (port_codecs.Codec,), {"name": "qsgd"}))
    with pytest.raises(ValueError, match="non-empty string"):
        port_codecs.register_codec(type("NoName", (port_codecs.Codec,), {}))


@pytest.mark.parametrize("name,kw", [
    ("none", {}), ("topk", dict(topk_frac=0.1)), ("topk", dict(topk_frac=1.0)),
    ("topk", dict(topk_frac=0.25)), ("qsgd", dict(quant_bits=8)),
    ("qsgd", dict(quant_bits=16))])
@pytest.mark.parametrize("dim", [1, 37, 7900])
def test_bytes_on_wire_match_reference(name, kw, dim):
    ref, port = _codecs(name, **kw)
    assert port.bytes_on_wire(dim) == ref.bytes_on_wire(dim)


# ---------------------------------------------------------------------------
# encodings, fed identical inputs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("k,n", [(1, 300), (4, 7900), (5, 1001)])
def test_qsgd_payload_bitwise_given_reference_uniforms(ref_draws, bits, k,
                                                       n):
    ref, port = _codecs("qsgd", quant_bits=bits)
    mat = _rows(k, n, k * n)
    ids = [3, 0, 7, 1, 12][:k]
    rp, _ = ref.encode(jnp.asarray(mat),
                       ref_codecs.upload_keys(0, 5, jnp.asarray(ids)))
    pp, _ = port.encode(torch.as_tensor(mat),
                        port_codecs.upload_keys(0, 5, ids))
    assert sorted(pp) == sorted(rp)
    if bits == 8:
        assert pp["q"].dtype == torch.int8
        np.testing.assert_array_equal(pp["q"].numpy(), np.asarray(rp["q"]))
        np.testing.assert_array_equal(pp["scale"].numpy(),
                                      np.asarray(rp["scale"]))
    else:
        assert pp["q"].dtype == torch.bfloat16
        np.testing.assert_array_equal(
            pp["q"].view(torch.int16).numpy(),
            np.asarray(rp["q"]).view(np.int16))
    dec_r = np.asarray(ref.decode(rp))
    dec_p = port.decode(pp).numpy()
    np.testing.assert_array_equal(dec_p, dec_r)


def test_qsgd_bf16_special_values(ref_draws):
    """±0, ±inf, NaN, the largest floats and values on a bf16 level
    against the reference; subnormals, and tiny normals whose gap to the
    next bf16 value is subnormal, stochastically rounded between their
    two bf16 neighbours. The reference's XLA:CPU flushes subnormal
    operands and results to zero, so it returns the lower neighbour (±0
    for subnormals) there; the port (on the CPU and the card) keeps them
    and returns one of the two neighbours."""
    ref, port = _codecs("qsgd", quant_bits=16)
    vals = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 3.3e38, -3.3e38,
                     np.float32(3.4028235e38), 1.0, -2.5, 1e-30],
                    np.float32)
    sub = np.array([1e-40, -1e-40, 1e-45, -3e-39, 1e-38, 2e-38],
                   np.float32)
    row = np.concatenate([vals, sub])[None]
    rp, _ = ref.encode(jnp.asarray(row),
                       ref_codecs.upload_keys(0, 0, jnp.asarray([0])))
    pp, _ = port.encode(torch.as_tensor(row),
                        port_codecs.upload_keys(0, 0, [0]))
    got = pp["q"].float().numpy()[0]
    want = np.asarray(rp["q"].astype(jnp.float32))[0]
    n = len(vals)
    np.testing.assert_array_equal(got[:n], want[:n])        # NaN == NaN
    np.testing.assert_array_equal(np.signbit(got[:2]), [False, True])
    bits = sub.view(np.uint32) & np.uint32(0xFFFF0000)
    lo = bits.view(np.float32)
    hi = (bits + np.uint32(0x10000)).view(np.float32)
    assert all(g in (a, b) for g, a, b in zip(got[n:], lo, hi))
    np.testing.assert_array_equal(want[n:], np.where(         # flushed
        np.abs(sub) < np.finfo(np.float32).tiny, 0.0, lo))


@pytest.mark.parametrize("frac", [0.1, 0.25, 1.0])
def test_topk_payload_and_residuals_equal_reference(frac):
    ref, port = _codecs("topk", topk_frac=frac)
    rng = np.random.default_rng(3)
    mat = rng.normal(size=(4, 7900)).astype(np.float32)
    base = rng.normal(size=(4, 7900)).astype(np.float32)
    resid = (0.01 * rng.normal(size=(4, 7900))).astype(np.float32)
    rp, rrows = ref.encode(jnp.asarray(mat), None, base=jnp.asarray(base),
                           rows={"resid": jnp.asarray(resid)})
    pp, prows = port.encode(torch.as_tensor(mat), None,
                            base=torch.as_tensor(base),
                            rows={"resid": torch.as_tensor(resid)})
    np.testing.assert_array_equal(pp["idx"].numpy(), np.asarray(rp["idx"]))
    np.testing.assert_array_equal(pp["values"].numpy(),
                                  np.asarray(rp["values"]))
    np.testing.assert_array_equal(prows["resid"].numpy(),
                                  np.asarray(rrows["resid"]))
    np.testing.assert_array_equal(
        port.decode(pp, base=torch.as_tensor(base)).numpy(),
        np.asarray(ref.decode(rp, base=jnp.asarray(base))))


def test_topk_ties_follow_jax_lax_top_k():
    """Exact ties in |delta| (equal values, opposite signs, zeros) go to
    the lower index, as `jax.lax.top_k` orders them."""
    ref, port = _codecs("topk", topk_frac=0.3)
    rng = np.random.default_rng(0)
    delta = rng.choice(np.array([-2.0, -1.0, 0.0, 1.0, 2.0], np.float32),
                       size=(6, 40))
    delta[5] = 0.0                                    # all tied
    zeros = np.zeros_like(delta)
    _, want = jax.lax.top_k(jnp.abs(jnp.asarray(delta)), 12)
    rp, _ = ref.encode(jnp.asarray(delta), None, base=jnp.asarray(zeros),
                       rows={"resid": jnp.asarray(zeros)})
    pp, _ = port.encode(torch.as_tensor(delta), None,
                        base=torch.as_tensor(zeros),
                        rows={"resid": torch.as_tensor(zeros)})
    np.testing.assert_array_equal(np.asarray(rp["idx"]), np.asarray(want))
    np.testing.assert_array_equal(pp["idx"].numpy(), np.asarray(want))


def test_roundtrip_tree_matches_reference(ref_draws):
    """The CFL per-visit seam: one tree raveled to a (1, N) row, through
    the codec, and back."""
    rng = np.random.default_rng(1)
    tree = {"a": {"bias": rng.normal(size=(3,)).astype(np.float32),
                  "kernel": rng.normal(size=(2, 3)).astype(np.float32)},
            "b": rng.normal(size=(5,)).astype(np.float32)}
    ref, port = _codecs("qsgd")
    r = ref_codecs.roundtrip_tree(
        ref, jax.tree.map(jnp.asarray, tree),
        ref_codecs.upload_keys(0, 1, jnp.asarray([2])))
    p = port_codecs.roundtrip_tree(port, convert.params_from_jax(tree),
                                   port_codecs.upload_keys(0, 1, [2]))
    for a, b in zip(jax.tree.leaves(r), tree_leaves(p)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


# ---------------------------------------------------------------------------
# the port's own randomness
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits,tol", [(8, 5e-3), (16, 5e-3)])
def test_qsgd_unbiased(bits, tol):
    """E[decode(encode(x))] == x: averaging the round trip over 512
    (seed, event, client) keys of the port's own uniforms recovers the
    dense value (the reference's check, tests/test_codecs.py)."""
    _, codec = _codecs("qsgd", quant_bits=bits)
    row = torch.as_tensor(np.random.default_rng(0).normal(
        size=(1, 256)).astype(np.float32))
    dec = [codec.scan_encode_decode(row, port_codecs.upload_keys(0, ev,
                                                                 [7]))[0][0]
           for ev in range(512)]
    np.testing.assert_allclose(torch.stack(dec).mean(0).numpy(),
                               row[0].numpy(), atol=tol)


def test_qsgd_keys_follow_rng_contract():
    """Rounding noise is keyed by (seed, event, ABSOLUTE client id)."""
    _, codec = _codecs("qsgd")
    row = torch.as_tensor(np.random.default_rng(1).normal(
        size=(1, 64)).astype(np.float32))

    def q(seed, event, cid):
        payload, _ = codec.encode(row, port_codecs.upload_keys(seed, event,
                                                               [cid]))
        return payload["q"][0].numpy()

    np.testing.assert_array_equal(q(0, 3, 5), q(0, 3, 5))
    assert (q(0, 3, 5) != q(0, 3, 6)).any()
    assert (q(0, 3, 5) != q(0, 4, 5)).any()
    assert (q(0, 3, 5) != q(1, 3, 5)).any()


# ---------------------------------------------------------------------------
# validation
# ---------------------------------------------------------------------------

def test_stateful_codec_rejects_sequential_seam(ds):
    with pytest.raises(ValueError, match="driver"):
        port_sim_mod.FederatedSimulation(
            port_types.FLConfig(**dict(CFG, strategy="cfl", codec="topk")),
            ds, device="cpu")
    with pytest.raises(ValueError, match="stateful codec"):
        port_scenarios.ScenarioSpec("bad-cfl-topk", "x", strategy="cfl",
                                    topology="sequential", codec="topk")
    with pytest.raises(ValueError, match="unknown codec"):
        port_scenarios.ScenarioSpec("bad-codec", "x", codec="zstd")


def test_codec_defense_validity_is_declared(ds):
    class Narrow(port_codecs.Codec):
        name = "narrow-port-test"
        defenses = ("none",)

    if Narrow.name not in port_codecs.CODEC_REGISTRY:
        port_codecs.register_codec(Narrow)
    with pytest.raises(ValueError, match="does not support defense"):
        port_sim_mod.FederatedSimulation(
            port_types.FLConfig(**dict(CFG, codec=Narrow.name,
                                       defense="median")),
            ds, device="cpu")
    with pytest.raises(ValueError, match="does not support defense"):
        port_scenarios.ScenarioSpec("bad-codec-def", "x", strategy="afl",
                                    topology="star", codec=Narrow.name,
                                    defense="median")
    del port_codecs.CODEC_REGISTRY[Narrow.name]


@pytest.mark.parametrize("name,item", [("comm-qsgd-hfl-fused", "§A.13"),
                                       ("serve-qsgd-signflip-median",
                                        "§A.14")])
def test_fused_and_serving_codec_scenarios_raise_naming_their_slice(
        name, item):
    """The slices these registrations waited for (`item`: the fused
    executor, the serving side-car) have come: the scenario builds its simulation with the qsgd codec on the wire (the
    runs themselves are held to the reference in
    test_torch_fused_docs.py and test_torch_serve.py)."""
    spec = port_scenarios.get(name)
    sim = port_scenarios.resolve(spec, device="cpu")
    assert sim.codec.name == "qsgd" and sim.codec.supports_fused
    assert (sim.fl.engine, sim.fl.serve) == (spec.engine, spec.serve)


def test_codec_registrations_equal_the_reference():
    names = [n for n in ref_scenarios.names()
             if n.startswith("comm-") or n == "serve-qsgd-signflip-median"]
    assert len(names) == 7
    for name in names:
        assert dataclasses.asdict(port_scenarios.get(name)) == \
            dataclasses.asdict(ref_scenarios.get(name)), name
    assert sorted(port_scenarios.CODEC_SCENARIOS) == sorted(
        n for n in names if "fused" not in n and "serve" not in n)


def test_codec_none_is_bitwise_degenerate(ds):
    """codec="none" runs the pre-codec path: no `communication` block,
    results bitwise equal to the default config's."""
    for engine in ("loop", "vectorized"):
        kw = dict(CFG, strategy="afl", engine=engine)
        a = port_sim_mod.FederatedSimulation(
            port_types.FLConfig(**kw), ds, device="cpu").run()
        b = port_sim_mod.FederatedSimulation(
            port_types.FLConfig(**kw, codec="none"), ds, device="cpu").run()
        assert "communication" not in b.extra
        assert a.round_test_acc == b.round_test_acc
        assert a.round_train_loss == b.round_train_loss


# ---------------------------------------------------------------------------
# whole simulations beside the reference
# ---------------------------------------------------------------------------

CODEC_RUNS = {
    "afl-topk": dict(strategy="afl", codec="topk", topk_frac=0.1),
    "afl-qsgd": dict(strategy="afl", codec="qsgd"),
    "hfl-topk": dict(strategy="hfl", codec="topk", topk_frac=0.25),
    "hfl-qsgd": dict(strategy="hfl", codec="qsgd"),
    "cfl-qsgd": dict(strategy="cfl", codec="qsgd"),
    "cfl-qsgd16": dict(strategy="cfl", codec="qsgd", quant_bits=16),
    "afl-qsgd-signflip-median": dict(strategy="afl", codec="qsgd",
                                     attack="sign_flip", attack_scale=4.0,
                                     defense="median"),
}


def _pair(ds, **kw):
    ref = ref_sim_mod.FederatedSimulation(ref_types.FLConfig(**kw), ds)
    init = jax.tree.map(np.asarray, ref.init_params)
    port = port_sim_mod.FederatedSimulation(
        port_types.FLConfig(**kw), ds,
        model_init=lambda g: convert.params_from_jax(init), device="cpu")
    return ref, port


# Each upload may flip one qsgd level or swap one top-k pair (one
# coordinate dropped, one shipped): at most this many round-model
# coordinates per upload so far may exceed the base tolerance (the rule of
# chip_smoke.py's phase 8(b)).
FLIPS_PER_UPLOAD = 2


def _weight(kw):
    """The largest weight one upload carries into the round model. A
    trimmed mean keeping C - 2f of C values moves by at most 1/(C - 2f)
    of what one value moves; the median keeps 1 (odd C) or 2 (even C)."""
    c = kw["num_clients"]
    if kw.get("defense") == "median":
        return 1.0 / (c - 2 * ((c - 1) // 2))
    if kw["strategy"] == "cfl":
        return kw["merge_alpha"]
    return kw["num_groups"] / c if kw["strategy"] == "hfl" else 1 / c


def _level(port, kw):
    """The largest amount one flipped level (qsgd) or one swapped
    boundary coordinate (top-k) of this event can move a round-model
    coordinate: max_c w_c * scale_c, resp. max_c w_c * |delta|_(k)."""
    return _weight(kw) * max(port._seen, default=0.0)


def _watch(port):
    """Record, per encode, the uploads encoded and the size of one
    quantization level (qsgd int8: scale; bf16: 2^-7 of the largest
    |value|) or the k-th largest |delta| (top-k)."""
    port._seen, port._uploads = [], 0
    codec = port.codec
    encode = codec.encode

    def watched(mat, keys, *, base=None, rows=None):
        port._uploads += len(keys)
        payload, new_rows = encode(mat, keys, base=base, rows=rows)
        if "scale" in payload:
            port._seen.append(float(payload["scale"].max()))
        elif "values" in payload:
            port._seen.append(float(payload["values"].abs().min(1)
                                    .values.max()))
        else:
            port._seen.append(float(mat.abs().max()) * 2.0 ** -7)
        return payload, new_rows

    codec.encode = watched


@pytest.mark.parametrize("engine", ["loop", "vectorized"])
@pytest.mark.parametrize("name", sorted(CODEC_RUNS))
def test_event_by_event_parity_with_a_codec(ds, ref_draws, name, engine):
    kw = dict(CFG, engine=engine, merge_alpha=0.5)
    kw.update(CODEC_RUNS[name])
    ref, port = _pair(ds, **kw)
    _watch(port)
    tol = 1e-3 if kw["strategy"] == "hfl" else 1e-4
    rs, ps = ref.strategy.init_state(ref), port.strategy.init_state(port)
    allowance, room, flipped = 0.0, 0, []
    for ev in range(kw["rounds"]):
        port._seen, port._uploads = [], 0
        rs, _, rloss = ref.strategy.run_event(ref, rs, ev)
        ps, _, ploss = port.strategy.run_event(port, ps, ev)
        allowance += _level(port, kw)
        room += FLIPS_PER_UPLOAD * port._uploads
        n_over = 0
        for a, b in zip(jax.tree.leaves(ref.strategy.round_model(rs)),
                        tree_leaves(port.strategy.round_model(ps))):
            a, b = np.asarray(a, np.float64), b.double().numpy()
            err = np.abs(a - b)
            assert (err <= tol + tol * np.abs(a) + allowance).all(), \
                (ev, float(err.max()), allowance)
            n_over += int((err > tol + tol * np.abs(a)).sum())
        assert n_over <= room, (ev, n_over, room)
        flipped.append(n_over)
        np.testing.assert_allclose(np.asarray(ploss, np.float64),
                                   np.asarray(rloss, np.float64),
                                   atol=tol + allowance)
    print(f"{name}/{engine}: coordinates beyond {tol} per event "
          f"{flipped} (at most {room}, allowance {allowance:.3g})")
    assert port._comm_log == ref._comm_log


@pytest.mark.parametrize("name", ["afl-qsgd", "hfl-topk", "cfl-qsgd16"])
def test_run_communication_block_matches_reference(ds, ref_draws, name):
    """Whole runs: the `communication` block equals the reference's key
    for key (analytic bytes), the `codec.uplink_bytes` counter too, and
    the warmup's dry transport leaks neither bytes nor residuals."""
    kw = dict(CFG, engine="vectorized")
    kw.update(CODEC_RUNS[name])
    ref, port = _pair(ds, **kw)
    rr, pr = ref.run(), port.run()
    assert pr.extra["communication"] == rr.extra["communication"]
    assert pr.extra["telemetry"]["counters"]["codec.uplink_bytes"] == \
        rr.extra["telemetry"]["counters"]["codec.uplink_bytes"]
    assert pr.extra["kernel_launches"]["dequant_agg"] == 0
    block = port_scenarios.communication_block(pr)
    assert block["registry_version"] == 1
    assert {k: v for k, v in block.items() if k != "registry_version"} == \
        pr.extra["communication"]


def test_acceptance_pair_communication_block_is_the_recorded_one():
    """The qsgd acceptance run's block is analytic: 32 clients x (7900 +
    4) bytes a round for 12 rounds, equal to the reference's recorded
    block (experiments/comm/acceptance.json) key for key."""
    import json
    from pathlib import Path
    recorded = {d["scenario"]: d["communication"] for d in json.loads(
        (Path(__file__).resolve().parents[1] / "experiments" / "comm"
         / "acceptance.json").read_text())}
    spec = port_scenarios.get("comm-qsgd-accept-32c-vec")
    sim = port_scenarios.resolve(spec, "cpu")
    sim._comm_log = [spec.num_clients] * spec.rounds    # one per round

    class Run:
        extra = {"communication": sim._communication_block()}

    assert port_scenarios.communication_block(Run) == \
        recorded["comm-qsgd-accept-32c-vec"]
    assert recorded["comm-dense-accept-32c-vec"] is None
