"""The sharded decode step keeps its KV caches cut as
`decode_state_shardings` stores them (`launch.serve.make_sharded_serve_step`,
`models.parallel.KVCut`, `models.attention`'s `kv` form) on the CPU: yi-9b
reduced (4 heads, 4 kv heads, head_dim 64, 2 layers) under the fsdp
profile it ships with, B = 2, a stand-in cache of 2048 positions filled
from a numpy seed, 6 steps from index 1021, across position 1024.

* (2, 4): rows over "data", the caches cut by kv heads over "model";
  (1, 8): every rank the same rows, the caches cut by position over
  "model" (256 positions a rank, the write crossing from rank 3's block to
  rank 4's); 2x2x2: rows over "pod", heads over "model", and the two
  "data" ranks that hold the same block split its positions.
* (a) every step's logits within 1e-4 of the port on one device, the
  caches after the steps within 1e-5 of their largest entry, the slots
  no step wrote bit for bit (one row's projection rounds otherwise than
  two rows' on the CPU: 2.9e-6 of 5.39 at layer 0); (b) the logits
  within 1e-4 of the reference's `decode_step` from the same params
  (`convert`) and caches;
  (c) every state leaf keeps its stored shard's shape, each cache is
  written where it lies (the same tensor every step: nothing gathered
  it), and a repeat gives the same bits; (d) per-device FLOPs at most
  1.15x the reference's compiled count and at least 0.99x one device's
  / 8; (e) the full-size dry-run of yi-9b long_500k on 16x16 (meta
  device) against the reference's counts
  (`tests/fixtures/reference_decode.json`, which
  `tests/torch_reference_decode.py` writes).
* gemma3-4b reduced on (1, 8) with a local layer's ring of 2048 positions
  and a global layer's 4096 both cut by position: 6 steps from index
  2045 wrap the ring from rank 7's block to rank 0's, against one device.

One `launch.mesh.World` of 8 CPU ranks serves the module (the ranks run
`torch_sharded_cases.decode_cut`); one subprocess with 8 fake devices
compiles the reference's sharded decode for (d), started with the
module (`start_reference`, which `test_torch_decode_stationary.py`
shares)."""
import functools
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.configs.registry import get_config as ref_get_config  # noqa: E402
from repro.models.model import build_model as ref_build  # noqa: E402
from repro_torch.configs.base import INPUT_SHAPES  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.device import generator  # noqa: E402
from repro_torch.launch import dryrun, mesh  # noqa: E402
from repro_torch.launch import serve as port_serve  # noqa: E402
from repro_torch.sharding import specs as sh  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

import torch_sharded_cases as cases  # noqa: E402
from test_torch_tensor_parallel import SRC  # noqa: E402

ARCH = "yi-9b"
KW = dict(dtype="float32", sharding_profile="fsdp")
B, CAP, START, STEPS = 2, 2048, 1021, 6
MESHES = {"2x4": ((2, 4), ("data", "model")),
          "1x8": ((1, 8), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
# the caches: of their largest |entry| (the slots no step wrote bit for
# bit); the new entries come through sums over "model" in another order
# than one device's (up to 1.05e-6 of it here), a misplaced write is O(1)
LOGIT_TOL, CACHE_TOL = 1e-4, 1e-5
RATIO = (0.99, 1.15)
# the reference's compiled decode counts at full size, a device
# (tests/torch_reference_decode.py writes them)
FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "reference_decode.json")


def reference_line(arch, shape, mesh):
    """The fixture's record of `arch` at `shape` on `mesh` ("16x16")."""
    with open(FIXTURE) as f:
        lines = json.load(f)["lines"]
    return next(r for r in lines if (r["arch"], r["shape"], r["mesh"])
                == (arch, shape, mesh))


# yi-9b long_500k on 16x16 under fsdp, a device: FLOPs and peak bytes
_LONG = reference_line("yi-9b", "long_500k", "16x16")
REF_LONG_500K = (_LONG["flops"], _LONG["peak_bytes"])

# the reference's sharded decode compiled for each job (name, arch, the
# reduced config's overrides, mesh shape, axis names, B, cap) on 8 forced
# host devices under fsdp: {name: {"flops", "collective_bytes"}}, a
# device
_REFERENCE_DECODE = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import sys, json
    sys.path.insert(0, {src!r})
    import jax
    from repro.configs.registry import get_config
    from repro.launch import mesh as mesh_mod, roofline as rl
    from repro.launch import serve as sm
    from repro.models.model import build_model
    from repro.sharding import specs as sh

    def sds(tree, shardings):
        return jax.tree.map(lambda l, s: jax.ShapeDtypeStruct(
            l.shape, l.dtype, sharding=s), tree, shardings)

    out = {{}}
    for name, arch, kw, shape, names, B, cap in {jobs!r}:
        mesh = jax.make_mesh(tuple(shape), tuple(names),
                             **mesh_mod.axis_types_kw(len(shape)))
        cfg = get_config(arch).reduced(**kw).with_updates(
            sharding_profile="fsdp", scan_layers=False)
        sh.set_profile("fsdp")
        sh.set_seq_shardable(set(cfg.layer_kinds()) == {{"attn"}})
        model = build_model(cfg)
        ps = jax.eval_shape(model.init, jax.random.PRNGKey(0))
        st = model.decode_state_specs(B, cap)
        tok = model.decode_token_specs(B)
        args = (sds(ps, sh.tree_shardings(ps, mesh)),
                sds(st, sm.decode_state_shardings(st, mesh, cfg)),
                jax.ShapeDtypeStruct(tok.shape, tok.dtype,
                                     sharding=sm.token_shardings(tok, mesh)))
        with mesh_mod.activate_mesh(mesh):
            compiled = jax.jit(sm.make_serve_step(model),
                               donate_argnums=(1,)).lower(*args).compile()
        roof = rl.analyze(compiled, 8)
        out[name] = {{"flops": roof.flops_per_device,
                      "collective_bytes": roof.collective_bytes_per_device}}
    print(json.dumps(out))
""")


def start_reference(jobs):
    """The reference's compile of `jobs` (`_REFERENCE_DECODE`) in a
    subprocess."""
    return subprocess.Popen(
        [sys.executable, "-c", _REFERENCE_DECODE.format(src=SRC, jobs=jobs)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def reference_counts(proc):
    out, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-3000:]
    return json.loads(out.strip().splitlines()[-1])


@pytest.fixture(scope="module", autouse=True)
def reference_run():
    """The reference's compile for (d), started before the module's
    other work."""
    proc = start_reference([(name, ARCH, {}, list(shape), list(names), B,
                             CAP) for name, (shape, names)
                            in sorted(MESHES.items())])
    yield proc
    proc.kill()
    proc.communicate()


@pytest.fixture(scope="module")
def reference_flops(reference_run):
    return {k: v["flops"] for k, v in reference_counts(reference_run).items()}


@pytest.fixture(scope="module")
def world():
    with mesh.World(8, device="cpu", timeout=120) as w:
        yield w


@functools.lru_cache(maxsize=None)
def _inputs():
    """(numpy params from the reference's init, tokens (steps, B), the
    port's one-device logits (steps, B, V) and caches after the steps
    {path: array}, the reference's logits)."""
    rmodel = ref_build(ref_get_config(ARCH).reduced(**KW))
    np_params = jax.tree.map(np.asarray, rmodel.init(jax.random.PRNGKey(7)))
    model = cases.build(ARCH, **KW)
    params = params_from_jax(np_params, "cpu")
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, model.cfg.vocab_size, (STEPS, B))
    state = cases.stand_in_state(model, B, CAP, START, 1, "cpu")
    rstate = {"index": jnp.asarray(START, jnp.int32),
              "layers": [{n: jnp.asarray(st[n].numpy()) for n in ("k", "v")}
                         for st in state["layers"]]}
    want, ref = [], []
    step = jax.jit(rmodel.decode_step)
    with torch.no_grad():
        for t in tokens:
            tok = torch.as_tensor(t[:, None])
            lg, state = model.decode_step(params, state, tok)
            want.append(lg[:, 0].numpy())
            rlg, rstate = step(jax.tree.map(jnp.asarray, np_params), rstate,
                               jnp.asarray(t[:, None], jnp.int32))
            ref.append(np.asarray(rlg[:, 0]))
    caches = {f"layers/{i}/{n}": st[n].numpy()
              for i, st in enumerate(state["layers"]) for n in ("k", "v")}
    return np_params, tokens, np.stack(want), caches, np.stack(ref)


_RUNS = {}


def _sharded(world, case):
    """The ranks' `decode_cut` outputs on MESHES[case], once a module."""
    if case not in _RUNS:
        np_params, tokens = _inputs()[:2]
        _RUNS[case] = world.run(cases.decode_cut, ARCH, KW, *MESHES[case],
                                B, CAP, START, tokens, params=np_params)
    return _RUNS[case]


def _stored(case):
    """State path -> (global shape, its rank -> slice map)."""
    shape = sh.MeshShape(*MESHES[case])
    model = cases.build(ARCH, **KW)
    specs = model.decode_state_specs(B, CAP)
    st_sh = port_serve.decode_state_shardings(specs, shape, model.cfg)
    return {p: (tuple(x.shape), s.indices_map(tuple(x.shape)))
            for (p, x), s in zip(tree_leaves(sh._paths(specs)),
                                 tree_leaves(st_sh))}


@pytest.mark.parametrize("case", sorted(MESHES))
def test_sharded_decode_matches_one_device(world, case):
    want, caches = _inputs()[2:4]
    stored = _stored(case)
    for r, ((a, b), logits, (names, shipped), _) in enumerate(
            _sharded(world, case)):
        np.testing.assert_allclose(logits, want[:, a:b], rtol=0,
                                   atol=LOGIT_TOL)
        assert sorted(names) == sorted(caches), names
        for name, got in zip(names, cases.load(shipped)):
            want_c = caches[name][stored[name][1][r]]
            scale = max(1.0, float(np.abs(caches[name]).max()))
            np.testing.assert_allclose(got, want_c, rtol=0,
                                       atol=CACHE_TOL * scale)
            # the slots no step wrote are the stand-in's, bit for bit
            pos = stored[name][1][r][1].start + np.arange(got.shape[1])
            kept = (pos < START) | (pos >= START + STEPS)
            np.testing.assert_array_equal(got[:, kept], want_c[:, kept])


@pytest.mark.parametrize("case", sorted(MESHES))
def test_sharded_decode_matches_the_reference(world, case):
    ref = _inputs()[4]
    for (a, b), logits, _, _ in _sharded(world, case):
        np.testing.assert_allclose(logits, ref[:, a:b], rtol=0,
                                   atol=LOGIT_TOL)


# each mesh's cut of the caches: (kind, positions a rank attends over, the
# query heads it attends with)
CUTS = {"2x4": ("heads", CAP, 1), "1x8": ("seq", CAP // 8, 4),
        "2x2x2": ("heads", CAP // 2, 2)}


@pytest.mark.parametrize("case", sorted(MESHES))
def test_caches_stay_cut_where_they_are_stored(world, case):
    kind, span, heads = CUTS[case]
    offsets = set()
    for _, _, _, rep in _sharded(world, case):
        assert rep["cache_in_place"] and rep["repeat_bitwise"], rep
        assert set(rep["cut"]) == {"attn", "mlp", "vocab"}, rep["cut"]
        assert sorted(rep["caches"]) == ["layers/0", "layers/1"]
        for k, offset, (lo, n), (q0, hl) in rep["caches"].values():
            assert (k, n, hl) == (kind, span, heads), rep["caches"]
            offsets.add(offset + lo)
        assert rep["collectives"]["kinds"].get("all-reduce", 0) > 0
    # the ranks' spans cover the positions
    assert sorted(offsets) == list(range(0, CAP, span)), offsets


# gemma3-4b reduced with a global layer after a local one whose ring of
# 2048 positions is cut by position too: 6 steps from index 2045 wrap it
RING = ("gemma3-4b", dict(KW, global_every=2, sliding_window=2048), 4096,
        2045)


def test_sharded_ring_decode_matches_one_device(world):
    arch, kw, cap, start = RING
    model = cases.build(arch, **kw)
    params = model.init(generator(0), "cpu")
    tokens = np.random.default_rng(5).integers(0, model.cfg.vocab_size,
                                               (STEPS, B))
    state = cases.stand_in_state(model, B, cap, start, 1, "cpu")
    want = []
    with torch.no_grad():
        for t in tokens:
            lg, state = model.decode_step(params, state,
                                          torch.as_tensor(t[:, None]))
            want.append(lg[:, 0].numpy())
    want = np.stack(want)
    outs = world.run(cases.decode_cut, arch, kw, *MESHES["1x8"], B, cap,
                     start, tokens)
    for r, ((a, b), logits, (names, shipped), rep) in enumerate(outs):
        np.testing.assert_allclose(logits, want[:, a:b], rtol=0,
                                   atol=LOGIT_TOL)
        # the ring's block and the global cache's, by position
        assert [rep["caches"][k][:3] for k in ("layers/0", "layers/1")] == [
            ("seq", 256 * r, (0, 256)), ("seq", 512 * r, (0, 512))]
        for name, got in zip(names, cases.load(shipped)):
            i, n = name.split("/")[1:]
            whole = state["layers"][int(i)][n].numpy()
            blk = got.shape[1]
            np.testing.assert_allclose(
                got, whole[:, r * blk:(r + 1) * blk], rtol=0,
                atol=CACHE_TOL * max(1.0, float(np.abs(whole).max())))


def _port_flops(shape, kind="decode", batch=B, cap=CAP, arch=ARCH,
                reduced=True):
    cfg = get_config(arch)
    cfg = (cfg.reduced().with_updates(scan_layers=False) if reduced
           else dryrun._apply_overrides(cfg, None))
    return dryrun.run_step(cfg, kind, batch, cap, sh.MeshShape(*shape))


@pytest.mark.parametrize("case", sorted(MESHES))
def test_per_device_flops_match_the_reference(reference_flops, case):
    got = _port_flops(MESHES[case])["flops"]
    want = reference_flops[case]
    one = _port_flops(((1, 1), ("data", "model")))["flops"]
    assert got <= RATIO[1] * want, (case, got, want)
    assert 8 * got >= RATIO[0] * one, (case, got, one)


def test_full_size_long_500k_dry_run_meets_the_reference():
    shape = INPUT_SHAPES["long_500k"]
    mesh16 = ((16, 16), ("data", "model"))
    got = _port_flops(mesh16, batch=shape.global_batch, cap=shape.seq_len,
                      reduced=False)
    one = _port_flops(((1, 1), ("data", "model")), batch=shape.global_batch,
                      cap=shape.seq_len, reduced=False)["flops"]
    flops, peak = REF_LONG_500K
    assert got["flops"] <= RATIO[1] * flops, got["flops"]
    assert 256 * got["flops"] >= RATIO[0] * one, (got["flops"], one)
    assert got["argument_bytes"] + got["temp_bytes"] <= RATIO[1] * peak, got
