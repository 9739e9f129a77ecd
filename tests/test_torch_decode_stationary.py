"""The sharded decode step computes each dense product where its weight is
stored (`specs.still_blocks`, `models.parallel.Stationary`, the `still`
forms of `models.layers`, `models.attention` and `models.ssm`) on the CPU,
under the fsdp profile, reduced configs that cover each form:

* yi-9b: every attention projection cut on its input dim ("rows"), the
  MLP's `wi_gate` / `wi_up` on their output and `wo` on its input over
  one block of hidden columns (one sum an MLP);
* qwen3-32b with 8 heads: `wq` (256 x 512) stored on its output dim
  ("cols"), as the published config's is, its output all-gathered whole;
* zamba2-1.2b with 3 layers (the shared block runs before layer 2) and a
  Mamba2 state of 14: `in_proj` (1068 columns) is cut over the FSDP axes
  only, so the ranks along "model" hold the same block and split the
  batch, and its output goes to the rank's rows by an all-to-all;
  `out_proj` on its input; the Mamba2 state carried over the steps;
* gemma3-4b with 2 heads and a local layer's ring of 2048 positions:
  `wo` (128 x 256) stored on its output dim.

Each runs 6 steps on the ranks of (2, 4), (1, 8) or 2x2x2 from a stand-in
state (`torch_sharded_cases.decode_cut`): (a) the logits within 1e-4 of
the port on one device and the KV caches within 1e-5 of their largest
entry; (b) the logits within 1e-4 of the reference's `decode_step` from
the same params (`convert.params_from_jax`) and state; (c) every
stationary product's leaf gathers 0 bytes, and the forms are the ones
above; (d) per-device collective bytes and FLOPs at most 1.15x the
reference's compiled counts on the same reduced pair, and FLOPs at least
0.99x one device's / 8.

One `launch.mesh.World` of 8 CPU ranks serves the module; one
subprocess with 8 forced host devices compiles the reference's sharded
decode steps for (d), started with the module."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.configs.registry import get_config as ref_get_config  # noqa: E402
from repro.models.model import build_model as ref_build  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.launch import dryrun, mesh  # noqa: E402
from repro_torch.launch import roofline as rl  # noqa: E402
from repro_torch.launch import serve as port_serve  # noqa: E402
from repro_torch.sharding import specs as sh  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

import torch_sharded_cases as cases  # noqa: E402
from test_torch_decode_parallel import (reference_counts,  # noqa: E402
                                        start_reference)

MESHES = {"2x4": ((2, 4), ("data", "model")),
          "1x8": ((1, 8), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
STEPS = 6
LOGIT_TOL, CACHE_TOL = 1e-4, 1e-5
RATIO = (0.99, 1.15)
F32 = dict(dtype="float32", sharding_profile="fsdp")
# name -> (arch, overrides, mesh, B, cap, start, the stationary blocks and
# their products' forms {block: {leaf: (form, the batch split)}})
ATTN_ROWS = {f"{n}/kernel": ("rows", False) for n in ("wq", "wk", "wv",
                                                      "wo")}
MLP = {"wi_gate": ("cols", False), "wi_up": ("cols", False),
       "wo": ("rows", False)}
CASES = {
    "yi-9b 2x4": ("yi-9b", {}, "2x4", 2, 2048, 1021,
                  {"layers/attn": ATTN_ROWS, "layers/mlp": MLP}),
    "qwen3-32b 2x2x2": (
        "qwen3-32b", dict(num_heads=8, num_kv_heads=2), "2x2x2", 2, 2048,
        1021, {"layers/attn": dict(ATTN_ROWS, **{"wq/kernel": (
            "cols", False)}), "layers/mlp": MLP}),
    "zamba2-1.2b 2x4": (
        "zamba2-1.2b", dict(num_layers=3, block_pattern=("mamba",) * 3,
                            ssm_state=14), "2x4", 8, 2048, 1021,
        {"layers/mamba": {"in_proj/kernel": ("cols", True),
                          "out_proj/kernel": ("rows", False)},
         "shared_attn/attn": ATTN_ROWS, "shared_attn/mlp": MLP}),
    "gemma3-4b 1x8": (
        "gemma3-4b", dict(num_heads=2, num_kv_heads=1, global_every=2,
                          sliding_window=2048), "1x8", 2, 4096, 2045,
        {"layers/attn": dict(ATTN_ROWS, **{"wo/kernel": ("cols", False)}),
         "layers/mlp": MLP}),
}


def _kw(case):
    return dict(F32, **CASES[case][1])


@pytest.fixture(scope="module", autouse=True)
def reference_run():
    """The reference's compiles for (d), started before the module's
    other work."""
    proc = start_reference([
        (case, arch, kw, list(MESHES[m][0]), list(MESHES[m][1]), B, cap)
        for case, (arch, kw, m, B, cap, _, _) in sorted(CASES.items())])
    yield proc
    proc.kill()
    proc.communicate()


@pytest.fixture(scope="module")
def reference(reference_run):
    return reference_counts(reference_run)


@pytest.fixture(scope="module")
def world():
    with mesh.World(8, device="cpu", timeout=120) as w:
        yield w


@functools.lru_cache(maxsize=None)
def _inputs(case):
    """(numpy params from the reference's init, tokens (steps, B), the
    port's one-device logits (steps, B, V) and KV caches after the steps
    {path: array}, the reference's logits)."""
    arch, _, _, B, cap, start, _ = CASES[case]
    kw = _kw(case)
    rmodel = ref_build(ref_get_config(arch).reduced(**kw))
    np_params = jax.tree.map(np.asarray, rmodel.init(jax.random.PRNGKey(7)))
    model = cases.build(arch, **kw)
    params = params_from_jax(np_params, "cpu")
    tokens = np.random.default_rng(5).integers(0, model.cfg.vocab_size,
                                               (STEPS, B))
    state = cases.stand_in_state(model, B, cap, start, 1, "cpu")
    rstate = jax.tree.map(lambda t: jnp.asarray(t.numpy()), state)
    step = jax.jit(rmodel.decode_step)
    rparams = jax.tree.map(jnp.asarray, np_params)
    want, ref = [], []
    with torch.no_grad():
        for t in tokens:
            lg, state = model.decode_step(params, state,
                                          torch.as_tensor(t[:, None]))
            want.append(lg[:, 0].numpy())
            rlg, rstate = step(rparams, rstate,
                               jnp.asarray(t[:, None], jnp.int32))
            ref.append(np.asarray(rlg[:, 0]))
    caches = {f"{key}/{i}/{n}": st[n].numpy()
              for key in ("layers", "shared") for i, st in
              enumerate(state.get(key, [])) for n in ("k", "v") if n in st}
    return np_params, tokens, np.stack(want), caches, np.stack(ref)


_RUNS = {}


def _sharded(world, case):
    """The ranks' `decode_cut` outputs of `case`, once a module."""
    if case not in _RUNS:
        arch, _, m, B, cap, start, _ = CASES[case]
        np_params, tokens = _inputs(case)[:2]
        _RUNS[case] = world.run(cases.decode_cut, arch, _kw(case),
                                *MESHES[m], B, cap, start, tokens,
                                params=np_params)
    return _RUNS[case]


@pytest.mark.parametrize("case", sorted(CASES))
def test_stationary_decode_matches_one_device(world, case):
    arch, _, m, B, cap, _, _ = CASES[case]
    want, caches = _inputs(case)[2:4]
    model = cases.build(arch, **_kw(case))
    specs = model.decode_state_specs(B, cap)
    st_sh = port_serve.decode_state_shardings(specs, sh.MeshShape(
        *MESHES[m]), model.cfg)
    stored = {p: s.indices_map(tuple(x.shape)) for (p, x), s in zip(
        tree_leaves(sh._paths(specs)), tree_leaves(st_sh))}
    for r, ((a, b), logits, (names, shipped), rep) in enumerate(
            _sharded(world, case)):
        np.testing.assert_allclose(logits, want[:, a:b], rtol=0,
                                   atol=LOGIT_TOL)
        assert sorted(names) == sorted(caches), names
        for name, got in zip(names, cases.load(shipped)):
            whole = caches[name]
            np.testing.assert_allclose(
                got, whole[stored[name][r]], rtol=0,
                atol=CACHE_TOL * max(1.0, float(np.abs(whole).max())))
        assert rep["repeat_bitwise"] and rep["cache_in_place"], rep


@pytest.mark.parametrize("case", sorted(CASES))
def test_stationary_decode_matches_the_reference(world, case):
    ref = _inputs(case)[4]
    for (a, b), logits, _, _ in _sharded(world, case):
        np.testing.assert_allclose(logits, ref[:, a:b], rtol=0,
                                   atol=LOGIT_TOL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_stationary_leaves_gather_nothing(world, case):
    forms = CASES[case][6]
    for _, _, _, rep in _sharded(world, case):
        assert rep["stills"] == forms, rep["stills"]
        for block, leaves in forms.items():
            for leaf in leaves:
                assert rep["gathered_bytes"][f"{block}/{leaf}"] == 0, leaf
        kinds = rep["collectives"]["kinds"]
        # the partial products' sums; Mamba2's regroup to the rank's rows
        assert kinds.get("all-reduce", 0) > 0, kinds
        assert ("all-to-all" in kinds) == ("layers/mamba" in forms), kinds


def _port_counts(arch, kw, shape, B, cap):
    cfg = get_config(arch).reduced(**kw).with_updates(scan_layers=False)
    return dryrun.run_step(cfg, "decode", B, cap, sh.MeshShape(*shape))


@pytest.mark.parametrize("case", sorted(CASES))
def test_stationary_counts_meet_the_reference(reference, case):
    arch, _, m, B, cap, _, _ = CASES[case]
    got = _port_counts(arch, _kw(case), MESHES[m], B, cap)
    one = _port_counts(arch, _kw(case), ((1, 1), ("data", "model")), B,
                       cap)["flops"]
    coll = rl.collective_bytes(got["counts"])["total"]
    want = reference[case]
    assert got["flops"] <= RATIO[1] * want["flops"], (got["flops"], want)
    assert 8 * got["flops"] >= RATIO[0] * one, (got["flops"], one)
    assert coll <= RATIO[1] * want["collective_bytes"], (coll, want)
