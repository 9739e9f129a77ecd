"""The decode state's sharding rules and the sharded prefill and decode
steps (`repro_torch.launch.serve`'s mesh half) on the CPU.

* `decode_state_shardings` gives the reference's leaf rules of
  tests/test_sharding_and_dryrun.py:184-208 (heads over "model" where
  they divide, else the cache sequence when longer than 1024; the layer
  dim of a 5-D stacked cache never sharded; batch only on a mesh with no
  "model" axis), and equals the reference's function, leaf by leaf, over
  every zoo config's reduced decode state (B = 8, capacity 2048) on a 4x2
  and a 2x2x2 mesh, as does `token_shardings` (the reference's in a
  subprocess with 8 fake devices).
* `make_sharded_prefill_step` and `make_sharded_serve_step` on 8 gloo
  ranks laid out (data 4, model 2) equal the single-device prefill and
  decode within 1e-5 (zamba2 under "fsdp", its rows over both axes; yi-9b
  under "tp" with 2 KV heads, the caches' heads over "model"; reduced,
  float32, plain attention: the flash and scan kernels run only on the
  card); and, from the reference's init, the reference's prefill and
  decode run under its `NamedSharding`s on 8 fake devices (params by
  `tree_shardings`, tokens by `batch_shardings` / `token_shardings`, the
  state by `decode_state_shardings`), row for row within 1e-5.
* Under "tp" each rank computes its "model" shard of every layer
  (`models.parallel`), its logits its vocabulary columns: zamba2 (Mamba2's
  heads over "model" in the prefill, whole in decode), qwen3-moe (experts
  over "model") and yi-9b with one KV head (no cache cut by heads: every
  rank computes the whole new K/V and attends with the head it reads)
  equal the single-device prefill and decode within 1e-5.

One `launch.mesh.World` of 8 CPU ranks serves the module; the ranks run
`torch_sharded_cases.serve`."""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.configs.registry import ARCH_IDS, get_config  # noqa: E402
from repro_torch.convert import params_to_numpy  # noqa: E402
from repro_torch.device import generator  # noqa: E402
from repro_torch.launch import mesh  # noqa: E402
from repro_torch.launch import serve as port_serve  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.sharding import specs as sh  # noqa: E402
from repro_torch.tree import tree_leaves, tree_unflatten  # noqa: E402

import torch_sharded_cases as cases  # noqa: E402

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
TOL = 1e-5
B, CAP = 8, 2048
MESHES = {"4x2": ((4, 2), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}


def _spec(ns, ndim):
    spec = [list(e) if isinstance(e, tuple) else e for e in ns.spec]
    return spec + [None] * (ndim - len(spec))


def test_decode_state_leaf_rules():
    """The reference test's leaves and expected specs."""
    f32 = torch.float32
    leaves = {
        "kv_div": torch.empty((2, 2048, 8, 16), dtype=f32, device="meta"),
        "kv_nondiv": torch.empty((2, 2048, 6, 16), dtype=f32, device="meta"),
        "kv_short": torch.empty((2, 64, 6, 16), dtype=f32, device="meta"),
        "conv": torch.empty((2, 3, 8), dtype=f32, device="meta"),
        "stack_div": torch.empty((4, 2, 2048, 8, 16), dtype=f32,
                                 device="meta"),
        "stack_nondiv": torch.empty((4, 2, 2048, 6, 16), dtype=f32,
                                    device="meta"),
        "index": 7,
    }

    def dump(m):
        got = port_serve.decode_state_shardings(leaves, m, None)
        return {k: _spec(got[k], getattr(v, "ndim", 0))
                for k, v in leaves.items()}

    model_mesh = dump(sh.MeshShape((2, 4), ("data", "model")))
    assert model_mesh == {
        "kv_div": ["data", None, "model", None],
        "kv_nondiv": ["data", "model", None, None],
        "kv_short": ["data", None, None, None],
        "conv": ["data", None, "model"],
        "stack_div": [None, "data", None, "model", None],
        "stack_nondiv": [None, "data", "model", None, None],
        "index": [],
    }
    data_mesh = dump(sh.MeshShape((8,), ("data",)))
    assert data_mesh["kv_div"] == [None, None, None, None]
    assert data_mesh["conv"] == [None, None, None]
    for spec in data_mesh.values():
        assert "model" not in spec


_REFERENCE = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import sys, json
    sys.path.insert(0, {src!r})
    import jax
    from repro.configs.registry import ARCH_IDS, get_config
    from repro.launch import mesh as mesh_mod
    from repro.launch.serve import decode_state_shardings, token_shardings
    from repro.models.model import build_model

    def spec(ns, ndim):
        s = [list(e) if isinstance(e, tuple) else e for e in ns.spec]
        return s + [None] * (ndim - len(s))

    meshes = {{"4x2": jax.make_mesh((4, 2), ("data", "model"),
                                    **mesh_mod.axis_types_kw(2)),
               "2x2x2": jax.make_mesh((2, 2, 2), ("pod", "data", "model"),
                                      **mesh_mod.axis_types_kw(3))}}
    res = {{}}
    for arch in ARCH_IDS:
        cfg = get_config(arch).reduced()
        model = build_model(cfg)
        st = model.decode_state_specs({B}, {CAP})
        tok = model.decode_token_specs({B})
        flat, _ = jax.tree_util.tree_flatten_with_path(st)
        for name, mesh in meshes.items():
            shs = jax.tree.leaves(decode_state_shardings(st, mesh, cfg))
            res[arch + "/" + name] = {{
                "state": {{"/".join(str(getattr(q, "key", getattr(q, "idx",
                                                                   q)))
                                    for q in path): spec(s, l.ndim)
                          for (path, l), s in zip(flat, shs)}},
                "tokens": spec(token_shardings(tok, mesh), tok.ndim)}}
    print(json.dumps(res))
""")


@pytest.fixture(scope="module")
def reference_decode_shardings():
    code = _REFERENCE.format(src=SRC, B=B, CAP=CAP)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_decode_state_shardings_match_the_reference(
        reference_decode_shardings, arch, mesh_name):
    want = reference_decode_shardings[f"{arch}/{mesh_name}"]
    cfg = get_config(arch).reduced()
    model = build_model(cfg)
    m = sh.MeshShape(*MESHES[mesh_name])
    st = model.decode_state_specs(B, CAP)
    shs = port_serve.decode_state_shardings(st, m, cfg)
    got = {path: _spec(s, getattr(x, "ndim", 0)) for (path, x), s in
           zip(tree_leaves(sh._paths(st)), tree_leaves(shs))}
    assert got == want["state"]
    tok = model.decode_token_specs(B)
    assert _spec(port_serve.token_shardings(tok, m), tok.ndim) == \
        want["tokens"]


# -- the sharded steps on 8 ranks -----------------------------------------------

@pytest.fixture(scope="module")
def world():
    with mesh.World(8, device="cpu", timeout=120) as w:
        yield w


STEP_CASES = {
    "zamba2-1.2b": dict(dtype="float32", sharding_profile="fsdp"),
    "yi-9b": dict(dtype="float32", num_kv_heads=2, sharding_profile="tp"),
}


@pytest.mark.parametrize("arch", sorted(STEP_CASES))
def test_sharded_prefill_and_decode_match_single_device(world, arch):
    kw = STEP_CASES[arch]
    model = cases.build(arch, **kw)
    params = model.init(generator(0), "cpu")
    tokens = torch.randint(0, model.cfg.vocab_size, (B, 64),
                           generator=generator(1))
    with torch.no_grad():
        logits = port_serve.make_prefill_step(model)(params,
                                                     {"tokens": tokens})
        steps = 6
        state = model.init_decode_state(B, steps, device="cpu")
        want = []
        for i in range(steps):
            lg, state = model.decode_step(params, state, tokens[:, i:i + 1])
            want.append(lg[:, 0])
    want = torch.stack(want).numpy()
    outs = world.run(cases.serve, arch, kw, *MESHES["4x2"], tokens.numpy(),
                     steps, params=params_to_numpy(params))
    rows = sorted({o[0] for o in outs})
    for (a, b), lg, (c, d), dec, report in outs:
        np.testing.assert_allclose(cases.load(lg)[0], logits[a:b].numpy(),
                                   rtol=0, atol=TOL)
        np.testing.assert_allclose(dec, want[:, c:d], rtol=0, atol=TOL)
        assert report["collectives"]["kinds"].get("all-gather", 0) > 0
        assert not any(report["launches"].values())
    # fsdp lays zamba2's prefill rows over both axes; tp over "data" only
    assert len(rows) == (8 if arch == "zamba2-1.2b" else 4)


# -- against the reference's sharded prefill and decode ----------------------

SERVE_STEPS = 6

_REFERENCE_SERVE = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import sys
    sys.path.insert(0, {src!r})
    import jax
    import numpy as np
    from repro.configs.registry import get_config
    from repro.launch import mesh as mesh_mod
    from repro.launch.serve import (decode_state_shardings,
                                    make_prefill_step, make_serve_step,
                                    token_shardings)
    from repro.launch.train import batch_shardings
    from repro.models.model import build_model
    from repro.sharding import specs as sh

    mesh = jax.make_mesh((4, 2), ("data", "model"),
                         **mesh_mod.axis_types_kw(2))
    out = {{}}
    for arch, kw in {cases!r}.items():
        cfg = get_config(arch).reduced(**kw)
        model = build_model(cfg)
        tokens = np.random.default_rng(1).integers(
            0, cfg.vocab_size, ({B}, 64)).astype(np.int32)
        params = model.init(jax.random.PRNGKey(7))
        with sh.profile_ctx(cfg.sharding_profile):
            params = jax.device_put(params, sh.tree_shardings(params, mesh))
            batch = {{"tokens": tokens}}
            batch = jax.device_put(batch, batch_shardings(batch, mesh))
            logits = jax.jit(make_prefill_step(model))(params, batch)
            state = model.init_decode_state({B}, {steps})
            state = jax.device_put(state, decode_state_shardings(
                state, mesh, cfg))
            step = jax.jit(make_serve_step(model))
            dec = []
            for i in range({steps}):
                tok = jax.device_put(tokens[:, i:i + 1], token_shardings(
                    jax.ShapeDtypeStruct(({B}, 1), np.int32), mesh))
                lg, state = step(params, state, tok)
                dec.append(np.asarray(lg[:, 0]))
        flat = jax.tree.leaves(jax.tree.map(np.asarray, params))
        np.savez(os.path.join({out!r}, arch + ".npz"),
                 tokens=tokens, logits=np.asarray(logits),
                 decode=np.stack(dec),
                 **{{f"p{{i}}": x for i, x in enumerate(flat)}})
""")


@pytest.fixture(scope="module")
def reference_serve(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("reference_serve"))
    code = _REFERENCE_SERVE.format(src=SRC, B=B, steps=SERVE_STEPS, out=out,
                                   cases=STEP_CASES)
    run = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    return out


@pytest.mark.parametrize("arch", sorted(STEP_CASES))
def test_sharded_prefill_and_decode_match_the_reference(world,
                                                        reference_serve,
                                                        arch):
    kw = STEP_CASES[arch]
    with np.load(os.path.join(reference_serve, arch + ".npz")) as f:
        ref = {k: f[k] for k in f.files}
    model = cases.build(arch, **kw)
    # the reference's params in its tree order, as `params_from_jax` takes
    # them: the port's tree of the same leaves
    names = sorted((k for k in ref if k.startswith("p")),
                   key=lambda k: int(k[1:]))
    spec = model.param_specs()
    leaves = [ref[k] for k in names]
    assert [tuple(x.shape) for x in leaves] == [
        tuple(x.shape) for x in tree_leaves(spec)]
    params = tree_unflatten(spec, leaves)
    outs = world.run(cases.serve, arch, kw, *MESHES["4x2"], ref["tokens"],
                     SERVE_STEPS, params=params)
    for (a, b), lg, (c, d), dec, _ in outs:
        np.testing.assert_allclose(cases.load(lg)[0], ref["logits"][a:b],
                                   rtol=0, atol=TOL)
        np.testing.assert_allclose(dec, ref["decode"][:, c:d], rtol=0,
                                   atol=TOL)


TP_CASES = {
    "zamba2-1.2b": ("zamba2-1.2b", dict(dtype="float32",
                                        sharding_profile="tp"),
                    {"mamba", "vocab"}),
    "qwen3-moe-30b-a3b": ("qwen3-moe-30b-a3b",
                          dict(dtype="float32", sharding_profile="tp"),
                          {"attn", "moe", "vocab"}),
    "yi-9b-kv1": ("yi-9b", dict(dtype="float32", num_kv_heads=1,
                                sharding_profile="tp"),
                  {"attn", "mlp", "vocab"}),
}


@pytest.mark.parametrize("case", sorted(TP_CASES))
def test_tensor_parallel_prefill_and_decode_match_single_device(world, case):
    arch, kw, want_cut = TP_CASES[case]
    model = cases.build(arch, **kw)
    params = model.init(generator(0), "cpu")
    tokens = torch.randint(0, model.cfg.vocab_size, (B, 64),
                           generator=generator(2))
    steps = 4
    with torch.no_grad():
        logits = port_serve.make_prefill_step(model)(params,
                                                     {"tokens": tokens})
        state = model.init_decode_state(B, steps, device="cpu")
        want = []
        for i in range(steps):
            lg, state = model.decode_step(params, state, tokens[:, i:i + 1])
            want.append(lg[:, 0])
    want = torch.stack(want).numpy()
    outs = world.run(cases.serve, arch, kw, *MESHES["4x2"], tokens.numpy(),
                     steps, params=params_to_numpy(params))
    for (a, b), lg, (c, d), dec, report in outs:
        np.testing.assert_allclose(cases.load(lg)[0], logits[a:b].numpy(),
                                   rtol=0, atol=TOL)
        np.testing.assert_allclose(dec, want[:, c:d], rtol=0, atol=TOL)
        assert set(report["cut"]) == want_cut, report["cut"]
        assert report["collectives"]["kinds"].get("all-reduce", 0) > 0
