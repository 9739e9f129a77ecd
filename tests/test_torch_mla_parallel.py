"""MLA cut by heads over "model" (`models.mla`'s `tp` form, the MLA layouts
of `specs.compute_layout`) on the CPU: the tp profile, and the multi-pod
moe profile that deepseek-v2-lite ships with.

* `mla_attention` (einsum and chunked) and the absorbed `mla_decode` with
  2 ranks along "model" against whole MLA: the output, the input's
  gradient and the parameters' gradients within 1e-5; the decode output
  and caches (every rank writes the same latent entry).
* The MLA leaves' compute layouts line up with the reference's specs
  (`repro.sharding.specs`): under "tp" the rank's heads' columns of
  `wq` / `w_uk` / `w_uv` and rows of `wo` are the blocks the reference
  stores over "model"; under multi-pod "moe" they cover every head once;
  `w_dkv` and `w_kpe` are whole with partial gradients.
* `make_sharded_train_step` for deepseek-v2-lite reduced under "moe" on
  2x2x2 and under "tp" on 4x2 against the reference's `make_train_step`
  from its init: loss and grad-norm within 1e-5 relative, SGD params
  within 1e-6; every rank ran MLA cut.
* The sharded prefill and decode on both meshes against one device
  within 1e-5.
* The dry-run at full width, cut to 2 layers, train_4k on 2x16x16 under
  the shipped moe profile (meta device): 512 x the per-device FLOPs
  within 0.99-1.15x the one-device step's (8 rows x 4096, x 32): before
  MLA was cut it read 3.436.

One `launch.mesh.World` of 8 CPU ranks serves the module; the ranks run
`torch_sharded_cases`."""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.configs.registry import get_config as ref_get_config  # noqa: E402
from repro.launch import train as ref_train  # noqa: E402
from repro.models.model import build_model as ref_build  # noqa: E402
from repro.optim import optimizers as ref_opt  # noqa: E402
from repro.sharding import specs as ref_specs  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.convert import params_to_numpy  # noqa: E402
from repro_torch.device import generator  # noqa: E402
from repro_torch.launch import dryrun, mesh  # noqa: E402
from repro_torch.launch import serve as port_serve  # noqa: E402
from repro_torch.models import mla  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.sharding import specs as sh  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

import torch_sharded_cases as cases  # noqa: E402

ARCH = "deepseek-v2-lite-16b"
MESHES = {"moe-2x2x2": ((2, 2, 2), ("pod", "data", "model")),
          "tp-4x2": ((4, 2), ("data", "model"))}
B, S = 8, 64
REL, PARAM_ATOL, TOL = 1e-5, 1e-6, 1e-5
RATIO = (0.99, 1.15)


@pytest.fixture(scope="module")
def world():
    with mesh.World(8, device="cpu", timeout=120) as w:
        yield w


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=TOL * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("impl", ["einsum", "chunked"])
def test_mla_cut_by_heads_matches_whole(world, impl):
    kw = dict(dtype="float32", attn_impl=impl, attn_chunk=16)
    cfg = build_model(get_config(ARCH).reduced(**kw)).cfg
    params = mla.init_mla(generator(0), cfg)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    w = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    cap, index = 8, 5
    ckv = rng.standard_normal((2, cap, 1, cfg.kv_lora_rank)).astype(
        np.float32)
    kpe = rng.standard_normal((2, cap, 1, cfg.qk_rope_dim)).astype(
        np.float32)
    p = tree_map(lambda v: v.clone().requires_grad_(True), params)
    xt = torch.tensor(x, requires_grad=True)
    positions = torch.arange(S, dtype=torch.int32)[None].expand(2, S)
    out = mla.mla_attention(p, cfg, xt, positions=positions)
    (out * torch.tensor(w)).sum().backward()
    with torch.no_grad():
        c, k = torch.tensor(ckv), torch.tensor(kpe)
        dec, c, k = mla.mla_decode(
            params, cfg, xt[:, :1].detach(), positions=torch.full(
                (2, 1), index, dtype=torch.int32), c_kv_cache=c,
            k_pe_cache=k, cache_index=torch.tensor(index))
    outs = world.run(cases.tp_mla, ARCH, kw, params_to_numpy(params), x, w,
                     ckv, kpe, index)
    for got in outs:
        _close(got["out"], out.detach())
        _close(got["x_grad"], xt.grad)
        for name, lay in got["layouts"].items():
            want = p[name]["kernel"].grad
            kind, dim, ranges, partial = lay
            assert partial, (name, lay)
            if dim is not None:
                idx = [slice(None)] * want.dim()
                idx[dim] = slice(*ranges[0])
                want = want[tuple(idx)]
            _close(got["grads"][name], want)
        _close(got["decode"], dec)
        _close(got["ckv"], c)
        _close(got["kpe"], k)
        # every rank wrote the same latent and rotary entry
        np.testing.assert_array_equal(got["ckv"], outs[0]["ckv"])
        np.testing.assert_array_equal(got["kpe"], outs[0]["kpe"])
        # f's backward and wo's g: all-reduces over "model", no gather
        assert set(got["kinds"]) == {"all-reduce"}, got["kinds"]
    kinds = {n: lay[0] for n, lay in outs[0]["layouts"].items()}
    assert kinds == {"wq": "column", "w_uk": "column", "w_uv": "column",
                     "wo": "row", "w_dkv": "whole", "w_kpe": "whole"}
    # the two ranks' heads cover wq's columns once
    assert sorted({o["layouts"]["wq"][2][0] for o in outs}) == [
        (0, 96), (96, 192)]


class _FakeMesh:
    def __init__(self, shape, names):
        self.axis_names = names
        self.shape = dict(zip(names, shape))


@pytest.mark.parametrize("case", sorted(MESHES))
def test_mla_layouts_line_up_with_the_reference_specs(case):
    shape, names = MESHES[case]
    profile = case.split("-")[0]
    cfg = get_config(ARCH).reduced()
    M = shape[-1]
    params = build_model(cfg).param_specs()
    pairs = [(p, x) for p, x in tree_leaves(sh._paths(params))
             if p.startswith("layers/attn/")]
    ref_params = jax.tree.map(lambda x: jax.ShapeDtypeStruct(
        tuple(x.shape), jnp.float32), params)

    def ref(prof):
        with ref_specs.profile_ctx(prof):
            return dict(zip(
                [p for p, _ in tree_leaves(sh._paths(params))],
                jax.tree.leaves(ref_specs.tree_specs(
                    ref_params, _FakeMesh(shape, names)), is_leaf=lambda s:
                    isinstance(s, jax.sharding.PartitionSpec))))
    # the dim GSPMD splits MLA's compute along: the tp rules' "model" dim
    # (under multi-pod moe the activations keep "model" on their
    # features, `remap_act_spec`'s keep_model)
    want, stored = ref("tp"), ref(profile)
    mshape = sh.MeshShape(shape, names)
    with sh.profile_ctx(profile):
        assert sh.tp_axis(mshape) == "model"
        assert sh.cut_kinds(cfg, M)["mla"]
        lays = {p: [sh.compute_layout(cfg, mshape, p, x.shape[1:], i)
                    for i in range(M)] for p, x in pairs}
    width = {"wq": cfg.qk_nope_dim + cfg.qk_rope_dim,
             "w_uk": cfg.qk_nope_dim, "w_uv": cfg.v_head_dim,
             "wo": cfg.v_head_dim}
    hl = cfg.num_heads // M
    for path, x in pairs:
        leaf = path.split("/")[2]
        ls = lays[path]
        if leaf in ("w_dkv", "w_kpe"):
            assert all(lay == sh.Layout("whole", None, (), True)
                       for lay in ls), (path, ls)
            continue
        d = 0 if leaf == "wo" else 1
        n = width[leaf]
        # each rank's heads, in order, every column of the leaf once
        assert [lay.ranges for lay in ls] == [
            ((i * hl * n, (i + 1) * hl * n),) for i in range(M)], (path, ls)
        assert all(lay.dim == d and lay.partial for lay in ls)
        entries = list(want[path])[1:]
        entries += [None] * (2 - len(entries))
        assert entries[d] == "model", (path, want[path])
        # the stored shard the rank cuts its heads from: the reference's
        # spec under the profile ("model" with the FSDP axes under moe)
        assert "model" in [a for e in stored[path]
                           for a in sh.entry_axes(e)], (path, stored[path])


def _batch(cfg, seed=3, rows=B):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (rows, S), dtype=np.int64)
    labels = np.concatenate([toks[:, 1:], np.full((rows, 1), -1, np.int64)],
                            1)
    return {"tokens": toks, "labels": labels}


def _kw(case):
    return dict(dtype="float32", sharding_profile=case.split("-")[0])


@pytest.mark.parametrize("case", sorted(MESHES))
def test_sharded_train_step_matches_the_reference(world, case):
    kw = _kw(case)
    rmodel = ref_build(ref_get_config(ARCH).reduced(**kw))
    rparams = rmodel.init(jax.random.PRNGKey(7))
    batch = _batch(get_config(ARCH).reduced())
    outs = [r[0] for r in world.run(
        cases.train, ARCH, kw, *MESHES[case], batch,
        params=jax.tree.map(np.asarray, rparams))]
    full = cases.gathered(outs)
    _, metrics, _ = outs[0]
    step = jax.jit(ref_train.make_train_step(rmodel, ref_opt.sgd(1e-2)))
    rb = {k: jnp.asarray(v.astype(np.int32)) for k, v in batch.items()}
    p, _, m = step(rparams, ref_opt.sgd(1e-2).init(rparams), rb)
    for k in ("loss", "grad_norm"):
        assert abs(metrics[0][k] - float(m[k])) <= REL * abs(float(m[k]))
    for a, b in zip(full, jax.tree.leaves(p)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0,
                                   atol=PARAM_ATOL)
    for _, got, rep in outs:
        assert got == metrics
        assert "mla" in rep["cut"] and "moe" in rep["cut"], rep["cut"]
        assert not rep["expert_parallel"]
        # a layer's MLA gathers: under "tp" the rank's heads, half of each
        # cut leaf (stored over "model" by heads); under multi-pod "moe"
        # the stored cut (all three axes, "model" last) is not the heads'
        # blocks, so the leaf is gathered whole and the heads cut from it
        whole = {p_: x.numel() // x.shape[0] * 4 for p_, x in tree_leaves(
            sh._paths(build_model(get_config(ARCH).reduced(
                **kw)).param_specs())) if p_.startswith("layers/attn/")}
        for leaf, n in whole.items():
            got_b = rep["gathered_bytes"][leaf]
            cut = leaf.split("/")[2] not in ("w_dkv", "w_kpe")
            half = cut and kw["sharding_profile"] == "tp"
            assert got_b * (2 if half else 1) == n, (leaf, got_b, n)
            # the slice the rank computed with, under either profile: its
            # heads' half of a cut leaf, the whole latent and rotary key
            if leaf.endswith("/kernel"):
                took = math.prod(rep["taken"][leaf]) * 4
                assert took * (2 if cut else 1) == n, (leaf, took, n)


@pytest.mark.parametrize("case", sorted(MESHES))
def test_sharded_prefill_and_decode_match_one_device(world, case):
    kw = _kw(case)
    model = cases.build(ARCH, **kw)
    params = model.init(generator(0), "cpu")
    tokens = torch.randint(0, model.cfg.vocab_size, (B, S),
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
    outs = world.run(cases.serve, ARCH, kw, *MESHES[case], tokens.numpy(),
                     steps, params=params_to_numpy(params))
    for (a, b), lg, (c, d), dec, report in outs:
        np.testing.assert_allclose(cases.load(lg)[0], logits[a:b].numpy(),
                                   rtol=0, atol=TOL)
        np.testing.assert_allclose(dec, want[:, c:d], rtol=0, atol=TOL)
        assert "mla" in report["cut"], report["cut"]


def _dry_ratio(arch, profile=None, **upd):
    """512 x the per-device FLOPs of `arch` at full width (`upd` cuts its
    depth) for train_4k on 2x16x16, over the one-device step's (8 rows x
    4096, x 32), on the meta device."""
    cfg = dryrun._apply_overrides(get_config(arch), None).with_updates(**upd)
    if profile:
        cfg = cfg.with_updates(sharding_profile=profile)
    got = dryrun.run_step(cfg, "train", 256, 4096, sh.MeshShape(
        (2, 16, 16), ("pod", "data", "model")))["flops"]
    one = dryrun.run_step(cfg, "train", 8, 4096, sh.MeshShape(
        (1, 1), ("data", "model")))["flops"] * 32
    return 512 * got / one


def test_full_width_dry_run_computes_the_per_device_share():
    ratio = _dry_ratio(ARCH, num_layers=2)
    assert RATIO[0] <= ratio <= RATIO[1], ratio


# the reference's compiled count (B 8, S 64): the pairs hold 0.7-1.15x it
FLOP_PAIRS = [(("moe", "train"), MESHES["moe-2x2x2"]),
              (("moe", "prefill"), MESHES["moe-2x2x2"]),
              (("tp", "train"), MESHES["tp-4x2"])]


@pytest.fixture(scope="module")
def reference_flops():
    import json
    import subprocess
    import sys
    from test_torch_tensor_parallel import _REFERENCE_FLOPS, SRC
    pairs = [((ARCH,) + p, m) for p, m in FLOP_PAIRS]
    code = _REFERENCE_FLOPS.format(src=SRC, pairs=pairs, B=B, S=S)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("pair,shape", FLOP_PAIRS,
                         ids=["/".join(p) for p, _ in FLOP_PAIRS])
def test_per_device_flops_match_the_reference(reference_flops, pair, shape):
    (profile, kind) = pair
    cfg = get_config(ARCH).reduced().with_updates(sharding_profile=profile,
                                                  scan_layers=False)
    got = dryrun.run_step(cfg, kind, B, S, sh.MeshShape(*shape))["flops"]
    want = reference_flops["/".join((ARCH, profile, kind))]
    assert 0.7 <= got / want <= 1.15, (pair, got, want)
    one = dryrun.run_step(cfg, kind, B, S, sh.MeshShape(
        (1, 1), ("data", "model")))["flops"]
    assert 0.99 <= 8 * got / one <= 1.15, (pair, got, one)
