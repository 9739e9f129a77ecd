"""The port's `FederatedTrainer` on a mesh (`repro_torch.core.trainer`'s mesh
half) on the CPU.

* `fl_tree_shardings` and `fl_tree_shardings_opt` (and CFL's global
  model under `tree_shardings`) of the reference test's state (phi3-mini
  reduced, 4 clients, SGD with momentum) equal the reference's
  `NamedSharding`s on a 4x2 and a 2x2x2 mesh: spec, shard shape and each
  device's slice (the reference's in a subprocess with 8 fake devices).
* The four strategies of tests/test_fl_mesh_dryrun.py:71-83 (HFL, AFL,
  AFL gossip, CFL) run 2 rounds on 8 gloo ranks laid out (data 4, model
  2), one client a "data" slice, and with 8 clients (2 a rank; HFL's
  groups over 2 ranks, or 2 whole groups a rank) and 6 (not dividing:
  every rank holds all 6); and HFL with 12 clients, 3 a rank, in 3
  groups of 4 that straddle ranks. From the reference's init (from the
  port's own for 6 and 8 clients, each rank drawing only its clients):
  every
  client's params and CFL's global model within 1e-5 of the one-device
  port trainer's and (one client a rank) of the reference's
  `fl_train_step`'s, the loss
  within 1e-5 relative, in float32 with distinct client data, unequal
  weights and partial participation; the served model too. Every
  strategy issues collectives;
  gossip's ring is a counted collective-permute, as the reference's HLO
  holds one. Under the tp profile (the trainer keeps the caller's, "tp"
  by default, as the reference's FL dry-run runs it) each rank computes
  its "model" shard of each client's layers (`models.parallel`): phi3-mini
  cuts its attention, MLP and vocabulary, zamba2 its Mamba2 heads.

One `launch.mesh.World` of 8 CPU ranks serves the module; the ranks run
`torch_sharded_cases.fl`."""
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
from repro.core.fl_types import FLConfig as RefFLConfig  # noqa: E402
from repro.core.trainer import FederatedTrainer as RefTrainer  # noqa: E402
from repro.models.model import build_model as ref_build  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import trainer as port_trainer  # noqa: E402
from repro_torch.core.fl_types import FLConfig  # noqa: E402
from repro_torch.device import generator  # noqa: E402
from repro_torch.launch import mesh  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.sharding import specs as sh  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

import torch_sharded_cases as cases  # noqa: E402

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
TOL = 1e-5
ARCH = "phi3-mini-3.8b"
C, K, B, S, ROUNDS = 4, 2, 2, 16, 2
MESH = ((4, 2), ("data", "model"))
MESHES = {"4x2": MESH, "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
CASES = {
    "hfl": dict(strategy="hfl"),
    "afl": dict(strategy="afl"),
    "afl-gossip": dict(strategy="afl", afl_mode="gossip"),
    "cfl": dict(strategy="cfl", merge_alpha=0.3),
}

_REFERENCE = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import sys, json
    sys.path.insert(0, {src!r})
    import jax
    from repro.configs.registry import get_config
    from repro.core.fl_types import FLConfig
    from repro.core.trainer import (FederatedTrainer, fl_tree_shardings,
                                    fl_tree_shardings_opt)
    from repro.launch import mesh as mesh_mod
    from repro.models.model import build_model
    from repro.sharding import specs as sh

    def entry(e):
        return list(e) if isinstance(e, tuple) else e

    def one(ns, shape):
        spec = [entry(e) for e in ns.spec]
        spec += [None] * (len(shape) - len(spec))
        m = ns.addressable_devices_indices_map(shape)
        return [spec, list(ns.shard_shape(shape)),
                [[[s.start or 0, d if s.stop is None else s.stop]
                  for s, d in zip(m[dev], shape)]
                 for dev in ns.mesh.devices.flat]]

    meshes = {{"4x2": jax.make_mesh((4, 2), ("data", "model"),
                                    **mesh_mod.axis_types_kw(2)),
               "2x2x2": jax.make_mesh((2, 2, 2), ("pod", "data", "model"),
                                      **mesh_mod.axis_types_kw(3))}}
    model = build_model(get_config("{arch}").reduced())
    res = {{}}
    for name, mesh in meshes.items():
        tr = FederatedTrainer(model, FLConfig(strategy="cfl", num_clients=4,
                                              num_groups=2), mesh)
        st = jax.eval_shape(tr.init_state, jax.random.PRNGKey(0))
        shs = tr.state_shardings(st)
        res[name] = {{}}
        for k in ("client_params", "opt", "global_params"):
            flat, _ = jax.tree_util.tree_flatten_with_path(st[k])
            res[name][k] = {{
                "/".join(str(getattr(q, "key", getattr(q, "idx", q)))
                         for q in path): one(s, l.shape)
                for (path, l), s in zip(flat, jax.tree.leaves(shs[k]))}}
        assert jax.tree.leaves(fl_tree_shardings(
            st["client_params"], mesh)) == jax.tree.leaves(
            shs["client_params"])
        assert jax.tree.leaves(fl_tree_shardings_opt(st["opt"], mesh)) == \\
            jax.tree.leaves(shs["opt"])
    print(json.dumps(res))
""")


@pytest.fixture(scope="module")
def reference_shardings():
    code = _REFERENCE.format(src=SRC, arch=ARCH)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def _port(ns, shape):
    spec = [list(e) if isinstance(e, tuple) else e for e in ns.spec]
    spec += [None] * (len(shape) - len(spec))
    m = ns.indices_map(shape)
    return [spec, list(ns.shard_shape(shape)),
            [[[s.start, s.stop] for s in m[r]] for r in sorted(m)]]


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_fl_shardings_match_the_reference(reference_shardings, mesh_name):
    want = reference_shardings[mesh_name]
    mesh_shape = sh.MeshShape(*MESHES[mesh_name])
    tr = port_trainer.FederatedTrainer(
        build_model(get_config(ARCH).reduced()),
        FLConfig(strategy="cfl", num_clients=C, num_groups=2))
    st = tr.state_specs()
    shs = {"client_params": port_trainer.fl_tree_shardings(
               st["client_params"], mesh_shape),
           "opt": port_trainer.fl_tree_shardings_opt(st["opt"], mesh_shape),
           "global_params": sh.tree_shardings(st["global_params"],
                                              mesh_shape)}
    for key, shardings in shs.items():
        got = {path: _port(s, tuple(x.shape)) for (path, x), s in
               zip(tree_leaves(sh._paths(st[key])), tree_leaves(shardings))}
        # the reference's SGD keeps a step count, replicated; the port's
        # keeps one only for a scheduled lr
        assert set(want[key]) - set(got) <= {"count"}, key
        assert got == {p: want[key][p] for p in got}, key


# -- the four strategies on 8 ranks -------------------------------------------

@pytest.fixture(scope="module")
def world():
    with mesh.World(8, device="cpu", timeout=120) as w:
        yield w


def _rounds(vocab, C=C):
    rng = np.random.default_rng(5)
    out = []
    for _ in range(ROUNDS):
        toks = rng.integers(0, vocab, (C, K, B, S), dtype=np.int64)
        labels = np.concatenate([toks[..., 1:],
                                 np.full((C, K, B, 1), -1, np.int64)], -1)
        out.append({"tokens": toks, "labels": labels})
    return out


def _run_and_check(world, fl_case, C, groups, part, reference=True,
                   arch=ARCH, cut=("attn", "mlp", "vocab")):
    """2 rounds of `fl_case` with C clients in `groups` HFL groups on the 8
    ranks, against the one-device port trainer and, with `reference`, the
    reference's `fl_train_step`, both from the reference's init; without
    it from the port's own init (seed 0), which each rank draws keeping
    only its clients. Returns the ranks' client ranges and model
    indices."""
    fl_kw = dict(fl_case, num_clients=C, num_groups=groups, local_steps=K,
                 lr=0.05)
    kw = dict(dtype="float32")
    ptr = port_trainer.FederatedTrainer(
        build_model(get_config(arch).reduced(**kw)), FLConfig(**fl_kw))
    if reference:
        rtr = RefTrainer(ref_build(ref_get_config(arch).reduced(**kw)),
                         RefFLConfig(**fl_kw))
        rstate = rtr.init_state(jax.random.PRNGKey(0))
        to_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
        cp = to_np(rstate["client_params"])
        gp = (to_np(rstate["global_params"]) if "global_params" in rstate
              else None)
        pstate = ptr.init_state(client_params=params_from_jax(cp),
                                global_params=(None if gp is None
                                               else params_from_jax(gp)),
                                device="cpu")
        rstep = jax.jit(rtr.fl_train_step)
    else:
        cp = gp = None
        pstate = ptr.init_state(generator(0), device="cpu")
    batches = _rounds(ptr.model.cfg.vocab_size, C)
    w = np.random.default_rng(6).integers(5, 50, C).astype(np.float32)
    r_losses, p_losses = [], []
    for b in batches:
        if reference:
            rstate, rm = rstep(rstate, {k: jnp.asarray(v.astype(np.int32))
                                        for k, v in b.items()},
                               jnp.asarray(w), jnp.asarray(part))
            r_losses.append(float(rm["loss"]))
        pstate, pm = ptr.fl_train_step(
            pstate, {k: torch.as_tensor(v) for k, v in b.items()},
            torch.as_tensor(w), torch.as_tensor(part))
        p_losses.append(float(pm["loss"]))
    outs = world.run(cases.fl, arch, kw, fl_kw, *MESH, batches, w, part,
                     client_params=cp, global_params=gp)
    for (lo, hi), m, mine, glob, losses, report in outs:
        np.testing.assert_allclose(losses, p_losses, rtol=TOL)
        one = tree_map(lambda x: x[lo:hi], pstate["client_params"])
        for a, p_ in zip(tree_leaves(mine), tree_leaves(one)):
            np.testing.assert_allclose(a, p_.numpy(), rtol=0, atol=TOL)
        if fl_case["strategy"] == "cfl":
            for a, p_ in zip(tree_leaves(glob),
                             tree_leaves(pstate["global_params"])):
                np.testing.assert_allclose(a, p_.numpy(), rtol=0, atol=TOL)
        if reference:
            np.testing.assert_allclose(losses, r_losses, rtol=TOL)
            ref = jax.tree.map(lambda x: np.asarray(x[lo:hi]),
                               rstate["client_params"])
            for a, r_ in zip(tree_leaves(mine), jax.tree.leaves(ref)):
                np.testing.assert_allclose(a, r_, rtol=0, atol=TOL)
            if fl_case["strategy"] == "cfl":
                for a, r_ in zip(tree_leaves(glob),
                                 jax.tree.leaves(rstate["global_params"])):
                    np.testing.assert_allclose(a, np.asarray(r_), rtol=0,
                                               atol=TOL)
        for a, b in zip(report["served"],
                        tree_leaves(ptr.served_model(pstate))):
            np.testing.assert_allclose(a, b.numpy(), rtol=0, atol=TOL)
        kinds = report["collectives"]["kinds"]
        assert sum(kinds.values()) > 0, kinds
        assert set(report["cut"]) == set(cut), report["cut"]
        if fl_case.get("afl_mode") == "gossip":
            assert kinds.get("collective-permute", 0) == 2 * ROUNDS, kinds
    return [(c, m) for c, m, *_ in outs]


@pytest.mark.parametrize("case", sorted(CASES))
def test_mesh_trainer_matches_one_device_and_reference(world, case):
    part = np.array([True, False, True, True])
    got = _run_and_check(world, CASES[case], C, 2, part)
    assert sorted(got) == [((c, c + 1), m) for c in range(C)
                           for m in range(2)]


# (strategy, clients, HFL groups): 8 clients lie 2 a rank over "data" 4;
# 6 do not divide over it and every rank holds all 6, as GSPMD replicates
# the dim
MANY = {
    "hfl-8": (CASES["hfl"], 8, 2),          # a group over 2 ranks
    "hfl-8-groups-8": (CASES["hfl"], 8, 8),  # 2 whole groups a rank
    "afl-8": (CASES["afl"], 8, 2),
    "afl-gossip-8": (CASES["afl-gossip"], 8, 2),
    "cfl-8": (CASES["cfl"], 8, 2),
    "hfl-6": (CASES["hfl"], 6, 2),
}


@pytest.mark.parametrize("case", sorted(MANY))
def test_mesh_trainer_with_many_clients_a_rank(world, case):
    fl_case, n, groups = MANY[case]
    # ranks 0 and 3's clients sit out AFL (client 1 of rank 0 and both of
    # rank 3 under 8 clients): a rank with no participant sends weight 0
    part = np.ones(n, bool)
    part[[1, 6, 7] if n == 8 else [1]] = False
    got = _run_and_check(world, fl_case, n, groups, part, reference=False)
    per = n // 4 if n % 4 == 0 else n
    assert sorted(got) == sorted(
        ((i * per, i * per + per) if per < n else (0, n), m)
        for i in range(4) for m in range(2))


def test_mesh_trainer_hfl_groups_straddling_ranks(world):
    """12 clients, 3 a rank, in 3 HFL groups of 4: group 1 is rank 1's
    last 2 clients and rank 2's first 2, groups 0 and 2 span a rank and
    one client of the next; held to the one-device trainer and the
    reference from the reference's init."""
    got = _run_and_check(world, CASES["hfl"], 12, 3, np.ones(12, bool))
    assert sorted(got) == sorted(((3 * i, 3 * i + 3), m) for i in range(4)
                                 for m in range(2))


@pytest.mark.parametrize("strategy", ["hfl", "cfl"])
def test_mesh_trainer_cuts_mamba2_heads_over_model(world, strategy):
    """zamba2 reduced: each client's local steps run its Mamba2 heads over
    "model"; held to the one-device port trainer from the port's init."""
    got = _run_and_check(world, CASES[strategy], C, 2, np.ones(C, bool),
                         reference=False, arch="zamba2-1.2b",
                         cut=("mamba", "vocab"))
    assert sorted(got) == [((c, c + 1), m) for c in range(C)
                           for m in range(2)]
