"""The port's `FederatedTrainer` (`repro_torch.core.trainer`): twins of the
six tests of tests/test_fl_trainer.py on the port's own init, then one
`fl_train_step` per strategy (HFL, AFL with partial participation, AFL
gossip, CFL) against the reference's from the reference's init, in
float32 with distinct client data and unequal weights; and a mesh
laying C clients over its "data" axis, where HFL groups that do not
nest with a rank's clients raise.

Tolerance of the parity cases: every client's parameters (and CFL's
global model) within 1e-5, the round's loss within 1e-5 relative: two
local SGD steps with momentum, then float32 means in another order."""
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
from repro_torch.core.fl_types import FLConfig  # noqa: E402
from repro_torch.core.trainer import FederatedTrainer  # noqa: E402
from repro_torch.device import generator  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.models.model import synthetic_train_batch  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

TOL = 1e-5
ARCH = "phi3-mini-3.8b"


def _setup(strategy, C=4, **fl_kw):
    """The reference test's setup on the port: phi3-mini reduced, 4
    clients in 2 groups, K = 2, lr 0.05, one batch repeated everywhere."""
    cfg = get_config(ARCH).reduced()
    model = build_model(cfg)
    fl = FLConfig(strategy=strategy, num_clients=C, num_groups=2,
                  local_steps=2, lr=0.05, **fl_kw)
    tr = FederatedTrainer(model, fl)
    state = tr.init_state(generator(0), device="cpu")
    base = synthetic_train_batch(generator(1), cfg, 2, 32, device="cpu")
    batch = {k: v[None, None].expand((C, 2) + tuple(v.shape))
             for k, v in base.items()}
    return tr, state, batch, torch.ones(C), torch.ones(C, dtype=torch.bool)


def _client_divergence(state):
    leaf = tree_leaves(state["client_params"])[0]
    return float((leaf - leaf[0:1]).abs().max())


@pytest.mark.parametrize("strategy", ["hfl", "afl"])
def test_full_aggregation_reaches_consensus(strategy):
    tr, state, batch, w, part = _setup(strategy)
    state, metrics = tr.fl_train_step(state, batch, w, part)
    assert _client_divergence(state) == 0.0
    assert np.isfinite(float(metrics["loss"]))


def test_cfl_partial_merge_keeps_divergence():
    tr, state, batch, w, part = _setup("cfl", merge_alpha=0.3)
    state, _ = tr.fl_train_step(state, batch, w, part)
    assert _client_divergence(state) > 0.0
    d0 = _client_divergence(state)
    for _ in range(3):
        state, _ = tr.fl_train_step(state, batch, w, part)
    assert _client_divergence(state) < d0 * 2


def test_afl_gossip_mixes_ring():
    tr, state, batch, w, part = _setup("afl", afl_mode="gossip")
    state, _ = tr.fl_train_step(state, batch, w, part)
    assert _client_divergence(state) > 0.0


def test_afl_participation_mask_freezes_nonparticipants_weighting():
    """With only client 0 participating, the consensus is client 0's
    locally trained params."""
    tr, state, batch, w, part = _setup("afl")
    part = torch.tensor([True, False, False, False])
    state, _ = tr.fl_train_step(state, batch, w, part)
    assert _client_divergence(state) == 0.0


def test_round_counter_and_served_model():
    tr, state, batch, w, part = _setup("hfl")
    state, _ = tr.fl_train_step(state, batch, w, part)
    state, _ = tr.fl_train_step(state, batch, w, part)
    assert int(state["round"]) == 2
    served = tr.served_model(state)
    c0 = tree_map(lambda x: x[0], state["client_params"])
    for a, b in zip(tree_leaves(served), tree_leaves(c0)):
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(),
                                   atol=1e-5)


def test_mesh_hfl_equals_host_hfl():
    """The trainer's two-tier client-dim aggregation equals the host-level
    list-of-trees HFL (`core.aggregation.hfl_aggregate`, which the
    reference's test reaches through its `strategies` shim)."""
    from repro_torch.core import aggregation, topology
    rng = np.random.default_rng(0)
    C, G = 6, 3
    trees = [{"w": torch.as_tensor(rng.normal(size=(3, 2)).astype(
        np.float32))} for _ in range(C)]
    wts = rng.integers(5, 50, C).astype(np.float32)
    host = aggregation.hfl_aggregate(trees, topology.hierarchical_groups(C, G),
                                    weights=list(wts))
    fl = FLConfig(strategy="hfl", num_clients=C, num_groups=G)
    tr = FederatedTrainer(build_model(get_config(ARCH).reduced()), fl)
    stacked = {"w": torch.stack([t["w"] for t in trees])}
    agg, _ = tr._aggregate(stacked, torch.as_tensor(wts),
                           torch.ones(C, dtype=torch.bool), None)
    np.testing.assert_allclose(agg["w"][0].numpy(), host["w"].numpy(),
                               rtol=1e-4)


def test_mesh_other_than_none_raises():
    """A mesh runs the sharded trainer (tests/test_torch_fl_trainer_mesh.py)
    with C / size("data") clients a rank; HFL groups that straddle ranks
    build, as the reference's trainer reshapes any C into its groups."""
    from repro_torch.core import collectives
    from repro_torch.launch.mesh import dry_run_mesh
    from repro_torch.sharding.specs import MeshShape
    model = build_model(get_config(ARCH).reduced())
    with collectives.dry_run():
        rm = dry_run_mesh(MeshShape((4, 2), ("data", "model")), rank=2)
        tr = FederatedTrainer(model, FLConfig(strategy="hfl", num_clients=8,
                                              num_groups=2), mesh=rm)
        assert tr.local_clients == range(2, 4)
        # 12 clients, 3 a rank, in 3 groups of 4
        tr = FederatedTrainer(model, FLConfig(strategy="hfl", num_clients=12,
                                              num_groups=3), mesh=rm)
        assert tr.local_clients == range(3, 6)


def test_batch_specs_and_meta():
    tr, _, _, _, _ = _setup("afl")
    specs = tr.fl_batch_specs(64, 3)
    assert {k: tuple(v.shape) for k, v in specs.items()} == {
        "tokens": (4, 2, 3, 64), "labels": (4, 2, 3, 64)}
    assert all(v.device.type == "meta" and v.dtype == torch.int64
               for v in specs.values())


# -- one round against the reference's, from its init -----------------------

CASES = {
    "hfl": dict(strategy="hfl"),
    "afl": dict(strategy="afl"),
    "afl-gossip": dict(strategy="afl", afl_mode="gossip"),
    "cfl": dict(strategy="cfl", merge_alpha=0.3),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_fl_train_step_matches_reference(case):
    C, K, B, S = 4, 2, 2, 16
    kw = dict(CASES[case], num_clients=C, num_groups=2, local_steps=K,
              lr=0.05)
    rcfg = ref_get_config(ARCH).reduced(dtype="float32")
    pcfg = get_config(ARCH).reduced(dtype="float32")
    rtr = RefTrainer(ref_build(rcfg), RefFLConfig(**kw))
    ptr = FederatedTrainer(build_model(pcfg), FLConfig(**kw))
    rstate = rtr.init_state(jax.random.PRNGKey(0))
    to_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    pstate = ptr.init_state(
        client_params=params_from_jax(to_np(rstate["client_params"])),
        global_params=(params_from_jax(to_np(rstate["global_params"]))
                       if "global_params" in rstate else None),
        device="cpu")
    rng = np.random.default_rng(5)
    toks = rng.integers(0, rcfg.vocab_size, (C, K, B, S), dtype=np.int32)
    labels = np.concatenate([toks[..., 1:],
                             np.full((C, K, B, 1), -1, np.int32)], -1)
    w = rng.integers(5, 50, C).astype(np.float32)
    part = np.array([True, False, True, True])
    rstate, rm = jax.jit(rtr.fl_train_step)(
        rstate, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)},
        jnp.asarray(w), jnp.asarray(part))
    pstate, pm = ptr.fl_train_step(
        pstate, {"tokens": torch.as_tensor(toks).long(),
                 "labels": torch.as_tensor(labels).long()},
        torch.as_tensor(w), torch.as_tensor(part))
    np.testing.assert_allclose(float(pm["loss"]), float(rm["loss"]),
                               rtol=TOL)
    assert int(pstate["round"]) == int(rstate["round"]) == 1
    keys = ["client_params"] + (["global_params"] if case == "cfl" else [])
    for key in keys:
        got, want = tree_leaves(pstate[key]), jax.tree.leaves(rstate[key])
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert tuple(a.shape) == b.shape
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=TOL)
    served = ptr.served_model(pstate)
    for a, b in zip(tree_leaves(served),
                    jax.tree.leaves(rtr.served_model(rstate))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=TOL)
