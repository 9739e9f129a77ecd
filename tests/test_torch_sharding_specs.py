"""The port's partition-spec rules (`repro_torch.sharding.specs`) against
the reference's (`repro.sharding.specs`), in one process on shape-only
meshes: the reference's `FakeMesh` cases (tests/test_sharding_and_dryrun.py
:20-62, the hypothesis property included), then `spec_for_param`,
`fit_spec` and `tree_specs` equal to the reference's over every zoo
config's `reduced()` parameter paths and shapes, under every profile, on a
single-pod and a multi-pod mesh; and the activation and client-axis specs.
Specs are compared as tuples (the port's `P` is a tuple)."""
import jax
import pytest
from hypothesis import given, settings, strategies as st
from jax.sharding import PartitionSpec as JP

torch = pytest.importorskip("torch")

from repro.configs import registry as ref_registry  # noqa: E402
from repro.models.model import build_model as ref_build  # noqa: E402
from repro.sharding import specs as ref  # noqa: E402
from repro_torch.sharding import specs as sh  # noqa: E402
from repro_torch.sharding.specs import P  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

PROFILES = ("tp", "dp", "fsdp", "moe")


class FakeMesh:
    axis_names = ("data", "model")
    shape = {"data": 4, "model": 2}
    size = 8


MESHES = {"single": sh.MeshShape((4, 2), ("data", "model")),
          "multi": sh.MeshShape((2, 4, 2), ("pod", "data", "model"))}


@pytest.fixture(autouse=True)
def _tp_profile():
    yield
    sh.set_profile("tp")
    ref.set_profile("tp")


@settings(max_examples=50, deadline=None)
@given(d0=st.integers(1, 64), d1=st.integers(1, 64))
def test_fit_spec_always_divides(d0, d1):
    m = FakeMesh()
    spec = sh.fit_spec((d0, d1), P("data", "model"), m)
    for dim, ax in zip((d0, d1), list(spec) + [None, None]):
        if ax is not None:
            assert dim % sh.axis_size(m, ax) == 0
    assert tuple(spec) == tuple(ref.fit_spec((d0, d1), JP("data", "model"),
                                             m))


def test_fit_spec_compound_prefix_fallback():
    m = FakeMesh()
    # 4 divides by ("data",) but not by ("data", "model") = 8
    spec = sh.fit_spec((4, 8), P(("data", "model"), None), m)
    assert spec[0] in (("data",), "data")


def test_param_rules_profiles():
    m = FakeMesh()
    sh.set_profile("tp")
    assert sh.spec_for_param("layers/attn/wq/kernel", (64, 32), m) \
        == P("data", "model")
    sh.set_profile("dp")
    assert sh.spec_for_param("layers/attn/wq/kernel", (64, 32), m) == P()
    sh.set_profile("fsdp")
    assert sh.spec_for_param("layers/attn/wq/kernel", (64, 32), m)[0] \
        == ("data", "model")


def test_norm_params_replicated():
    sh.set_profile("tp")
    got = sh.spec_for_param("layers/attn_norm/scale", (64,), FakeMesh())
    assert all(e is None for e in got)


def test_profile_ctx_restores():
    with sh.profile_ctx("fsdp"):
        assert sh.get_profile() == "fsdp"
    assert sh.get_profile() == "tp"
    with pytest.raises(AssertionError):
        sh.set_profile("zero")


def _ref_tree(arch):
    cfg = ref_registry.get_config(arch).reduced()
    return jax.eval_shape(ref_build(cfg).init, jax.random.PRNGKey(0))


def _meta(tree):
    """The reference's shape tree as meta tensors in the port's tree
    types (dicts and lists)."""
    if isinstance(tree, dict):
        return {k: _meta(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_meta(v) for v in tree]
    if tree is None:
        return None
    return torch.empty(tree.shape, device="meta")


@pytest.fixture(scope="module")
def zoo():
    return {arch: _ref_tree(arch) for arch in ref_registry.ARCH_IDS}


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("profile", PROFILES)
def test_rules_equal_the_reference_over_the_zoo(zoo, profile, mesh_name):
    m = MESHES[mesh_name]
    sh.set_profile(profile)
    ref.set_profile(profile)
    n = 0
    for arch, tree in zoo.items():
        flat, _ = jax.tree_util.tree_flatten_with_path(tree)
        for path, leaf in flat:
            p = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                         for k in path)
            shape = tuple(leaf.shape)
            assert tuple(sh.spec_for_param(p, shape, m)) == tuple(
                ref.spec_for_param(p, shape, m)), (arch, p, shape)
            for tmpl in (("data", "model"), (("data", "model"), None),
                         (None, ("pod", "data"))):
                assert tuple(sh.fit_spec(shape, P(*tmpl), m)) == tuple(
                    ref.fit_spec(shape, JP(*tmpl), m)), (arch, p, tmpl)
            n += 1
        got = tree_leaves(sh.tree_specs(_meta(tree), m))
        want = jax.tree.leaves(ref.tree_specs(tree, m),
                               is_leaf=lambda x: isinstance(x, JP))
        assert [tuple(s) for s in got] == [tuple(s) for s in want], arch
    assert n > 150


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("profile", PROFILES)
def test_activation_specs_equal_the_reference(profile, mesh_name):
    m = MESHES[mesh_name]
    for flag in (True, False):
        sh.set_profile(profile)
        ref.set_profile(profile)
        sh.set_seq_shardable(flag)
        ref.set_seq_shardable(flag)
        assert tuple(sh.act_spec_btd(m)) == tuple(ref.act_spec_btd(m))
        assert tuple(sh.batch_spec(m)) == tuple(ref.batch_spec(m))
        assert sh.batch_axes(m) == ref.batch_axes(m)
        assert sh.seq_axis(m) == ref.seq_axis(m)
        assert sh.fsdp_axes(m) == ref.fsdp_axes(m)
        for spec in (("data", None, "model"), ("model", "data", None),
                     (("pod", "data"), None), ("data", None)):
            assert tuple(sh.remap_act_spec(P(*spec), m)) == tuple(
                ref.remap_act_spec(JP(*spec), m)), spec
    sh.set_seq_shardable(True)
    ref.set_seq_shardable(True)


def test_client_stack_specs():
    tree = {"conv1": {"kernel": torch.empty(16, 3, 3, 1, 8, device="meta")},
            "b": torch.empty(16, 10, device="meta")}
    specs = sh.client_stack_specs(tree)
    assert specs == {"conv1": {"kernel": P("data", None, None, None, None)},
                     "b": P("data", None)}
    assert sh.client_stack_specs(tree, lead=1)["b"] == P(None, "data")
    assert sh.replicated_specs(tree) == {"conv1": {"kernel": P()}, "b": P()}
    with pytest.raises(ValueError, match="cannot shard"):
        sh.client_stack_specs({"x": torch.empty((), device="meta")})
