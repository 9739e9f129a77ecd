"""The port's checkpoints (`repro_torch.checkpoint.checkpoint`) against the
reference's (`repro.checkpoint.checkpoint`): one file format, so a
reference checkpoint restores in the port and a port checkpoint restores
in the reference, bit for bit, on model parameter trees with a stacked
"layers" axis and "blocks": None (seamless reduced), MoE expert stacks
(qwen3-moe reduced) and a list of per-layer dicts (xlstm reduced);
bfloat16 leaves go through float32; a shape mismatch raises;
`latest_checkpoint` and `checkpoint_step` agree."""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.checkpoint import checkpoint as ref_ckpt  # noqa: E402
from repro.configs.registry import get_config as ref_get_config  # noqa: E402
from repro.models.model import build_model as ref_build  # noqa: E402
from repro_torch.checkpoint import checkpoint as port_ckpt  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

ARCHS = ["seamless-m4t-large-v2", "qwen3-moe-30b-a3b", "xlstm-125m"]


def _ref_params(arch, seed):
    cfg = ref_get_config(arch).reduced(num_layers=2, d_model=64,
                                       vocab_size=64, d_ff=64, head_dim=16)
    return ref_build(cfg).init(jax.random.PRNGKey(seed))


def _same_bits(port_tree, ref_tree):
    p, r = tree_leaves(port_tree), jax.tree.leaves(ref_tree)
    assert len(p) == len(r)
    for a, b in zip(p, r):
        a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        b = np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


@pytest.mark.parametrize("arch", ARCHS)
def test_reference_checkpoint_restores_in_the_port(arch, tmp_path):
    saved = _ref_params(arch, 0)
    path = ref_ckpt.save_checkpoint(str(tmp_path), 7, saved)
    template = params_from_jax(jax.tree.map(np.asarray, _ref_params(arch, 1)))
    got = port_ckpt.restore_checkpoint(path, template)
    _same_bits(got, saved)
    assert port_ckpt.checkpoint_step(path) == 7


@pytest.mark.parametrize("arch", ARCHS)
def test_port_checkpoint_restores_in_the_reference(arch, tmp_path):
    saved = params_from_jax(jax.tree.map(np.asarray, _ref_params(arch, 0)))
    path = port_ckpt.save_checkpoint(str(tmp_path), 3, saved,
                                     extra_meta={"arch": arch})
    got = ref_ckpt.restore_checkpoint(path, _ref_params(arch, 1))
    _same_bits(saved, got)
    meta = json.loads((tmp_path / "ckpt_00000003.json").read_text())
    assert meta["arch"] == arch and ref_ckpt.checkpoint_step(path) == 3
    # the same keys, shapes and dtypes as the reference writes
    ref_path = ref_ckpt.save_checkpoint(str(tmp_path / "ref"), 3,
                                        _ref_params(arch, 0))
    want = json.loads(open(ref_path.replace(".npz", ".json")).read())
    for key in ("keys", "shapes", "dtypes"):
        assert meta[key] == want[key]


def test_bfloat16_leaves_go_through_float32(tmp_path):
    g = torch.Generator().manual_seed(0)
    tree = {"w": torch.randn((3, 5), generator=g).to(torch.bfloat16),
            "blocks": [None, {"b": torch.arange(4, dtype=torch.float32)}]}
    path = port_ckpt.save_checkpoint(str(tmp_path), 1, tree)
    with np.load(path) as data:
        assert data["w"].dtype == np.float32 and "blocks/1/b" in data
    back = port_ckpt.restore_checkpoint(path, tree)
    assert back["w"].dtype == torch.bfloat16 and back["blocks"][0] is None
    assert torch.equal(back["w"], tree["w"])
    # the reference restores the same file to bfloat16, bit for bit
    ref_back = ref_ckpt.restore_checkpoint(
        path, {"w": jnp.zeros((3, 5), jnp.bfloat16),
               "blocks": [None, {"b": jnp.zeros(4)}]})
    np.testing.assert_array_equal(
        np.asarray(ref_back["w"]).view(np.uint16),
        tree["w"].view(torch.int16).numpy().view(np.uint16))


def test_shape_mismatch_raises(tmp_path):
    path = port_ckpt.save_checkpoint(str(tmp_path), 1,
                                     {"a": torch.zeros((2, 3))})
    with pytest.raises(ValueError, match="shape mismatch for a"):
        port_ckpt.restore_checkpoint(path, {"a": torch.zeros((3, 2))})
    with pytest.raises(ValueError, match="shape mismatch for a"):
        ref_ckpt.restore_checkpoint(path, {"a": jnp.zeros((3, 2))})


def test_latest_checkpoint_and_step_agree(tmp_path):
    assert port_ckpt.latest_checkpoint(str(tmp_path / "none")) is None
    assert ref_ckpt.latest_checkpoint(str(tmp_path / "none")) is None
    tree = {"a": torch.ones(2)}
    port_ckpt.save_checkpoint(str(tmp_path), 12, tree)
    ref_ckpt.save_checkpoint(str(tmp_path), 3, {"a": jnp.ones(2)})
    port_ckpt.save_checkpoint(str(tmp_path), 9, tree)
    latest = port_ckpt.latest_checkpoint(str(tmp_path))
    assert latest == ref_ckpt.latest_checkpoint(str(tmp_path))
    assert latest.endswith("ckpt_00000012.npz")
    assert port_ckpt.checkpoint_step(latest) == 12
    assert ref_ckpt.checkpoint_step(latest) == 12
