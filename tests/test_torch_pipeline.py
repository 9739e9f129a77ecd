"""The port's batch pipelines (`repro_torch.data.pipeline`) bitwise the
reference's for the same seeds, and the optimizer pieces training adds
(`global_norm`, `clip_by_global_norm`, `cosine_schedule`, a scheduled
`lr` in `sgd` and `adamw`) against the reference's.

Tolerances: batches bitwise; the norm, the clip and the schedule within
1e-6 relative (float32 sums and a cosine in another library); a few
scheduled optimizer steps within 1e-6."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.data import pipeline as ref_pipe  # noqa: E402
from repro.optim import optimizers as ref_opt  # noqa: E402
from repro_torch.data import pipeline as port_pipe  # noqa: E402
from repro_torch.optim import optimizers  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

REL = 1e-6


@pytest.mark.parametrize("vocab,seed", [(512, 0), (512, 3), (32000, 1)])
def test_markov_lm_batches_bitwise(vocab, seed):
    ref = ref_pipe.MarkovLM(vocab, seed=seed)
    port = port_pipe.MarkovLM(vocab, seed=seed)
    np.testing.assert_array_equal(port.next_tokens, ref.next_tokens)
    np.testing.assert_array_equal(port.probs, ref.probs)
    want = list(ref.batches(3, 24, 3, seed=seed + 5))
    got = list(port.batches(3, 24, 3, seed=seed + 5))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w) == ["labels", "tokens"]
        for k in w:
            assert g[k].dtype == w[k].dtype == np.int32
            np.testing.assert_array_equal(g[k], w[k])
        assert (g["labels"][:, -1] == -1).all()


@pytest.mark.parametrize("drop", [True, False])
def test_image_batches_bitwise(drop):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((37, 4, 4, 1)).astype(np.float32)
    y = rng.integers(0, 10, 37)
    kw = dict(seed=4, epochs=2, drop_remainder=drop)
    want = list(ref_pipe.image_batches(x, y, 8, **kw))
    got = list(port_pipe.image_batches(x, y, 8, **kw))
    assert len(got) == len(want) == (8 if drop else 10)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["image"], w["image"])
        np.testing.assert_array_equal(g["label"], w["label"])


def _trees(seed=0):
    rng = np.random.default_rng(seed)
    tree = {"b": rng.standard_normal((7,)).astype(np.float32),
            "a": {"k": rng.standard_normal((5, 3)).astype(np.float32),
                  "s": np.float32(rng.standard_normal())}}
    port = {"b": torch.as_tensor(tree["b"]),
            "a": {"k": torch.as_tensor(tree["a"]["k"]),
                  "s": torch.as_tensor(tree["a"]["s"])}}
    return jax.tree.map(jnp.asarray, tree), port


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_global_norm_and_clip_match_reference(max_norm):
    rtree, ptree = _trees()
    norm = optimizers.global_norm(ptree)
    assert norm.dtype == torch.float32 and norm.shape == ()
    np.testing.assert_allclose(float(norm), float(ref_opt.global_norm(rtree)),
                               rtol=REL)
    rclip, rnorm = ref_opt.clip_by_global_norm(rtree, max_norm)
    pclip, pnorm = optimizers.clip_by_global_norm(ptree, max_norm)
    assert isinstance(pnorm, torch.Tensor)
    np.testing.assert_allclose(float(pnorm), float(rnorm), rtol=REL)
    for a, b in zip(tree_leaves(pclip), jax.tree.leaves(rclip)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=REL,
                                   atol=1e-7)
    if max_norm > float(pnorm):          # no clip: the grads unchanged
        for a, b in zip(tree_leaves(pclip), tree_leaves(ptree)):
            np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("floor", [0.0, 1e-4])
def test_cosine_schedule_matches_reference(floor):
    ref = ref_opt.cosine_schedule(3e-3, 10, 100, floor)
    port = optimizers.cosine_schedule(3e-3, 10, 100, floor)
    steps = [0, 1, 5, 9, 10, 11, 50, 99, 100, 150]
    for s in steps:
        want = float(ref(jnp.asarray(s, jnp.int32)))
        for arg in (s, torch.tensor(float(s))):
            got = port(arg)
            assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
            np.testing.assert_allclose(float(got), want, rtol=REL, atol=1e-12)


@pytest.mark.parametrize("name", ["sgd", "sgd_momentum", "adamw"])
def test_scheduled_lr_matches_reference(name):
    """Three steps with lr a cosine schedule: SGD reads it at the count
    before the step, AdamW after."""
    make = {"sgd": lambda m, lr: m.sgd(lr),
            "sgd_momentum": lambda m, lr: m.sgd(lr, momentum=0.9),
            "adamw": lambda m, lr: m.adamw(lr, weight_decay=0.01)}[name]
    ropt = make(ref_opt, ref_opt.cosine_schedule(0.1, 2, 6))
    popt = make(optimizers, optimizers.cosine_schedule(0.1, 2, 6))
    rp, pp = _trees(1)
    rs, ps = ropt.init(rp), popt.init(pp)
    assert float(ps["count"]) == 0
    for i in range(3):
        rg, pg = _trees(10 + i)
        ru, rs = ropt.update(rg, rs, rp)
        rp = ref_opt.apply_updates(rp, ru)
        pu, ps = popt.update(pg, ps, pp)
        pp = optimizers.apply_updates(pp, pu)
    assert float(ps["count"]) == int(rs["count"]) == 3
    for a, b in zip(tree_leaves(pp), jax.tree.leaves(rp)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=REL,
                                   atol=1e-6)


def test_constant_lr_sgd_state_unchanged():
    """A float lr keeps SGD's state as before (no count), which the FL
    engines' captured rounds rely on."""
    _, pp = _trees()
    assert optimizers.sgd(0.1).init(pp) == {}
    assert sorted(optimizers.sgd(0.1, momentum=0.9).init(pp)) == ["mu"]
