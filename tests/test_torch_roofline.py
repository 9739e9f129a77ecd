"""`repro_torch.launch.roofline`: `active_param_count` and
`model_flops_per_step` equal to the reference's for all ten zoo configs
(parameter totals counted from the port's meta-device init, no storage),
the terms of `Roofline`, and the port's constants the H100 SXM's, not the
TPU v5e's."""
import pytest

torch = pytest.importorskip("torch")

from repro.configs.registry import get_config as ref_get_config  # noqa: E402
from repro.launch import roofline as ref_rl  # noqa: E402
from repro_torch.configs.registry import ARCH_IDS, get_config  # noqa: E402
from repro_torch.launch import roofline as rl  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402


def _param_total(cfg):
    with torch.device("meta"):
        params = transformer.init_transformer(None, cfg)
    return sum(p.numel() for p in tree_leaves(params))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_active_params_and_model_flops_match_reference(arch):
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    total = _param_total(cfg)
    active = rl.active_param_count(cfg, total)
    assert active == ref_rl.active_param_count(rcfg, total)
    assert (active < total) == bool(cfg.moe)
    for tokens in (1, 8192):
        assert rl.model_flops_per_step(cfg, tokens, active) == \
            ref_rl.model_flops_per_step(rcfg, tokens, active)


def test_zamba2_parameter_count_is_the_published_one():
    """1,104,777,344 parameters (PERF.md §4), counted without storage."""
    assert _param_total(get_config("zamba2-1.2b")) == 1_104_777_344


def test_constants_are_the_h100s():
    assert rl.PEAK_FLOPS == 989e12            # dense bf16, H100 SXM
    assert rl.HBM_BW == 3.35e12               # HBM3, H100 SXM
    assert rl.LINK_BW == 450e9                # NVLink 4, each way
    for v5e in (ref_rl.PEAK_FLOPS, ref_rl.HBM_BW, ref_rl.ICI_BW):
        assert v5e not in (rl.PEAK_FLOPS, rl.HBM_BW, rl.LINK_BW)


def test_roofline_terms():
    r = rl.Roofline(flops_per_device=989e12, bytes_per_device=6.7e12,
                    collective_bytes_per_device=45e9, collective_count=3,
                    chips=1)
    assert r.compute_s == pytest.approx(1.0)
    assert r.memory_s == pytest.approx(2.0)
    assert r.collective_s == pytest.approx(0.1)
    assert r.dominant == "memory"
    d = r.to_dict()
    assert d["dominant"] == "memory" and d["chips"] == 1
    assert sorted(d) == sorted(ref_rl.Roofline(1, 1, 1, 1, 1).to_dict())
    assert rl.mfu(2.0, 989e12) == pytest.approx(0.5)
