"""Architecture registry: --arch <id> -> ModelConfig (port of
`repro.configs.registry`; every arch id of the reference resolves, also
those whose layer kinds the port does not build yet)."""
from __future__ import annotations

import importlib

_ARCH_MODULES = {
    "phi-3-vision-4.2b": "phi3_vision_4_2b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "zamba2-1.2b": "zamba2_1_2b",
    "xlstm-125m": "xlstm_125m",
    "qwen3-32b": "qwen3_32b",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
    "phi3-mini-3.8b": "phi3_mini_3_8b",
    "gemma3-4b": "gemma3_4b",
    "yi-9b": "yi_9b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "paper-cnn": "paper_cnn",
}

ARCH_IDS = [a for a in _ARCH_MODULES if a != "paper-cnn"]

# archs eligible for the long_500k decode shape (sub-quadratic decode path)
LONG_CONTEXT_ARCHS = ("zamba2-1.2b", "xlstm-125m", "gemma3-4b")


def get_config(arch_id: str):
    key = arch_id.replace("_", "-") if arch_id not in _ARCH_MODULES else arch_id
    if key not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_ARCH_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[key]}")
    return mod.CONFIG


def combos(shapes=None):
    """All (arch, shape) dry-run combinations, honoring long_500k skips."""
    from repro_torch.configs.base import INPUT_SHAPES
    shapes = shapes or list(INPUT_SHAPES)
    out = []
    for a in ARCH_IDS:
        for s in shapes:
            if s == "long_500k" and a not in LONG_CONTEXT_ARCHS:
                continue
            out.append((a, s))
    return out
