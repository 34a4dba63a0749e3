"""Architecture config registry: --arch <id> resolution (a copy of
``repro.configs``, data only)."""
from repro_torch.configs.base import ModelConfig, SHAPES, ShapeSpec, reduce_for_smoke  # noqa: F401

from repro_torch.configs.rwkv6_3b import CONFIG as _rwkv6_3b
from repro_torch.configs.granite_8b import CONFIG as _granite_8b
from repro_torch.configs.starcoder2_15b import CONFIG as _starcoder2_15b
from repro_torch.configs.gemma_2b import CONFIG as _gemma_2b
from repro_torch.configs.qwen2_5_3b import CONFIG as _qwen2_5_3b
from repro_torch.configs.whisper_tiny import CONFIG as _whisper_tiny
from repro_torch.configs.qwen2_vl_72b import CONFIG as _qwen2_vl_72b
from repro_torch.configs.recurrentgemma_9b import CONFIG as _recurrentgemma_9b
from repro_torch.configs.olmoe_1b_7b import CONFIG as _olmoe_1b_7b
from repro_torch.configs.qwen3_moe_235b import CONFIG as _qwen3_moe_235b

ARCHS = {
    c.arch_id: c
    for c in [
        _rwkv6_3b,
        _granite_8b,
        _starcoder2_15b,
        _gemma_2b,
        _qwen2_5_3b,
        _whisper_tiny,
        _qwen2_vl_72b,
        _recurrentgemma_9b,
        _olmoe_1b_7b,
        _qwen3_moe_235b,
    ]
}


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; have {sorted(ARCHS)}")
    return ARCHS[arch_id]


def runnable_cells():
    """All (arch, shape) dry-run cells honoring the long_500k skip rule."""
    cells = []
    for aid, cfg in ARCHS.items():
        for sname, spec in SHAPES.items():
            if sname == "long_500k" and not cfg.subquadratic:
                continue  # full quadratic attention cannot serve 512k decode
            cells.append((aid, sname))
    return cells
