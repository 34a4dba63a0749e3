"""Gated MLPs: SwiGLU (llama/qwen/granite-style) and GeGLU (gemma), and the
ungated two-matrix MLP (starcoder2)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import Init


def init_mlp(init: Init, cfg: ModelConfig, dtype, *, stack: int = 0):
    d, f = cfg.d_model, cfg.d_ff
    p = {
        "w_up": init((d, f), ("embed_fsdp", "mlp"), dtype=dtype, stack=stack),
        "w_down": init((f, d), ("mlp", "embed_fsdp"), dtype=dtype, stack=stack),
    }
    if cfg.mlp_gated:
        p["w_gate"] = init((d, f), ("embed_fsdp", "mlp"), dtype=dtype, stack=stack)
    return p


def _act(cfg: ModelConfig):
    if cfg.act == "silu":
        return F.silu
    return lambda g: F.gelu(g, approximate="tanh")  # jax.nn.gelu(approximate=True)


def mlp(p, x, cfg: ModelConfig):
    act = _act(cfg)
    u = torch.matmul(x, p["w_up"])
    h = act(torch.matmul(x, p["w_gate"])) * u if cfg.mlp_gated else act(u)
    return torch.matmul(h, p["w_down"])
