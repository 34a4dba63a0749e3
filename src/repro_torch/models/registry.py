"""Unified model API of the port: (init, forward, prefill, decode_step,
init_cache) per config — the dense family only (``repro.models.registry``
serves every family).

``init(seed, device=...)`` returns the parameter dict alone and
``init_cache(...)`` the cache dict alone: there are no logical sharding axes
to return beside them. ``loss_fn`` raises: training is ROADMAP A10c.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer

__all__ = ["ModelAPI", "get_model"]


@dataclasses.dataclass
class ModelAPI:
    cfg: ModelConfig
    init: Callable
    forward: Callable
    loss_fn: Callable
    prefill: Callable
    decode_step: Callable
    init_cache: Callable


def _no_training(*args, **kwargs):
    raise NotImplementedError("loss_fn: training is not ported yet (ROADMAP A10c: loss_fn, "
                              "autograd through the plain paths, train/)")


def get_model(cfg: ModelConfig) -> ModelAPI:
    transformer.check_served(cfg)
    return ModelAPI(
        cfg=cfg,
        init=lambda seed=0, device="cuda": transformer.init_params(cfg, seed, device=device),
        forward=lambda p, b, **kw: transformer.forward(
            p, cfg, b.get("tokens"), embeds=b.get("embeds"), mrope_pos=b.get("mrope_pos"), **kw),
        loss_fn=_no_training,
        prefill=lambda p, b, **kw: transformer.prefill(
            p, cfg, b.get("tokens"), embeds=b.get("embeds"), mrope_pos=b.get("mrope_pos"), **kw),
        decode_step=lambda p, tok, cache, pos: transformer.decode_step(p, cfg, tok, cache, pos),
        init_cache=lambda b, s, dtype=torch.bfloat16, device="cuda": transformer.init_cache(
            cfg, b, s, dtype, device=device),
    )
