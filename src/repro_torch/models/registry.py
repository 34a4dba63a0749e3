"""Unified model API of the port: (init, forward, prefill, decode_step,
init_cache) per config, every family (``repro.models.registry``).

``init(seed, device=...)`` returns the parameter dict alone and
``init_cache(...)`` the cache dict alone: there are no logical sharding axes
to return beside them. ``forward(params, batch)`` returns (logits, aux); for
the encoder-decoder it is ``decode_train(encode(frames), tokens)``, whose
``prefill`` is ``None`` as in the reference (serve it with ``encdec.encode``,
``prefill_cross`` and ``decode_step``; ``init_cache`` takes ``enc_seq``).
``loss_fn(params, batch, attn_impl=...)`` returns (loss, {"ce", "aux"}).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import encdec, transformer

__all__ = ["ModelAPI", "get_model"]


@dataclasses.dataclass
class ModelAPI:
    cfg: ModelConfig
    init: Callable
    forward: Callable
    loss_fn: Callable
    prefill: Optional[Callable]
    decode_step: Callable
    init_cache: Callable


def _encdec_forward(cfg, p, b, attn_impl="auto"):
    enc = encdec.encode(p, cfg, b["frames"], attn_impl=attn_impl)
    return encdec.decode_train(p, cfg, b["tokens"], enc, attn_impl=attn_impl), 0.0


def get_model(cfg: ModelConfig) -> ModelAPI:
    if cfg.is_encdec:
        return ModelAPI(
            cfg=cfg,
            init=lambda seed=0, device="cuda": encdec.init_params(cfg, seed, device=device),
            forward=lambda p, b, **kw: _encdec_forward(cfg, p, b, **kw),
            loss_fn=lambda p, b, **kw: encdec.loss_fn(p, cfg, b, **kw),
            prefill=None,
            decode_step=lambda p, tok, cache, pos: encdec.decode_step(p, cfg, tok, cache, pos),
            init_cache=lambda b, s, dtype=torch.bfloat16, enc_seq=None, device="cuda":
                encdec.init_cache(cfg, b, s, enc_seq or s, dtype, device=device),
        )
    return ModelAPI(
        cfg=cfg,
        init=lambda seed=0, device="cuda": transformer.init_params(cfg, seed, device=device),
        forward=lambda p, b, **kw: transformer.forward(
            p, cfg, b.get("tokens"), embeds=b.get("embeds"), mrope_pos=b.get("mrope_pos"), **kw),
        loss_fn=lambda p, b, **kw: transformer.loss_fn(p, cfg, b, **kw),
        prefill=lambda p, b, **kw: transformer.prefill(
            p, cfg, b.get("tokens"), embeds=b.get("embeds"), mrope_pos=b.get("mrope_pos"), **kw),
        decode_step=lambda p, tok, cache, pos: transformer.decode_step(p, cfg, tok, cache, pos),
        init_cache=lambda b, s, dtype=torch.bfloat16, device="cuda": transformer.init_cache(
            cfg, b, s, dtype, device=device),
    )
