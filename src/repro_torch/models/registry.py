"""Unified model API of the port: (init, forward, prefill, decode_step,
init_cache) per config, every family (``repro.models.registry``).

``init(seed, device=...)`` returns the parameter dict alone and
``init_cache(...)`` the cache dict alone; their logical sharding axes come
from :func:`abstract_params` and :func:`cache_axes`, and
:func:`input_specs` gives the step's inputs — meta tensors, nothing
allocated on any device (the dry-run's contract, ``launch.dryrun``).
``forward(params, batch)`` returns (logits, aux); for the encoder-decoder
it is ``decode_train(encode(frames), tokens)``, whose ``prefill`` is
``None`` as in the reference (serve it with ``encdec.encode``,
``prefill_cross`` and ``decode_step``; ``init_cache`` takes ``enc_seq``).
``loss_fn(params, batch, attn_impl=...)`` returns (loss, {"ce", "aux"}).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.models import encdec, transformer
from repro_torch.models.common import Init, dtype_of

__all__ = ["ModelAPI", "get_model", "abstract_params", "abstract_tree", "cache_axes",
           "input_specs"]

META = torch.device("meta")


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


def _family(cfg: ModelConfig):
    return encdec if cfg.is_encdec else transformer


def abstract_params(cfg: ModelConfig, seed: int = 0):
    """(parameter tree of meta tensors, logical axes tree) without allocating
    anything: the reference's ``abstract_params`` (``jax.eval_shape`` of its
    init). ``seed`` is accepted for its signature; meta tensors hold no
    values."""
    del seed
    init = Init(0, META)
    params = _family(cfg).build_params(cfg, init)
    return params, init.axes(params)


def abstract_tree(fn):
    """``fn() -> (tensor tree, axes tree)`` run with meta as the default
    device; raises if a leaf of the tree is not a meta tensor (``fn`` must
    pass ``device="meta"`` where it names a device)."""
    with META:
        tree, axes = fn()
    bad = [t.device for t in _leaves(tree) if t.device != META]
    if bad:
        raise ValueError(f"abstract_tree: {len(bad)} leaves allocated on {bad[0]}, not meta")
    return tree, axes


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def cache_axes(cfg: ModelConfig):
    """Logical axes of ``get_model(cfg).init_cache(...)``'s tree."""
    return _family(cfg).cache_axes(cfg)


def input_specs(cfg: ModelConfig, shape: ShapeSpec, *, reduced: bool = False) -> Dict[str, Any]:
    """Meta tensors of every input of the step the shape's kind selects, with
    the reference's keys, shapes and dtypes (``repro.models.registry.
    input_specs``; ``reduced``: batch 8, 128 tokens)."""
    B = 8 if reduced else shape.global_batch
    S = 128 if reduced else shape.seq_len
    i32 = torch.int32
    cdt = dtype_of(cfg.compute_dtype)
    m = lambda *dims, dt=i32: torch.empty(dims, dtype=dt, device=META)  # noqa: E731
    if shape.kind == "decode":  # one new token against a seq_len cache
        return {"token": m(B)}
    if cfg.is_encdec:
        out = {"frames": m(B, S, cfg.d_model, dt=cdt), "tokens": m(B, S)}
    elif cfg.mrope_sections is not None:
        out = {"embeds": m(B, S, cfg.d_model, dt=cdt), "mrope_pos": m(B, 3, S)}
    else:
        out = {"tokens": m(B, S)}
    if shape.kind == "train":
        out["labels"] = m(B, S)
    return out
