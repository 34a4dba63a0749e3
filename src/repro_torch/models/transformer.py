"""Decoder-only LM, dense family: init, forward, prefill, KV cache, decode.

Plain functions over a dict of tensors, not ``nn.Module``s: the parameter
tree is the reference's (``repro.models.transformer``) key for key and shape
for shape — ``embed [V, d]``, ``final_norm [d]``, ``lm_head [d, V]`` unless
embeddings are tied, and ``layers`` holding every per-layer parameter
stacked on a leading layer axis (``layers.attn.wq [L, d, H, hd]``, …) — and
the cache is ``{'k', 'v'}`` of ``[L, B, S, Kv, hd]``, so weights and caches
carry across one-to-one (``models.weights``). Layers run in a Python loop
over views of the stacks (the reference's ``lax.scan``).

Only the dense family is served. The other families and M-RoPE inputs
raise ``NotImplementedError`` naming their ROADMAP item; there are no
sharding constraints (one card) and no training (``loss_fn``: A10c).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import attention, decode_attention, init_attention
from repro_torch.models.common import Init, dtype_of, rms_norm, rotary
from repro_torch.models.mlp import init_mlp, mlp

__all__ = ["init_params", "forward", "prefill", "init_cache", "decode_step", "check_served",
           "layer_params"]

DECODE_LOOPS = ("scan", "fori")


def check_served(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for what the port does not serve yet."""
    family = "encdec" if cfg.is_encdec else cfg.family
    if family != "dense":
        raise NotImplementedError(
            f"{cfg.arch_id}: the {family!r} family is not ported yet (ROADMAP A10b: the moe, "
            "rwkv, hybrid/rglru, encdec and M-RoPE families); the port serves 'dense'")


def _no_mrope(mrope_pos):
    if mrope_pos is not None:
        raise NotImplementedError("M-RoPE position inputs are not ported yet (ROADMAP A10b)")


# --------------------------------------------------------------------- init
def init_params(cfg: ModelConfig, seed: int = 0, *, device="cuda"):
    """Seeded random parameters on ``device`` (the card unless asked
    otherwise): the reference's tree and scales, another generator."""
    check_served(cfg)
    init = Init(seed, device)
    dtype = dtype_of(cfg.param_dtype)
    L, d = cfg.n_layers, cfg.d_model
    params = {
        "embed": init((cfg.vocab, d), dtype=dtype, scale=d ** -0.5),
        "final_norm": init((d,), dtype=torch.float32, zeros=True),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = init((d, cfg.vocab), dtype=dtype)
    params["layers"] = {
        "ln1": init((d,), dtype=torch.float32, zeros=True, stack=L),
        "attn": init_attention(init, cfg, dtype, stack=L),
        "ln2": init((d,), dtype=torch.float32, zeros=True, stack=L),
        "mlp": init_mlp(init, cfg, dtype, stack=L),
    }
    return params


def layer_params(tree, i):
    """Views of layer ``i`` of the stacked parameter tree."""
    return {k: layer_params(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


# ------------------------------------------------------------------- blocks
def _rope_for(cfg: ModelConfig, positions, mrope_pos=None):
    _no_mrope(mrope_pos)
    cos, sin = rotary(positions, cfg.hd, cfg.rope_theta)
    return cos[None, :, None, :], sin[None, :, None, :]


def _embed(params, cfg: ModelConfig, tokens, embeds):
    if embeds is None:
        x = params["embed"][tokens].to(dtype_of(cfg.compute_dtype))
    else:
        x = embeds.to(dtype_of(cfg.compute_dtype))
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype, device=x.device)
    return x


def _head(params, cfg: ModelConfig, x):
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return torch.matmul(x, head)


def _block(lp, x, cfg: ModelConfig, rope, attn_impl):
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    a, kv = attention(lp["attn"], h, cfg, rope, causal=cfg.attn_kind == "causal",
                      impl=attn_impl)
    x = x + a
    h = rms_norm(x, lp["ln2"], cfg.norm_eps)
    return x + mlp(lp["mlp"], h, cfg), kv


def forward(params, cfg: ModelConfig, tokens=None, *, embeds=None, mrope_pos=None,
            attn_impl: str = "auto"):
    """Full-sequence forward -> (logits [B, S, V], aux loss 0.0)."""
    check_served(cfg)
    _no_mrope(mrope_pos)
    x = _embed(params, cfg, tokens, embeds)
    S = x.shape[1]
    rope = _rope_for(cfg, torch.arange(S, device=x.device))
    for i in range(cfg.n_layers):
        x, _ = _block(layer_params(params["layers"], i), x, cfg, rope, attn_impl)
    return _head(params, cfg, x), 0.0


# ------------------------------------------------------------------ serving
def prefill(params, cfg: ModelConfig, tokens=None, *, embeds=None, mrope_pos=None,
            attn_impl: str = "auto"):
    """Full-prompt forward that also materialises the decode cache.

    Returns (last-token logits [B, V], cache) with the layout of
    :func:`init_cache`, the cache in the compute dtype.
    """
    check_served(cfg)
    _no_mrope(mrope_pos)
    x = _embed(params, cfg, tokens, embeds)
    B, S = x.shape[0], x.shape[1]
    rope = _rope_for(cfg, torch.arange(S, device=x.device))
    cache = init_cache(cfg, B, S, dtype=dtype_of(cfg.compute_dtype), device=x.device)
    for i in range(cfg.n_layers):
        x, (k, v) = _block(layer_params(params["layers"], i), x, cfg, rope, attn_impl)
        cache["k"][i] = k
        cache["v"][i] = v
    return _head(params, cfg, x[:, -1:])[:, 0], cache


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=torch.bfloat16, *,
               device="cuda"):
    """Zeroed decode cache ``{'k', 'v'}``, each ``[L, B, max_seq, Kv, hd]``."""
    check_served(cfg)
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def decode_step(params, cfg: ModelConfig, token, cache, pos):
    """One decode step: ``token [B]`` at position ``pos`` (the write index)
    -> (logits [B, V], cache).

    Both of the reference's ``cfg.decode_loop`` names are accepted and run
    the same loop: the reference's ``'fori'`` exists only to keep XLA from
    copying the stacked cache through ``lax.scan``, and eager PyTorch has no
    such copy. The new token's K/V are written into the given cache tensors
    in place, and those tensors are returned.
    """
    check_served(cfg)
    if cfg.decode_loop not in DECODE_LOOPS:
        raise ValueError(f"decode_loop must be one of {DECODE_LOOPS}, got {cfg.decode_loop!r}")
    x = _embed(params, cfg, token[:, None], None)
    pos = int(pos)
    rope = _rope_for(cfg, torch.tensor([pos], device=x.device))
    ck, cv = cache["k"], cache["v"]
    for i in range(cfg.n_layers):
        lp = layer_params(params["layers"], i)
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        a, _ = decode_attention(lp["attn"], h, cfg, rope, ck[i], cv[i], pos)
        x = x + a
        h = rms_norm(x, lp["ln2"], cfg.norm_eps)
        x = x + mlp(lp["mlp"], h, cfg)
    return _head(params, cfg, x)[:, 0], {"k": ck, "v": cv}

