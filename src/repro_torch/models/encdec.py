"""Encoder-decoder backbone (whisper-tiny; ``repro.models.encdec``): a
full-attention encoder over precomputed frame embeddings (the conv frontend
is a stub: ``frames [B, S_enc, d]``), a causal decoder with cross-attention.
Sinusoidal encoder positions, learned decoder positions (``dec_pos``, 32 768
rows), LayerNorm with gain ``1 + g``, tied output head.

Self-attention takes ``attn_impl`` (``'kernel'``: the hand-written
``flash_attention``, non-causal in the encoder, causal in the decoder).
Cross-attention is plain torch: the kernel takes one sequence length for q
and k. Decode reads the cross K/V that :func:`prefill_cross` computed once
from the encoder's output. The reference has no decoder prefill, and
neither has the port (``get_model(...).prefill is None``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import _out_proj, _proj, attention, decode_attention
from repro_torch.models.attention import init_attention
from repro_torch.models.common import Init, cross_entropy, dtype_of, layer_norm, wide
from repro_torch.models.mlp import init_mlp, mlp
from repro_torch.models.transformer import layer_params

__all__ = ["init_params", "build_params", "cache_axes", "encode", "decode_train", "init_cache",
           "prefill_cross", "decode_step", "loss_fn"]

DEC_POS = 32768  # learned decoder positions, sized for the largest shape (32k)


def _init_ln(init: Init, d: int, stack: int = 0):
    f32 = torch.float32
    return {"g": init((d,), ("embed",), dtype=f32, scale=0.0, stack=stack),
            "b": init((d,), ("embed",), dtype=f32, zeros=True, stack=stack)}


def _ln(x, p, eps):
    return layer_norm(x, 1.0 + wide(p["g"]), wide(p["b"]), eps)


def _init_layer(init: Init, cfg: ModelConfig, dtype, n: int, *, cross: bool):
    p = {"ln1": _init_ln(init, cfg.d_model, n),
         "attn": init_attention(init, cfg, dtype, stack=n),
         "ln2": _init_ln(init, cfg.d_model, n),
         "mlp": init_mlp(init, cfg, dtype, stack=n)}
    if cross:
        p["ln_x"] = _init_ln(init, cfg.d_model, n)
        p["xattn"] = init_attention(init, cfg, dtype, stack=n)
    return p


def init_params(cfg: ModelConfig, seed: int = 0, *, device="cuda"):
    """Seeded random parameters on ``device``: the reference's tree and
    scales, another generator."""
    return build_params(cfg, Init(seed, device))


def build_params(cfg: ModelConfig, init: Init):
    """The parameter tree, each leaf made by ``init`` (which records its
    logical axes: ``init.axes(params)``)."""
    dtype = dtype_of(cfg.param_dtype)
    d = cfg.d_model
    return {
        "embed": init((cfg.vocab, d), ("vocab", "embed_fsdp"), dtype=dtype, scale=d ** -0.5),
        "dec_pos": init((DEC_POS, d), (None, "embed_fsdp"), dtype=dtype, scale=0.02),
        "enc": _init_layer(init, cfg, dtype, cfg.n_enc_layers, cross=False),
        "dec": _init_layer(init, cfg, dtype, cfg.n_layers, cross=True),
        "enc_ln": _init_ln(init, d),
        "dec_ln": _init_ln(init, d),
    }


def _sinusoid(S: int, d: int, dtype, device):
    pos = torch.arange(S, dtype=torch.float32, device=device)[:, None]
    i = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / (10000.0 ** (2 * i / d))
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


def _cross_attention(p, x, k, v, cfg: ModelConfig):
    """Decoder queries against the encoder's K/V ``[B, S_enc, H, hd]``
    (whisper: as many K/V heads as query heads)."""
    q = _proj(x, p["wq"])
    if cfg.qkv_bias:
        q = q + p["bq"]
    D = q.shape[-1]
    ct = torch.promote_types(q.dtype, k.dtype)  # jnp's promotion of mixed dtypes
    logits = wide(torch.einsum("bqhd,bkhd->bhqk", q.to(ct), k.to(ct))) * (D ** -0.5)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", w.to(v.dtype), v)
    return _out_proj(out.to(q.dtype), p["wo"])


def encode(params, cfg: ModelConfig, frames, *, attn_impl: str = "auto"):
    """``frames [B, S_enc, d]`` -> encoder output ``[B, S_enc, d]``."""
    x = frames.to(dtype_of(cfg.compute_dtype))
    x = x + _sinusoid(x.shape[1], cfg.d_model, x.dtype, x.device)
    for i in range(cfg.n_enc_layers):
        lp = layer_params(params["enc"], i)
        a, _ = attention(lp["attn"], _ln(x, lp["ln1"], cfg.norm_eps), cfg, None, causal=False,
                         impl=attn_impl)
        x = x + a
        x = x + mlp(lp["mlp"], _ln(x, lp["ln2"], cfg.norm_eps), cfg)
    return _ln(x, params["enc_ln"], cfg.norm_eps)


def _head(params, cfg: ModelConfig, x):
    return torch.matmul(_ln(x, params["dec_ln"], cfg.norm_eps), params["embed"].T)  # tied


def decode_train(params, cfg: ModelConfig, tokens, enc_out, *, attn_impl: str = "auto"):
    """Teacher-forced decoder over ``tokens [B, S]`` -> logits ``[B, S, V]``."""
    x = F.embedding(tokens, params["embed"]).to(dtype_of(cfg.compute_dtype))  # see transformer
    x = x + params["dec_pos"][:x.shape[1]].to(x.dtype)
    for i in range(cfg.n_layers):
        lp = layer_params(params["dec"], i)
        a, _ = attention(lp["attn"], _ln(x, lp["ln1"], cfg.norm_eps), cfg, None, causal=True,
                         impl=attn_impl)
        x = x + a
        k, v = _proj(enc_out, lp["xattn"]["wk"]), _proj(enc_out, lp["xattn"]["wv"])
        x = x + _cross_attention(lp["xattn"], _ln(x, lp["ln_x"], cfg.norm_eps), k, v, cfg)
        x = x + mlp(lp["mlp"], _ln(x, lp["ln2"], cfg.norm_eps), cfg)
    return _head(params, cfg, x)


def loss_fn(params, cfg: ModelConfig, batch, *, attn_impl: str = "auto", batch_sum=None):
    """Training loss of ``{frames [B, S_enc, d], tokens [B, S], labels
    [B, S]}`` -> (ce, {"ce", "aux"}): the plain mean cross entropy (no mask)
    and ``aux = 0``, as the reference's; with ``batch_sum``
    (``common.cross_entropy``'s) this rank's share of the global batch's."""
    enc = encode(params, cfg, batch["frames"], attn_impl=attn_impl)
    ce = cross_entropy(decode_train(params, cfg, batch["tokens"], enc, attn_impl=attn_impl),
                       batch["labels"], batch_sum=batch_sum)
    return ce, {"ce": ce, "aux": torch.zeros((), dtype=torch.float32, device=ce.device)}


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, enc_seq: int, dtype=torch.bfloat16,
               *, device="cuda"):
    """Zeroed decode cache: self ``k``/``v`` ``[L, B, max_seq, Kv, hd]`` and
    cross ``xk``/``xv`` ``[L, B, enc_seq, Kv, hd]``."""
    self_shape = (cfg.n_layers, batch, max_seq, cfg.n_kv, cfg.hd)
    cross_shape = (cfg.n_layers, batch, enc_seq, cfg.n_kv, cfg.hd)
    return {n: torch.zeros(s, dtype=dtype, device=device)
            for n, s in (("k", self_shape), ("v", self_shape), ("xk", cross_shape),
                         ("xv", cross_shape))}


def cache_axes(cfg: ModelConfig):
    """The logical axes of :func:`init_cache`'s tree (the reference's)."""
    ax = ("layers", "cache_batch", "cache_seq", "kv_heads", "head_dim")
    return {"k": ax, "v": ax, "xk": ax, "xv": ax}


def prefill_cross(params, cfg: ModelConfig, enc_out):
    """Cross K/V for decode, once per encoder output: ``[L, B, S_enc, Kv, hd]``
    stacks (no bias on k and v, as the reference has it)."""
    x = params["dec"]["xattn"]
    ks = torch.stack([_proj(enc_out, x["wk"][i]) for i in range(cfg.n_layers)])
    vs = torch.stack([_proj(enc_out, x["wv"][i]) for i in range(cfg.n_layers)])
    return ks, vs


def decode_step(params, cfg: ModelConfig, token, cache, pos):
    """One decoder step: ``token [B]`` at ``pos`` -> (logits [B, V], cache);
    the self K/V row is written into the cache in place."""
    pos = int(pos)
    x = params["embed"][token][:, None].to(dtype_of(cfg.compute_dtype))
    x = x + params["dec_pos"][pos][None, None].to(x.dtype)
    for i in range(cfg.n_layers):
        lp = layer_params(params["dec"], i)
        a, _ = decode_attention(lp["attn"], _ln(x, lp["ln1"], cfg.norm_eps), cfg, None,
                                cache["k"][i], cache["v"][i], pos)
        x = x + a
        x = x + _cross_attention(lp["xattn"], _ln(x, lp["ln_x"], cfg.norm_eps), cache["xk"][i],
                                 cache["xv"][i], cfg)
        x = x + mlp(lp["mlp"], _ln(x, lp["ln2"], cfg.norm_eps), cfg)
    return _head(params, cfg, x)[:, 0], cache
