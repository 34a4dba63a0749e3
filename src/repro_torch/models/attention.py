"""Attention: GQA/MQA/MHA with RoPE / QK-norm / QKV bias, memory-bounded
blocked softmax for long prefill, and KV-cache decode.

Three execution paths, one math (the reference's ``repro.models.attention``):
  * ``impl='dense'``   — materialised logits (short sequences; exact oracle)
  * ``impl='blocked'`` — online softmax over (query-chunk × kv-chunk) tiles in
    plain torch: memory O(Tq × Tk), picked by ``'auto'`` above 4 096 tokens
  * ``impl='kernel'``  — the hand-written CUDA ``flash_attention`` kernel
    (``repro_torch.kernels.ops``; its plain version for CPU tensors). It is
    the port's name for the reference's ``impl='pallas'``, which raises here.
Everything outside the kernel is plain torch (``matmul``/``einsum``), as the
reference leaves it to XLA.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import Init, apply_rope, rms_norm, wide

NEG_INF = -1e30
IMPLS = ("auto", "dense", "blocked", "kernel")


def init_attention(init: Init, cfg: ModelConfig, dtype, *, stack: int = 0):
    d, H, Kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.hd
    p = {
        "wq": init((d, H, hd), ("embed_fsdp", "heads", "head_dim"), dtype=dtype, stack=stack),
        "wk": init((d, Kv, hd), ("embed_fsdp", "kv_heads", "head_dim"), dtype=dtype, stack=stack),
        "wv": init((d, Kv, hd), ("embed_fsdp", "kv_heads", "head_dim"), dtype=dtype, stack=stack),
        "wo": init((H, hd, d), ("heads", "head_dim", "embed_fsdp"), dtype=dtype, stack=stack),
    }
    if cfg.qkv_bias:
        p["bq"] = init((H, hd), ("heads", "head_dim"), dtype=dtype, zeros=True, stack=stack)
        p["bk"] = init((Kv, hd), ("kv_heads", "head_dim"), dtype=dtype, zeros=True, stack=stack)
        p["bv"] = init((Kv, hd), ("kv_heads", "head_dim"), dtype=dtype, zeros=True, stack=stack)
    if cfg.qk_norm:
        p["q_norm"] = init((hd,), ("head_dim",), dtype=torch.float32, zeros=True, stack=stack)
        p["k_norm"] = init((hd,), ("head_dim",), dtype=torch.float32, zeros=True, stack=stack)
    return p


def _proj(x, w):
    """einsum('bsd,dhk->bshk'): one matmul over the flattened heads."""
    d, h, k = w.shape
    return torch.matmul(x, w.reshape(d, h * k)).unflatten(-1, (h, k))


def _out_proj(o, wo):
    """einsum('bshk,hkd->bsd')."""
    h, k, d = wo.shape
    return torch.matmul(o.flatten(-2), wo.reshape(h * k, d))


def qkv(p, x, cfg: ModelConfig, rope: Optional[Tuple]):
    q, k, v = _proj(x, p["wq"]), _proj(x, p["wk"]), _proj(x, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if rope is not None:
        cos, sin = rope
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    return q, k, v


def _dense_attn(q, k, v, *, causal, window):
    B, Sq, H, D = q.shape
    Kv = k.shape[2]
    rep = H // Kv
    scale = D ** -0.5
    qh = q.reshape(B, Sq, Kv, rep, D)
    logits = wide(torch.einsum("bqhrd,bkhd->bhrqk", qh, k)) * scale
    rows = torch.arange(Sq, device=q.device)[:, None]
    cols = torch.arange(k.shape[1], device=q.device)[None, :]
    mask = torch.ones((Sq, k.shape[1]), dtype=torch.bool, device=q.device)
    if causal:
        mask &= rows >= cols
    if window:
        mask &= rows - cols < window
    logits = logits.masked_fill(~mask, NEG_INF)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhrqk,bkhd->bqhrd", w.to(v.dtype), v)
    return out.reshape(B, Sq, H, D)


def _blocked_attn(q, k, v, *, causal, window, tq=2048, tk=2048):
    """Online softmax over (query-chunk × kv-chunk) tiles in plain torch."""
    B, S, H, D = q.shape
    Kv = k.shape[2]
    rep = H // Kv
    scale = D ** -0.5
    nq, nk = -(-S // tq), -(-S // tk)
    pad = lambda t, n: torch.nn.functional.pad(t, (0, 0, 0, 0, 0, n - S))  # noqa: E731
    qs = pad(q, nq * tq).reshape(B, nq, tq, Kv, rep, D)
    ks = pad(k, nk * tk).reshape(B, nk, tk, Kv, D)
    vs = pad(v, nk * tk).reshape(B, nk, tk, Kv, D)
    outs = []
    for qi in range(nq):
        q_blk = qs[:, qi]
        m = torch.full((B, tq, Kv, rep), NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros((B, tq, Kv, rep), dtype=torch.float32, device=q.device)
        acc = torch.zeros((B, tq, Kv, rep, D), dtype=torch.float32, device=q.device)
        rows = qi * tq + torch.arange(tq, device=q.device)[:, None]
        for kj in range(nk):
            k_blk, v_blk = ks[:, kj], vs[:, kj]
            s = torch.einsum("bqhrd,bkhd->bqhrk", q_blk, k_blk).float() * scale
            cols = kj * tk + torch.arange(tk, device=q.device)[None, :]
            ok = (rows < S) & (cols < S)
            if causal:
                ok &= rows >= cols
            if window:
                ok &= rows - cols < window
            s = s.masked_fill(~ok[None, :, None, None, :], NEG_INF)
            m2 = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m2[..., None])
            corr = torch.exp(m - m2)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum("bqhrk,bkhd->bqhrd", p.to(v_blk.dtype),
                                                       v_blk)
            m = m2
        outs.append(acc / torch.clamp(l[..., None], min=1e-30))
    out = torch.stack(outs, 1).reshape(B, nq * tq, H, D)[:, :S]
    return out.to(q.dtype)


def attention(p, x, cfg: ModelConfig, rope, *, causal=True, window=0, impl: str = "auto"):
    """Self-attention over ``x [B, S, d]`` -> (out [B, S, d], (k, v)), with
    ``k/v [B, S, Kv, hd]`` the cache rows of this layer."""
    if impl == "pallas":
        raise ValueError("impl='pallas' is the JAX package's name; the port's CUDA kernel is "
                         "impl='kernel'")
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    q, k, v = qkv(p, x, cfg, rope)
    S = x.shape[1]
    if impl == "auto":
        impl = "blocked" if S > 4096 else "dense"
    if impl == "dense":
        out = _dense_attn(q, k, v, causal=causal, window=window)
    elif impl == "blocked":
        out = _blocked_attn(q, k, v, causal=causal, window=window)
    else:
        if window:
            raise NotImplementedError("the flash_attention kernel has no sliding window (nor "
                                      "has the reference's Pallas kernel): use 'dense' or "
                                      "'blocked'")
        from repro_torch.kernels import ops

        out = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                  causal=causal).transpose(1, 2)
    return _out_proj(out, p["wo"]), (k, v)


def decode_attention(p, x, cfg: ModelConfig, rope, cache_k, cache_v, write_pos, *,
                     valid_len=None):
    """One-token decode against a ``[B, S, Kv, D]`` cache -> (out, (cache_k,
    cache_v)).

    ``write_pos`` is the slot receiving the new token; ``valid_len`` masks
    the populated prefix of the cache (default ``write_pos + 1``). The new
    K/V row is written into ``cache_k``/``cache_v`` IN PLACE (the reference
    returns updated copies), and the same tensors are returned.
    """
    q, k_new, v_new = qkv(p, x, cfg, rope)  # q [B, 1, H, D]
    B, _, H, D = q.shape
    Kv = k_new.shape[2]
    pos = int(write_pos)
    cache_k[:, pos:pos + 1] = k_new.to(cache_k.dtype)
    cache_v[:, pos:pos + 1] = v_new.to(cache_v.dtype)
    rep = H // Kv
    S = cache_k.shape[1]
    valid = pos + 1 if valid_len is None else int(valid_len)
    ct = torch.promote_types(q.dtype, cache_k.dtype)
    qh = q.reshape(B, 1, Kv, rep, D).to(ct)
    logits = torch.einsum("bqhrd,bkhd->bhrqk", qh, cache_k.to(ct)).float() * (D ** -0.5)
    ok = torch.arange(S, device=q.device) < valid
    logits = logits.masked_fill(~ok, NEG_INF)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhrqk,bkhd->bqhrd", w.to(cache_v.dtype), cache_v).reshape(B, 1, H, D)
    return _out_proj(out.to(q.dtype), p["wo"]), (cache_k, cache_v)
