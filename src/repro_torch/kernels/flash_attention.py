"""Flash attention (forward) — the attention of the LM prefill/forward path
with ``attn_impl='kernel'``.

It replaces the TPU kernel
``repro.kernels.flash_attention.flash_attention_pallas`` with
``csrc/flash_attention.cu``: ``q [B, H, S, D]``, ``k/v [B, Hkv, S, D]``
(bf16 or f32), GQA by index (q-head ``h`` reads kv-head ``h // (H // Hkv)``),
logits ``(q @ k^T) * scale`` in float32 (``scale`` defaults to
``D ** -0.5``), causal positions masked, online softmax in float32 and the
output cast once to ``q.dtype``. ``S`` must be at most 128 or a multiple of
128 (the Pallas tiling).

The two dtypes have two kernels and two contracts:

* **bfloat16** — the tensor-core kernel (``wgmma``). Its arithmetic is
  :func:`flash_attention_bf16_ref`: keys in tiles of :func:`key_tile` ``(D)``
  in order, a running row max ``m`` and sum ``l``, the softmax as ``exp2``
  with ``scale·log2(e)`` folded in, ``l`` summing ``p`` in float32 BEFORE it
  is rounded, and ``p`` rounded to bf16 for ``p @ v`` (float32
  accumulation). Rounding ``p`` to ``v``'s dtype is what the JAX package's
  own oracle ``repro.kernels.ref.flash_attention`` does; the Pallas body
  keeps ``p`` in float32.
* **float32** — the CUDA-core kernel, with the Pallas body's contract,
  :func:`flash_attention_f32_ref`: logits masked with ``NEG_INF = -1e30``,
  softmax and ``p @ v`` all in float32.

:func:`flash_attention_ref` picks the one of the input's dtype: it is what a
CPU tensor gets and what the kernel is compared with on the card. This
module also holds the ``ctypes`` binding of the compiled kernels. The
launching wrapper, with its checks and launch count, is
:func:`repro_torch.kernels.ops.flash_attention`.
"""
from __future__ import annotations

import ctypes

import torch

__all__ = ["flash_attention_ref", "flash_attention_bf16_ref", "flash_attention_f32_ref",
           "flash_library", "check_seq_len", "key_tile", "NEG_INF", "HEAD_DIMS"]

NEG_INF = -1e30
LOG2E = 1.4426950408889634  # log2(e): exp(x) = exp2(x·LOG2E)
HEAD_DIMS = (16, 32, 64, 128, 256)  # the kernel's instantiations (csrc/flash_attention.cu)


def check_seq_len(S: int) -> None:
    """The Pallas kernel tiles S by min(128, S): S <= 128 or S % 128 == 0."""
    if not (S <= 128 or S % 128 == 0):
        raise ValueError(f"flash_attention: S={S} must be <= 128 or a multiple of 128 "
                         "(pad the sequence to tile multiples)")


def key_tile(D: int) -> int:
    """Keys per tile of the bf16 kernel (csrc/flash_attention.cu BK): the
    64 × 256 float32 output accumulator of D = 256 leaves room for 64 keys'
    scores, the other head dims take 128."""
    return 64 if D > 128 else 128


def flash_attention_f32_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                            causal: bool = True, scale: float | None = None) -> torch.Tensor:
    """Attention with the Pallas body's arithmetic, materialised: f32 logits
    times ``scale``, the causal mask, f32 softmax, f32 ``p @ v``, cast to
    ``q.dtype``. ``[B, H, S, D]``; K/V heads are expanded by index."""
    B, H, S, D = q.shape
    Hkv = k.shape[1]
    if H % Hkv:
        raise ValueError(f"flash_attention: H={H} is not a multiple of Hkv={Hkv}")
    rep = H // Hkv
    scale = float(D ** -0.5) if scale is None else float(scale)
    kk = k.float().repeat_interleave(rep, dim=1)
    vv = v.float().repeat_interleave(rep, dim=1)
    s = torch.matmul(q.float(), kk.transpose(-1, -2)) * scale
    if causal:
        mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p, vv).to(q.dtype)


def flash_attention_bf16_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                             causal: bool = True, scale: float | None = None) -> torch.Tensor:
    """The bf16 kernel's arithmetic in plain PyTorch: per key tile of
    ``key_tile(D)`` keys, in order, ``s = q·kᵀ`` in float32 (masked
    positions -inf), ``m' = max(m, max_j s)``, ``corr = exp2((m − m')·c)``,
    ``p = exp2(s·c − m'·c)`` with ``c = scale·log2(e)``,
    ``l = l·corr + Σ_j p`` (float32 ``p``), ``acc = acc·corr +
    bf16(p) @ v`` (float32 products and sums); then ``acc / l`` rounded to
    bf16. The kernel computes ``s·c − m'·c`` as one fused multiply-add, takes
    ``exp2`` from the special-function unit (~2 ulp, subnormal results
    flushed to zero) and sums in another order: the two differ by float32
    rounding, and where that moves a ``p`` across a bf16 rounding
    boundary."""
    B, H, S, D = q.shape
    Hkv = k.shape[1]
    if H % Hkv:
        raise ValueError(f"flash_attention: H={H} is not a multiple of Hkv={Hkv}")
    rep = H // Hkv
    scale = float(D ** -0.5) if scale is None else float(scale)
    c = scale * LOG2E
    BK = key_tile(D)
    qf = q.float()
    kk = k.float().repeat_interleave(rep, dim=1)
    vv = v.float().repeat_interleave(rep, dim=1)
    m = torch.full((B, H, S), float("-inf"), device=q.device)
    l = torch.zeros((B, H, S), device=q.device)
    acc = torch.zeros((B, H, S, D), device=q.device)
    rows = torch.arange(S, device=q.device)
    for k0 in range(0, S, BK):
        k1 = min(k0 + BK, S)
        s = torch.matmul(qf, kk[:, :, k0:k1].transpose(-1, -2))
        if causal:
            keys = torch.arange(k0, k1, device=q.device)
            s = s.masked_fill(keys[None, :] > rows[:, None], float("-inf"))
        m_new = torch.maximum(m, s.amax(-1))
        corr = torch.exp2((m - m_new) * c)
        p = torch.exp2(s * c - (m_new * c)[..., None])
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.matmul(p.to(torch.bfloat16).float(), vv[:, :, k0:k1])
        m = m_new
    return (acc / l[..., None]).to(q.dtype)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, scale: float | None = None) -> torch.Tensor:
    """The plain version of the kernel for ``q``'s dtype: bf16
    (:func:`flash_attention_bf16_ref`) or float32
    (:func:`flash_attention_f32_ref`)."""
    fn = flash_attention_bf16_ref if q.dtype == torch.bfloat16 else flash_attention_f32_ref
    return fn(q, k, v, causal=causal, scale=scale)


def flash_library(*, verbose: bool = False) -> ctypes.CDLL:
    """The compiled ``csrc/flash_attention.cu``, built at first use, with the
    argument types of ``flash_attention_f32`` / ``flash_attention_bf16`` set
    (pointers and the stream are ``c_void_p``: ctypes would otherwise cut
    them to 32 bits)."""
    from ._build import load_library

    lib = load_library("flash_attention", verbose=verbose)
    for fn in (lib.flash_attention_f32, lib.flash_attention_bf16):
        if fn.argtypes is None:
            p, i = ctypes.c_void_p, ctypes.c_int
            fn.argtypes = [p, p, p, p, i, i, i, i, i, ctypes.POINTER(ctypes.c_longlong),
                           ctypes.c_float, i, i, p]
            fn.restype = i
    return lib
