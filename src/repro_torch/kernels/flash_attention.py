"""Flash attention (forward) — the attention of the LM prefill/forward path
with ``attn_impl='kernel'``.

It replaces the TPU kernel
``repro.kernels.flash_attention.flash_attention_pallas`` with
``csrc/flash_attention.cu`` and keeps the Pallas body's contract, not the
one of ``repro.kernels.ref.flash_attention``: ``q [B, H, S, D]``,
``k/v [B, Hkv, S, D]`` (bf16 or f32), GQA by index (q-head ``h`` reads
kv-head ``h // (H // Hkv)``), logits ``(q @ k^T) * scale`` in float32
(``scale`` defaults to ``D ** -0.5``), causal positions masked with
``NEG_INF = -1e30``, softmax and ``p @ v`` in float32 — the reference's
``ref.flash_attention`` instead rounds ``p`` to ``v``'s dtype before the
product — and the output cast once to ``q.dtype``. ``S`` must be at most
128 or a multiple of 128 (the Pallas tiling).

This module holds the plain PyTorch version, :func:`flash_attention_ref` —
what a CPU tensor gets and what the kernel is compared with on the card —
and the ``ctypes`` binding of the compiled kernel. The launching wrapper,
with its checks and launch count, is
:func:`repro_torch.kernels.ops.flash_attention`.
"""
from __future__ import annotations

import ctypes

import torch

__all__ = ["flash_attention_ref", "flash_library", "check_seq_len", "NEG_INF", "HEAD_DIMS"]

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128, 256)  # the kernel's instantiations (csrc/flash_attention.cu)


def check_seq_len(S: int) -> None:
    """The Pallas kernel tiles S by min(128, S): S <= 128 or S % 128 == 0."""
    if not (S <= 128 or S % 128 == 0):
        raise ValueError(f"flash_attention: S={S} must be <= 128 or a multiple of 128 "
                         "(pad the sequence to tile multiples)")


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
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
