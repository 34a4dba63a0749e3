"""Shared model plumbing: dtypes, norms, rotary embeddings, seeded init.

Parameters are plain nested dicts of tensors with the reference's keys and
shapes (``repro.models``), layers stacked on a leading axis, so weights
carry across one-to-one (``models.weights``). There are no logical sharding
axes and no activation checkpointing here: those belong to sharding and
training (ROADMAP A10).
"""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["dtype_of", "rms_norm", "layer_norm", "rotary", "apply_rope", "mrope_positions",
           "Init", "no_training"]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]


def no_training(*args, **kwargs):
    """Every family's ``loss_fn``: training is not ported yet."""
    raise NotImplementedError("loss_fn: training is not ported yet (ROADMAP A10c: loss_fn, "
                              "autograd through the plain paths, train/)")


def rms_norm(x, gamma, eps: float):
    dt = x.dtype
    x32 = x.float()
    nrm = x32 * torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)
    return (nrm * (1.0 + gamma.float())).to(dt)


def layer_norm(x, gamma, beta, eps: float):
    dt = x.dtype
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, unbiased=False)
    return ((x32 - mu) * torch.rsqrt(var + eps) * gamma + beta).to(dt)


def rotary(positions, head_dim: int, theta: float, dtype=torch.float32):
    """[..., head_dim/2] cos/sin tables for the given integer positions."""
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=positions.device) / half
    freqs = 1.0 / (torch.tensor(theta, dtype=torch.float32, device=positions.device) ** exps)
    ang = positions.float()[..., None] * freqs  # [..., half]
    return torch.cos(ang).to(dtype), torch.sin(ang).to(dtype)


def apply_rope(x, cos, sin):
    """x [..., S, H, D]; cos/sin [..., S, 1, D/2] (broadcastable).

    Rotation of the two halves (not interleaved pairs) in fp32, cast back."""
    dt = x.dtype
    x32 = x.float()
    half = x.shape[-1] // 2
    x1, x2 = x32[..., :half], x32[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(dt)


def mrope_positions(positions, sections, head_dim: int, theta: float):
    """Qwen2-VL M-RoPE: the ``head_dim/2`` rotary frequencies are split into
    ``sections`` (temporal / height / width), each rotated by its own
    position stream. ``positions [B, 3, S]`` (for pure text the three streams
    are equal, which gives :func:`rotary`'s tables). Returns cos/sin
    ``[B, S, 1, head_dim/2]`` in float32."""
    half = head_dim // 2
    if sum(sections) != half:
        raise ValueError(f"mrope sections {tuple(sections)} must sum to head_dim/2 = {half}")
    exps = torch.arange(0, half, dtype=torch.float32, device=positions.device) / half
    freqs = 1.0 / (torch.tensor(theta, dtype=torch.float32, device=positions.device) ** exps)
    cos, sin, off = [], [], 0
    for i, sec in enumerate(sections):
        ang = positions[:, i, :].float()[..., None] * freqs[off:off + sec]  # [B, S, sec]
        cos.append(torch.cos(ang))
        sin.append(torch.sin(ang))
        off += sec
    return torch.cat(cos, -1)[:, :, None, :], torch.cat(sin, -1)[:, :, None, :]


class Init:
    """Seeded parameter factory on one ``torch.Generator``, with the
    reference's scales (``repro.models.common.mk``): normal × ``fan_in ** -0.5``
    (``fan_in`` the first dimension of a vector, else the second to last), an
    explicit ``scale`` where given, zeros for norms and biases. The draws are
    float32 on ``device``, cast to the parameter dtype after scaling — as the
    reference draws in f32 and casts before scaling, a bf16 parameter may
    differ from it by one rounding; the numbers differ anyway (another
    generator). Weights that must equal the reference's come from
    ``models.weights.params_from_reference``."""

    def __init__(self, seed: int, device="cpu"):
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(int(seed))

    def __call__(self, shape, *, dtype, scale: Optional[float] = None, zeros: bool = False,
                 stack: int = 0):
        """One parameter of per-layer ``shape``; with ``stack`` = L, the L
        layers' copies stacked on a leading axis (the scale still comes from
        the per-layer shape)."""
        full = (stack, *shape) if stack else tuple(shape)
        if zeros:
            return torch.zeros(full, dtype=dtype, device=self.device)
        fan_in = shape[0] if len(shape) == 1 else shape[-2]
        s = scale if scale is not None else fan_in ** -0.5
        w = torch.randn(full, generator=self.gen, dtype=torch.float32, device=self.device)
        return w.mul_(s).to(dtype)
