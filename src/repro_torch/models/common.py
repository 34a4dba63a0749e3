"""Shared model plumbing: dtypes, norms, rotary embeddings, seeded init,
the training loss and per-layer activation checkpointing.

Parameters are plain nested dicts of tensors with the reference's keys and
shapes (``repro.models``), layers stacked on a leading axis, so weights
carry across one-to-one (``models.weights``). :class:`Init` records each
parameter's logical sharding axes beside it (``models.registry.abstract_params``,
``sharding.rules``).
"""
from __future__ import annotations

import functools
from typing import Optional

import torch
from torch.utils import checkpoint as _ckpt

__all__ = ["dtype_of", "wide", "rms_norm", "layer_norm", "rotary", "apply_rope",
           "mrope_positions", "Init", "cross_entropy", "REMAT_POLICIES", "maybe_remat"]

# float64 beside the reference's three: a float64 run of a float32 config is
# the yardstick its float32 gradients are read against
_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16,
           "float64": torch.float64}

_aten = torch.ops.aten
#: activation-checkpoint policies applied to each layer (the reference's
#: ``jax.checkpoint_policies``): ``'none'`` keeps every activation, ``'full'``
#: keeps only the layer's inputs and recomputes the rest in the backward,
#: ``'dots'`` also keeps the outputs of the matrix products (``mm``,
#: ``addmm``, ``bmm``) and ``'dots_no_batch'`` those of the products without
#: a batch dimension (``mm``, ``addmm``). A policy changes memory and time,
#: never values.
REMAT_POLICIES = {
    "none": None,
    "full": (),
    "dots": (_aten.mm.default, _aten.addmm.default, _aten.bmm.default),
    "dots_no_batch": (_aten.mm.default, _aten.addmm.default),
}


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]


def wide(x):
    """``x`` in float32 where the reference widens to float32; a float64
    ``x`` stays float64."""
    return x if x.dtype == torch.float64 else x.float()


def maybe_remat(fn, remat: str):
    """``fn`` run under the activation-checkpoint policy ``remat`` (a key of
    :data:`REMAT_POLICIES`) whenever autograd records; called as it is
    otherwise (serving)."""
    if remat not in REMAT_POLICIES:
        raise ValueError(f"remat must be one of {tuple(REMAT_POLICIES)}, got {remat!r}")
    saved = REMAT_POLICIES[remat]
    if saved is None:
        return fn
    kw = {}
    if saved:
        kw["context_fn"] = functools.partial(_ckpt.create_selective_checkpoint_contexts,
                                             list(saved))

    def run(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        # the models draw no random numbers: no RNG state to replay
        return _ckpt.checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False, **kw)

    return run


def cross_entropy(logits, labels, mask=None, batch_sum=None):
    """Mean next-token cross entropy in float32 (float64 for float64
    logits): ``Σ (lse − gold)·mask /
    max(Σ mask, 1)``, or the plain mean over every position when ``mask`` is
    None (the reference's ``loss_fn``s).

    With ``batch_sum`` (``x`` → ``x`` summed over every rank's rows of the
    global batch, no gradient: the data-parallel train step's) the
    denominator is the global batch's and the sum this rank's rows': the
    ranks' losses add up to the global batch's, and so do their gradients."""
    lf = wide(logits)
    nll = torch.logsumexp(lf, dim=-1) - torch.gather(lf, -1, labels[..., None].long())[..., 0]
    if batch_sum is not None:
        if mask is None:
            count = torch.full((), float(nll.numel()), dtype=nll.dtype, device=nll.device)
            return torch.sum(nll) / batch_sum(count)
        mask = mask.to(lf.dtype)
        return torch.sum(nll * mask) / torch.clamp(batch_sum(mask.sum().detach()), min=1.0)
    if mask is None:
        return torch.mean(nll)
    mask = mask.to(lf.dtype)
    return torch.sum(nll * mask) / torch.clamp(mask.sum(), min=1.0)


def rms_norm(x, gamma, eps: float):
    dt = x.dtype
    x32 = wide(x)
    nrm = x32 * torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)
    return (nrm * (1.0 + gamma.to(x32.dtype))).to(dt)


def layer_norm(x, gamma, beta, eps: float):
    dt = x.dtype
    x32 = wide(x)
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
    x32 = wide(x)
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
    ``models.weights.params_from_reference``.

    Each call names the parameter's logical sharding axes, one per
    dimension, as the reference's ``mk`` does; :meth:`axes` returns them as
    a tree beside the parameters (``"layers"`` leading on stacks), which
    ``sharding.rules`` resolves against a mesh. On ``device="meta"`` nothing
    is drawn and nothing is allocated: every parameter is an empty meta
    tensor of its shape and dtype (the dry-run's abstract parameters; a meta
    device has no generator)."""

    def __init__(self, seed: int, device):
        self.device = torch.device(device)
        self.gen = None
        if self.device.type != "meta":
            self.gen = torch.Generator(device=self.device)
            self.gen.manual_seed(int(seed))
        self._axes = {}  # id(tensor) -> (tensor, logical axes)

    def __call__(self, shape, axes, *, dtype, scale: Optional[float] = None,
                 zeros: bool = False, stack: int = 0):
        """One parameter of per-layer ``shape`` with logical ``axes``; with
        ``stack`` = L, the L layers' copies stacked on a leading axis (the
        scale still comes from the per-layer shape)."""
        if len(axes) != len(shape):
            raise ValueError(f"Init: {len(axes)} logical axes {tuple(axes)} for shape "
                             f"{tuple(shape)}")
        full = (stack, *shape) if stack else tuple(shape)
        if self.gen is None:
            w = torch.empty(full, dtype=dtype, device=self.device)
        elif zeros:
            w = torch.zeros(full, dtype=dtype, device=self.device)
        else:
            fan_in = shape[0] if len(shape) == 1 else shape[-2]
            s = scale if scale is not None else fan_in ** -0.5
            w = torch.randn(full, generator=self.gen, dtype=torch.float32, device=self.device)
            w = w.mul_(s).to(dtype)
        self._axes[id(w)] = (w, (("layers",) if stack else ()) + tuple(axes))
        return w

    def axes(self, tree):
        """The logical axes of every parameter of ``tree`` (dicts and lists
        of tensors this factory made), in the same structure."""
        if isinstance(tree, dict):
            return {k: self.axes(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [self.axes(v) for v in tree]
        return self._axes[id(tree)][1]
