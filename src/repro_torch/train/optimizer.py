"""AdamW from scratch: float32 master weights and moments, decoupled weight
decay, global-norm clipping, the WSD schedule (``repro.train.optimizer``).

The arithmetic is the reference's, in float32 tensors on the parameters'
device (``lr``, the bias corrections ``c1``/``c2`` and the clip scale
included), so a step needs no host sync.

Departure from the reference (documented, like ``decode_step``'s in-place
cache): the update is IN PLACE. At full width a functional update cannot
fit on one card — a second copy of master, mu and nu is 12 bytes a
parameter (+37 GB for qwen2.5-3b). :func:`adamw_update` overwrites the
``mu``, ``nu`` and ``master`` leaves of the state it is given, leaf by leaf,
writes the new parameters into ``params`` with ``copy_``, and returns the
same trees in a new :class:`AdamWState`. The clip never holds a
float32 copy of every gradient at once: each leaf is scaled as it is
updated.

A second departure: the global norm is accumulated in float64 (each leaf's
``vector_norm`` in float64, their squares summed, the root rounded to
float32). The reference sums the squares in float32, which overflows to
``inf`` once the gradients pass ~1e19 — as the full-width random-init model's
do at 36 layers (ROADMAP C15) — and then its clip scale is 0 and the step
learns nothing. Below the overflow the two agree to float32's rounding.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

__all__ = ["AdamWState", "adamw_init", "adamw_update", "clip_by_global_norm", "wsd_schedule",
           "sum_of_squares", "tree_leaves", "tree_map", "tree_fill"]


class AdamWState(NamedTuple):
    step: torch.Tensor  # int32 scalar
    mu: Any  # float32 tree
    nu: Any  # float32 tree
    master: Any  # float32 master weights tree


def tree_leaves(tree):
    """Leaves in the reference's ``jax.tree_util`` order: dict keys sorted,
    lists, tuples and NamedTuples in order; ``None`` holds no leaf."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the same places of ``rest``),
    keeping the structure."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
        return type(tree)(*out) if hasattr(tree, "_fields") else type(tree)(out)
    return fn(tree, *rest)


def adamw_init(params) -> AdamWState:
    """Zero moments and a float32 master copy of ``params`` (never aliasing
    them), each on its parameter's device."""
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)  # noqa: E731
    leaf = tree_leaves(params)[0]
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=leaf.device),
        mu=tree_map(zeros, params),
        nu=tree_map(zeros, params),
        master=tree_map(lambda p: p.detach().to(torch.float32, copy=True), params),
    )


def sum_of_squares(leaves):
    """``Σ_leaf Σ g²`` in float64, one leaf at a time (None for no leaf)."""
    total = None
    for g in leaves:
        s = torch.square(torch.linalg.vector_norm(g, dtype=torch.float64))
        total = s if total is None else total + s
    return total


def _global_norm(grads):
    """``sqrt(Σ_leaf Σ g²)`` as float32, accumulated in float64 one leaf at
    a time (module docstring: the reference's float32 sum overflows)."""
    return torch.sqrt(sum_of_squares(tree_leaves(grads))).to(torch.float32)


def _clip_scale(gn, max_norm: float):
    # a true division (``float / tensor`` multiplies by the reciprocal)
    return torch.clamp(gn.new_full((), max_norm) / torch.clamp(gn, min=1e-9), max=1.0)


def clip_by_global_norm(grads, max_norm: float):
    """(grads as float32 scaled to global norm ≤ ``max_norm``, global norm).
    :func:`adamw_update` applies the same scale leaf by leaf instead."""
    gn = _global_norm(grads)
    scale = _clip_scale(gn, max_norm)
    return tree_map(lambda g: g.float() * scale, grads), gn


def wsd_schedule(base_lr: float, warmup: int = 200, stable: int = 10_000,
                 decay: int = 2_000) -> Callable[[torch.Tensor], torch.Tensor]:
    """Warmup-Stable-Decay: ``lr(step)`` (an integer tensor) as a float32
    tensor — linear warmup over the first ``warmup`` steps, ``base_lr`` up to
    step ``stable``, then linear decay to 0 at ``stable + decay``."""

    def lr(step):
        s = step.to(torch.float32)
        w = torch.clamp(s / max(warmup, 1), max=1.0)
        d = torch.clamp((stable + decay - s) / max(decay, 1), 0.0, 1.0)
        return base_lr * w * d

    return lr


@torch.no_grad()
def adamw_update(grads, state: AdamWState, *, lr_fn: Callable, params, b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8, weight_decay: float = 0.1,
                 max_grad_norm: float = 1.0, norm_of: Callable | None = None):
    """One AdamW step -> (params, state, {"lr", "grad_norm"}).

    ``grads``, ``params``, ``state.mu``, ``state.nu`` and ``state.master``
    are trees of one structure. The ``mu``/``nu``/``master`` leaves are
    overwritten in place (module docstring) and the new parameters written
    into ``params`` with ``copy_``, each leaf in its own dtype (the train step
    casts a leaf not in the config's parameter dtype, as the reference casts
    every leaf). The step counter is a new tensor. ``norm_of(grads)`` gives
    the global norm the clip reads (default: of ``grads`` alone; the
    data-parallel step's takes every rank's blocks).
    """
    gn = (norm_of or _global_norm)(grads)
    scale = _clip_scale(gn, max_grad_norm)
    step = state.step + 1
    lr = lr_fn(step)
    sf = step.to(torch.float32)
    c1 = 1.0 - torch.pow(b1, sf)
    c2 = 1.0 - torch.pow(b2, sf)
    for g, p, m, v, w in zip(tree_leaves(grads), tree_leaves(params), tree_leaves(state.mu),
                             tree_leaves(state.nu), tree_leaves(state.master)):
        g = g.float() * scale
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * torch.square(g))
        upd = (m / c1) / (torch.sqrt(v / c2) + eps) + weight_decay * w
        w.sub_(lr * upd)
        p.copy_(w)
    return params, AdamWState(step, state.mu, state.nu, state.master), {"lr": lr,
                                                                      "grad_norm": gn}


def tree_fill(tree, leaves):
    """``tree``'s structure with its leaves replaced, in :func:`tree_leaves`
    order, by ``leaves``."""
    it = iter(leaves)

    def fill(t):
        if t is None:
            return None
        if isinstance(t, dict):
            out = {k: fill(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}
        if isinstance(t, (list, tuple)):
            out = [fill(v) for v in t]
            return type(t)(*out) if hasattr(t, "_fields") else type(t)(out)
        return next(it)

    return fill(tree)
