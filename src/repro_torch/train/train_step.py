"""The training step: loss -> gradients -> (optionally int8-compressed)
cross-pod mean -> AdamW (``repro.train.train_step``).

Activation checkpointing happens per layer inside the model's forward
(``cfg.remat``, ``models.common.maybe_remat``), as the reference's does.

The step takes the gradient of each layer in a leaf of its own: it hands the
loss per-layer views of the stacked parameters (``layer_views``: basic
indexing, so they share the stacks' storage), detached and requiring grad.
Reading layer ``i`` of a stack that requires grad instead (``v[i]``) would
make every layer's backward allocate a zero gradient the size of the whole
stack and add it into the stack's gradient: at full width ≈ 5.5 GB of
transient memory per layer, and one full-size add per layer. The optimizer
updates the stacks through the same views, in place, so the stacked tree
stays the one format of parameters, optimizer state and checkpoints.

``metrics`` are tensors on the device (``loss``, ``ce``, ``aux``, ``lr``,
``grad_norm``): the step makes no host sync.
"""
from __future__ import annotations

import functools
from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import dtype_of
from repro_torch.train.grad_compression import compressed_tree_allreduce
from repro_torch.train.optimizer import (AdamWState, adamw_update, tree_leaves, tree_map,
                                         wsd_schedule)

__all__ = ["make_train_step", "layer_views"]

_STACKS = ("layers", "enc", "dec")  # layer stacks of the decoder-only and encdec trees


def layer_views(tree, leaf=lambda t: t):
    """``tree`` with each layer stack (``layers``, ``enc``, ``dec``, every
    ``pattern`` stack) as a list of per-layer trees of ``leaf(stack[i])``,
    and ``leaf`` applied to every other leaf."""

    def per_layer(stack):
        n = tree_leaves(stack)[0].shape[0]
        return [tree_map(lambda t: leaf(t[i]), stack) for i in range(n)]

    out = {}
    for k, v in tree.items():
        if k in _STACKS:
            out[k] = per_layer(v)
        elif k == "pattern":
            out[k] = [per_layer(s) for s in v]
        else:
            out[k] = tree_map(leaf, v)
    return out


@torch.no_grad()
def _stacked(params, grads):
    """Per-layer gradients (in ``tree_leaves(layer_views(params))`` order)
    written into a tree shaped like ``params``."""
    out = tree_map(lambda p: torch.empty(p.shape, dtype=p.dtype, device=p.device), params)
    for dst, g in zip(tree_leaves(layer_views(out)), grads):
        dst.copy_(g)
    return out


@torch.no_grad()
def _recast(params, master, dtype):
    """Replace each parameter leaf not of ``dtype`` (the float32 norms of a
    bfloat16 model, until its first step) by its master weights in
    ``dtype``: the reference casts every leaf to the parameter dtype."""
    items = params.items() if isinstance(params, dict) else enumerate(params)
    for k, v in items:
        if isinstance(v, (dict, list)):
            _recast(v, master[k], dtype)
        elif v.dtype != dtype:
            params[k] = master[k].to(dtype)


def make_train_step(loss_fn: Callable, cfg: ModelConfig, *, mesh=None, rules=None,
                    lr: float = 3e-4, warmup: int = 200, attn_impl: str = "auto",
                    pod_compression: bool = False, pod_axis: str = "pod"):
    """Returns ``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``, or, with ``pod_compression`` and a ``ShardMesh`` that has a
    ``pod_axis``, ``hier_step(params, opt_state, residuals, batch) ->
    (params, opt_state, residuals, metrics)``.

    Both update ``params`` and the optimizer state in place and return them
    (``train.optimizer``). The hierarchical step splits the batch over the
    pod members (``mesh.shard_devices([pod_axis])``, in order), takes each
    member's gradients on the one replica of the parameters, reduces them
    with the int8 error-feedback mean over the stacked tree (``residuals``:
    one tree per member, from ``grad_compression.init_residuals(params)``;
    the new ones are returned) and applies one AdamW. Its ``loss``, ``ce``
    and ``aux`` are the members' mean (the reference reports member 0's: its
    out_spec is replicated).

    As the reference's, the update leaves every parameter in
    ``cfg.param_dtype``: a leaf of another dtype (the float32 norms of a
    bfloat16 model) is replaced by its master weights in that dtype.

    With a ``mesh``, at the first call every position of the mesh is checked
    to be the parameters' device; the step is then the one above, as the
    reference's math is the same under any sharding. ``step.specs()``
    resolves every parameter's spec under ``rules`` (``sharding.rules``)
    against the mesh (path → spec; None without both), once, when asked. A
    mesh over more than one device raises ``NotImplementedError``:
    data-parallel training over cards is ROADMAP A12.
    """
    n_dev = len({_canon(d) for d in mesh.devices}) if mesh is not None else 0
    if n_dev > 1:
        raise NotImplementedError(
            f"train step: a mesh over {n_dev} devices; data-parallel training over cards is "
            "ROADMAP A12 (one device, or every position on it, only)")
    specs = functools.cache(lambda: _resolve_specs(cfg, mesh, rules))
    lr_fn = wsd_schedule(lr, warmup=warmup)
    pdt = dtype_of(cfg.param_dtype)

    def grads_of(params, batch):
        leaves = layer_views(params, lambda t: t.detach().requires_grad_())
        with torch.enable_grad():
            loss, metrics = loss_fn(leaves, batch, attn_impl=attn_impl)
            grads = torch.autograd.grad(loss, tree_leaves(leaves), allow_unused=True,
                                        materialize_grads=True)
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, list(grads)

    def update(params, opt_state, grads):
        st = AdamWState(opt_state.step, *(layer_views(t) for t in opt_state[1:]))
        _, st, om = adamw_update(grads, st, lr_fn=lr_fn, params=layer_views(params))
        _recast(params, opt_state.master, pdt)
        return AdamWState(st.step, *opt_state[1:]), om

    placed = []

    def check_placement(params):
        if mesh is None or placed:
            return
        dev = tree_leaves(params)[0].device
        off = [d for d in mesh.devices if _canon(d) != dev]
        if off:
            raise ValueError(f"train step: mesh positions on {off[0]}, the parameters on {dev}")
        placed.append(True)

    def train_step(params, opt_state: AdamWState, batch):
        check_placement(params)
        loss, metrics, grads = grads_of(params, batch)
        opt_state, om = update(params, opt_state, grads)
        return params, opt_state, dict(metrics, loss=loss, **om)

    if not pod_compression or mesh is None or pod_axis not in mesh.shape:
        train_step.specs = specs
        return train_step

    def hier_step(params, opt_state: AdamWState, residuals, batch):
        dev = tree_leaves(params)[0].device
        members = [_canon(d) for d in mesh.shard_devices([pod_axis])]
        if any(d != dev for d in members):
            raise ValueError(f"hierarchical step: the pod members' devices {members} must all "
                             f"be the parameters' device {dev} (one replica serves every "
                             "member on one card)")
        P = len(members)
        if len(residuals) != P:
            raise ValueError(f"hierarchical step: {len(residuals)} residual trees for {P} "
                             "pod members")
        for k, v in batch.items():
            if v.shape[0] % P:
                raise ValueError(f"hierarchical step: batch {k!r} of {v.shape[0]} rows does "
                                 f"not split over {P} pod members")
        parts = [grads_of(params, {k: v.tensor_split(P)[i] for k, v in batch.items()})
                 for i in range(P)]
        # one int8 scale per stacked leaf, as the reference's: the members'
        # gradients are compressed in the stacked tree
        mean, residuals = compressed_tree_allreduce(
            [_stacked(params, g) for _, _, g in parts], residuals, members)
        opt_state, om = update(params, opt_state, tree_leaves(layer_views(mean)))
        avg = lambda vals: torch.stack(vals).mean()  # noqa: E731
        metrics = {k: avg([m[k] for _, m, _ in parts]) for k in parts[0][1]}
        return params, opt_state, residuals, dict(metrics, loss=avg([l for l, _, _ in parts]),
                                                  **om)

    hier_step.specs = specs
    return hier_step


def _canon(d):
    """``d`` with the current card's index where it names ``cuda`` alone."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None and torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    return d


def _resolve_specs(cfg: ModelConfig, mesh, rules):
    """{leaf path: spec} of every parameter under ``rules`` on ``mesh`` (None
    without a mesh or rules)."""
    if mesh is None or rules is None:
        return None
    from repro_torch.models.registry import abstract_params
    from repro_torch.sharding.rules import logical_spec

    params, axes = abstract_params(cfg)
    out = {}

    def walk(t, ax, path):
        if isinstance(t, dict):
            for k in t:
                walk(t[k], ax[k], f"{path}/{k}")
        elif isinstance(t, list):
            for i, (u, a) in enumerate(zip(t, ax)):
                walk(u, a, f"{path}/{i}")
        else:
            out[path] = logical_spec(tuple(t.shape), ax, mesh, rules)

    walk(params, axes, "")
    return out
