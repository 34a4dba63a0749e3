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

Over several processes (a ``sharding.process.ProcessMesh``, one process per
device) each rank holds the block of every parameter and AdamW leaf its
spec gives it (``sharding.rules.logical_spec`` under the rules), takes its
rows of the global batch (:func:`row_axes`), and hands the loss a tree
that all-gathers a layer's blocks when the layer reads them
(``sharding.process.gather_leaf``: the backward reduce-scatters the
gradient onto the block). Gathering every sharded axis makes ``model`` one
more FSDP axis: the answer is the reference's. When the rows divide by the
world they are split over every rank, in rank order, and each rank runs the
tokens the reference's ``act_batch`` × ``act_seq`` split gives a device.
Otherwise they are split over the axes the rules give ``act_batch`` (the
reference's fallback drops an axis that does not divide), and the ``r``
ranks of a row group each run its rows whole, with the full sequence: ``r``
times the reference's share of tokens a rank (a sequence-parallel forward
over ``model`` would cut that back with the same answer). The loss stays
the global batch's: each of its batch-wide statistics is this rank's sum
over the sum of the ranks' counts (the ``batch_sum`` of
``models.common.cross_entropy`` and the moe router), and the gradients and
metrics are summed over every batch axis, so an ``r``-fold copy of a row
scales each numerator and each denominator alike, and the ranks' gradients
add up to the one-process step's.
"""
from __future__ import annotations

import functools
from collections.abc import Mapping
from types import SimpleNamespace
from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import dtype_of
from repro_torch.sharding.process import Blocks, ProcessMesh, gather_leaf, param_blocks
from repro_torch.sharding.rules import logical_spec, spec_axes
from repro_torch.train.grad_compression import compressed_tree_allreduce
from repro_torch.train.optimizer import (AdamWState, adamw_update, sum_of_squares, tree_leaves,
                                         tree_map, wsd_schedule)

__all__ = ["make_train_step", "layer_views", "row_axes"]

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
    metrics)``, or, with ``pod_compression`` and a mesh that has a
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
    ``ShardMesh`` over more than one device raises ``NotImplementedError``:
    training over several devices takes a ``ProcessMesh``, one process per
    device (:func:`_process_step`).
    """
    specs = functools.cache(lambda: _resolve_specs(cfg, mesh, rules))
    lr_fn = wsd_schedule(lr, warmup=warmup)
    pdt = dtype_of(cfg.param_dtype)
    if isinstance(mesh, ProcessMesh):
        step = _process_step(loss_fn, cfg, mesh, rules, lr_fn, pdt, attn_impl,
                             pod_axis if pod_compression and pod_axis in mesh.shape else None)
        step.specs = specs
        return step
    n_dev = len({_canon(d) for d in mesh.devices}) if mesh is not None else 0
    if n_dev > 1:
        raise NotImplementedError(
            f"train step: a ShardMesh over {n_dev} devices in one process; train over several "
            "devices with a ProcessMesh (sharding.process), one process per device")

    def grads_of(params, batch):
        leaves = layer_views(params, lambda t: t.detach().requires_grad_())
        with torch.enable_grad():
            loss, metrics = loss_fn(leaves, batch, attn_impl=attn_impl)
            grads = torch.autograd.grad(loss, tree_leaves(leaves), allow_unused=True,
                                        materialize_grads=True)
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, list(grads)

    def update(params, opt_state, grads):
        return _update(params, opt_state, grads, lr_fn, pdt)

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
        train_step.specs, train_step.grads = specs, grads_of
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


def _update(params, opt_state, grads, lr_fn, pdt, norm_of=None):
    """AdamW on the per-layer views of the stacks, in place; the leaves not
    in ``pdt`` recast from their master weights."""
    st = AdamWState(opt_state.step, *(layer_views(t) for t in opt_state[1:]))
    _, st, om = adamw_update(grads, st, lr_fn=lr_fn, params=layer_views(params), norm_of=norm_of)
    _recast(params, opt_state.master, pdt)
    return AdamWState(st.step, *opt_state[1:]), om


class _Gathered(Mapping):
    """A parameter tree read through this rank's blocks: reading a leaf
    all-gathers it (``sharding.process.gather_leaf``). Leaves under a layer
    list are gathered at every read — a layer under remat gathers in its
    forward and again in its recompute, and no layer's whole weights are
    held between — the others once a step (the tied embedding is read by
    the embedding and the head)."""

    def __init__(self, tree, blocks, keep: bool):
        self._tree, self._blocks, self._keep, self._held = tree, blocks, keep, {}

    def __getitem__(self, k):
        if k in self._held:
            return self._held[k]
        v = _gathered(self._tree[k], self._blocks[k], self._keep)
        if self._keep:
            self._held[k] = v
        return v

    def __iter__(self):
        return iter(self._tree)

    def __len__(self):
        return len(self._tree)


def _gathered(t, b, keep):
    if isinstance(t, dict):
        return _Gathered(t, b, keep)
    if isinstance(t, list):  # the per-layer trees of a stack, a pattern or a tail
        return [_gathered(u, c, False) for u, c in zip(t, b)]
    return gather_leaf(t, b)


def _process_step(loss_fn, cfg, mesh: ProcessMesh, rules, lr_fn, pdt, attn_impl, pod):
    """The train step of one rank of ``mesh`` (module docstring), or with a
    ``pod`` axis the hierarchical step: within a pod as the plain step, then
    the int8 error-feedback mean across pods
    (``grad_compression.compressed_tree_allreduce(mesh=)``, one scale per
    stacked leaf over the whole pod-local leaf) and one AdamW.

    ``train_step(params, opt_state, batch)`` and ``hier_step(params,
    opt_state, residuals, batch)`` take this rank's blocks (``step.blocks``:
    the ``Blocks`` of every parameter; AdamW's leaves in the same blocks,
    ``residuals`` this rank's, in the stacked blocks) and the global batch,
    of which this rank runs the rows :func:`row_axes` gives it: any row
    count the reference takes (the hierarchical step: any that divides by
    the pods).
    Their ``loss``, ``ce`` and ``aux`` are the global batch's (the hierarchical
    step: the pods' mean) on every rank; the clip's global norm sums each
    block once over the world, in float64. ``step.grads(params, batch)`` ->
    (loss, metrics, per-layer gradient blocks) is the plain step's gradient
    part."""
    if rules is None:
        raise ValueError("train step: a ProcessMesh needs rules (sharding.rules.PROFILES)")
    blocks = param_blocks(cfg, mesh, rules)
    batch_axes = tuple(a for a in mesh.axis_names if a != pod)
    if pod is not None and any(pod in b.axes for b in tree_leaves(blocks)):
        raise ValueError(f"hierarchical step: the rules shard a parameter over {pod!r}")
    layer_blocks = tree_leaves(layer_views(blocks))
    # over the batch's axes a leaf is not split on, its gradient is summed whole
    rest = [tuple(a for a in batch_axes if a in b.replicated) for b in layer_blocks]
    owned = [b.owner() for b in layer_blocks]
    # the loss's batch-wide statistics over every rank's rows (none on one rank)
    kw = {} if mesh.group(batch_axes) is None else dict(
        batch_sum=lambda x: mesh.all_reduce(x.detach().clone(), batch_axes))

    def local_rows(batch):
        return {k: v[Blocks(mesh, (row_axes(mesh, rules, v.shape[0], pod),),
                            (v.shape[0],)).index()] for k, v in batch.items()}

    def grads_of(params, batch):
        dev = tree_leaves(params)[0].device
        if dev != mesh.device:
            raise ValueError(f"train step: the parameters on {dev}, this rank's device is "
                             f"{mesh.device}")
        leaves = layer_views(params, lambda t: t.detach().requires_grad_())
        tree = _gathered(leaves, layer_views(blocks), True)
        with torch.enable_grad():
            loss, metrics = loss_fn(tree, local_rows(batch), attn_impl=attn_impl, **kw)
            grads = torch.autograd.grad(loss, tree_leaves(leaves), allow_unused=True,
                                        materialize_grads=True)
        grads = [mesh.all_reduce(g.contiguous(), axes) for g, axes in zip(grads, rest)]
        vals = torch.stack([loss.detach(), *(v.detach() for v in metrics.values())])
        mesh.all_reduce(vals, batch_axes)
        return vals[0], dict(zip(metrics, vals[1:])), grads

    def norm_of(grads):
        total = sum_of_squares([g for g, own in zip(grads, owned) if own])
        if total is None:
            total = torch.zeros((), dtype=torch.float64, device=mesh.device)
        return torch.sqrt(mesh.all_reduce(total, mesh.axis_names)).to(torch.float32)

    def train_step(params, opt_state: AdamWState, batch):
        loss, metrics, grads = grads_of(params, batch)
        opt_state, om = _update(params, opt_state, grads, lr_fn, pdt, norm_of)
        return params, opt_state, dict(metrics, loss=loss, **om)

    def hier_step(params, opt_state: AdamWState, residuals, batch):
        loss, metrics, grads = grads_of(params, batch)
        mean, residuals = compressed_tree_allreduce(_stacked(params, grads), residuals,
                                                    mesh=mesh, axis=pod)
        opt_state, om = _update(params, opt_state, tree_leaves(layer_views(mean)), lr_fn, pdt,
                                norm_of)
        vals = torch.stack([loss, *metrics.values()])
        vals = mesh.all_reduce(vals, (pod,)) / mesh.shape[pod]  # the pods' mean
        return (params, opt_state, residuals,
                dict(dict(zip(metrics, vals[1:])), loss=vals[0], **om))

    step = train_step if pod is None else hier_step
    step.blocks, step.grads = blocks, grads_of
    return step


def row_axes(mesh: ProcessMesh, rules, rows: int, pod=None) -> tuple:
    """The axes of ``mesh`` the global batch's ``rows`` are split over (a
    ``Blocks`` spec entry: the block index is the coordinate over them,
    row-major in this order): every axis, so in rank order, when ``rows``
    divide by the world; else those ``logical_spec`` gives ``act_batch``
    under ``rules``, an axis that does not divide dropped. Under the
    hierarchical step ``pod`` splits the rows first (``ValueError`` when
    they do not divide by it: the reference's ``shard_map`` cannot split
    them either) and the rule applies to each pod's rows over the other
    axes."""
    if rows % mesh.world == 0:
        return tuple(mesh.axis_names)
    if pod is None:
        return spec_axes(logical_spec((rows,), ("act_batch",), mesh, rules)[0])
    if rows % mesh.shape[pod]:
        raise ValueError(f"hierarchical step: a batch of {rows} rows does not split over "
                         f"{mesh.shape[pod]} pods")
    inner = SimpleNamespace(shape={a: n for a, n in mesh.shape.items() if a != pod})
    return (pod, *spec_axes(logical_spec((rows // mesh.shape[pod],), ("act_batch",), inner,
                                         rules)[0]))


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
