"""Dry-run of every (arch × shape) cell on the production meshes, accounted
on the meta device (``repro.launch.dryrun``, redesigned for PyTorch).

The reference asks XLA to lower and compile each cell on a 256- or 512-chip
mesh and reads the compiler's memory and cost analyses and the collectives
in the HLO. PyTorch has no such compiler; this module runs the port's own
step on meta tensors — shapes and dtypes, no values, nothing allocated on
any device — and accounts for what it sees. For each cell it writes one
JSON file (``{arch}__{shape}__{pod1|pod2}.json``) with the reference's
keys, ``arch shape kind mesh profile memory{…} cost{flops, bytes}
collectives{…, total} layer{…} ok``:

* **memory**, per device. State: the sum over every leaf of its block's
  bytes under the profile's specs (``sharding.rules.logical_sharding``):
  for ``train`` the parameters and their gradients in ``cfg.param_dtype``
  (the step leaves every parameter in it: ``train_step._recast``) and the
  AdamW state as ``train.optimizer`` holds it (float32 ``mu``, ``nu``,
  ``master``, an int32 ``step``); for ``prefill`` the parameters as
  initialised and the cache the prefill returns; for ``decode`` the
  parameters and the cache it updates in place. Activations: the peak of the
  live bytes of the storages the step's ops allocate (a
  ``TorchDispatchMode`` adds each output storage's bytes and takes them off
  when the storage dies; parameter gradients are state, not activations),
  divided by the product of the mesh axes that ``act_batch`` and
  ``act_seq`` resolve to. ``bytes_per_device`` = state + inputs +
  activations (+ the logits a serving step returns).
* **cost**, the whole step: FLOPs from ``torch.utils.flop_counter.
  FlopCounterMode`` (matrix products, convolutions and attention;
  elementwise ops are not counted), bytes from the same dispatch mode — the
  input plus output bytes of every op that moves data (views move none).
  These are the bytes of the port's unfused eager program, which is what
  PyTorch runs, not XLA's fused count. Per device both are divided by the
  chips: the ideal split (``flops_global``, ``bytes_global`` keep the
  totals).
* **collectives**, per device and per step, in the reference's unit, the
  bytes of each collective's result:

  - each parameter with a dimension sharded over ``data``: an all-gather in
    the forward (result: the block with ``data`` gathered), another in the
    remat recompute (layer parameters, ``train``, remat ≠ ``'none'``), and
    in ``train`` a reduce-scatter of its gradient (result: the block);
  - each contraction split over ``model`` — the attention out-projection,
    the MLP down-projection, the MoE expert FFN, rwkv's time-mix output and
    channel-mix value, RG-LRU's out-projection: the weight's contracted
    (first per-layer) dimension sharded over ``model`` — an all-reduce of
    its output ``[B / act_batch, tokens, d]`` in the forward, another in the
    recompute and one in the backward (the input gradient of the matching
    column-parallel projection) in ``train``;
  - under ``train_pod`` the cross-pod gradient mean: an all-reduce of every
    gradient block.

  ``total`` is their sum. The formula is the port's reading of the specs;
  nothing is compiled or run.

**Depth without the token loops.** Each cell runs the model's own entry
point on meta tensors — ``loss_fn`` and ``torch.autograd.grad`` over the
per-layer leaves the trainer takes (``train_step.layer_views``),
``prefill``, or ``decode_step`` on a given cache — at two depths, the
outside (embedding, head, loss) with ``k`` units of layers and with
``k + 1``. A unit is one layer, or for the hybrid one pattern period (its
tail layers stay in both). The difference is one unit, and the totals are
the first trace plus the unit times the units that remain
(:func:`trace_cell`); the whole depth is never traced. FLOPs and bytes
repeat exactly per unit. So does the activation peak's growth once the
first trace holds two layers (``k = 2``, but 1 for the hybrid, whose period
and tail are five): training holds each layer's saved input until the
backward, the hybrid's prefill each period's states until they are
stacked. With one layer the peak can sit elsewhere: a serving step holds no
layer's output while the next runs, and qwen2-vl's training step at 4 096
tokens peaks in its one layer's backward. ``tools/dryrun_depth_check.py``
traces every cell at ``k + 2`` units too and holds the second growth
against the first.

rwkv's WKV recurrence loops over the tokens, and every op of that family is
linear in the sequence length, so its training and prefill steps are traced
at one and two 256-token checkpointed chunks (``models.rwkv.WKV_CHUNK``)
and extrapolated linearly (the reference instead adds the recurrence in
closed form). The encoder-decoder (whisper-tiny, 4 + 4 layers) is traced
whole, its prefill as the reference's dry-run defines it (encode, cross
K/V, decoder logits).

Attention follows ``attn_impl``; ``'kernel'`` cannot run on meta tensors,
so a stand-in returns its output and counts its dense equivalent's FLOPs
(``4·B·H·Sq·Sk·D``, the two products of ``'dense'``) and its operands'
bytes.

``--kde`` accounts the sharded TN-KDE flush on the production meshes
instead (:func:`kde_cell`, ``ShardedForestEngine.lower_flush``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both --out runs/dryrun --jobs 4
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-8b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --kde --mesh both

It runs on the host by design (like the reference's, it never runs a
step): nothing is allocated on any device, and nothing needs a card.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import dataclasses
import json
import math
import multiprocessing
import os
import sys
import time
import traceback
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.configs import SHAPES, get_config, runnable_cells
from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import common, encdec
from repro_torch.models import rwkv as rk
from repro_torch.models.registry import abstract_params, cache_axes, get_model, input_specs
from repro_torch.sharding.rules import PROFILES, logical_sharding, logical_spec, spec_axes
from repro_torch.train.optimizer import tree_leaves
from repro_torch.train.train_step import layer_views

__all__ = ["trace_cell", "account", "lower_cell", "lower_layer_cost", "kde_cell", "kde_main",
           "main"]

META = torch.device("meta")
ACT = ("act_batch", "act_seq", "act_embed")
_aten = torch.ops.aten
_NO_MOVE = {_aten.empty.memory_format, _aten.empty_strided.default, _aten.empty_like.default,
            _aten._unsafe_view.default}


# ------------------------------------------------------------------ tracing
def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return []


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


class _Account(TorchDispatchMode):
    """Bytes moved by every op (inputs + outputs; views and empty
    allocations move none) and the lifetime of every storage an op
    allocates, as a timeline of (serial, ±bytes)."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.extra_flops = 0  # the attention kernel's stand-in
        self.events = []
        self._serial = WeakIdKeyDictionary()
        self._n = 0

    def _alloc(self, t, known):
        st = t.untyped_storage()
        if st._cdata in known or st in self._serial:
            return
        k, n = self._n, st.nbytes()
        self._n += 1
        self._serial[st] = k
        self.events.append((k, n))
        weakref.finalize(st, self.events.append, (k, -n))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        if not func.is_view and func not in _NO_MOVE:
            self.bytes += _nbytes(ins) + _nbytes(outs)
        known = {t.untyped_storage()._cdata for t in ins}
        for t in outs:
            if t.device.type != "meta":
                # empty placeholders (non-reentrant checkpointing makes one
                # on the default device in some releases) hold no memory
                if t.numel() == 0:
                    continue
                raise RuntimeError(f"dry-run: {func} made a tensor on {t.device}; the account "
                                   "runs on meta tensors only")
            self._alloc(t, known)
        return out

    def peak(self, exclude=()):
        """The peak of the live bytes, the storages of ``exclude`` left out."""
        ex = {self._serial[t.untyped_storage()] for t in exclude
              if t.untyped_storage() in self._serial}
        live = peak = 0
        for k, n in self.events:
            if k not in ex:
                live += n
                peak = max(peak, live)
        return peak


@contextlib.contextmanager
def _kernel_stand_in(acct: _Account):
    """``ops.flash_attention`` on meta tensors: its output, its dense
    equivalent's FLOPs and its operands' bytes."""
    from repro_torch.kernels import ops

    real = ops.flash_attention

    def stand_in(q, k, v, *, causal=True, scale=None):
        B, H, S, D = q.shape
        acct.extra_flops += 4 * B * H * S * k.shape[2] * D
        acct.bytes += _nbytes((q, k, v)) + q.numel() * q.element_size()
        return torch.empty((B, S, H, D), dtype=q.dtype, device=q.device).transpose(1, 2)

    ops.flash_attention = stand_in
    try:
        yield
    finally:
        ops.flash_attention = real


def _trace(fn):
    """Run ``fn()`` on meta tensors; it returns the tensors to leave out of
    the activations (parameter gradients, the cache a prefill returns).
    -> {flops, bytes, peak}."""
    acct = _Account()
    fc = FlopCounterMode(display=False)
    with _kernel_stand_in(acct), fc, acct:
        exclude = fn()
        peak = acct.peak(_tensors(exclude))
    return dict(flops=fc.get_total_flops() + acct.extra_flops, bytes=acct.bytes, peak=peak)


def _step(cfg: ModelConfig, shape: ShapeSpec, attn_impl):
    """One step of ``cfg`` at ``shape`` through the model's own entry point,
    traced (module docstring)."""
    model = get_model(cfg)
    params, _ = abstract_params(cfg)
    batch = input_specs(cfg, shape)
    B, S = shape.global_batch, shape.seq_len
    cdt = common.dtype_of(cfg.compute_dtype)
    if shape.kind == "decode":  # the cache is the step's argument
        cache = model.init_cache(B, S, cdt, device=META, **(dict(enc_seq=S) if cfg.is_encdec
                                                             else {}))

    def run():
        if shape.kind == "train":
            views = layer_views(params, lambda t: t.detach().requires_grad_())
            with torch.enable_grad():
                loss, _ = model.loss_fn(views, batch, attn_impl=attn_impl)
                return torch.autograd.grad(loss, tree_leaves(views), allow_unused=True,
                                           materialize_grads=True)
        with torch.no_grad():
            if shape.kind == "decode":
                model.decode_step(params, batch["token"], cache, S - 1)
                return []
            if not cfg.is_encdec:
                return model.prefill(params, batch, attn_impl=attn_impl)[1]
            # the reference's dry-run prefill of the encoder-decoder
            enc = encdec.encode(params, cfg, batch["frames"], attn_impl=attn_impl)
            cross = encdec.prefill_cross(params, cfg, enc)
            encdec.decode_train(params, cfg, batch["tokens"], enc, attn_impl=attn_impl)[:, -1]
            return cross

    return _trace(run)


_FIELDS = ("flops", "bytes", "peak")


def _affine(a, b, x0, x1, x):
    """The fields of traces ``a`` at ``x0`` and ``b`` at ``x1``, extended
    linearly to ``x`` (whole steps of ``x1 - x0``)."""
    return {k: a[k] + (b[k] - a[k]) * (x - x0) // (x1 - x0) for k in _FIELDS}


def _step_at(cfg: ModelConfig, shape: ShapeSpec, attn_impl):
    """:func:`_step`; rwkv's training and prefill steps over more than two
    WKV chunks extrapolated from one and two (module docstring)."""
    S1, S2 = rk.WKV_CHUNK, 2 * rk.WKV_CHUNK
    S = shape.seq_len
    if cfg.family != "rwkv" or shape.kind == "decode" or S <= S2:
        return _step(cfg, shape, attn_impl)
    if S % S1:
        raise ValueError(f"{cfg.arch_id}: {S} tokens is not a multiple of {S1} (the "
                         "extrapolation of the rwkv step is exact only there)")
    at = lambda n: _step(cfg, dataclasses.replace(shape, seq_len=n), attn_impl)  # noqa: E731
    return dict(_affine(at(S1), at(S2), S1, S2, S), extrapolated_from=[S1, S2])


def units_of(cfg: ModelConfig):
    """(layers in a unit, tail layers, units, units in the first trace) of
    a decoder-only stack (module docstring)."""
    u = len(cfg.block_pattern) if cfg.family == "hybrid" else 1
    tail = cfg.n_layers % u
    return u, tail, cfg.n_layers // u, 1 if tail + u >= 2 else 2


def trace_cell(cfg: ModelConfig, shape: ShapeSpec, attn_impl: str = "auto"):
    """Trace one cell's step on meta tensors (mesh-independent totals):
    {flops, bytes, peak} of the whole step, and but for the encoder-decoder
    ``unit`` (the same of one unit of layers), ``units``, ``unit_layers``,
    ``depths`` (the two traced depths) and, for rwkv's long steps,
    ``extrapolated_from``."""
    if cfg.is_encdec:
        return _step(cfg, shape, attn_impl)
    u, tail, n, k = units_of(cfg)
    depths = [tail + k * u, tail + (k + 1) * u]
    one, two = (_step_at(dataclasses.replace(cfg, n_layers=d), shape, attn_impl) for d in depths)
    out = _affine(one, two, k, k + 1, n)
    out.update(unit={f: two[f] - one[f] for f in _FIELDS}, units=n, unit_layers=u,
               depths=depths)
    if "extrapolated_from" in one:
        out["extrapolated_from"] = one["extrapolated_from"]
    return out


# -------------------------------------------------------------- accounting
def _leaves_with_axes(tree, axes, path=""):
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves_with_axes(tree[k], axes[k], f"{path}/{k}")]
    if isinstance(tree, list):
        return [x for i, (t, a) in enumerate(zip(tree, axes))
                for x in _leaves_with_axes(t, a, f"{path}/{i}")]
    return [(path, tree, axes)]


def _block_bytes(t, ax, mesh, rules, dtype=None):
    return logical_sharding(tuple(t.shape), ax, mesh, rules, dtype or t.dtype).shard_nbytes


def _act_divisor(mesh, rules, B, S, d):
    spec = logical_spec((B, S, d), ACT, mesh, rules)
    return math.prod(mesh.shape[a] for e in spec[:2] for a in spec_axes(e))


def _batch_bytes(batch, mesh, rules):
    out = 0
    for k, v in batch.items():
        if k in ("tokens", "labels", "mask", "token"):
            ax = ("act_batch", "act_seq")[: v.dim()]
        elif k == "mrope_pos":
            ax = ("act_batch", None, "act_seq")
        elif k in ("frames", "embeds"):
            ax = ACT
        else:
            ax = (None,) * v.dim()
        out += _block_bytes(v, ax, mesh, rules)
    return out


def _is_layer(path):
    return path.split("/")[1] in ("layers", "pattern", "tail", "enc", "dec")


#: per-layer weights whose first (per-layer) dimension is contracted: split
#: over 'model', their product ends in an all-reduce
_CONTRACTED = ("attn/wo", "xattn/wo", "mlp/w_down", "tm/wo", "cm/wv", "rec/w_out")


def _collectives(cfg, shape, mesh, profile, params, axes):
    """Per-device collective result bytes of one step (module docstring)."""
    rules = PROFILES[profile]
    train = shape.kind == "train"
    remat = train and cfg.remat != "none"
    pdt = common.dtype_of(cfg.param_dtype)
    cdt = common.dtype_of(cfg.compute_dtype)
    B, S = shape.global_batch, shape.seq_len
    tokens = 1 if shape.kind == "decode" else S
    act = (B // _act_divisor(mesh, rules, B, 1, cfg.d_model)) * tokens * cfg.d_model * \
        torch.empty((), dtype=cdt).element_size()
    out = {"all-gather": 0, "reduce-scatter": 0, "all-reduce": 0}
    layer = {"all-gather": 0, "reduce-scatter": 0, "all-reduce": 0}
    grads = 0
    for path, t, ax in _leaves_with_axes(params, axes):
        sh = logical_sharding(tuple(t.shape), ax, mesh, rules, pdt if train else t.dtype)
        stacked = ax[0] == "layers"
        n_layers = t.shape[0] if stacked else 1
        per = {"all-gather": 0, "reduce-scatter": 0, "all-reduce": 0}
        grads += sh.shard_nbytes
        data = math.prod(mesh.shape[a] for e in sh.spec for a in spec_axes(e) if a == "data")
        if data > 1:
            per["all-gather"] += sh.shard_nbytes * data * (2 if remat and _is_layer(path) else 1)
            if train:
                per["reduce-scatter"] += sh.shard_nbytes
        first = sh.spec[1] if stacked else sh.spec[0]
        split = math.prod(mesh.shape[a] for a in spec_axes(first) if a == "model")
        if _is_layer(path) and path.endswith(_CONTRACTED) and split > 1:
            per["all-reduce"] += act * n_layers * (3 if remat else 2 if train else 1)
        for k, v in per.items():
            out[k] += v
            if _is_layer(path):
                layer[k] += v / n_layers if stacked else v
    if train and "pod" in mesh.shape and profile.endswith("_pod"):
        out["all-reduce"] += grads
    out["total"] = sum(out.values())
    layer["total"] = sum(layer.values())
    return out, layer


def _state(cfg, shape, mesh, rules, params, axes):
    """Per-device bytes of parameters, gradients, optimizer state and cache."""
    pdt = common.dtype_of(cfg.param_dtype)
    leaves = _leaves_with_axes(params, axes)
    out = dict(param_bytes=0, grad_bytes=0, opt_bytes=0, cache_bytes=0)
    if shape.kind == "train":
        f32 = torch.float32
        for _, t, ax in leaves:
            out["param_bytes"] += _block_bytes(t, ax, mesh, rules, pdt)
            out["opt_bytes"] += 3 * _block_bytes(t, ax, mesh, rules, f32)
        out["grad_bytes"] = out["param_bytes"]
        out["opt_bytes"] += 4  # the int32 step, replicated
        return out
    out["param_bytes"] = sum(_block_bytes(t, ax, mesh, rules) for _, t, ax in leaves)
    B, S = shape.global_batch, shape.seq_len
    model = get_model(cfg)
    cdt = common.dtype_of(cfg.compute_dtype)
    kw = dict(enc_seq=S) if cfg.is_encdec else {}
    cache = model.init_cache(B, S, cdt, device=META, **kw)
    out["cache_bytes"] = sum(_block_bytes(t, ax, mesh, rules)
                             for _, t, ax in _leaves_with_axes(cache, cache_axes(cfg)))
    return out


def account(traced, cfg: ModelConfig, shape: ShapeSpec, mesh, profile: str):
    """A traced cell's per-device record on ``mesh`` under ``profile``."""
    rules = PROFILES[profile]
    params, axes = abstract_params(cfg)
    batch = input_specs(cfg, shape)
    B, S, d = shape.global_batch, shape.seq_len, cfg.d_model
    n_chips = math.prod(mesh.shape.values())
    flops, byts, peak = (traced[k] for k in _FIELDS)
    div = _act_divisor(mesh, rules, B, 1 if shape.kind == "decode" else S, d)
    st = _state(cfg, shape, mesh, rules, params, axes)
    inputs = _batch_bytes(batch, mesh, rules)
    acts = -(-peak // div)
    logits = 0
    if shape.kind != "train":  # [B, V] of the compute dtype, split over the batch axes
        logits = -(-B // _act_divisor(mesh, rules, B, 1, d)) * cfg.vocab * torch.empty(
            (), dtype=common.dtype_of(cfg.compute_dtype)).element_size()
    state = st["param_bytes"] + st["grad_bytes"] + st["opt_bytes"]
    mem = dict(st, input_bytes=inputs, activation_bytes=acts, logits_bytes=logits,
               activation_divisor=div, state_bytes=state)
    if shape.kind == "train":
        arg = st["param_bytes"] + st["opt_bytes"] + inputs
        mem.update(argument_bytes=arg, output_bytes=arg - inputs, alias_bytes=arg - inputs,
                   temp_bytes=st["grad_bytes"] + acts)
    elif shape.kind == "prefill":
        mem.update(argument_bytes=st["param_bytes"] + inputs, temp_bytes=acts,
                   output_bytes=st["cache_bytes"] + logits, alias_bytes=0)
    else:
        mem.update(argument_bytes=st["param_bytes"] + st["cache_bytes"] + inputs,
                   temp_bytes=acts, output_bytes=st["cache_bytes"] + logits,
                   alias_bytes=st["cache_bytes"])
    mem["bytes_per_device"] = (mem["argument_bytes"] + mem["temp_bytes"] + mem["output_bytes"]
                               - mem["alias_bytes"])
    coll, layer_coll = _collectives(cfg, shape, mesh, profile, params, axes)
    res = dict(arch=cfg.arch_id, shape=shape.name, kind=shape.kind, mesh=dict(mesh.shape),
               profile=profile, n_chips=n_chips, memory=mem,
               cost=dict(flops=flops / n_chips, bytes=byts / n_chips, flops_global=flops,
                         bytes_global=byts, split="ideal: the whole step over the chips"),
               collectives=coll)
    if "unit" in traced:
        res["layer"] = _layer_record(traced, layer_coll, n_chips)
    return res


def _layer_record(traced, layer_coll, n_chips):
    """The reference's ``layer`` record, per device: one unit of layers
    (dense, moe, rwkv: one block; hybrid: one pattern period, where the
    reference's holds one attention block) with its count."""
    unit = traced["unit"]
    return dict(flops=unit["flops"] / n_chips, bytes=unit["bytes"] / n_chips,
                collectives=layer_coll, n=traced["units"], unit_layers=traced["unit_layers"],
                depths=traced["depths"],
                **({"extrapolated_from": traced["extrapolated_from"]}
                   if "extrapolated_from" in traced else {}))


def _shape_of(shape) -> ShapeSpec:
    return shape if isinstance(shape, ShapeSpec) else SHAPES[shape]


def lower_cell(arch, shape_name, mesh, *, profile_train="train", profile_serve="serve",
               remat: str = "full", attn_impl: str = "auto", layer_cost: bool = True,
               traced=None):
    """One cell's record (the reference's ``lower_cell``): ``arch`` an id or
    a ``ModelConfig``, ``shape_name`` a key of ``SHAPES`` or a
    ``ShapeSpec``. ``traced`` reuses :func:`trace_cell`'s output (one trace
    serves both meshes)."""
    cfg = arch if isinstance(arch, ModelConfig) else get_config(arch)
    cfg = dataclasses.replace(cfg, remat=remat)
    shape = _shape_of(shape_name)
    profile = profile_train if shape.kind == "train" else profile_serve
    t0 = time.time()
    if traced is None:
        traced = trace_cell(cfg, shape, attn_impl)
    res = account(traced, cfg, shape, mesh, profile)
    if not layer_cost:
        res.pop("layer", None)
    res["attn_impl"] = attn_impl
    res["lower_s"] = time.time() - t0
    return res


def lower_layer_cost(cfg: ModelConfig, shape, mesh, profile: str, attn_impl="auto"):
    """The per-layer record alone (``--layer-cost-only``); ``profile`` a key
    of ``PROFILES``."""
    shape = _shape_of(shape)
    params, axes = abstract_params(cfg)
    traced = trace_cell(cfg, shape, attn_impl)
    _, layer_coll = _collectives(cfg, shape, mesh, profile, params, axes)
    return _layer_record(traced, layer_coll, math.prod(mesh.shape.values()))


# --------------------------------------------------------------- TN-KDE
def kde_cell(multi_pod: bool, *, compile_prog: bool = True):
    """Account the sharded packed TN-KDE flush on a production mesh: the KDE
    analogue of :func:`lower_cell` (the reference's ``kde_cell``). Shards over
    ``data`` on the 16 × 16 pod (16 shards) and over ``(pod, data)`` on the
    2 × 16 × 16 double pod (32 shards), on the mesh's meta positions: the
    host index, slabs and plan are built, nothing is allocated on any
    device. The world is the reference's (``make_network(40, 70, seed=5)``,
    800 events, seed 6, three centres); ``compile_prog`` loads the CUDA
    library the flush launches, building it if needed (needs ``nvcc``;
    ``library_load_s``: the load, not a compile of the flush)."""
    from repro_torch.core import TNKDE
    from repro_torch.data.spatial import make_events, make_network

    mesh = make_production_mesh(multi_pod=multi_pod)
    axes = ("pod", "data") if multi_pod else ("data",)
    net = make_network(40, 70, seed=5)
    ev = make_events(net, 800, seed=6, span_days=10)
    ts = [2.0 * 86400.0, 5.0 * 86400.0, 8.0 * 86400.0]
    t0 = time.time()
    model = TNKDE(net, ev, solution="rfs", mesh=mesh, shard_axes=axes, device="meta",
                  g=50.0, b_s=600.0, b_t=2.0 * 86400.0)
    fe = model._fe
    res = {"kind": "kde_sharded", "mesh": dict(mesh.shape), "shard_axes": list(axes),
           "engine_desc": model.engine_desc, "n_shards": int(fe.n_shards),
           "build_s": time.time() - t0}
    wb = fe.window_batch(model.ctx, ts)
    plan = model._host_plan(None)
    t1 = time.time()
    lowered = fe.lower_flush(wb, plan, model.n_lixels)
    res["lower_s"] = time.time() - t1
    res["bytes_per_shard"] = int(lowered.slab_bytes_per_shard)
    res["flush_bytes_per_shard"] = int(lowered.bytes_per_shard)
    res["segment_add_launches"] = int(lowered.launches)
    res["collectives"] = dict(lowered.collectives)
    res["memory"] = {"argument_bytes": lowered.argument_bytes,
                     "temp_bytes": lowered.temp_bytes}
    if compile_prog:
        from repro_torch.kernels import _build

        t2 = time.time()
        _build.load_library("segment_add")
        res["library_load_s"] = time.time() - t2
    res["lowered"] = lowered
    return res


def kde_main(args):
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    os.makedirs(args.out, exist_ok=True)
    failures = 0
    for mp in meshes:
        tag = f"kde__{'pod2' if mp else 'pod1'}"
        try:
            res = kde_cell(mp, compile_prog=not args.kde_no_compile)
            res.pop("lowered")
            res["ok"] = True
            print(f"[OK] {tag}: engine={res['engine_desc']} shards={res['n_shards']} "
                  f"bytes/shard={res['bytes_per_shard']} "
                  f"flush bytes/shard={res['flush_bytes_per_shard']} "
                  f"launches={res['segment_add_launches']} lower={res['lower_s']:.1f}s"
                  + (f" library={res['library_load_s']:.1f}s" if "library_load_s" in res
                     else "")
                  + f" coll={res['collectives']['total']}B")
        except Exception as e:
            res = {"kind": "kde_sharded", "mesh": "pod2" if mp else "pod1", "ok": False,
                   "error": f"{type(e).__name__}: {e}", "trace": traceback.format_exc()[-2000:]}
            failures += 1
            print(f"[FAIL] {tag}: {type(e).__name__}: {e}")
        with open(os.path.join(args.out, tag + ".json"), "w") as f:
            json.dump(res, f, indent=1)
    print(f"done; failures={failures}")
    return 1 if failures else 0


# ------------------------------------------------------------------- main
def _parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="single")
    ap.add_argument("--kde", action="store_true",
                    help="account the sharded packed TN-KDE flush on the production meshes "
                    "instead of the LM cells")
    ap.add_argument("--kde-no-compile", action="store_true",
                    help="with --kde: stop after the account (load no CUDA library)")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="runs/dryrun")
    ap.add_argument("--profile-train", default="train")
    ap.add_argument("--profile-serve", default="serve")
    ap.add_argument("--remat", default="full")
    ap.add_argument("--attn-impl", default="auto")
    ap.add_argument("--no-layer-cost", action="store_true")
    ap.add_argument("--decode-loop", default="scan", choices=["scan", "fori"],
                    help="the reference's flag, accepted and without effect: the port's "
                    "decode_step runs one loop for both")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells traced at once, one process each")
    ap.add_argument("--layer-cost-only", action="store_true",
                    help="refresh only the `layer` record of existing cell JSONs")
    return ap


def main(argv=None):
    args = _parser().parse_args(argv)
    if args.kde:
        return kde_main(args)
    cells = runnable_cells() if args.all else [(args.arch, args.shape)]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    os.makedirs(args.out, exist_ok=True)
    if args.layer_cost_only:
        for arch, shape in cells:
            for mp in meshes:
                path = os.path.join(args.out, f"{arch}__{shape}__{'pod2' if mp else 'pod1'}.json")
                if not os.path.exists(path):
                    continue
                with open(path) as f:
                    res = json.load(f)
                if not res.get("ok") or get_config(arch).is_encdec:
                    continue
                kind = SHAPES[shape].kind
                prof = (args.profile_train if kind == "train" else args.profile_serve) + \
                    ("_pod" if mp else "")
                cfg = dataclasses.replace(get_config(arch), remat=args.remat)
                res["layer"] = lower_layer_cost(cfg, shape, make_production_mesh(multi_pod=mp),
                                                prof, args.attn_impl)
                print(f"[layer OK] {path}: flops={res['layer']['flops']:.3g}")
                with open(path, "w") as f:
                    json.dump(res, f, indent=1)
        return 0
    work = [(args, arch, shape) for arch, shape in cells]
    if args.jobs > 1:
        ctx = multiprocessing.get_context("spawn")  # the caller may hold a CUDA context
        with concurrent.futures.ProcessPoolExecutor(args.jobs, mp_context=ctx) as ex:
            failures = sum(ex.map(_run_cell, *zip(*work)))
    else:
        failures = sum(_run_cell(*w) for w in work)
    print(f"done; failures={failures}")
    return 1 if failures else 0


def _run_cell(args, arch, shape):
    """Trace one cell, account it on each mesh of ``args.mesh`` and write
    its files -> the number that failed."""
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    traced, err, failures = None, None, 0
    t0 = time.time()
    try:
        cfg = dataclasses.replace(get_config(arch), remat=args.remat)
        traced = trace_cell(cfg, SHAPES[shape], args.attn_impl)
    except Exception as e:
        err = e, traceback.format_exc()[-2000:]
    trace_s = time.time() - t0
    for mp in meshes:
        tag = f"{arch}__{shape}__{'pod2' if mp else 'pod1'}"
        try:
            if err:
                raise err[0]
            res = lower_cell(arch, shape, make_production_mesh(multi_pod=mp),
                             profile_train=args.profile_train + ("_pod" if mp else ""),
                             profile_serve=args.profile_serve + ("_pod" if mp else ""),
                             remat=args.remat, attn_impl=args.attn_impl,
                             layer_cost=not args.no_layer_cost, traced=traced)
            res["trace_s"] = trace_s
            res["ok"] = True
            print(f"[OK] {tag}: trace={trace_s:.1f}s "
                  f"mem/dev={res['memory']['bytes_per_device'] / 2**30:.2f}GiB "
                  f"flops={res['cost']['flops']:.3g} coll={res['collectives']['total']:.3g}B",
                  flush=True)
        except Exception as e:
            res = {"arch": arch, "shape": shape, "mesh": "pod2" if mp else "pod1",
                   "ok": False, "error": f"{type(e).__name__}: {e}",
                   "trace": err[1] if err else traceback.format_exc()[-2000:]}
            failures += 1
            print(f"[FAIL] {tag}: {type(e).__name__}: {e}", flush=True)
        with open(os.path.join(args.out, tag + ".json"), "w") as f:
            json.dump(res, f, indent=1)
    return failures


if __name__ == "__main__":
    sys.exit(main())
