"""Logical-axis sharding rules (MaxText-style) with divisibility fallback
(``repro.sharding.rules``).

Every parameter, cache entry and activation is annotated with *logical*
axis names (``models.common.Init``, ``models.registry.cache_axes``); a
profile maps logical names to mesh axes. :func:`logical_spec` resolves the
map against a mesh's ``shape`` (a ``core.distributed.ShardMesh``, or any
object with a ``shape`` mapping of axis name → extent) and drops mesh axes
that do not divide the dimension (e.g. MQA's kv_heads=1 under a 16-way
model axis stays replicated) — the fallback that makes one rule set serve
all ten architectures.

Profiles (DESIGN.md §3):
  train     — FSDP(ZeRO-3) over 'data' on the embed dim of every weight,
              TP over 'model' on heads/mlp/vocab/experts; activations
              batch→data, seq→model (Megatron-style sequence parallelism).
  serve     — weights TP over 'model' only (replicated over 'data' so the
              batch can shard there); KV cache batch→data, seq→model
              (context-parallel decode).
  multi-pod — same, with batch over ('pod','data'): the pod axis is pure DP
              with hierarchical gradient reduction.

A spec is a tuple with one entry per dimension: ``None``, one mesh axis
name, or a tuple of axis names — the entries of the reference's
``PartitionSpec``. :func:`logical_sharding` adds what the port needs in
place of a ``NamedSharding``: the per-device shape and bytes of the array.
The reference's ``constrain`` (``with_sharding_constraint``) has no
counterpart: the port's models take no mesh and carry no constraints
(ROADMAP C6).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple, Union

import torch

__all__ = ["ShardingRules", "PROFILES", "Sharding", "logical_spec", "logical_sharding",
           "spec_axes"]

Axes = Union[None, str, Tuple[str, ...]]


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    rules: Dict[str, Axes]

    def get(self, logical: Optional[str]) -> Axes:
        if logical is None:
            return None
        return self.rules.get(logical)


_TRAIN = {
    # weights: FSDP over data on the "long" embed dim + TP over model
    "embed_fsdp": "data",
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "mlp": "model",
    "vocab": "model",
    "experts": "model",
    "expert_mlp": None,
    "rnn": "model",
    "embed": None,
    # activations
    "act_batch": "data",
    "act_seq": "model",  # sequence parallelism for the residual stream
    "act_embed": None,
    "act_heads": "model",
    "act_vocab": "model",
    # decode cache (unused in train)
    "cache_batch": "data",
    "cache_seq": "model",
    "layers": None,
}

_SERVE = dict(_TRAIN)
_SERVE.update(
    {
        "embed_fsdp": None,  # weights replicated over data for batch-DP serving
        # MoE expert weights are ~all of a big MoE's params — replicating
        # them over 'data' at serve time costs 29 GiB/dev on qwen3-235b.
        # Shard d_expert over 'data' instead: experts x model, d_expert x
        # data = fully sharded weights; the FFN contraction psums over data.
        "expert_mlp": "data",
        "act_seq": "model",
        "cache_batch": "data",
        "cache_seq": "model",
    }
)

_TRAIN_POD = dict(_TRAIN)
_TRAIN_POD.update({"act_batch": ("pod", "data"), "cache_batch": ("pod", "data")})

_SERVE_POD = dict(_SERVE)
_SERVE_POD.update({"act_batch": ("pod", "data"), "cache_batch": ("pod", "data")})

PROFILES: Dict[str, ShardingRules] = {
    "train": ShardingRules(_TRAIN),
    "serve": ShardingRules(_SERVE),
    "train_pod": ShardingRules(_TRAIN_POD),
    "serve_pod": ShardingRules(_SERVE_POD),
}


def _normalize(ax: Axes) -> Tuple[str, ...]:
    if ax is None:
        return ()
    if isinstance(ax, str):
        return (ax,)
    return tuple(ax)


def spec_axes(entry: Axes) -> Tuple[str, ...]:
    """The mesh axes one spec entry shards its dimension over."""
    return _normalize(entry)


def logical_spec(shape: Sequence[int], logical_axes: Sequence[Optional[str]], mesh,
                 rules: ShardingRules) -> Tuple[Axes, ...]:
    """Spec of one array, dropping non-dividing / absent / already-used mesh
    axes (the reference's fallback, over ``mesh.shape``)."""
    if len(shape) != len(logical_axes):
        raise ValueError(f"logical_spec: shape {tuple(shape)} has {len(shape)} dimensions, "
                         f"axes {tuple(logical_axes)} name {len(logical_axes)}")
    used = set()
    out = []
    for dim, name in zip(shape, logical_axes):
        picked = []
        prod = 1
        for ax in _normalize(rules.get(name)):
            if ax in used or ax not in mesh.shape:
                continue
            size = mesh.shape[ax]
            if dim % (prod * size) == 0:
                picked.append(ax)
                prod *= size
        used.update(picked)
        out.append(tuple(picked) if len(picked) > 1 else (picked[0] if picked else None))
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """One array resolved against a mesh: its spec, and the shape and bytes
    of the block each device holds."""

    spec: Tuple[Axes, ...]
    shard_shape: Tuple[int, ...]
    shard_nbytes: int


def logical_sharding(shape: Sequence[int], logical_axes: Sequence[Optional[str]], mesh,
                     rules: ShardingRules, dtype: torch.dtype = torch.float32) -> Sharding:
    """:func:`logical_spec` with the per-device block of a ``dtype`` array
    of ``shape`` (every dimension divides by its axes, by construction)."""
    spec = logical_spec(shape, logical_axes, mesh, rules)
    block = tuple(int(d) // math.prod(mesh.shape[a] for a in spec_axes(e))
                  for d, e in zip(shape, spec))
    itemsize = torch.empty((), dtype=dtype).element_size()
    return Sharding(spec, block, math.prod(block) * itemsize)
