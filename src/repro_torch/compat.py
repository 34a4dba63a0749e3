"""Mesh construction over ``core.distributed.ShardMesh`` (``repro.compat``).

The reference's module papers over JAX versions (``jax.make_mesh`` axis
types, where ``shard_map`` lives). The port needs only its two mesh
builders: a ``ShardMesh`` is named axes over one ``torch.device`` per
position. ``shard_map`` has no counterpart: the port's sharded engines loop
over their shards (``core.distributed``), each on its own device, and sum
the per-shard results in shard order (ROADMAP C6).
"""
from __future__ import annotations

import math
from typing import Sequence

import torch

from repro_torch.core.distributed import ShardMesh

__all__ = ["make_mesh", "host_mesh"]


def make_mesh(shape: Sequence[int], axes: Sequence[str], devices=None) -> ShardMesh:
    """A ``ShardMesh`` of ``shape`` over named ``axes``: ``devices`` (one per
    position, row-major with ``axes[0]`` outermost), by default every
    visible card."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return ShardMesh(list(devices), shape=tuple(shape), axis_names=tuple(axes))


def host_mesh(n_shards, axes: Sequence[str] = ("data",), devices=None) -> ShardMesh:
    """A mesh over the FIRST ``prod(shape)`` of ``devices`` (default: the
    visible cards), folded row-major (``axes[0]`` outermost), so that 2- and
    4-shard meshes can be made in one process beside a larger one.
    ``n_shards`` is an int or a shape."""
    shape = (int(n_shards),) if isinstance(n_shards, int) else tuple(int(s) for s in n_shards)
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    total = math.prod(shape)
    if total > len(devices):
        raise ValueError(f"host_mesh needs {total} devices, have {len(devices)}")
    return make_mesh(shape, axes, list(devices)[:total])
