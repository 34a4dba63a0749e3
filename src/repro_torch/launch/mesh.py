"""Production and local meshes (``repro.launch.mesh``).

``make_production_mesh`` keeps the reference's logical arrangement — 16 ×
16 positions over ``("data", "model")``, or 2 × 16 × 16 over ``("pod",
"data", "model")`` — as a ``ShardMesh`` whose positions are all
``torch.device("meta")``: an abstract mesh, like ``jax.sharding.
AbstractMesh``, for the dry-run (``launch.dryrun``) and the sharding specs
(``sharding.rules``). The shapes are the reference's logical arrangement,
not a claim about any H100 cluster. Importing this module touches no
device.
"""
from __future__ import annotations

import math

import torch

from repro_torch.compat import make_mesh
from repro_torch.core.distributed import ShardMesh

__all__ = ["make_production_mesh", "make_local_mesh"]


def make_production_mesh(*, multi_pod: bool = False) -> ShardMesh:
    """16 × 16 = 256 positions (one pod), or 2 pods = 512 with a ``pod`` axis
    for hierarchical data parallelism; every position on the meta device."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, [torch.device("meta")] * math.prod(shape))


def make_local_mesh(model_parallel: int = 1, device="cuda") -> ShardMesh:
    """``(data, model)`` over this host's devices: every visible card, or
    one position on the CPU when asked (``device="cpu"``)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("make_local_mesh: no CUDA device; pass device='cpu'")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        devices = [dev]
    n = len(devices)
    mp = max(1, min(int(model_parallel), n))
    return make_mesh((n // mp, mp), ("data", "model"), devices[: (n // mp) * mp])
