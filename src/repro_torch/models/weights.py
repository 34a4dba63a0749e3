"""Carry the reference's weights and caches into the port.

The JAX package's parameters and decode caches are nested dicts of arrays
with the same keys, shapes and layer stacking as the port's
(``models.transformer``). ``params_from_reference`` / ``cache_from_reference``
take them as numpy arrays — e.g. ``jax.tree.map(np.asarray, params)`` — and
return the port's tensors with the same dtypes (bfloat16 included), so the
two packages can be held against each other on one set of weights. On the
card there is no JAX: weights there come from the port's own seeded init.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["params_from_reference", "cache_from_reference"]


def _tensor(a, device) -> torch.Tensor:
    a = np.array(a)  # a writable copy: jax hands out read-only buffers
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: same bits as torch's
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _tree(tree, device):
    if isinstance(tree, dict):
        return {k: _tree(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree(v, device) for v in tree)
    return _tensor(tree, device)


def params_from_reference(tree, *, device="cuda"):
    """The reference's ``params`` (nested dict of numpy arrays) as the port's
    parameter dict on ``device``: same keys, shapes and dtypes."""
    return _tree(tree, device)


def cache_from_reference(cache, *, device="cuda"):
    """The reference's dense decode cache ``{'k', 'v'}`` (``[L, B, S, Kv,
    hd]`` numpy arrays) as the port's, on ``device``."""
    return _tree(cache, device)
