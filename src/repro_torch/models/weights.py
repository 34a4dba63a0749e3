"""Carry the reference's weights and caches into the port.

The JAX package's parameters and decode caches are nested dicts (and, for
the hybrid family, lists) of arrays with the same keys, shapes and layer
stacking as the port's (``models.transformer``, ``models.encdec``).
``params_from_reference`` / ``cache_from_reference`` take them as numpy
arrays — e.g. ``jax.tree.map(np.asarray, params)`` — and return the port's
tensors with the same dtypes (bfloat16 included), so the two packages can be
held against each other on one set of weights. ``opt_state_from_reference``
does the same for the reference's optimizer state (``AdamWState``), so both
packages can start a training step from one state. On the card there is no
JAX: weights there come from the port's own seeded init.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["params_from_reference", "cache_from_reference", "opt_state_from_reference"]


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


def cache_from_reference(cache, cfg=None, *, device="cuda"):
    """The reference's decode cache (numpy arrays) as the port's, on
    ``device``: every family's tree, the encoder-decoder's ``xk``/``xv``
    included.

    A hybrid cache (``p0``, ``p1``, …) gains the port's ``tail``. The
    reference's hybrid prefill and decode leave out the ``n_layers mod
    len(block_pattern)`` tail layers (ROADMAP Queue C item 11), so its cache
    has no states for them: for a ``cfg`` with tail layers this raises
    rather than serve them from zeros, and ``cfg`` is required to tell."""
    out = _tree(cache, device)
    if "p0" in out and "tail" not in out:
        if cfg is None:
            raise ValueError("cache_from_reference: a hybrid cache needs cfg to tell whether "
                             "the config has tail layers")
        n_tail = cfg.n_layers % len(cfg.block_pattern)
        if n_tail:
            raise ValueError(
                f"cache_from_reference: {cfg.arch_id} has {n_tail} tail layer(s) after its "
                f"{cfg.n_layers // len(cfg.block_pattern)} pattern periods, and the reference's "
                "hybrid cache holds no state for them (ROADMAP Queue C item 11: the reference's "
                "prefill and decode skip the tail); prefill with the port instead")
        out["tail"] = []
    return out


def opt_state_from_reference(state, *, device="cuda"):
    """The reference's ``AdamWState(step, mu, nu, master)`` with numpy
    leaves (e.g. ``jax.tree.map(np.asarray, opt)``) as the port's
    ``train.optimizer.AdamWState`` on ``device``."""
    from repro_torch.train.optimizer import AdamWState

    return AdamWState(_tensor(state.step, device), _tree(state.mu, device),
                      _tree(state.nu, device), _tree(state.master, device))
