"""Shared helpers of the training tests (``tests/test_torch_train*.py``):
the reference's jitted loss and gradient, the port's, and the batches of
``tests/test_models_smoke.py::_batch_for`` (plus a 0/1 mask for the
decoder-only families) in both packages' forms."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from test_models_smoke import _batch_for
from torch_lm_common import flat
from repro.models.registry import get_model as ref_get_model
from repro_torch.models.registry import get_model

_REF_GRAD = {}


def batches(rcfg, B=2, S=16, seed=0):
    """(reference batch, the port's copy): ``_batch_for``'s arrays, with a
    seeded 0/1 ``mask`` for the decoder-only families (the encoder-decoder's
    loss takes none)."""
    b = dict(_batch_for(rcfg, B=B, S=S, seed=seed))
    if not rcfg.is_encdec:
        mask = np.random.default_rng(seed + 5).random((B, S)) < 0.7
        b["mask"] = jnp.asarray(mask.astype(np.float32))
    return b, {k: torch.from_numpy(np.array(v)) for k, v in b.items()}


def ref_loss_and_grad(rcfg, params, batch):
    """The reference's (loss, {ce, aux}) and ``jax.grad`` of its loss_fn,
    jitted once per config."""
    key = repr(rcfg)
    if key not in _REF_GRAD:
        model = ref_get_model(rcfg)
        _REF_GRAD[key] = jax.jit(jax.value_and_grad(lambda p, b: model.loss_fn(p, b),
                                                    has_aux=True))
    (loss, metrics), grads = _REF_GRAD[key](params, batch)
    return float(loss), {k: float(v) for k, v in metrics.items()}, flat(grads)


def port_loss_and_grad(pcfg, params, batch, **kw):
    """The port's (loss, {ce, aux}) and the gradient of every leaf
    ``{path: numpy}``, each stacked leaf taking its gradient whole."""
    leaves = {k: v.detach().clone().requires_grad_() for k, v in flat(params).items()}
    tree = _rebuild(params, iter(leaves.values()))
    loss, metrics = get_model(pcfg).loss_fn(tree, batch, **kw)
    grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True,
                                materialize_grads=True)
    return (loss, {k: v for k, v in metrics.items()},
            {k: g.detach().double().numpy() for k, g in zip(leaves, grads)})


def _rebuild(tree, it):
    """``tree``'s structure with its leaves, in ``flat``'s order, from ``it``."""
    if isinstance(tree, dict):
        return {k: _rebuild(v, it) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, it) for v in tree)
    return next(it)
