"""Activation checkpointing changes memory and time, never values: every
``cfg.remat`` policy gives bitwise the same loss and gradients on the CPU,
for a dense, a moe, a hybrid and an rwkv config (the port's own seeded
weights, reduced size), and so do the rwkv WKV chunks
(``cfg.rwkv_chunk_remat``, over two chunks of 256 tokens). That the
policies do differ is read off the operators run in forward + backward:
``'full'`` recomputes the layers' matrix products, ``'dots'`` keeps every
product and recomputes the rest, ``'dots_no_batch'`` recomputes the batched
ones (``bmm``: attention's einsums) only."""
import dataclasses
from collections import Counter

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from torch_lm_common import flat
from torch_train_common import _rebuild
from repro_torch import configs
from repro_torch.data.synthetic import TokenPipeline
from repro_torch.models.common import REMAT_POLICIES
from repro_torch.models.registry import get_model
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

ARCHS = ("qwen2.5-3b", "olmoe-1b-7b", "recurrentgemma-9b", "rwkv6-3b")


class _OpCount(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n[func.overloadpacket.__name__] += 1
        return func(*args, **(kwargs or {}))


def _loss_and_grads(cfg, params, batch):
    leaves = {k: v.detach().clone().requires_grad_() for k, v in flat(params).items()}
    loss, _ = get_model(cfg).loss_fn(_rebuild(params, iter(leaves.values())), batch)
    grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True,
                                materialize_grads=True)
    return loss.detach(), dict(zip(leaves, grads))


def _world(arch, S=24, B=2, **overrides):
    cfg = dataclasses.replace(configs.reduce_for_smoke(configs.get_config(arch)), **overrides)
    params = get_model(cfg).init(3, device="cpu")
    return cfg, params, TokenPipeline(cfg.vocab, S, B, seed=4).batch(0, "cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_policies_bitwise_equal(arch):
    cfg, params, batch = _world(arch)
    runs, ops = {}, {}
    for policy in REMAT_POLICIES:
        with _OpCount() as count:
            runs[policy] = _loss_and_grads(dataclasses.replace(cfg, remat=policy), params, batch)
        ops[policy] = count.n
    loss0, g0 = runs["none"]
    for policy, (loss, grads) in runs.items():
        assert torch.equal(loss, loss0), policy
        assert all(torch.equal(grads[k], g0[k]) for k in g0), policy
    mm = {p: n["mm"] + n["addmm"] for p, n in ops.items()}
    assert mm["full"] > mm["none"] == mm["dots"] == mm["dots_no_batch"], mm
    if ops["none"]["bmm"]:  # the attention einsums of the dense, moe and hybrid families
        bmm = {p: n["bmm"] for p, n in ops.items()}
        assert bmm["full"] == bmm["dots_no_batch"] > bmm["none"] == bmm["dots"], bmm
    assert ops["dots"]["mul"] > ops["none"]["mul"]  # the elementwise work is recomputed


def test_rwkv_chunk_remat_bitwise_equal():
    cfg, params, batch = _world("rwkv6-3b", S=300, B=1, remat="none")
    runs = {}
    for chunk_remat in (False, True):
        with _OpCount() as count:
            loss, g = _loss_and_grads(dataclasses.replace(cfg, rwkv_chunk_remat=chunk_remat),
                                      params, batch)
        runs[chunk_remat] = loss, g, count.n
    (loss0, g0, n0), (loss, g, n) = runs[False], runs[True]
    assert torch.equal(loss, loss0) and all(torch.equal(g[k], g0[k]) for k in g0)
    # the 300 tokens' state updates run once more in the backward (2 layers)
    assert n["mul"] - n0["mul"] >= 2 * 300
