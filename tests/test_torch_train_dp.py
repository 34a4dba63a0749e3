"""The port's train step over several processes (``sharding.process``,
``train.train_step`` on a ``ProcessMesh``), against the port's one-process
step and the reference's jitted step on forced host devices.

Two spawned groups of gloo processes on the CPU, one torch thread each
(``tests/torch_train_dp_common.py``), reduced qwen2.5-3b with the
reference's initial weights, ``TokenPipeline(512, 32, 4)`` batches,
``PROFILES['train']``; meanwhile the reference runs on 4 forced host
devices (``tests/torch_train_dp_ref.py``):

* 4 ranks on ``('data',)`` = 4 and ``('data', 'model')`` = (2, 2): the
  global-batch loss within 1e-6 relative and every gradient leaf, gathered
  whole, within 1e-4 of its max|g| of the one-process step's and of the
  reference's on the same mesh (which is not bitwise across its own meshes:
  6.5e-5 of max|g| between them); three steps' losses the same way; each
  rank's state bytes equal to ``logical_sharding``'s blocks'. Reduced
  olmoe-1b-7b on (2, 2) against one process: the router's load-balance and
  z-loss statistics are the global batch's. One hierarchical step on
  ``('pod', 'data')`` = (2, 2) against the reference's: the pods' mean loss
  within 1e-6, ``grad_norm`` within 1e-4, each rank's residual block within
  1e-2 of an int8 quantum but for at most 0.1 % of the elements (one
  quantum: a rounding boundary crossed on float32 noise). The state after
  the (2, 2) steps is checkpointed.
* 2 ranks on ``('pod',)`` = 2: two hierarchical steps bitwise the one-card
  ``hier_step``'s (parameters and each member's residuals); the 4-rank
  checkpoint restored on ``('data',)`` = 2 and in this process, bitwise, and
  read by the reference's ``restore_checkpoint``; ``run_training`` on 2
  ranks, resumed from its checkpoint, against the one-process run.
* A rank that raises makes ``spawn_ranks`` raise.
* ``Blocks`` against ``NamedSharding.devices_indices_map`` for specs with
  tuple entries, on a stand-in mesh of 4 positions in this process.
"""
import json
import os
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

import torch_train_dp_common as dp
from repro.ckpt.checkpoint import restore_checkpoint as ref_restore
from repro.models.registry import get_model as ref_get_model
from repro.train.optimizer import adamw_init as ref_adamw_init
from repro_torch.ckpt.checkpoint import _flatten, restore_checkpoint
from repro_torch.core.distributed import ShardMesh
from repro_torch.launch.train import run_training
from repro_torch.models.registry import abstract_params, get_model
from repro_torch.sharding.process import Blocks, spawn_ranks
from repro_torch.sharding.rules import logical_sharding
from repro_torch.train.grad_compression import init_residuals
from repro_torch.train.optimizer import adamw_init
from repro_torch.train.train_step import layer_views, make_train_step
from torch_lm_common import configs_for
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_TOL, GRAD_TOL, NORM_TOL = 1e-6, 1e-4, 1e-4
MESHES = ("data4", "data2x2")


def _rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


def _paths(tree, pre=""):
    """Leaf paths in ``train.optimizer.tree_leaves`` order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _paths(tree[k], f"{pre}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree) for p in _paths(v, f"{pre}/{i}")]
    return [pre]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's initial weights, its runs, the two spawned groups'
    results and the one-process step's (loss, metrics, gradients)."""
    tmp = tmp_path_factory.mktemp("dp")
    rcfg, _ = configs_for("qwen2.5-3b")
    rparams, _ = ref_get_model(rcfg).init(jax.random.key(0))
    p0 = str(tmp / "p0.npz")
    np.savez(p0, **{jax.tree_util.keystr(kp): np.asarray(v)
                    for kp, v in jax.tree_util.tree_flatten_with_path(rparams)[0]})
    ref_out = str(tmp / "ref.npz")
    ref = subprocess.Popen([sys.executable, os.path.join(ROOT, "tests", "torch_train_dp_ref.py"),
                            os.path.join(ROOT, "src"), p0, ref_out],
                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                           env=dict(os.environ, JAX_PLATFORMS="cpu"))
    try:
        ckpt = str(tmp / "ckpt")
        r4 = spawn_ranks(dp.ranks4, 4, (p0, ckpt), timeout_s=300)
        r2 = spawn_ranks(dp.ranks2, 2, (p0, ckpt, str(tmp / "run")), timeout_s=300)
        log, _ = ref.communicate(timeout=300)
    finally:
        if ref.poll() is None:
            ref.kill()
    assert ref.returncode == 0, log[-3000:]
    cfg = dp.config()
    params = dp.load_params(cfg, p0)
    one = make_train_step(get_model(cfg).loss_fn, cfg, lr=dp.LR, warmup=dp.WARMUP)
    return dict(ref=dict(np.load(ref_out)), r4=r4, r2=r2, p0=p0, ckpt=ckpt, cfg=cfg,
                rparams=rparams, params=params, one=one.grads(params, dp.batch(cfg, 0)),
                paths=_paths(layer_views(params)))


def _grads_close(got, want):
    """The worst gradient leaf's max|Δ| / max|g|."""
    worst = 0.0
    for g, w in zip(got, want):
        scale = float(np.abs(w).max())
        if scale:
            worst = max(worst, float(np.abs(g - w).max()) / scale)
    return worst


@pytest.mark.parametrize("mesh", MESHES)
def test_loss_and_gradients_match_one_process(runs, mesh):
    loss, met, grads = runs["one"]
    for r in runs["r4"]:  # every rank reports the global batch's loss
        assert _rel(r[mesh]["loss"], loss) <= LOSS_TOL, (mesh, r[mesh]["loss"], float(loss))
        assert _rel(r[mesh]["met"]["ce"], met["ce"]) <= LOSS_TOL
    got = runs["r4"][0][mesh]["grads"]
    want = [g.numpy() for g in grads]
    assert len(got) == len(want) == len(runs["paths"])
    assert _grads_close(got, want) <= GRAD_TOL


@pytest.mark.parametrize("mesh", MESHES)
def test_loss_and_gradients_match_reference_on_its_mesh(runs, mesh):
    ref = runs["ref"]
    r = runs["r4"][0][mesh]
    assert _rel(r["loss"], ref[f"{mesh}/loss"]) <= LOSS_TOL
    assert _rel(r["met"]["ce"], ref[f"{mesh}/ce"]) <= LOSS_TOL
    worst = 0.0
    for path, g in zip(runs["paths"], r["grads"]):
        parts = path.strip("/").split("/")
        if parts[0] in ("layers",):  # a layer of a stacked leaf
            key = "".join(f"[{p!r}]" for p in [parts[0], *parts[2:]])
            want = ref[f"{mesh}/g" + key]
            scale, want = float(np.abs(want).max()), want[int(parts[1])]
        else:
            want = ref[f"{mesh}/g" + "".join(f"[{p!r}]" for p in parts)]
            scale = float(np.abs(want).max())
        worst = max(worst, float(np.abs(g - want).max()) / scale)
    assert worst <= GRAD_TOL, worst


@pytest.mark.parametrize("mesh", MESHES)
def test_three_steps(runs, mesh):
    cfg = runs["cfg"]
    step = make_train_step(get_model(cfg).loss_fn, cfg, lr=dp.LR, warmup=dp.WARMUP)
    params = dp.load_params(cfg, runs["p0"])
    opt = adamw_init(params)
    losses, norms = [], []
    for t in range(dp.STEPS):
        params, opt, m = step(params, opt, dp.batch(cfg, t))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    want = runs["ref"][f"{mesh}/losses"]
    for r in runs["r4"]:
        got = r[mesh]
        assert all(_rel(a, b) <= LOSS_TOL for a, b in zip(got["losses"], losses)), (got, losses)
        assert all(_rel(a, b) <= LOSS_TOL for a, b in zip(got["losses"], want)), (got, want)
        assert all(_rel(a, b) <= NORM_TOL for a, b in zip(got["norms"], norms)), (got, norms)


@pytest.mark.parametrize("mesh", MESHES)
def test_state_bytes_are_logical_sharding(runs, mesh):
    shape, names = dp.MESHES4[mesh]
    meta = ShardMesh(["meta"] * 4, shape=shape, axis_names=names)
    params, axes = abstract_params(runs["cfg"])
    flat_p, flat_a = _flatten(params), dict(_flatten_axes(axes))
    want = 0
    for key, p in flat_p:
        sh = logical_sharding(tuple(p.shape), flat_a[key], meta, dp.RULES, p.dtype)
        want += sh.shard_nbytes + 3 * logical_sharding(tuple(p.shape), flat_a[key], meta,
                                                       dp.RULES, torch.float32).shard_nbytes
    assert want < 4 * 4 * sum(p.numel() for _, p in flat_p)  # something is sharded
    assert [r[mesh]["state_bytes"] for r in runs["r4"]] == [want] * 4


def _flatten_axes(axes, pre=""):
    """``(keystr, logical axes)`` of a logical-axes tree."""
    if isinstance(axes, dict):
        return [kv for k in sorted(axes) for kv in _flatten_axes(axes[k], f"{pre}[{k!r}]")]
    if isinstance(axes, list):
        return [kv for i, v in enumerate(axes) for kv in _flatten_axes(v, f"{pre}[{i}]")]
    return [(pre, axes)]


def test_moe_router_statistics_are_global(runs):
    cfg = dp.config("olmoe-1b-7b")
    params = get_model(cfg).init(0, device="cpu")
    loss, met, grads = make_train_step(get_model(cfg).loss_fn, cfg).grads(params,
                                                                           dp.batch(cfg, 0))
    assert float(met["aux"]) > 0
    for r in runs["r4"]:
        assert _rel(r["moe"]["loss"], loss) <= LOSS_TOL
        assert _rel(r["moe"]["met"]["aux"], met["aux"]) <= LOSS_TOL
    got = runs["r4"][0]["moe"]["grads"]
    assert _grads_close(got, [g.numpy() for g in grads]) <= GRAD_TOL


def test_pod_step_is_bitwise_the_one_card_step(runs):
    cfg = runs["cfg"]
    mesh = ShardMesh.on_one_device(2, "cpu", axis="pod")
    step = make_train_step(get_model(cfg).loss_fn, cfg, mesh=mesh, lr=dp.LR, warmup=dp.WARMUP,
                           pod_compression=True)
    params = dp.load_params(cfg, runs["p0"])
    opt, res = adamw_init(params), [init_residuals(params)] * 2
    for t in range(2):
        params, opt, res, met = step(params, opt, res, dp.batch(cfg, t))
        for i, r in enumerate(runs["r2"]):
            got = r["hier"][t]
            for k, v in dp.host(params).items():
                assert np.array_equal(got["params"][k], v), (t, i, k)
            for k, v in dp.host(res[i]).items():
                assert np.array_equal(got["res"][k], v), (t, i, k)
            assert _rel(got["loss"], met["loss"]) <= LOSS_TOL


def test_pod_data_step_matches_reference(runs):
    ref = runs["ref"]
    for r in runs["r4"]:
        got = r["pod2x2"]
        assert _rel(got["met"]["loss"], ref["hier/met_loss"].mean()) <= LOSS_TOL
        assert _rel(got["met"]["grad_norm"], ref["hier/met_grad_norm"][0]) <= NORM_TOL
        assert got["met"]["lr"] == float(ref["hier/met_lr"][0])
        pod = got["coords"]["pod"]
        for k, v in got["res"].items():
            want = ref[f"hier/res{pod}" + k]
            quantum = 2 * float(np.abs(want).max())
            d = np.abs(v - want[got["index"][k]]) / quantum
            flip = d > 0.5
            assert flip.mean() <= 1e-3 and (d[flip] <= 1.01).all(), (k, flip.mean())
            assert d[~flip].max() <= 1e-2, (k, d[~flip].max())


class _Ranks:
    """What ``Blocks`` reads of a ``ProcessMesh``, at one rank of a mesh of
    ``shape`` whose ranks all hold blocks of ``whole`` under ``spec``, in
    this process: its collectives concatenate or pick those blocks over a
    sub-group, in rank order."""

    def __init__(self, shape, names, rank, whole, spec):
        self.shape, self.axis_names = dict(zip(names, shape)), names
        self.whole, self.spec = whole, spec
        self.coords = dict(zip(names, map(int, np.unravel_index(rank, shape))))

    def blocks(self):
        return Blocks(self, self.spec, tuple(self.whole.shape))

    def axes_of(self, axes):
        return tuple(a for a in self.axis_names if a in set(axes) and self.shape[a] > 1)

    def _group(self, axes):
        """The ranks of the sub-group over ``axes``, in rank order."""
        extents = tuple(self.shape.values())
        for pos in np.ndindex(*(self.shape[a] for a in axes)):
            c = dict(self.coords, **dict(zip(axes, map(int, pos))))
            yield int(np.ravel_multi_index(tuple(c.values()), extents))

    def all_gather(self, block, axes):
        return torch.cat([_Ranks(tuple(self.shape.values()), self.axis_names, r, self.whole,
                                 self.spec).blocks().take(self.whole).reshape(-1)
                          for r in self._group(axes)])

    def reduce_scatter(self, parts, axes):
        group = list(self._group(axes))
        rank = int(np.ravel_multi_index(tuple(self.coords.values()),
                                        tuple(self.shape.values())))
        return parts.reshape(-1).tensor_split(len(group))[group.index(rank)]


@pytest.mark.parametrize("case", range(5))
def test_blocks_follow_named_sharding(runs, case):
    """``Blocks`` places, gathers and reduce-scatters in the reference's
    ``NamedSharding`` block order (the reference's parameters' spec entries
    name one axis each; these cases add tuple entries in both orders)."""
    ref = runs["ref"]
    spec = [tuple(e) if isinstance(e, list) else e
            for e in json.loads(str(ref["block_cases"]))[case]]
    shape = tuple(int(n) for n in ref["block_shape"])
    whole = torch.arange(float(np.prod(shape))).reshape(shape)
    for rank in range(4):
        b = _Ranks((2, 2), ("data", "model"), rank, whole, spec).blocks()
        got = [(sl.start, sl.stop) for sl in b.index()]
        assert got == [tuple(x) for x in ref[f"blocks{case}"][rank]], (spec, rank)
        assert torch.equal(b.gather(b.take(whole)), whole), (spec, rank)
        assert torch.equal(b.reduce_scatter(whole), b.take(whole)), (spec, rank)


def _whole_restore(runs):
    cfg = runs["cfg"]
    skel = get_model(cfg).init(0, device="cpu")
    tree, at, _ = restore_checkpoint(runs["ckpt"], {"params": skel, "opt": adamw_init(skel)})
    return dp.host(tree), at


def test_checkpoint_from_4_ranks_restores_on_2_ranks_and_one_process(runs):
    whole, at = _whole_restore(runs)
    assert at == dp.STEPS
    for r in runs["r4"]:  # one process holds each of the 4 ranks' blocks
        got = r["data2x2"]
        for k, v in got["blocks"].items():
            assert np.array_equal(whole[k][got["index"][k]], v), k
    for r in runs["r2"]:  # and so do 2 ranks
        assert r["at"] == dp.STEPS
        for k, v in r["restored"].items():
            assert np.array_equal(whole[k][r["index"][k]], v), k
        for k, v in r["whole"].items():
            assert np.array_equal(whole[k], v), k


def test_reference_reads_the_checkpoint(runs):
    whole, _ = _whole_restore(runs)
    skel = {"params": runs["rparams"], "opt": ref_adamw_init(runs["rparams"])}
    tree, at, _ = ref_restore(runs["ckpt"], skel)
    assert at == dp.STEPS
    got = {jax.tree_util.keystr(kp): np.asarray(v)
           for kp, v in jax.tree_util.tree_flatten_with_path(tree)[0]}
    assert set(got) == set(whole)
    for k, v in whole.items():
        assert got[k].dtype == v.dtype and np.array_equal(got[k], v), k


def test_run_training_over_ranks_matches_one_process(runs, tmp_path):
    _, _, want = run_training(runs["cfg"], steps=3, global_batch=dp.B, seq_len=16, lr=dp.LR,
                              warmup=dp.WARMUP, device="cpu", log_fn=lambda line: None)
    lead, other = runs["r2"]
    for r in (lead, other):
        assert len(r["losses"]) == 3
        assert all(_rel(a, b) <= LOSS_TOL for a, b in zip(r["losses"], want)), (r, want)
    assert other["lines"] == [] and "[train] resumed from step 2" in lead["lines"]


def test_a_failing_rank_fails_the_launch():
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="rank 1 of 2 failed"):
        spawn_ranks(dp.rank1_fails, 2, timeout_s=60)
    assert time.perf_counter() - t0 < 45
