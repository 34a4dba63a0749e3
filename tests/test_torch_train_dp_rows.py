"""The port's train step over several processes on global batches whose rows
do not divide by the world (``train.train_step.row_axes``), against the
port's one-process step and the reference's jitted step on the same mesh.

One spawned group of 4 gloo processes on the CPU, one torch thread each
(``tests/torch_train_dp_common.py::ranks_rows``), reduced qwen2.5-3b and
olmoe-1b-7b with the reference's initial weights, ``TokenPipeline(512, 32,
B)`` batches, ``PROFILES['train']``; meanwhile the reference runs on 4
forced host devices (``tests/torch_train_dp_rows_ref.py``):

* ``('data', 'model')`` = (2, 2): 2 rows (split over ``data``, whole on
  both ``model`` ranks), 3 rows (both axes dropped: every rank runs the 3
  rows) and 2 rows of olmoe (the router's statistics): the global batch's
  loss within 1e-6 relative on every rank and every gradient leaf, gathered
  whole, within 1e-4 of its max|g| of the one-process step's and the
  reference's; two steps' losses and grad norms the same way.
* ``('pod', 'data')`` = (2, 2), the hierarchical step on 2 rows (one a pod,
  whole on both ``data`` ranks): the pods' mean loss and ``grad_norm``
  against the one-process ``hier_step`` and the reference's, each pod's
  gradients against the one-process gradients of its row, each rank's
  residual block against the reference's within the gradients' tolerance
  (``RES_TOL``), or one int8 quantum apart where the reference's lies that
  close to a rounding boundary;
  on 1 row it raises, and so does the reference's.
"""
import os
import subprocess
import sys
from types import SimpleNamespace

import jax
import numpy as np
import pytest

import torch_train_dp_common as dp
from repro.models.registry import get_model as ref_get_model
from repro_torch.core.distributed import ShardMesh
from repro_torch.models.registry import get_model
from repro_torch.sharding.process import Blocks, spawn_ranks
from repro_torch.train.grad_compression import init_residuals
from repro_torch.train.optimizer import adamw_init, tree_map
from repro_torch.train.train_step import layer_views, make_train_step, row_axes
from torch_lm_common import configs_for
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_TOL, GRAD_TOL, NORM_TOL = 1e-6, 1e-4, 1e-4
# a residual is its gradient less the int8 rounding, so off a rounding
# boundary it differs as the gradient does: GRAD_TOL of max|g| is 127 ×
# GRAD_TOL of one quantum (the pods' max|g| / 127)
RES_TOL = 127 * GRAD_TOL
ARCHS = ("qwen2.5-3b", "olmoe-1b-7b")


def _rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


def _paths(tree, pre=""):
    """Leaf paths in ``train.optimizer.tree_leaves`` order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _paths(tree[k], f"{pre}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree) for p in _paths(v, f"{pre}/{i}")]
    return [pre]


def _grads_close(got, want):
    """The worst gradient leaf's max|Δ| / max|g|."""
    worst = 0.0
    for g, w in zip(got, want):
        scale = float(np.abs(w).max())
        if scale:
            worst = max(worst, float(np.abs(g - w).max()) / scale)
    return worst


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's initial weights of both archs, its run, the spawned
    group's results and the archs' port configs and parameters."""
    tmp = tmp_path_factory.mktemp("rows")
    paths = {}
    for arch in ARCHS:
        rcfg, _ = configs_for(arch)
        rparams, _ = ref_get_model(rcfg).init(jax.random.key(0))
        paths[arch] = str(tmp / f"{arch}.npz")
        np.savez(paths[arch], **{jax.tree_util.keystr(kp): np.asarray(v)
                                 for kp, v in jax.tree_util.tree_flatten_with_path(rparams)[0]})
    ref_out = str(tmp / "ref.npz")
    ref = subprocess.Popen([sys.executable, os.path.join(ROOT, "tests", "torch_train_dp_rows_ref.py"),
                            os.path.join(ROOT, "src"), *(paths[a] for a in ARCHS), ref_out],
                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                           env=dict(os.environ, JAX_PLATFORMS="cpu"))
    try:
        ranks = spawn_ranks(dp.ranks_rows, 4, (paths,), timeout_s=300)
        log, _ = ref.communicate(timeout=300)
    finally:
        if ref.poll() is None:
            ref.kill()
    assert ref.returncode == 0, log[-3000:]
    cfgs = {a: dp.config(a) for a in ARCHS}
    params = {a: dp.load_params(cfgs[a], paths[a]) for a in ARCHS}
    return dict(ref=dict(np.load(ref_out)), ranks=ranks, cfgs=cfgs, params=params)


def _one_process(runs, case, t=0, rows=None):
    """(loss, metrics, gradients as numpy) of the one-process step on batch
    ``t`` of ``case`` (``rows``: those rows of it alone)."""
    arch, n, _ = dp.ROWS_CASES[case]
    cfg = runs["cfgs"][arch]
    batch = dp.rows_batch(cfg, n, t)
    if rows is not None:
        batch = {k: v[rows] for k, v in batch.items()}
    loss, met, grads = make_train_step(get_model(cfg).loss_fn, cfg).grads(runs["params"][arch],
                                                                         batch)
    return loss, met, [g.numpy() for g in grads]


@pytest.mark.parametrize("case", list(dp.ROWS_CASES))
def test_loss_and_gradients_match_one_process(runs, case):
    loss, met, want = _one_process(runs, case)
    for r in runs["ranks"]:  # every rank reports the global batch's loss
        got = r[case]
        assert _rel(got["loss"], loss) <= LOSS_TOL, (case, got["loss"], float(loss))
        for k in ("ce", "aux"):
            assert abs(got["met"][k] - float(met[k])) <= LOSS_TOL * max(abs(float(met[k])),
                                                                        1e-30), (case, k)
    if case.startswith("moe"):
        assert float(met["aux"]) > 0
    got = runs["ranks"][0][case]["grads"]
    assert len(got) == len(want)
    assert _grads_close(got, want) <= GRAD_TOL


@pytest.mark.parametrize("case", list(dp.ROWS_CASES))
def test_loss_and_gradients_match_reference_on_its_mesh(runs, case):
    ref = runs["ref"]
    arch = dp.ROWS_CASES[case][0]
    r = runs["ranks"][0][case]
    assert _rel(r["loss"], ref[f"{case}/loss"]) <= LOSS_TOL
    assert _rel(r["met"]["ce"], ref[f"{case}/ce"]) <= LOSS_TOL
    if case.startswith("moe"):
        assert _rel(r["met"]["aux"], ref[f"{case}/aux"]) <= LOSS_TOL
    worst = 0.0
    paths = _paths(layer_views(runs["params"][arch]))
    assert len(paths) == len(r["grads"])
    for path, g in zip(paths, r["grads"]):
        parts = path.strip("/").split("/")
        if parts[0] == "layers":  # a layer of a stacked leaf
            want = ref[f"{case}/g" + "".join(f"[{p!r}]" for p in [parts[0], *parts[2:]])]
            scale, want = float(np.abs(want).max()), want[int(parts[1])]
        else:
            want = ref[f"{case}/g" + "".join(f"[{p!r}]" for p in parts)]
            scale = float(np.abs(want).max())
        if scale:
            worst = max(worst, float(np.abs(g - want).max()) / scale)
    assert worst <= GRAD_TOL, worst


@pytest.mark.parametrize("case", [c for c, (_, _, steps) in dp.ROWS_CASES.items() if steps])
def test_steps(runs, case):
    arch, n, steps = dp.ROWS_CASES[case]
    cfg = runs["cfgs"][arch]
    step = make_train_step(get_model(cfg).loss_fn, cfg, lr=dp.LR, warmup=dp.WARMUP)
    params = tree_map(lambda t: t.clone(), runs["params"][arch])  # the step updates in place
    opt = adamw_init(params)
    losses, norms = [], []
    for t in range(steps):
        params, opt, m = step(params, opt, dp.rows_batch(cfg, n, t))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    ref = runs["ref"]
    for r in runs["ranks"]:
        got = r[case]
        assert len(got["losses"]) == steps
        for want, tol in ((losses, LOSS_TOL), (ref[f"{case}/losses"], LOSS_TOL)):
            assert all(_rel(a, b) <= tol for a, b in zip(got["losses"], want)), (got, want)
        for want in (norms, ref[f"{case}/norms"]):
            assert all(_rel(a, b) <= NORM_TOL for a, b in zip(got["norms"], want)), (got, want)


def test_pod_step_splits_the_pods_rows_inside_the_pod(runs):
    """The hierarchical step on 2 rows over ('pod', 'data') = (2, 2): each
    pod's row whole on its two ``data`` ranks."""
    cfg, ref = runs["cfgs"]["qwen2.5-3b"], runs["ref"]
    batch = dp.rows_batch(cfg, 2, 0)
    one = make_train_step(get_model(cfg).loss_fn, cfg,
                          mesh=ShardMesh.on_one_device(2, "cpu", axis="pod"), lr=dp.LR,
                          warmup=dp.WARMUP, pod_compression=True)
    params = tree_map(lambda t: t.clone(), runs["params"]["qwen2.5-3b"])
    _, _, _, met = one(params, adamw_init(params), [init_residuals(params)] * 2, batch)
    pod_grads = [_one_process(runs, "rows2", rows=slice(p, p + 1))[2] for p in range(2)]
    for r in runs["ranks"]:
        got = r["pod2"]
        for want in (met["loss"], ref["pod2/met_loss"].mean()):
            assert _rel(got["met"]["loss"], want) <= LOSS_TOL, (got["met"]["loss"], float(want))
        for want in (met["grad_norm"], ref["pod2/met_grad_norm"][0]):
            assert _rel(got["met"]["grad_norm"], want) <= NORM_TOL
        assert got["met"]["lr"] == float(ref["pod2/met_lr"][0])
        pod = got["coords"]["pod"]
        assert _grads_close(got["grads"], pod_grads[pod]) <= GRAD_TOL
        for k, v in got["res"].items():
            want = ref[f"pod2/res{pod}" + k]
            quantum = 2 * float(np.abs(want).max())
            want = want[got["index"][k]]
            d = np.abs(v - want) / quantum
            # one int8 quantum apart: a rounding boundary crossed on float32
            # noise, so only where the reference's residual is half a quantum
            flip = d > 0.5
            edge = np.abs(np.abs(want[flip]) / quantum - 0.5)
            assert (d[flip] <= 1 + RES_TOL).all() and (edge <= RES_TOL).all(), (k, edge.max())
            assert d[~flip].max() <= RES_TOL, (k, d[~flip].max())


def test_pod_step_raises_where_the_reference_cannot_split(runs):
    """1 row over 2 pods: the reference's ``shard_map`` raises, and so do
    the port's step on every rank and the one-process ``hier_step``."""
    assert str(runs["ref"]["pod1/raised"]) == "ValueError", runs["ref"].get("pod1/message")
    for r in runs["ranks"]:
        assert "does not split over 2 pods" in r["pod2"]["raised"], r["pod2"]["raised"]
    cfg = runs["cfgs"]["qwen2.5-3b"]
    one = make_train_step(get_model(cfg).loss_fn, cfg,
                          mesh=ShardMesh.on_one_device(2, "cpu", axis="pod"), pod_compression=True)
    params = runs["params"]["qwen2.5-3b"]
    with pytest.raises(ValueError, match="does not split"):
        one(params, adamw_init(params), [init_residuals(params)] * 2, dp.rows_batch(cfg, 1, 0))


def _mesh(shape, names):
    """What ``row_axes`` and ``Blocks`` read of a ``ProcessMesh``: its axes,
    extents and world (a position's coordinates set by ``_at``)."""
    return SimpleNamespace(shape=dict(zip(names, shape)), axis_names=names,
                           world=int(np.prod(shape)),
                           axes_of=lambda axes: tuple(a for a in names if a in set(axes)
                                                      and dict(zip(names, shape))[a] > 1))


def _at(mesh, rank):
    extents = tuple(mesh.shape.values())
    mesh.coords = dict(zip(mesh.axis_names, map(int, np.unravel_index(rank, extents))))
    return mesh


ROW_CASES = [  # (shape, names, rows, pod, the axes the rows split over)
    ((2, 2), ("data", "model"), 4, None, ("data", "model")),
    ((2, 2), ("data", "model"), 2, None, ("data",)),
    ((2, 2), ("data", "model"), 3, None, ()),
    ((1, 2), ("data", "model"), 1, None, ("data",)),
    ((4,), ("data",), 6, None, ()),
    ((2, 2), ("pod", "data"), 4, "pod", ("pod", "data")),
    ((2, 2), ("pod", "data"), 2, "pod", ("pod",)),
    ((2, 4, 2), ("pod", "data", "model"), 8, "pod", ("pod", "data")),
    ((2, 4, 2), ("pod", "data", "model"), 6, "pod", ("pod",)),
]


@pytest.mark.parametrize("shape,names,rows,pod,axes", ROW_CASES)
def test_row_axes_and_every_row_block_held_alike(shape, names, rows, pod, axes):
    """``row_axes`` under ``PROFILES['train']``: every axis when the rows
    divide by the world, else ``act_batch``'s axes that divide (inside each
    pod under the hierarchical step); the ranks' blocks cover every row the
    same number of times, and ranks that differ only off those axes hold
    the same rows."""
    mesh = _mesh(shape, names)
    assert row_axes(mesh, dp.RULES, rows, pod) == axes
    held, by_coords = np.zeros(rows, int), {}
    for rank in range(mesh.world):
        sl = Blocks(_at(mesh, rank), (axes,), (rows,)).index()[0]
        held[sl] += 1
        key = tuple(mesh.coords[a] for a in axes)
        assert by_coords.setdefault(key, (sl.start, sl.stop)) == (sl.start, sl.stop)
    assert (held == mesh.world // int(np.prod([mesh.shape[a] for a in axes] or [1]))).all()


def test_row_axes_pod_rows_must_split_over_the_pods():
    mesh = _mesh((2, 2), ("pod", "data"))
    with pytest.raises(ValueError, match="does not split over 2 pods"):
        row_axes(mesh, dp.RULES, 3, "pod")
    assert row_axes(mesh, dp.RULES, 3, None) == ()  # without the pod step: replicated
