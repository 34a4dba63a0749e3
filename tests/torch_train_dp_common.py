"""What each rank runs in ``tests/test_torch_train_dp.py`` and
``tests/test_torch_train_dp_rows.py`` (the port only, no JAX: every
spawned process imports this module). Each function is ``fn(rank, world,
address, *args)`` for ``sharding.process.spawn_ranks``: it joins a gloo
group on the CPU, one torch thread, and returns numpy arrays for the test
to hold against the one-process step and the reference."""
import numpy as np
import torch

from repro_torch.ckpt.checkpoint import _flatten, _unflatten, restore_checkpoint, save_checkpoint
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.data.synthetic import TokenPipeline
from repro_torch.launch.train import run_training
from repro_torch.models.registry import get_model
from repro_torch.sharding.process import (ProcessMesh, gather_tree, init_group, state_blocks,
                                          take_blocks, tree_nbytes)
from repro_torch.sharding.rules import PROFILES
from repro_torch.train.grad_compression import init_residuals
from repro_torch.train.optimizer import adamw_init, tree_leaves
from repro_torch.train.train_step import layer_views, make_train_step

LR, WARMUP, B, S, STEPS = 1e-3, 2, 4, 32, 3
RULES = PROFILES["train"]
# the meshes of the 4-rank run, in the order every rank builds them
MESHES4 = {"data4": ((4,), ("data",)), "data2x2": ((2, 2), ("data", "model")),
           "pod2x2": ((2, 2), ("pod", "data"))}


def config(arch="qwen2.5-3b"):
    return reduce_for_smoke(get_config(arch))


def load_params(cfg, path):
    """The port's tree of ``cfg`` with the leaves of ``path`` (an npz keyed
    as ``jax.tree_util.keystr``)."""
    given = np.load(path)
    skel = get_model(cfg).init(0, device="cpu")
    return _unflatten(skel, iter(torch.from_numpy(given[k]) for k, _ in _flatten(skel)))


def batch(cfg, t):
    return TokenPipeline(cfg.vocab, S, B, seed=0).batch(t, "cpu")


def host(tree):
    """``{keystr: numpy}`` of a tree of tensors."""
    return {k: v.detach().numpy().copy() for k, v in _flatten(tree)}


def _join(rank, world, address):
    torch.set_num_threads(1)
    init_group(address=address, rank=rank, world=world, backend="gloo", device="cpu",
               timeout_s=120.0)


def grads_on(mesh, cfg, params):
    """(loss, metrics, every per-layer gradient whole) of batch 0 on ``mesh``."""
    step = make_train_step(get_model(cfg).loss_fn, cfg, mesh=mesh, rules=RULES, lr=LR,
                           warmup=WARMUP)
    blocks = step.blocks
    loss, met, grads = step.grads(take_blocks(params, blocks), batch(cfg, 0))
    whole = [b.gather(g) for g, b in zip(grads, tree_leaves(layer_views(blocks)))]
    return (float(loss), {k: float(v) for k, v in met.items()},
            [g.numpy().copy() for g in whole])


def ranks4(rank, world, address, p0_path, ckpt_dir):
    """The 4-rank run: on ``data4`` and ``data2x2`` the gradients of batch 0,
    three steps' losses and this rank's state bytes (and on ``data2x2`` a
    checkpoint of the state after the steps, with this rank's blocks of
    it); the reduced olmoe-1b-7b's gradients on ``data2x2``; one
    hierarchical step on ``pod2x2``."""
    _join(rank, world, address)
    meshes = {k: ProcessMesh(shape, names, device="cpu") for k, (shape, names) in MESHES4.items()}
    cfg = config()
    p0 = load_params(cfg, p0_path)
    out = {}
    for name in ("data4", "data2x2"):
        mesh = meshes[name]
        loss, met, grads = grads_on(mesh, cfg, p0)
        step = make_train_step(get_model(cfg).loss_fn, cfg, mesh=mesh, rules=RULES, lr=LR,
                               warmup=WARMUP)
        params = take_blocks(p0, step.blocks)
        opt = adamw_init(params)
        losses, norms = [], []
        for t in range(STEPS):
            params, opt, m = step(params, opt, batch(cfg, t))
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        out[name] = dict(loss=loss, met=met, grads=grads, losses=losses, norms=norms,
                         state_bytes=tree_nbytes(params) + tree_nbytes(tuple(opt)[1:]),
                         coords=dict(mesh.coords))
        if name == "data2x2":
            state = {"params": params, "opt": opt}
            save_checkpoint(ckpt_dir, STEPS, state, shardings=state_blocks(step.blocks))
            out[name]["blocks"] = host(state)
            out[name]["index"] = {k: b.index()
                                  for k, b in _flatten(state_blocks(step.blocks))}
    moe = config("olmoe-1b-7b")
    loss, met, grads = grads_on(meshes["data2x2"], moe, get_model(moe).init(0, device="cpu"))
    out["moe"] = dict(loss=loss, met=met, grads=grads)
    mesh = meshes["pod2x2"]
    step = make_train_step(get_model(cfg).loss_fn, cfg, mesh=mesh, rules=RULES, lr=LR,
                           warmup=WARMUP, pod_compression=True)
    params = take_blocks(p0, step.blocks)
    _, _, res, met = step(params, adamw_init(params), init_residuals(params), batch(cfg, 0))
    index = {k: b.index() for k, b in _flatten(step.blocks)}
    out["pod2x2"] = dict(met={k: float(v) for k, v in met.items()}, res=host(res), index=index,
                         coords=dict(mesh.coords))
    return out


def ranks2(rank, world, address, p0_path, ckpt_dir, run_dir):
    """The 2-rank run: two hierarchical steps on ``('pod',)`` = 2 (this
    rank's parameters and residuals after each); the 4-rank checkpoint
    restored on ``('data',)`` = 2 (this rank's blocks); two steps of
    ``run_training`` on that mesh into ``run_dir``, then one more resumed
    from its checkpoint (the losses, only rank 0's log lines)."""
    _join(rank, world, address)
    pod = ProcessMesh((2,), ("pod",), device="cpu")
    data = ProcessMesh((2,), ("data",), device="cpu")
    cfg = config()
    step = make_train_step(get_model(cfg).loss_fn, cfg, mesh=pod, rules=RULES, lr=LR,
                           warmup=WARMUP, pod_compression=True)
    params = take_blocks(load_params(cfg, p0_path), step.blocks)
    opt, res = adamw_init(params), init_residuals(params)
    hier = []
    for t in range(2):
        params, opt, res, met = step(params, opt, res, batch(cfg, t))
        hier.append(dict(params=host(params), res=host(res), loss=float(met["loss"])))
    blocks = make_train_step(get_model(cfg).loss_fn, cfg, mesh=data, rules=RULES).blocks
    skel = take_blocks(get_model(cfg).init(0, device="cpu"), blocks)
    skel = {"params": skel, "opt": adamw_init(skel)}
    restored, at, _ = restore_checkpoint(ckpt_dir, skel, shardings=state_blocks(blocks))
    whole = gather_tree(restored, state_blocks(blocks))
    lines = []
    kw = dict(global_batch=B, seq_len=16, lr=LR, warmup=WARMUP, ckpt_dir=run_dir, ckpt_every=1,
              mesh=data, log_every=1, log_fn=lines.append, device="cpu")
    _, _, first = run_training(cfg, steps=2, **kw)
    _, _, resumed = run_training(cfg, steps=3, **kw)
    index = {k: b.index() for k, b in _flatten(state_blocks(blocks))}
    return dict(hier=hier, restored=host(restored), whole=host(whole), at=at, index=index,
                losses=first + resumed, lines=lines)


def rank1_fails(rank, world, address):
    """Rank 1 raises after joining; rank 0 waits for it in a collective."""
    _join(rank, world, address)
    if rank == 1:
        raise RuntimeError("rank 1 fails on purpose")
    torch.distributed.barrier()
    return rank


# the meshes of the rows run (tests/test_torch_train_dp_rows.py), in the
# order every rank builds them
MESHES_ROWS = {"data2x2": ((2, 2), ("data", "model")), "pod2x2": ((2, 2), ("pod", "data"))}
# case -> (arch, global rows, steps taken): rows that do not divide by the world
ROWS_CASES = {"rows2": ("qwen2.5-3b", 2, 2), "rows3": ("qwen2.5-3b", 3, 2),
              "moe2": ("olmoe-1b-7b", 2, 0)}


def rows_batch(cfg, rows, t):
    return TokenPipeline(cfg.vocab, S, rows, seed=0).batch(t, "cpu")


def ranks_rows(rank, world, address, paths):
    """The rows run: for each of ``ROWS_CASES`` on ``data2x2`` the gradients
    of batch 0 (whole) and the losses and grad norms of its steps; on
    ``pod2x2`` one hierarchical step on 2 rows (its metrics, this rank's
    residuals and the pod-local gradients of batch 0, whole) and the error
    a 1-row batch raises. ``paths``: arch -> its parameters' npz."""
    _join(rank, world, address)
    meshes = {k: ProcessMesh(shape, names, device="cpu")
              for k, (shape, names) in MESHES_ROWS.items()}
    out = {}
    for name, (arch, rows, steps) in ROWS_CASES.items():
        cfg = config(arch)
        p0 = load_params(cfg, paths[arch])
        step = make_train_step(get_model(cfg).loss_fn, cfg, mesh=meshes["data2x2"], rules=RULES,
                               lr=LR, warmup=WARMUP)
        loss, met, grads = step.grads(take_blocks(p0, step.blocks), rows_batch(cfg, rows, 0))
        whole = [b.gather(g) for g, b in zip(grads, tree_leaves(layer_views(step.blocks)))]
        params = take_blocks(p0, step.blocks)
        opt = adamw_init(params)
        losses, norms = [], []
        for t in range(steps):
            params, opt, m = step(params, opt, rows_batch(cfg, rows, t))
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        out[name] = dict(loss=float(loss), met={k: float(v) for k, v in met.items()},
                         grads=[g.numpy().copy() for g in whole], losses=losses, norms=norms)
    cfg = config()
    p0 = load_params(cfg, paths["qwen2.5-3b"])
    mesh = meshes["pod2x2"]
    step = make_train_step(get_model(cfg).loss_fn, cfg, mesh=mesh, rules=RULES, lr=LR,
                           warmup=WARMUP, pod_compression=True)
    _, _, grads = step.grads(take_blocks(p0, step.blocks), rows_batch(cfg, 2, 0))
    whole = [b.gather(g) for g, b in zip(grads, tree_leaves(layer_views(step.blocks)))]
    params = take_blocks(p0, step.blocks)
    _, _, res, met = step(params, adamw_init(params), init_residuals(params),
                          rows_batch(cfg, 2, 0))
    index = {k: b.index() for k, b in _flatten(step.blocks)}
    try:
        step(params, adamw_init(params), init_residuals(params), rows_batch(cfg, 1, 0))
        raised = ""
    except ValueError as e:
        raised = str(e)
    out["pod2"] = dict(met={k: float(v) for k, v in met.items()}, res=host(res), index=index,
                       coords=dict(mesh.coords), grads=[g.numpy().copy() for g in whole],
                       raised=raised)
    return out
