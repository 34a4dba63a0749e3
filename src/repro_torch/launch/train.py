"""End-to-end trainer: data pipeline -> train step -> checkpoints, with
auto-resume, preemption and the step watchdog (``repro.launch.train``).

Trains on the card unless asked otherwise; without a CUDA device it raises
rather than fall back to the CPU (``--device cpu`` / ``device="cpu"``
trains there).

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \\
      --steps 4 --batch 2 --seq 2048            # full width, one H100
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b --reduce \\
      --steps 300 --batch 8 --seq 256 --ckpt-dir runs/train --device cpu

A full-width qwen2.5-3b step at 2 × 2 048 tokens needs ≈ 60-75 GB of the
card: bf16 parameters and gradients, the float32 master weights and
moments, the activations of one layer at a time (``remat='full'``).

Over several processes, one per device, each rank is started with its rank,
the world size, rank 0's address and a backend; only rank 0 logs, and a
rank that fails makes the others fail (the group's timeout) rather than
hang:

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b --reduce \
      --steps 20 --batch 8 --seq 64 --device cpu --backend gloo \
      --world 4 --rank R --address 127.0.0.1:29500 --mesh-shape 2,2   # R = 0..3
"""
from __future__ import annotations

import argparse
import dataclasses
import signal
import time

import torch

from repro_torch.ckpt import CheckpointManager, latest_step, restore_checkpoint
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.data.synthetic import TokenPipeline
from repro_torch.ft.watchdog import PreemptionHandler, StepWatchdog
from repro_torch.models.registry import get_model
from repro_torch.sharding.process import (ProcessMesh, init_group, state_blocks,
                                          take_blocks)
from repro_torch.sharding.rules import PROFILES
from repro_torch.train.optimizer import adamw_init
from repro_torch.train.train_step import make_train_step

__all__ = ["run_training", "main"]


def run_training(cfg, *, steps: int, global_batch: int, seq_len: int, lr: float = 3e-4,
                 warmup: int = 50, ckpt_dir: str | None = None, ckpt_every: int = 100,
                 mesh=None, profile: str = "train", seed: int = 0, log_every: int = 10,
                 log_fn=print, device="cuda"):
    """Train ``cfg`` from seeded weights (or the newest checkpoint under
    ``ckpt_dir``) up to step ``steps`` on ``device`` -> (params, opt_state,
    losses of the steps run). Batch ``t`` is ``TokenPipeline(seed).batch(t)``,
    so a resumed run sees the stream an uninterrupted one would. With
    ``mesh`` (a ``ShardMesh`` whose positions are all ``device``) the step
    resolves every parameter's spec under ``PROFILES[profile]``, as the
    reference's. With a ``ProcessMesh`` every rank calls this: it trains on
    the mesh's device, holds its blocks of the parameters and AdamW state
    (and returns them), checkpoints them whole and restores its blocks from
    a checkpoint of any mesh; only rank 0 calls ``log_fn``. A ``ShardMesh``
    over several devices raises."""
    ranks = mesh if isinstance(mesh, ProcessMesh) else None
    device = ranks.device if ranks is not None else torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("run_training: no CUDA device; pass device='cpu' to train on the CPU")
    if ranks is not None and ranks.rank != 0:
        log_fn = lambda line: None  # noqa: E731 — rank 0 logs for the group
    model = get_model(cfg)
    pipe = TokenPipeline(cfg.vocab, seq_len, global_batch, seed=seed)
    rules = PROFILES[profile] if mesh is not None else None
    step_fn = make_train_step(model.loss_fn, cfg, mesh=mesh, rules=rules, lr=lr, warmup=warmup)
    params = model.init(seed, device=device)
    shardings = None
    if ranks is not None:
        params = take_blocks(params, step_fn.blocks)
        shardings = state_blocks(step_fn.blocks)
    opt = adamw_init(params)
    start = 0
    mgr = CheckpointManager(ckpt_dir, every=ckpt_every, shardings=shardings) if ckpt_dir else None
    if ckpt_dir and latest_step(ckpt_dir) is not None:
        # into the live tensors: the card never holds the state twice
        tree, start, _ = restore_checkpoint(ckpt_dir, {"params": params, "opt": opt},
                                            in_place=True, shardings=shardings)
        params, opt = tree["params"], tree["opt"]
        log_fn(f"[train] resumed from step {start}")
    wd = StepWatchdog()
    pre = PreemptionHandler(
        on_preempt=lambda: mgr and mgr.maybe_save(cur_step, {"params": params, "opt": opt},
                                                  force=True)
    )
    prev_handler = signal.getsignal(signal.SIGTERM)
    pre.install()
    losses = []
    cur_step = start
    try:
        for cur_step in range(start, steps):
            batch = pipe.batch(cur_step, device)  # pure fn of step: restart-deterministic
            wd.step_start()
            params, opt, metrics = step_fn(params, opt, batch)
            loss = float(metrics["loss"])  # waits for the step
            straggler = wd.step_end()
            losses.append(loss)
            if cur_step % log_every == 0 or cur_step == steps - 1:
                log_fn(
                    f"[train] step {cur_step} loss {loss:.4f} ce {float(metrics['ce']):.4f} "
                    f"gnorm {float(metrics['grad_norm']):.3f} lr {float(metrics['lr']):.2e}"
                    + (" [straggler]" if straggler else "")
                )
            if mgr:
                mgr.maybe_save(cur_step + 1, {"params": params, "opt": opt})
            if ranks is not None and _any_rank(ranks, pre.requested.is_set()):
                pre.requested.set()  # every rank checkpoints (a collective) and stops
            if pre.poll():
                log_fn("[train] preempted — checkpointed and exiting")
                break
        if mgr:
            mgr.maybe_save(cur_step + 1, {"params": params, "opt": opt}, force=True)
            mgr.wait()
    finally:
        signal.signal(signal.SIGTERM, prev_handler)
    return params, opt, losses


def _any_rank(mesh: ProcessMesh, flag: bool) -> bool:
    t = torch.tensor([int(flag)], dtype=torch.int32, device=mesh.device)
    return bool(mesh.all_reduce(t, mesh.axis_names, op="max").item())


_MESH_AXES = {1: ("data",), 2: ("data", "model"), 3: ("pod", "data", "model")}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduce", action="store_true", help="smoke-size the config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--d-model", type=int, default=None, help="override width")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--world", type=int, default=None,
                    help="train over WORLD processes, one per device (this one is --rank)")
    ap.add_argument("--rank", type=int, default=0)
    ap.add_argument("--address", default=None, help="host:port where rank 0 listens")
    ap.add_argument("--backend", default="nccl", choices=("nccl", "gloo"))
    ap.add_argument("--mesh-shape", default=None,
                    help="the ranks' mesh: 'D' (data), 'D,M' (data, model) or 'P,D,M' "
                         "(pod, data, model); default WORLD over data")
    ap.add_argument("--timeout", type=float, default=300.0,
                    help="seconds a collective may wait for the other ranks")
    args = ap.parse_args(argv)
    cfg = get_config(args.arch)
    if args.reduce:
        cfg = reduce_for_smoke(cfg)
    if args.d_model:
        cfg = dataclasses.replace(
            cfg, d_model=args.d_model, head_dim=max(args.d_model // cfg.n_heads, 8)
        )
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    mesh = None
    if args.world is not None:
        if args.address is None:
            ap.error("--world needs --address")
        shape = (tuple(int(n) for n in args.mesh_shape.split(","))
                 if args.mesh_shape else (args.world,))
        if len(shape) not in _MESH_AXES:
            ap.error(f"--mesh-shape {args.mesh_shape}: 1, 2 or 3 axes")
        device = init_group(address=args.address, rank=args.rank, world=args.world,
                            backend=args.backend, device=args.device, timeout_s=args.timeout)
        mesh = ProcessMesh(shape, _MESH_AXES[len(shape)], device=device,
                           timeout_s=args.timeout)
    t0 = time.time()
    try:
        _, _, losses = run_training(
            cfg,
            steps=args.steps,
            global_batch=args.batch,
            seq_len=args.seq,
            lr=args.lr,
            ckpt_dir=args.ckpt_dir,
            ckpt_every=args.ckpt_every,
            mesh=mesh,
            device=args.device,
        )
    finally:
        if mesh is not None:
            torch.distributed.destroy_process_group()
    if mesh is None or mesh.rank == 0:
        print(
            f"[train] done: {args.steps} steps in {time.time()-t0:.1f}s; "
            f"loss {losses[0]:.3f} -> {losses[-1]:.3f}"
        )


if __name__ == "__main__":
    main()
