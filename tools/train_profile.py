"""Where a training step of the port's trainer spends its time.

Trains qwen2.5-3b at full width (or ``--layers`` of it) with the trainer's
step (``train.train_step.make_train_step``, remat ``'full'``, dense
attention) on ``TokenPipeline`` batches, then:

* times, wall clock with the card synchronised, ``--steps`` warm steps in
  their three parts — the batch on the host (``TokenPipeline.batch``), the
  loss and its gradients, the AdamW update — taken the way the step takes
  them (``train_step.layer_views``, ``torch.autograd.grad``,
  ``optimizer.adamw_update`` through the views);
* runs one whole warm step under ``torch.profiler`` and prints the device's
  busy time, its share of the step's wall time, and the 25 kernels with
  the most device time.

Each measurement is one ``COST <label> <value>`` line; the profile's table
follows; the last line is one JSON object of the costs.

    python3 tools/train_profile.py                 # one H100
    python3 tools/train_profile.py --device cpu --reduce --steps 2
"""
import argparse
import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "src"))

import torch  # noqa: E402

from repro_torch.configs import get_config, reduce_for_smoke  # noqa: E402
from repro_torch.data.synthetic import TokenPipeline  # noqa: E402
from repro_torch.models.registry import get_model  # noqa: E402
from repro_torch.train.optimizer import (AdamWState, adamw_init, adamw_update,  # noqa: E402
                                         tree_leaves, wsd_schedule)
from repro_torch.train.train_step import layer_views, make_train_step  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--reduce", action="store_true", help="the reduced miniature")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--steps", type=int, default=3, help="warm steps timed by part")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("train_profile: no CUDA device (pass --device cpu)")
    cfg = get_config(args.arch)
    if args.reduce:
        cfg = reduce_for_smoke(cfg)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    cfg = dataclasses.replace(cfg, remat="full")

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    costs = {}

    def cost(label, value):
        costs[label] = value
        print(f"COST {label} {value}", flush=True)

    model = get_model(cfg)
    params = model.init(0, device=dev)
    opt = adamw_init(params)
    pipe = TokenPipeline(cfg.vocab, args.seq, args.batch, seed=0)
    step = make_train_step(model.loss_fn, cfg, lr=3e-4, warmup=2)
    for t in range(2):  # warm-up: cuBLAS handles, allocator pools
        params, opt, m = step(params, opt, pipe.batch(t, dev))
    sync()
    lr_fn = wsd_schedule(3e-4, warmup=2)
    parts = {"batch_s": 0.0, "loss_and_grads_s": 0.0, "adamw_s": 0.0}
    for t in range(2, 2 + args.steps):
        t0 = time.perf_counter()
        batch = pipe.batch(t, dev)
        sync()
        t1 = time.perf_counter()
        leaves = layer_views(params, lambda x: x.detach().requires_grad_())
        loss, _ = model.loss_fn(leaves, batch)
        grads = torch.autograd.grad(loss, tree_leaves(leaves))
        sync()
        t2 = time.perf_counter()
        st = AdamWState(opt.step, *(layer_views(x) for x in opt[1:]))
        _, st, _ = adamw_update(list(grads), st, lr_fn=lr_fn, params=layer_views(params))
        opt = AdamWState(st.step, *opt[1:])
        sync()
        t3 = time.perf_counter()
        parts["batch_s"] += t1 - t0
        parts["loss_and_grads_s"] += t2 - t1
        parts["adamw_s"] += t3 - t2
        del leaves, loss, grads
    for k, v in parts.items():
        cost(k, v / args.steps)
    cost("step_s", sum(parts.values()) / args.steps)
    cost("tokens_per_step", args.batch * args.seq)
    cost("model_flops_per_step", cfg.flops_per_token_train() * args.batch * args.seq)

    from torch.profiler import ProfilerActivity, profile

    batch = pipe.batch(99, dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        params, opt, m = step(params, opt, batch)
        sync()
        wall = time.perf_counter() - t1
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in events)
    cost("profiled_step_wall_s", wall)
    cost("device_busy_s", busy_us / 1e6)
    cost("device_idle_share", 1.0 - busy_us / 1e6 / wall)
    cost("kernel_launches", sum(e.count for e in events))
    print(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=25), flush=True)
    if dev.type == "cuda":
        cost("max_memory_allocated", torch.cuda.max_memory_allocated())
        cost("device", torch.cuda.get_device_name(0))
    print(json.dumps(costs), flush=True)


if __name__ == "__main__":
    main()
