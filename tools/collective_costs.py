"""What a collective of the multi-process train step costs when its ranks
share one card under gloo (``sharding.process``; gloo's transport is TCP,
so every CUDA tensor goes through host memory).

    python3 tools/collective_costs.py [--world 2] [--mib 16 150 600] [--reps 3]

Starts ``--world`` ranks on card 0 (gloo, ``sharding.process.spawn_ranks``)
and times, per size, the median of ``--reps`` runs on rank 0 of: the copy
of a CUDA tensor to pageable and to pinned host memory and back, gloo's
``all_gather_into_tensor`` and ``reduce_scatter_tensor`` on host tensors
(each rank's part of that size), ``ProcessMesh.all_gather`` /
``reduce_scatter`` / ``all_reduce`` as the step calls them, and whether
gloo takes CUDA tensors for the all-gather, the reduce-scatter and the
gather itself, and how long it takes then (and for the all-reduce).
Prints one JSON line per size. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro_torch.sharding.process import (ProcessMesh, init_group,  # noqa: E402
                                          spawn_ranks)


def _timed(fn, reps, device):
    out = []
    for _ in range(reps + 1):  # the first run warms up
        dist.barrier()
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(device)
        out.append(time.perf_counter() - t0)
    return statistics.median(out[1:])


def _cuda_takes(op, x, out):
    """Whether gloo runs ``op`` on CUDA tensors itself (a probe: reported only)."""
    try:
        op(out, x)
        return True
    except (RuntimeError, ValueError) as e:
        return f"{type(e).__name__}: {str(e).splitlines()[0][:120]}"


def rank_main(rank, world, address, sizes, reps):
    dev = init_group(address=address, rank=rank, world=world, backend="gloo", device="cuda")
    mesh = ProcessMesh((world,), ("data",), device=dev)
    rows = []
    for mib in sizes:
        n = mib * (1 << 20) // 2  # bf16 elements of this rank's part
        x = torch.randn(n, device=dev).to(torch.bfloat16)
        whole = torch.empty(world * n, dtype=x.dtype, device=dev)
        pinned = torch.empty(n, dtype=x.dtype, pin_memory=True)
        h, hw = x.cpu(), torch.empty(world * n, dtype=x.dtype)
        row = dict(mib=mib, world=world)
        row["d2h_pageable_s"] = _timed(lambda: x.cpu(), reps, dev)
        row["d2h_pinned_s"] = _timed(lambda: pinned.copy_(x), reps, dev)
        row["h2d_pageable_s"] = _timed(lambda: h.to(dev), reps, dev)
        row["h2d_pinned_s"] = _timed(lambda: x.copy_(pinned, non_blocking=True), reps, dev)
        row["gloo_all_gather_host_s"] = _timed(lambda: dist.all_gather_into_tensor(hw, h), reps,
                                               dev)
        row["gloo_reduce_scatter_host_s"] = _timed(
            lambda: dist.reduce_scatter_tensor(h, hw), reps, dev)
        row["mesh_all_gather_s"] = _timed(lambda: mesh.all_gather(x, ("data",)), reps, dev)
        row["mesh_reduce_scatter_s"] = _timed(lambda: mesh.reduce_scatter(whole, ("data",)),
                                              reps, dev)
        row["gloo_takes_cuda_all_gather"] = _cuda_takes(dist.all_gather_into_tensor, x, whole)
        row["gloo_takes_cuda_reduce_scatter"] = _cuda_takes(
            dist.reduce_scatter_tensor, whole, torch.empty_like(x))
        parts = [torch.empty_like(x) for _ in range(world)] if rank == 0 else None
        row["gloo_takes_cuda_gather"] = _cuda_takes(
            lambda out, t: dist.gather(t, out, dst=0), x, parts)
        if row["gloo_takes_cuda_all_gather"] is True:
            row["gloo_cuda_all_gather_s"] = _timed(
                lambda: dist.all_gather_into_tensor(whole, x), reps, dev)
        if row["gloo_takes_cuda_reduce_scatter"] is True:
            row["gloo_cuda_reduce_scatter_s"] = _timed(
                lambda: dist.reduce_scatter_tensor(x, whole), reps, dev)
        row["gloo_cuda_all_reduce_s"] = _timed(lambda: dist.all_reduce(x), reps, dev)
        row["mesh_all_reduce_s"] = _timed(lambda: mesh.all_reduce(x, ("data",)), reps, dev)
        rows.append(row)
        del x, whole, pinned, h, hw
        torch.cuda.empty_cache()
    return rows


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--world", type=int, default=2)
    ap.add_argument("--mib", type=int, nargs="+", default=[16, 150, 600])
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("collective_costs: no CUDA device", file=sys.stderr)
        return 2
    rows = spawn_ranks(rank_main, args.world, (args.mib, args.reps), timeout_s=900)[0]
    for row in rows:
        print(json.dumps(dict(row, card=torch.cuda.get_device_name(0))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
