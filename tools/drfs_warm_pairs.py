"""Warm streaming-DRFS query times of two source trees, in alternating runs.

Each run is a fresh process that puts one tree's ``src`` first on the path,
builds ``chip_smoke.py``'s ``[drfs]`` world (berkeley replica, first 90 % of
the events by time, ``drfs_depth=8``, ``auto_seal=False``, ``executor='fused'``),
answers one cold query in the chosen mode, then times ``--warm`` warm queries
(wall clock, synchronised) and profiles one more with ``cProfile``, printing
the functions that took most host time and, by cumulative time, those of the
flush path (``--focus``). Pair i runs the trees in the order
A, B for even i and B, A for odd i, so a drift of the machine falls on both.

    python3 tools/drfs_warm_pairs.py --trees build/parent/src src --pairs 3

needs a CUDA card (``--device cpu --scale 0.02`` walks it on the CPU). The
last line is one JSON object: every run's warm times and each tree's median.
"""
from __future__ import annotations

import argparse
import cProfile
import io
import json
import os
import pstats
import subprocess
import sys
import time

DRFS_FRACS = (0.2, 0.5, 0.8, 0.95, 0.5)  # as chip_smoke.py: one centre duplicated


def one_run(args):
    """The measurement in this process, on the tree at ``args.one``."""
    sys.path.insert(0, os.path.abspath(args.one))
    import numpy as np
    import torch

    from repro_torch.core import TNKDE
    from repro_torch.core.events import Events
    from repro_torch.data.spatial import make_dataset

    def sync():
        if args.device != "cpu":
            torch.cuda.synchronize()

    net, ev, _ = make_dataset("berkeley", scale=args.scale, seed=0)
    order = np.argsort(ev.time, kind="stable")
    sel = order[: int(0.9 * ev.n)]
    t_min = float(ev.time.min())
    span = float(ev.time.max()) - t_min
    ts = [t_min + f * span for f in DRFS_FRACS]
    m = TNKDE(net, Events(ev.edge_id[sel], ev.pos[sel], ev.time[sel]), g=50.0, b_s=800.0,
              b_t=0.2 * span, solution="drfs", engine="torch", executor="fused", drfs_depth=8,
              auto_seal=False, horizon_s=0.9 * span, device=args.device)
    m.drfs_exact_leaf = args.mode == "exact"
    t0 = time.perf_counter()
    m.query(ts)
    sync()
    cold = time.perf_counter() - t0
    warm = []
    for _ in range(args.warm):
        t0 = time.perf_counter()
        m.query(ts)
        sync()
        warm.append(time.perf_counter() - t0)
    prof = cProfile.Profile()
    prof.enable()
    m.query(ts)
    sync()
    prof.disable()
    buf = io.StringIO()
    stats = pstats.Stats(prof, stream=buf)
    stats.sort_stats("tottime").print_stats(args.top)
    stats.sort_stats("cumulative").print_stats(args.focus, args.top)
    print(buf.getvalue())
    print(json.dumps(dict(tree=args.one, mode=args.mode, cold_s=cold, warm_s=warm)))
    return 0


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trees", nargs=2, metavar=("A", "B"), help="two source directories")
    ap.add_argument("--pairs", type=int, default=3)
    ap.add_argument("--warm", type=int, default=5, help="timed warm queries per run")
    ap.add_argument("--mode", choices=("exact", "quantized"), default="exact")
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--top", type=int, default=15, help="functions printed from the profile")
    ap.add_argument("--focus", default="rfs.py|fused_walk.py|ops.py|torch_engine.py",
                    help="regex of the functions also listed by cumulative time")
    ap.add_argument("--one", metavar="SRC", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        return one_run(args)
    if args.device != "cpu":
        import torch

        if not torch.cuda.is_available():
            print("drfs_warm_pairs: no CUDA device available", file=sys.stderr)
            return 2
    runs = []
    for i in range(args.pairs):
        for tree in (args.trees if i % 2 == 0 else args.trees[::-1]):
            cmd = [sys.executable, os.path.abspath(__file__), "--one", tree, "--warm",
                   str(args.warm), "--mode", args.mode, "--scale", str(args.scale),
                   "--device", args.device, "--top", str(args.top), "--focus", args.focus]
            p = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
            print(f"== pair {i} tree {tree} rc={p.returncode}")
            print(p.stdout[-6000:], p.stderr[-2000:] if p.returncode else "", sep="")
            if p.returncode:
                return p.returncode
            runs.append(json.loads(p.stdout.strip().splitlines()[-1]))
    median = {t: sorted(w for r in runs if r["tree"] == t for w in r["warm_s"]) for t in args.trees}
    median = {t: w[len(w) // 2] for t, w in median.items()}
    print(json.dumps(dict(mode=args.mode, runs=runs, median_warm_s=median)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
