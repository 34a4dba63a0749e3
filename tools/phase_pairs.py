"""Measurements of two source trees, in alternating runs.

Each run is a fresh process that imports one tree's ``chip_smoke.py`` (which
puts that tree's ``src`` first on the path) and takes the chosen
measurements on the card, printing their lines:

* ``kernel-drfs``: the streaming index through ``executor='kernel'``
  (``phase_drfs`` with one insert, no compaction, held against the fused
  executor) and its blocks (``phase_drfs_shapes``: every block against the
  plain version, the largest timed with L2 flushed);
* ``minplus``: device all-pairs shortest paths (``phase_minplus``: the
  berkeley product timed, held against scipy's bounded Dijkstra);
* ``segment``: the fixed-order scatter at the shapes of ``[main]`` (static
  RFS, ``executor='fused'``) and ``[drfs]`` (the base epoch, no inserts):
  every pack and block held bitwise against the plain version, the largest
  of each timed beside ``index_put_`` with L2 flushed
  (``phase_segment_shapes``, ``phase_segment_shapes_drfs``), with each
  path's warm query;
* ``warm-drfs``: warm streaming-DRFS queries of ``chip_smoke.py``'s
  ``[drfs]`` world (berkeley replica, first 90 % of the events by time,
  ``drfs_depth=8``, ``auto_seal=False``, ``executor='fused'``) in ``--mode``:
  one cold query, ``--warm`` warm queries (wall clock, synchronised), and one
  more under ``cProfile``, printing the functions that took most host time
  and, by cumulative time, those matching ``--focus``.

Pair i runs the trees in the order A, B for even i and B, A for odd i, so
two pairs give A, B, B, A and a drift of the machine falls on both.

    python3 tools/phase_pairs.py --trees build/parent . --pairs 2
    python3 tools/phase_pairs.py --trees build/parent . --pairs 3 --phases warm-drfs

needs a CUDA card and ``nvcc`` (each tree builds its kernels into its own
``build/``; ``--device cpu --scale 0.02`` walks it on the CPU). The last
line is one JSON object: per run, the tree and the numbers of each
measurement's summary line, and with ``warm-drfs`` each tree's median warm
query.
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

PHASES = ("kernel-drfs", "minplus", "segment", "warm-drfs")
# the summary keys read from each measurement's lines: (tag, key)
KEYS = {
    "kernel-drfs": [("kernel-drfs", "device_bytes"), ("kernel-drfs", "max_memory_allocated"),
                    ("kernel-drfs", "warm_quantized_s"), ("kernel-drfs", "warm_exact_s"),
                    ("kernel-drfs", "kernel_vs_fused"), ("kernel-drfs", "exact_vs_sps")],
    "minplus": [("minplus", "round_kernel_ms"), ("minplus", "call_s"),
                ("minplus", "vs_dijkstra_rel")],
    "segment": [("main-segment", "ms"), ("main-segment", "library_ms"),
                ("drfs-segment", "ms"), ("drfs-segment", "library_ms"), ("main", "warm_s"),
                ("drfs", "warm_quantized_s")],
    "warm-drfs": [("warm-drfs", "mode"), ("warm-drfs", "cold_s"), ("warm-drfs", "warm_s")],
}
DRFS_FRACS = (0.2, 0.5, 0.8, 0.95, 0.5)  # as chip_smoke.py: one centre duplicated


def warm_drfs(cs, args, dev):
    """Cold, warm and one profiled query of the fused [drfs] world."""
    import numpy as np
    import torch

    from repro_torch.core import TNKDE
    from repro_torch.core.events import Events
    from repro_torch.data.spatial import make_dataset

    def sync():
        if dev != "cpu":
            torch.cuda.synchronize()

    net, ev, _ = make_dataset("berkeley", scale=args.scale, seed=0)
    order = np.argsort(ev.time, kind="stable")
    sel = order[: int(0.9 * ev.n)]
    t_min = float(ev.time.min())
    span = float(ev.time.max()) - t_min
    ts = [t_min + f * span for f in DRFS_FRACS]
    m = TNKDE(net, Events(ev.edge_id[sel], ev.pos[sel], ev.time[sel]), g=50.0, b_s=800.0,
              b_t=0.2 * span, solution="drfs", engine="torch", executor="fused", drfs_depth=8,
              auto_seal=False, horizon_s=0.9 * span, device=dev)
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
    cs.say("warm-drfs", mode=args.mode, cold_s=cold, warm_s=",".join(map(str, warm)))
    del m


def one_run(args):
    """The measurements in this process, on the tree at ``args.one``."""
    from types import SimpleNamespace

    root = os.path.abspath(args.one)
    sys.path.insert(0, root)
    import chip_smoke as cs  # the tree's own, with its src first on the path
    import torch

    dev = args.device
    if dev == "cpu":
        card = "cpu-rehearsal"
    else:
        if not torch.cuda.is_available():
            print("phase_pairs: no CUDA device", file=sys.stderr)
            return 2
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              check=True, timeout=60).stdout.strip().splitlines()[0]
        card = card.replace(" ", "_")
        torch.backends.cuda.matmul.allow_tf32 = False
    ns = SimpleNamespace(scale=args.scale, seed=0, profile=None)
    for phase in args.phases:
        t1 = time.perf_counter()
        if phase == "kernel-drfs":
            m, ts, _, _ = cs.phase_drfs(ns, dev, card, executor="kernel", versus="fused",
                                        inserts=1, compact=False, tag="kernel-drfs")
            cs.phase_drfs_shapes(m, ts, dev, card, executor="kernel", tag="kernel-drfs-shapes")
            del m
        elif phase == "minplus":
            cs.phase_minplus(ns, dev, card)
        elif phase == "segment":
            m, ts, _, _, secs = cs.phase_main(ns, dev, card)
            cs.phase_segment_shapes(m, ts, dev, card)
            del m, secs
            cs.free(dev)
            m, ts, _, _ = cs.phase_drfs(ns, dev, card, inserts=0, compact=False)
            cs.phase_segment_shapes_drfs(m, ts, dev, card)
            del m
        else:
            warm_drfs(cs, args, dev)
        cs.free(dev)
        cs.say("phase-pairs", tree=root, ran=phase, seconds=round(time.perf_counter() - t1, 1))
    return 0


def summary(lines, phases):
    """The numbers of the summary keys from one run's output lines."""
    out = {}
    for phase in phases:
        for tag, key in KEYS[phase]:
            for line in lines:
                if not line.startswith(f"[{tag}] "):
                    continue
                for tok in line.split()[1:]:
                    k, _, v = tok.partition("=")
                    if k == key:
                        out[f"{tag}.{key}"] = v
        for line in lines:  # the timed block of each kernel
            if line.startswith("[kernel-drfs-shapes] ") and phase == "kernel-drfs":
                kv = dict(t.partition("=")[::2] for t in line.split()[1:] if "=" in t)
                if "ms" in kv:
                    out[f"kernel-drfs-shapes.{kv.get('kernel')}.ms"] = kv["ms"]
                    out[f"kernel-drfs-shapes.{kv.get('kernel')}.bound_ms"] = kv.get("bound_ms")
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trees", nargs=2, metavar=("A", "B"),
                    help="two checkouts, each with chip_smoke.py and src/")
    ap.add_argument("--pairs", type=int, default=2)
    ap.add_argument("--phases", nargs="+", choices=PHASES, default=["kernel-drfs", "minplus"])
    ap.add_argument("--scale", type=float, default=1.0, help="berkeley replica scale")
    ap.add_argument("--device", default="cuda", help="cpu walks the runs on the CPU (no result)")
    ap.add_argument("--warm", type=int, default=5, help="warm-drfs: timed warm queries per run")
    ap.add_argument("--mode", choices=("exact", "quantized"), default="exact",
                    help="warm-drfs: the DRFS leaf mode")
    ap.add_argument("--top", type=int, default=15,
                    help="warm-drfs: functions printed from the profile")
    ap.add_argument("--focus", default="rfs.py|fused_walk.py|ops.py|torch_engine.py",
                    help="warm-drfs: regex of the functions also listed by cumulative time")
    ap.add_argument("--one", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        return one_run(args)
    runs = []
    for i in range(args.pairs):
        for tree in (args.trees if i % 2 == 0 else args.trees[::-1]):
            cmd = [sys.executable, os.path.abspath(__file__), "--one", tree, "--scale",
                   str(args.scale), "--device", args.device, "--warm", str(args.warm),
                   "--mode", args.mode, "--top", str(args.top), "--focus", args.focus,
                   "--phases", *args.phases]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            print(proc.stdout, end="", flush=True)
            if proc.returncode != 0:
                print(proc.stderr[-4000:], file=sys.stderr, flush=True)
                raise SystemExit(f"phase_pairs: the run on {tree} failed ({proc.returncode})")
            runs.append(dict(tree=tree, **summary(proc.stdout.splitlines(), args.phases)))
    result = {"runs": runs}
    if "warm-drfs" in args.phases:
        median = {}
        for t in args.trees:
            w = sorted(float(x) for r in runs if r["tree"] == t
                       for x in r["warm-drfs.warm_s"].split(",") if x)
            median[t] = w[len(w) // 2] if w else None
        result["median_warm_s"] = median
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
