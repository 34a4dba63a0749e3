#!/usr/bin/env python3
"""Readings the limit of ``correct`` is set from, for one cell, in one process.

    python3 tnkde_bench/readings.py --workload berkeley-rfs-fresh \\
        --seeds 11 12 13 --control-seeds 21 22 23 --seconds 3

For each of ``--seeds``: a run of the cell at its own size with a short
window (the program as the configuration states it), and its ``rel_err``.
For each of ``--control-seeds``: the same with the program's lower-precision
path switched on (``CONTROL_CODEC``: float32 window tables, the nearest
precision below the configuration's float64). One JSON line per run
on standard output; the benchmark's own runs do not run this.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CONTROL_CODEC = "f32"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from tnkde_bench.harness.cell import run_cell

    runs = [(s, None) for s in args.seeds]
    runs += [(s, {"table_codec": CONTROL_CODEC}) for s in args.control_seeds]
    for seed, over in runs:
        t0 = time.perf_counter()
        res, info = run_cell(args.workload, seed, args.seconds, False, overrides=over)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "codec": (over or {}).get("table_codec", "as configured"),
                          "rel_err": res["check"]["rel_err"]["value"],
                          "correct": res["correct"], "attempted": res["attempted"],
                          "failed": res["failed"], "metrics": res["metrics"],
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
