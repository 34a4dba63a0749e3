"""Check the dry-run's depth extrapolation on every runnable cell.

``launch.dryrun.trace_cell`` traces a decoder-only step at ``k`` and
``k + 1`` units of layers and extends the growth of one unit to the full
depth. This script traces each cell at ``k + 2`` units too and prints, per
cell, the relative error of the FLOPs, the bytes and the activation peak
extrapolated to ``k + 2`` units against that trace (0 where the
extrapolation is exact). It runs on meta tensors on the host; nothing is
allocated on any device.

    PYTHONPATH=src python tools/dryrun_depth_check.py --jobs 4
"""
import argparse
import concurrent.futures
import dataclasses
import json
import multiprocessing

from repro_torch.configs import SHAPES, get_config, runnable_cells
from repro_torch.launch import dryrun


def check(arch, shape):
    cfg = dataclasses.replace(get_config(arch), remat="full")
    u, tail, _, k = dryrun.units_of(cfg)
    tr = [dryrun._step_at(dataclasses.replace(cfg, n_layers=tail + j * u), SHAPES[shape], "auto")
          for j in (k, k + 1, k + 2)]
    # the extrapolation to k + 2 units against its trace
    rel = {f: (2 * tr[1][f] - tr[0][f]) / tr[2][f] - 1.0 for f in dryrun._FIELDS}
    return dict(arch=arch, shape=shape, depths=[tail + j * u for j in (k, k + 1, k + 2)], **rel)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--jobs", type=int, default=1)
    args = ap.parse_args()
    cells = [(a, s) for a, s in runnable_cells() if not get_config(a).is_encdec]
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(args.jobs, mp_context=ctx) as ex:
        rows = list(ex.map(check, *zip(*cells)))
    for r in rows:
        print(json.dumps(r))
    worst = {f: max(abs(r[f]) for r in rows) for f in dryrun._FIELDS}
    print(json.dumps({"cells": len(rows), "worst_rel": worst}))


if __name__ == "__main__":
    main()
