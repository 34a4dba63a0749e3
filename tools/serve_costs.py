"""What one DRFS flush costs at each epoch of a serve stream, by mode and width.

Builds the quantized profile of ``chip_smoke.py``'s serve phases (berkeley
replica, first 90 % of the events by time, ``drfs_depth=8``,
``auto_seal=False``, ``executor='fused'``) and times, wall clock with the
card synchronised, each step a server pays:

* the model build and the host plan of every epoch;
* at four epochs — the base, 1 % of the events pending, 5 % pending, and
  after ``compact()`` — a query of W = 1, 4 and 16 new window centres
  (window tables built) and the same query again (warm), in each mode;
* the inserts and the compaction.

Each measurement is one ``COST <label> <seconds>`` line; the last line is
one JSON object of them all.

    python3 tools/serve_costs.py             # needs a CUDA card and nvcc
    python3 tools/serve_costs.py --device cpu --scale 0.02
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402  (puts this tree's src first on the path)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=float, default=1.0, help="berkeley replica scale")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    from repro_torch.core import TNKDE
    from repro_torch.core.events import Events
    from repro_torch.data.spatial import make_dataset

    dev = args.device
    if dev != "cpu":  # built (or loaded) before anything is timed
        from repro_torch.kernels.fused_walk import fused_leaf_library, fused_walk_library

        fused_leaf_library()
        fused_walk_library()
    net, base, prof, _ = chip_smoke.serve_world(args)
    _, ev, _ = make_dataset("berkeley", scale=args.scale, seed=args.seed)
    order = np.argsort(ev.time, kind="stable")
    n_base = int(0.9 * ev.n)

    def part(lo, hi):
        sel = order[lo:hi]
        return Events(ev.edge_id[sel], ev.pos[sel], ev.time[sel])

    t_min = float(ev.time.min())
    span = float(ev.time.max()) - t_min
    rng = np.random.default_rng(args.seed + 1)
    costs = {}

    def timed(label, fn):
        if dev != "cpu":
            torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        if dev != "cpu":
            torch.cuda.synchronize()
        costs[label] = time.perf_counter() - t
        print(f"COST {label} {costs[label]:.3f}", flush=True)
        return out

    kw = chip_smoke.serve_profiles(prof, ("quantized",))["quantized"].to_kwargs()
    m = timed("build", lambda: TNKDE(net, base, device=dev, **kw))
    n1, n5 = n_base + int(0.01 * ev.n), n_base + int(0.05 * ev.n)
    steps = (("base", None),
             ("pend1pct", lambda: m.insert(part(n_base, n1))),
             ("pend5pct", lambda: m.insert(part(n1, n5))),
             ("compacted", lambda: m.compact()))
    for epoch, mutate in steps:
        if mutate is not None:
            timed(f"{epoch} mutate", mutate)
        timed(f"{epoch} plan", lambda: m._host_plan(m.snapshot()))
        for exact in (False, True):
            m.drfs_exact_leaf = exact
            for W in (1, 4, 16):
                ts = [float(t) for t in rng.uniform(t_min + 0.2 * span, t_min + 0.8 * span, W)]
                for when in ("new", "warm"):
                    timed(f"{epoch} exact={exact} W={W} {when}", lambda: m.query(ts))
    print(json.dumps({"scale": args.scale, "device": dev, "seconds": costs}))


if __name__ == "__main__":
    main()
