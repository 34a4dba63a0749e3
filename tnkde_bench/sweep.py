#!/usr/bin/env python3
"""Find the knee of a served cell's configuration once: the highest offered
rate at which completions keep pace with arrivals and no backlog grows.

    python3 tnkde_bench/sweep.py --workload johns_creek-rfs-serve \\
        --rates 10 20 40 60 80 --seconds 15 --seed 5

One set-up (the cell's server, warmed), then one open-loop window of
``--seconds`` at each rate in turn, with the cell's mix. Per rate, one JSON
line: requests offered and answered, windows completed a second, p50 / p95
of the latency from the scheduled arrival, the p95 of the first and of the
last third of the arrivals (a backlog that grows shows as a last third far
above the first), and how long after the last arrival the last answer came.
The knee is written into the cells' files by hand, as a number.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=15.0)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from tnkde_bench.harness import check
    from tnkde_bench.harness.cell import cell_inputs, load_cell, load_module
    from tnkde_bench.harness.trace import Spans

    wl, cfg = load_cell(args.workload)
    driver = load_module(ROOT / "tnkde_bench" / "traffic" / f"{wl['driver']}.py")
    rng, ds = cell_inputs(cfg, args.seed)
    b_t = float(cfg["b_t_span_frac"]) * ds.t_span
    t0 = time.perf_counter()
    sut = driver.setup(cfg=cfg, params=wl["params"], ds=ds, b_t=b_t, rng=rng, device="cuda",
                       spans=Spans(), sync=torch.cuda.synchronize)
    print(json.dumps({"setup_s": time.perf_counter() - t0}), flush=True)
    for rate in args.rates:
        sut.params = {**wl["params"], "rate_hz": rate}
        answers = check.Answers(np.zeros(1, np.int64), 1 << 62)  # keeps nothing
        out = driver.measure(sut, seconds=args.seconds, spans=Spans(),
                             sync=torch.cuda.synchronize, answers=answers)
        lat = np.asarray(out["serve"]["latencies_s"])
        third = max(len(lat) // 3, 1)
        fin = lambda x: float(np.percentile(x, 95) * 1e3)  # noqa: E731
        print(json.dumps({
            "rate_hz": rate, "offered": out["attempted"],
            "answered": out["attempted"] - out["failed"],
            "windows_per_s": out["e2e"]["windows_per_s"][0],
            "p50_ms": float(np.percentile(lat, 50) * 1e3),
            "p95_ms": out["e2e"]["request_p95_ms"][0],
            "p95_first_third_ms": fin(lat[:third]), "p95_last_third_ms": fin(lat[-third:]),
            "last_answer_after_close_s": out["t_after_close_s"],
            "late_ms": out["late_s"] * 1e3,
            "windows_per_flush": out["serve"]["windows_evaluated"] / max(out["serve"]["flushes"], 1),
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
