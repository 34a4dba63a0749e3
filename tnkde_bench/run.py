#!/usr/bin/env python3
"""The benchmark of the PyTorch/CUDA port (``repro_torch``): one cell, once.

    python3 tnkde_bench/run.py --workload berkeley-rfs-fresh --seed 7 \\
        --seconds 30 --trace 0

Run from the root of a checkout on a machine with an NVIDIA GPU. The cell's
inputs (the road network and its events) and its traffic come from
``--seed``; set-up builds the index and warms the cell's shapes, then the
window measures for ``--seconds``. The last line of standard output is one
JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics with ``--trace 0``, its per-layer metrics with
``--trace 1``), ``device`` and, traced, ``breakdown``; then ``check``, each
number compared beside its limit, which are also the last lines of standard
error. Exits non-zero, printing no result, without a CUDA device, when the
port is missing, or when the JAX stack or the JAX package got loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _environment():
    """Paths and caches: the port from this checkout's ``src``, its kernel
    libraries built once into ``build/`` of the checkout, at fixed paths."""
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(ROOT / "build" / "repro_torch")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")


def _finite(x):
    """JSON has no infinity: an unbounded reading prints as the largest float."""
    if isinstance(x, float) and not math.isfinite(x):
        return 1e308
    if isinstance(x, dict):
        return {k: _finite(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_finite(v) for v in x]
    return x


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < 1:
        print("no CUDA device: the benchmark measures the port on the card", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401 — fail before any work if the port is missing

    from tnkde_bench.harness.cell import run_cell

    result, info = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                            device="cuda", t_start=T_START)
    if info["forbidden"]:
        print(f"loaded in this process: {', '.join(info['forbidden'])}", file=sys.stderr)
        return 3
    print(f"set-up {info['setup_s']:.3f} s; check of {info['answers_checked']} answers "
          f"took {info['check_s']:.3f} s", file=sys.stderr)
    for name, c in result["check"].items():
        print(f"check {name}={c['value']!r} limit={c['limit']!r}", file=sys.stderr)
    print(json.dumps(_finite(result)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
