"""Run the port's four TN-KDE examples (``examples/*_torch.py``) one after
another and time each end to end.

    python3 tools/run_examples.py [--device cpu] [--out DIR]

Each example runs in a process of its own (``PYTHONPATH=src``), on the card
unless ``--device cpu`` is given, so its wall seconds include the start of
Python, the kernels' first build and every first use. Prints the card's
name and power limit (``nvidia-smi``) when it runs on the card, then each
example's output and one JSON line per example (``name``, ``rc``,
``seconds``); ``--out`` also writes each output to ``DIR/<name>.log``.
Exits non-zero if any example does (each fails its own check so).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = ("quickstart", "heatmap_kernels", "streaming_kde", "serve_tnkde")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out", default=None, help="a directory for each example's output")
    args = ap.parse_args()
    if args.device != "cpu":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip())
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (os.path.join(ROOT, "src"),
                                                    env.get("PYTHONPATH")) if p)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    failed = []
    for name in EXAMPLES:
        cmd = [sys.executable, os.path.join(ROOT, "examples", f"{name}_torch.py"),
               "--device", args.device]
        t0 = time.perf_counter()
        run = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        text = run.stdout + (f"\n[stderr]\n{run.stderr}" if run.returncode else "")
        print(f"== {name}\n{text}")
        if args.out:
            with open(os.path.join(args.out, f"{name}.log"), "w") as f:
                f.write(run.stdout + run.stderr)
        print(json.dumps(dict(name=name, device=args.device, rc=run.returncode,
                              seconds=round(seconds, 3))))
        if run.returncode:
            failed.append(name)
    if failed:
        sys.exit(f"run_examples: {failed} failed")


if __name__ == "__main__":
    main()
