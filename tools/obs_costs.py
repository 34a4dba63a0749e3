"""What the port's spans (``repro_torch.obs``) cost, and whether they lie on
the profiler's clock.

* ``off_ns``: one ``with obs.span(...)`` block with no profiler recording
  (the flag read and the shared no-op context), with and without
  attributes, beside an empty ``with`` block of a shared no-op context
  (``nullcontext_ns``) and one read of the flag alone (``flag_ns``);
* ``on_us``: one span block while a profiler records the host and the
  device (its ``record_function`` range, two clock readings, the record);
* ``clock``: spans around device work under the profiler, each record's
  ``t0_ns`` / ``t1_ns`` against the start and end of its
  ``repro_torch.*`` event (most and least difference, milliseconds), and
  the device-side mirrors of the ranges by name with their
  ``is_user_annotation()`` flags (the benchmark's device trace leaves
  flagged ones out of the device's busy time).

The last line is one JSON object of them all.

    python3 tools/obs_costs.py               # on a machine with a CUDA card
    python3 tools/obs_costs.py --device cpu  # host activity only
"""
import argparse
import contextlib
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "src"))

import torch  # noqa: E402
from torch.autograd import profiler as autograd_profiler  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch import obs  # noqa: E402


def per_call_ns(fn, n):
    fn(n // 10)
    t = time.perf_counter_ns()
    fn(n)
    return (time.perf_counter_ns() - t) / n


def off_costs(n):
    null = contextlib.nullcontext()

    def empty(k):
        for _ in range(k):
            with null:
                pass

    def flag(k):
        for _ in range(k):
            if not autograd_profiler._is_profiler_enabled:
                pass

    def bare(k):
        for _ in range(k):
            with obs.span("tnkde.plan"):
                pass

    def with_attrs(k):
        for i in range(k):
            with obs.span("tnkde.dispatch", query=i, windows=24) as sp:
                if sp is not None:
                    sp["hit"] = True

    return {"nullcontext_ns": per_call_ns(empty, n), "flag_ns": per_call_ns(flag, n),
            "span_ns": per_call_ns(bare, n), "span_attrs_ns": per_call_ns(with_attrs, n)}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=1_000_000, help="span blocks timed off")
    args = ap.parse_args()
    dev = torch.device(args.device)
    on_card = dev.type == "cuda"
    if on_card and not torch.cuda.is_available():
        raise SystemExit("no CUDA device; pass --device cpu for host activity only")
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    out = {"device": torch.cuda.get_device_name(0) if on_card else "cpu",
           "torch": torch.__version__}

    out["off"] = off_costs(args.n)
    print("COST off", json.dumps(out["off"]), flush=True)

    x = torch.ones(1 << 20, dtype=torch.float64, device=dev)
    for _ in range(3):  # the profiler's own first-use costs
        with profile(activities=acts):
            (x * 2.0).sum()
    n_on = 2000
    with profile(activities=acts):
        t = time.perf_counter_ns()
        for _ in range(n_on):
            pass
        base = time.perf_counter_ns() - t
        t = time.perf_counter_ns()
        for i in range(n_on):
            with obs.span("tnkde.plan", query=i) as sp:
                sp["hit"] = True
        spans = time.perf_counter_ns() - t
    out["on_us"] = (spans - base) / n_on * 1e-3
    print("COST on_us", out["on_us"], flush=True)

    obs.clear()
    with profile(activities=acts) as prof:
        for i in range(20):
            with obs.span("tnkde.dispatch", query=i):
                with obs.span("tnkde.tables"):
                    y = (x * float(i)).cumsum(0)
                with obs.span("tnkde.launch"):
                    y = y + x
            with obs.span("tnkde.result", query=i):
                with obs.span("tnkde.wait"):
                    y.sum().item()
    recs = obs.records()
    host, mirrors = {}, {}
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        if not name.startswith(obs.PREFIX):
            continue
        if ev.device_type() == torch.autograd.DeviceType.CUDA:
            key = f"{name} user_annotation={bool(ev.is_user_annotation())}"
            mirrors[key] = mirrors.get(key, 0) + 1
        else:
            host.setdefault(name[len(obs.PREFIX):], []).append(
                (ev.start_ns(), ev.start_ns() + ev.duration_ns()))
    d0, d1 = [], []
    for name in sorted({r.name for r in recs}):
        mine = sorted((r.t0_ns, r.t1_ns) for r in recs if r.name == name)
        theirs = sorted(host.get(name, []))
        if len(mine) != len(theirs):
            raise SystemExit(f"{name}: {len(mine)} records against {len(theirs)} events")
        for (a0, a1), (b0, b1) in zip(mine, theirs):
            d0.append((a0 - b0) * 1e-6)
            d1.append((a1 - b1) * 1e-6)
    out["clock"] = {"records": len(recs), "t0_minus_start_ms": [min(d0), max(d0)],
                    "t1_minus_end_ms": [min(d1), max(d1)], "device_mirrors": mirrors}
    print("CLOCK", json.dumps(out["clock"]), flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
