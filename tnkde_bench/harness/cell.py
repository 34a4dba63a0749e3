"""One run of one cell: everything is found by name.

* ``workloads/<cell>.json``: the cell's configuration, traffic driver,
  traffic parameters, its check sizes and limits, and why it exists;
* ``configs/<config>.json``: the deployment (dataset, scale, index and
  query parameters) with its source and cuts;
* ``traffic/<driver>.py``: a general traffic driver (``setup``,
  ``measure``, ``release``), which reads its parameters from the cell;
* ``metrics/<metric>.py``: one reader per per-layer metric (``read(run)``),
  listed for the cell in ``BENCHMARK.json``.

Adding a cell, a configuration, a driver or a metric adds files and entries
and edits nothing here.
"""
from __future__ import annotations

import importlib.util
import json
import math
import sys
import time
from pathlib import Path

import numpy as np

from . import check
from .dataset import make_dataset, reorder
from .trace import DeviceTrace, Spans
from ..reference.tnkde_ref import lixel_geometry

__all__ = ["BENCH", "load_cell", "load_module", "run_cell", "forbidden_modules"]

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
TRACE_SECONDS = 8.0  # the traced part of a --trace 1 run's window


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """Import a driver or a reader from its file (names may hold dots)."""
    name = "tnkde_bench_" + path.stem.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_cell(name: str, root: Path = BENCH):
    wl = load_json(root / "workloads" / f"{name}.json")
    cfg = load_json(root / "configs" / f"{wl['config']}.json")
    return wl, cfg


def cell_inputs(cfg, seed: int):
    """The run's seeded generator and inputs: the configuration's Table-3
    replica (drawn once, from its ``dataset_seed``) reordered by the seed."""
    rng = np.random.default_rng([int(seed), 0x7E4DE])
    ds = reorder(make_dataset(cfg["table3"], float(cfg["scale"]), int(cfg["dataset_seed"])),
                 rng)
    return rng, ds


def cell_metrics(cell: str, kind: str, root: Path = BENCH):
    """The ``end_to_end`` or ``per_layer`` metrics BENCHMARK.json lists for
    this cell."""
    spec = load_json(root.parent / "BENCHMARK.json")
    return [m for m in spec[kind] if cell in m.get("workloads", [cell])]


def forbidden_modules():
    """Loaded modules whose top-level name is the JAX stack's or the JAX
    package's (whole names: ``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


class Run:
    """What a traced run hands to the per-layer metric readers."""

    def __init__(self, **kw):
        self.spans = None  # trace.Spans
        self.device = None  # trace.DeviceTrace over the traced window
        self.n_queries = 0  # queries (or engine flushes) inside the traced window
        self.counters = {}
        self.work = {}  # kernel -> roofline account of the traced window's work
        self.peak_bytes = 0
        self.serve = {}
        self.__dict__.update(kw)


def run_cell(cell: str, seed: int, seconds: float, trace: bool, *, device="cuda",
             t_start=None, root: Path = BENCH, overrides=None):
    """Run the cell once; returns the result (the last line of standard
    output) and what else the run learned (set-up seconds, loaded JAX
    modules, the check's cost). ``overrides`` changes configuration keys
    (tests and controls only). A traced run reads the per-layer metrics
    that ``BENCHMARK.json`` beside ``root`` lists for the cell."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    wl, cfg = load_cell(cell, root)
    cfg = {**cfg, **(overrides or {})}
    driver = load_module(root / "traffic" / f"{wl['driver']}.py")
    rng, ds = cell_inputs(cfg, seed)
    b_t = float(cfg["b_t_span_frac"]) * ds.t_span
    spans = Spans()
    on_card = torch.device(device).type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    L = lixel_geometry(ds.edge_len, float(cfg["g"]))[0].shape[0]
    answers = check.Answers(check.sample_lixels(L, wl["check"]["lixels"], rng), L)
    sut = driver.setup(cfg=cfg, params=wl["params"], ds=ds, b_t=b_t, rng=rng, device=device,
                       spans=spans, sync=sync)
    sync()
    setup_s = time.perf_counter() - t_start

    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
        prof = profile(activities=acts)
        spans.annotate = True
        seconds = min(float(seconds), TRACE_SECONDS)
        prof.__enter__()
    try:
        out = driver.measure(sut, seconds=float(seconds), spans=spans, sync=sync,
                             answers=answers)
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
            spans.annotate = False
    peak = int(torch.cuda.max_memory_allocated()) if on_card else 0
    forbidden = forbidden_modules()

    run = None
    if trace:
        run = Run(spans=spans, n_queries=out["n_queries"], peak_bytes=peak,
                  counters=out.get("counters", {}), serve=out.get("serve", {}),
                  late_s=out.get("late_s"),
                  device=DeviceTrace(prof, out["window_s"]) if on_card else None)
        run.work = driver.work(sut, out) if hasattr(driver, "work") else {}
    driver.release(sut)
    del sut
    if on_card:
        torch.cuda.empty_cache()

    # ---- the check, once the window has closed and the program is freed
    keys = sorted(answers.items)
    n_pick = min(int(wl["check"]["answers"]), len(keys))
    picks = [keys[i] for i in sorted(rng.choice(len(keys), size=n_pick, replace=False))]
    t_chk = time.perf_counter()
    rel_err = check.compare(answers, picks, ds, cfg, b_t, device)
    check_s = time.perf_counter() - t_chk
    limit = float(wl["check"]["rel_err_limit"])
    correct = (math.isfinite(rel_err) and rel_err <= limit and out["failed"] == 0
               and not forbidden)

    if trace:
        metric_out = {}
        for m in cell_metrics(cell, "per_layer", root):
            v = load_module(root / "metrics" / f"{m['name']}.py").read(run)
            if v is not None:  # a reader that finds nothing leaves its metric out
                metric_out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:  # the cell's end-to-end metrics, of those its driver measures
        e2e = {"setup_s": (setup_s, "s"), **out["e2e"]}
        metric_out = {m["name"]: {"value": e2e[m["name"]][0], "unit": m["unit"]}
                      for m in cell_metrics(cell, "end_to_end", root) if m["name"] in e2e}

    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": 1, "memory_peak_bytes": peak}
    if trace and run.device is not None:
        dev["busy_s"] = run.device.busy_s
        dev["window_s"] = run.device.window_s
    result = {"correct": bool(correct), "attempted": int(out["attempted"]),
              "failed": int(out["failed"]), "metrics": metric_out, "device": dev}
    if trace and run.device is not None:
        result["breakdown"] = run.device.breakdown()
    chk = {"rel_err": {"value": rel_err if math.isfinite(rel_err) else 1e308,
                       "limit": limit},
           "failed": {"value": int(out["failed"]), "limit": 0},
           "jax_modules": {"value": len(forbidden), "limit": 0}}
    result["check"] = chk
    info = {"forbidden": forbidden, "check_s": check_s, "answers_checked": n_pick,
            "setup_s": setup_s}
    return result, info
