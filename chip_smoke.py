#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # needs one CUDA device and nvcc

Builds the hand-written kernels from the sources in this checkout, holds each
against its plain PyTorch version on the card, then drives the port's main
path once at full width — a static RFS query, ``TNKDE(solution='rfs',
engine='torch', executor='fused').query(ts)`` over the Table-3 berkeley
replica — and checks the answer against the port's plain-torch ``packed``
executor and the index-free SPS oracle. Any failed check raises (non-zero
exit). Without a CUDA device it exits non-zero and prints no result.

Output, in order: the card's name and power limit as ``nvidia-smi`` gives
them; one line per phase; one JSON line ``{"kernels": [...]}`` with each
kernel's launches on the main path, its error against the plain version, its
time, the plain version's time and its roofline bound; and as the last line
``{"ok": true, "device": {...}}``.

``--cpu-rehearsal`` walks the same control flow on the CPU at a small scale
(plain versions only, no timings, exit code 3): it finds wrong paths and
shapes before a run on the card, and is no result.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import repro_torch  # noqa: E402,F401 — fail before any output if the package is missing

# published peaks of one H100 SXM (NVIDIA data sheet): HBM3 bandwidth and the
# float64 rate outside the tensor cores — the kernel does scalar f64 adds
PEAK_BYTES_PER_S = 3.35e12
PEAK_F64_FLOPS = 34e12

KERNEL_TOL = 1e-13  # f64, <= 24 addends per output; only association differs
PACKED_TOL = 1e-12  # fused vs packed executor, relative to max|F|
SPS_TOL = 1e-10  # index vs index-free oracle, relative to max|F|
SPS_EDGES = 32  # query edges in the SPS sample (>= 64 lixels checked)


def require(cond, msg):
    """A failed check ends the run with a non-zero exit (also under -O)."""
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def say(phase, **kv):
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()), flush=True)


# ------------------------------------------------------------------ kernels
def rfs_offs(npad):
    """Level-major packed-forest row offsets: offs[lev] = sum_{j<lev} npad>>j."""
    offs, acc = [], 0
    for lev in range(npad.bit_length()):
        offs.append(acc)
        acc += npad >> lev
    return tuple(offs), acc


def layout_case(layout, G, Q, W, ks, device):
    """Seeded random inputs for one level layout ('rfs<npad>' / 'tree<hq>')."""
    n = int(layout.lstrip("rfstre"))
    if layout.startswith("rfs"):
        offs, R = rfs_offs(n)
        rank_hi = n
    else:  # complete tree of height hq=n
        offs = tuple((1 << (n - lev)) - 1 for lev in range(n + 1))
        R = (1 << (n + 1)) - 1
        rank_hi = 1 << n
    rng = np.random.default_rng(R * 100 + Q)
    nv = rng.normal(size=(G, R * 2, W * 2 * ks))
    r_lo = rng.integers(0, rank_hi + 1, (G, Q))
    r_hi = np.maximum(rng.integers(0, rank_hi + 1, (G, Q)), r_lo)
    side = rng.integers(0, 2, (G, Q))
    qs = rng.normal(size=(G, Q, ks))
    t = lambda x, dt: torch.as_tensor(x, device=device).to(dt).contiguous()  # noqa: E731
    return (t(nv, torch.float64), t(r_lo, torch.int32), t(r_hi, torch.int32),
            t(side, torch.int32), t(qs, torch.float64)), offs


def compare_fused_walk(args, offs):
    """(max_abs_err, max_rel_err) of ops.fused_walk against fused_walk_ref,
    relative to max|plain|; synchronises so a fault surfaces here."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.fused_walk import fused_walk_ref

    got = ops.fused_walk(*args, offs=offs)
    if got.is_cuda:
        torch.cuda.synchronize()
    want = fused_walk_ref(*args, offs=offs)
    require(got.shape == want.shape and got.dtype == torch.float64, "fused_walk output shape/dtype")
    require(bool(torch.isfinite(got).all()), "fused_walk produced non-finite values")
    abs_err = float((got - want).abs().max()) if got.numel() else 0.0
    scale = float(want.abs().max()) if got.numel() else 1.0
    return abs_err, abs_err / (scale or 1.0)


def time_ms(fn, *, reps=10, flush=None):
    """Median CUDA-event time of fn() in ms; ``flush`` (a large tensor) is
    overwritten before every launch so the inputs are not L2-resident."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b))
    return float(np.median(out))


def walk_work(r_lo, r_hi, side, offs, R2):
    """What THIS input makes the walk do: (rows emitted, distinct rows)."""
    l, r = r_lo.to(torch.int64), r_hi.to(torch.int64)
    g = torch.arange(l.shape[0], device=l.device)[:, None] * R2
    emitted, rows = 0, []
    for off in offs:
        for left in (True, False):
            emit = (l < r) & (((l if left else r) & 1) == 1)
            row = ((off + (l if left else r - 1)) * 2 + side + g)[emit]
            emitted += int(emit.sum())
            rows.append(row)
            if left:
                l = torch.where(emit, l + 1, l)
            else:
                r = torch.where(emit, r - 1, r)
        l, r = l >> 1, r >> 1
    distinct = int(torch.unique(torch.cat(rows)).numel()) if rows else 0
    return emitted, distinct


def fused_walk_bound(args, offs):
    """Least time the card could take for this call, from this input: the
    larger of bytes/bandwidth (each distinct node row the climb needs, the
    per-atom coefficients and rank state read once, the output written once)
    and operations/peak f64 (one add per gathered value, 3 per (atom,
    window, feature) in the contraction)."""
    nv, r_lo, r_hi, side, qs = args
    G, R2, WC = nv.shape
    Q, ks = qs.shape[1], qs.shape[2]
    W = WC // (2 * ks)
    emitted, distinct = walk_work(r_lo, r_hi, side, offs, R2)
    nbytes = distinct * WC * 8 + G * Q * (ks * 8 + 12) + G * W * Q * 8
    flops = emitted * WC + G * Q * W * 3 * ks
    t_b, t_f = nbytes / PEAK_BYTES_PER_S, flops / PEAK_F64_FLOPS
    return dict(bound_ms=max(t_b, t_f) * 1e3, bound_by="bytes" if t_b >= t_f else "operations",
                bytes=nbytes, flops=flops, rows_emitted=emitted, rows_distinct=distinct)


def phase_kernels(device):
    """fused_walk vs its plain version over the level layouts of the
    reference's kernel sweep plus one main-path-like shape, ragged Q
    included (33, 65, 1000 are no multiple of the block's 64 atoms)."""
    cases = [
        ("rfs4", 3, 7, 1, 2), ("rfs8", 3, 33, 2, 3), ("rfs16", 3, 65, 3, 2),
        ("tree2", 3, 7, 1, 2), ("tree3", 3, 33, 2, 3), ("tree4", 3, 65, 2, 2),
        ("rfs64", 5, 130, 9, 11),  # W > 8 windows a block, k_s of the gaussian kernel
        ("rfs512", 64, 1024, 5, 2), ("rfs512", 64, 1000, 5, 2),
    ]
    worst_abs = worst_rel = 0.0
    for layout, G, Q, W, ks in cases:
        args, offs = layout_case(layout, G, Q, W, ks, device)
        abs_err, rel = compare_fused_walk(args, offs)
        say("kernels", case=f"{layout}:G{G}:Q{Q}:W{W}:ks{ks}", max_abs_err=abs_err, max_rel_err=rel)
        require(rel <= KERNEL_TOL, f"fused_walk disagrees with its plain version: {rel}")
        worst_abs, worst_rel = max(worst_abs, abs_err), max(worst_rel, rel)
    return worst_abs, worst_rel


# ---------------------------------------------------------------- main path
def sps_sample(m, ts, n_edges, seed):
    """The port's SPS oracle on a random sample of query edges:
    (lixel ids, F_sps [W, n]) — the index-free evaluation of the same KDE."""
    from repro_torch.core.plan import build_edge_geometry
    from repro_torch.core.shortest_path import bounded_dijkstra
    from repro_torch.core.sps import sps_eval_edge

    net, ctx = m.net, m.ctx
    rng = np.random.default_rng(seed)
    radius = ctx.b_s + float(net.edge_len.max()) + 1.0
    ids, vals = [], []
    for a in rng.permutation(net.n_edges)[:n_edges]:
        rows = bounded_dijkstra(net, [net.edge_src[a], net.edge_dst[a]], radius, adj=m._adj)
        geom = build_edge_geometry(net, m.lix, m.ee, int(a), ctx.b_s, rows)
        n = geom.x.shape[0]
        if n == 0:
            continue
        ids.append(np.arange(geom.lix_base, geom.lix_base + n))
        vals.append(np.stack([sps_eval_edge(geom, m.ee, ctx, t) for t in ts]))
    return np.concatenate(ids), np.concatenate(vals, axis=1)


def profile_warm(m, ts, path):
    """Kernel-time table of one warm query (torch.profiler) written to ``path``."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        m.query(ts)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write(f"warm query under the profiler: {wall:.4f} s, engine {m.engine_desc}\n")
        f.write(prof.key_averages().table(sort_by="cuda_time_total", row_limit=40))
    say("profile", written=path, warm_s_profiled=round(wall, 4))


def phase_main(args, device, card):
    from repro_torch.core import TNKDE
    from repro_torch.core.rfs import FlatForestEngine, build_packed_host_tables
    from repro_torch.data.spatial import make_dataset
    from repro_torch.kernels import ops

    t0 = time.perf_counter()
    net, ev, meta = make_dataset("berkeley", scale=args.scale, seed=args.seed)
    span = float(ev.time.max() - ev.time.min())
    t_min = float(ev.time.min())
    # W = 5 centres, one duplicated (must come out bitwise identical)
    ts = [t_min + f * span for f in (0.2, 0.4, 0.6, 0.8, 0.4)]
    m = TNKDE(net, ev, g=50.0, b_s=800.0, b_t=0.2 * span, solution="rfs",
              engine="torch", executor="fused", device=device)
    require(m.engine_desc == "torch/fused", m.engine_desc)
    say("main", dataset="berkeley", scale=args.scale, edges=net.n_edges, events=ev.n,
        lixels=m.n_lixels, build_s=round(time.perf_counter() - t0, 3))

    def sync():
        if device != "cpu":
            torch.cuda.synchronize()

    # ---- the main path: cold then warm query, launch counts read around it
    ops.fused_walk.launches = 0
    c0 = dict(m._fe.counters)
    t1 = time.perf_counter()
    F_cold = m.query(ts)
    sync()
    cold_s = time.perf_counter() - t1
    launches_cold = ops.fused_walk.launches
    s0 = m.stats.n_rank_searches
    t1 = time.perf_counter()
    F = m.query(ts)
    sync()
    warm_s = time.perf_counter() - t1
    launches = ops.fused_walk.launches
    warm_searches = m.stats.n_rank_searches - s0

    packs = m._fe._pack_cache.get(((m.epoch, m.ls), "fused"))
    n_packs = len(packs)
    require(n_packs > 0, "the plan has no atom packs")
    if device != "cpu":
        require(launches_cold == n_packs and launches == 2 * n_packs,
                f"launches {launches_cold}/{launches} for {n_packs} packs")
    require(m._fe.counters["fused_launches"] - c0["fused_launches"] == 2 * n_packs,
            "counters['fused_launches'] != atom packs per flush")
    require(warm_searches == 0, f"warm query searched again: {warm_searches}")
    require(F.shape == (len(ts), m.n_lixels) and F.dtype == np.float64, "heatmap shape/dtype")
    require(np.isfinite(F).all(), "NaN/inf in the heatmap")
    require(np.array_equal(F, F_cold), "warm query differs from the cold one")
    require(np.array_equal(F[1], F[4]), "duplicate window centres are not bitwise identical")
    fmax = float(np.abs(F).max())
    require(fmax > 0.0, "the heatmap is all zeros")
    slots = sum(e["r_lo"].numel() for e in packs)
    say("main", card=card, engine=m.engine_desc, atoms=m._host_plan().n_atoms, packs=n_packs,
        padded_slots=slots,
        launches=launches, device_bytes=m._fe.device_bytes, cold_s=round(cold_s, 4),
        warm_s=round(warm_s, 4), max_F=fmax)

    # ---- vs the plain-torch packed executor on the same device and tables
    fused_fe = m._fe
    m._fe = FlatForestEngine.from_host_tables(
        m.index, build_packed_host_tables(m.index), executor="packed", device=device)
    m._counter_cursor = {}
    t1 = time.perf_counter()
    F_packed = m.query(ts)
    sync()
    packed_cold_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    m.query(ts)
    sync()
    packed_warm_s = time.perf_counter() - t1
    m._fe = fused_fe
    m._counter_cursor = {}
    if args.profile:
        profile_warm(m, ts, args.profile)
    err_packed = float(np.abs(F - F_packed).max()) / fmax
    require(err_packed <= PACKED_TOL, f"fused vs packed: {err_packed}")

    # ---- vs the SPS oracle on a sample of lixels
    ids, F_sps = sps_sample(m, ts, SPS_EDGES, args.seed + 7)
    require(len(ids) >= 64, f"SPS sample too small: {len(ids)} lixels")
    err_sps = float(np.abs(F[:, ids] - F_sps).max()) / fmax
    require(err_sps <= SPS_TOL, f"rfs vs sps: {err_sps}")
    say("main", card=card, fused_vs_packed=err_packed, rfs_vs_sps=err_sps, sps_lixels=len(ids),
        packed_cold_s=round(packed_cold_s, 4), packed_warm_s=round(packed_warm_s, 4))
    return m, ts, launches, dict(cold_s=cold_s, warm_s=warm_s)


def phase_main_shapes(m, ts, device, card):
    """The kernel at the shapes the main path gave it: every atom pack of the
    plan is compared with the plain version; the largest is timed."""
    from repro_torch.core.rfs import _rfs_group
    from repro_torch.kernels import ops
    from repro_torch.kernels.fused_walk import fused_walk_ref

    fe = m._fe
    packs = fe._pack_cache.get(((m.epoch, m.ls), "fused"))
    tabs = fe.window_tables(fe.window_batch(m.ctx, ts), tuple(ts))
    worst_abs = worst_rel = 0.0
    biggest, big_n = None, -1
    t_group = t_kernel = 0.0
    for entry in packs:
        if device != "cpu":
            torch.cuda.synchronize()
        t1 = time.perf_counter()
        nv = _rfs_group(tabs, fe._packed["node_base_lvl"], entry["edges"],
                        npad=entry["npad"], nlev=entry["max_levels"])
        if device != "cpu":
            torch.cuda.synchronize()
        t_group += time.perf_counter() - t1
        kargs = (nv, entry["r_lo"], entry["r_hi"], entry["side"], entry["qs"])
        t1 = time.perf_counter()
        abs_err, rel = compare_fused_walk(kargs, entry["offs"])  # syncs after the kernel
        t_kernel += time.perf_counter() - t1
        require(rel <= KERNEL_TOL, f"fused_walk vs plain at npad={entry['npad']}: {rel}")
        worst_abs, worst_rel = max(worst_abs, abs_err), max(worst_rel, rel)
        n = entry["r_lo"].numel()
        if n > big_n:
            biggest, big_n = (kargs, entry["offs"], entry["npad"]), n
    kargs, offs, npad = biggest
    G, Q = kargs[1].shape
    shape = dict(G=G, npad=npad, R2=kargs[0].shape[1], Q=Q, W=len(ts), k_s=kargs[4].shape[2])
    bound = fused_walk_bound(kargs, offs)
    timing = dict(ms=None, plain_ms=None)
    if device != "cpu":
        flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=device)  # 256 MB > L2
        timing["ms"] = time_ms(lambda: ops.fused_walk(*kargs, offs=offs), flush=flush)
        timing["plain_ms"] = time_ms(lambda: fused_walk_ref(*kargs, offs=offs), flush=flush)
    say("main-shapes", card=card, packs=len(packs), max_abs_err=worst_abs, max_rel_err=worst_rel,
        regroup_all_packs_s=round(t_group, 4), walk_and_compare_all_packs_s=round(t_kernel, 4),
        timed_shape=json.dumps(shape), **{k: v for k, v in bound.items() if k not in ("bound_ms", "bound_by")})
    return worst_abs, worst_rel, shape, bound, timing


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=float, default=1.0, help="berkeley replica scale (Table 3 = 1.0)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", metavar="PATH", default=None,
                    help="also write a torch.profiler table of one warm query to PATH")
    ap.add_argument("--cpu-rehearsal", action="store_true",
                    help="walk the control flow on the CPU (no card, no result, exit code 3)")
    args = ap.parse_args()
    t_start = time.perf_counter()

    if args.cpu_rehearsal:
        device, card = "cpu", "cpu-rehearsal"
    else:
        if not torch.cuda.is_available():
            print("chip_smoke: no CUDA device available — this script measures on the card only",
                  file=sys.stderr)
            return 2
        device = "cuda"
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip().splitlines()[0]
        card = smi.replace(" ", "_")
        print(smi, flush=True)
        say("device", torch=torch.__version__, cuda=torch.version.cuda,
            kind=torch.cuda.get_device_name(0), count=torch.cuda.device_count())
        from repro_torch.kernels.fused_walk import fused_walk_library

        t1 = time.perf_counter()
        fused_walk_library(verbose=True)  # compiles csrc/fused_walk.cu, prints ptxas -v
        say("build", kernel="fused_walk", seconds=round(time.perf_counter() - t1, 2))

    abs1, rel1 = phase_kernels(device)
    m, ts, launches, secs = phase_main(args, device, card)
    abs2, rel2, shape, bound, timing = phase_main_shapes(m, ts, device, card)

    # `launches` was read right after the main path's queries: the launches
    # made since, to compare the kernel with its plain version, do not count
    if device != "cpu":
        require(launches > 0, "the main path never launched fused_walk")
    kernels = [dict(
        name="fused_walk", route="cuda",
        source="src/repro_torch/kernels/csrc/fused_walk.cu",
        replaces="src/repro/kernels/fused_walk.py:86",
        launches=launches,
        max_abs_err=max(abs1, abs2), max_rel_err=max(rel1, rel2),
        ms=timing["ms"], kernel_ms=timing["ms"], plain_ms=timing["plain_ms"],
        bound_ms=bound["bound_ms"], bound_by=bound["bound_by"],
        library_ms=None,  # no single PyTorch call computes the climb + contraction
        timed_shape=shape, card=card,
        main_path=dict(scale=args.scale, cold_s=secs["cold_s"], warm_s=secs["warm_s"]),
    )]
    say("done", seconds=round(time.perf_counter() - t_start, 1))
    print(json.dumps({"kernels": kernels}), flush=True)
    if args.cpu_rehearsal:
        print(json.dumps({"ok": False, "rehearsal": "cpu"}))
        return 3
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
