#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # needs one CUDA device and nvcc

Builds the hand-written kernels from the sources in this checkout (one
``nvcc`` per source, all started together), holds each against its plain
PyTorch version on the card, then drives the port's two paths at full width
over the Table-3 berkeley replica:

* ``[main]`` a static RFS query, ``TNKDE(solution='rfs', engine='torch',
  executor='fused').query(ts)``, checked against the plain-torch ``packed``
  executor and the index-free SPS oracle;
* ``[drfs]`` the streaming index, ``TNKDE(solution='drfs', engine='torch',
  executor='fused', drfs_depth=8, auto_seal=False, horizon_s=0.9·span)``
  built from the first 90 % of the events: queries in both modes
  (quantized: ``fused_leaf``; exact: ``fused_walk`` on the complete tree),
  a pinned snapshot, two inserts of 5 % each, ``query(at=snapshot)`` and
  ``compact()``, each answer checked against the ``packed`` executor and,
  in exact mode, the SPS oracle over the surviving events.

Any failed check raises (non-zero exit). Without a CUDA device it exits
non-zero and prints no result.

Output, in order: the card's name and power limit as ``nvidia-smi`` gives
them; one line per phase and step (with its time); one JSON line
``{"kernels": [...]}`` with one entry per (kernel, path): launches on that
path, error against the plain version, time, the plain version's time and
the roofline bound at the largest main-path block; and as the last line
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
SPS_EDGES = 32  # most query edges in the SPS sample
SPS_LIXELS = 96  # the sample stops once it holds this many lixels (>= 64 checked)


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


def leaf_case(nleaf, G, Q, W, ks, kt, device):
    """Seeded random inputs for fused_leaf, as the reference's kernel sweep
    builds them: per-edge prefix rows (cumsum over the row axis), leaf
    ranges in [0, nleaf], sides, q_s and the two [W, k_t] temporal tables."""
    rng = np.random.default_rng(nleaf * 100 + Q)
    R = (nleaf + 1) * 2
    tab = np.cumsum(rng.normal(size=(G, R, W * 2 * ks * kt)), axis=1)
    lo = rng.integers(0, nleaf + 1, (G, Q))
    hi = np.maximum(rng.integers(0, nleaf + 1, (G, Q)), lo)
    side = rng.integers(0, 2, (G, Q))
    qs = rng.normal(size=(G, Q, ks))
    qtl, qtr = rng.normal(size=(W, kt)), rng.normal(size=(W, kt))
    t = lambda x, dt: torch.as_tensor(x, device=device).to(dt).contiguous()  # noqa: E731
    return (t(tab, torch.float64), t(lo, torch.int32), t(hi, torch.int32), t(side, torch.int32),
            t(qs, torch.float64), t(qtl, torch.float64), t(qtr, torch.float64))


def compare_fused_leaf(args):
    """(max_abs_err, max_rel_err) of ops.fused_leaf against fused_leaf_ref,
    relative to max|plain|; synchronises so a fault surfaces here."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.fused_walk import fused_leaf_ref

    got = ops.fused_leaf(*args)
    if got.is_cuda:
        torch.cuda.synchronize()
    want = fused_leaf_ref(*args)
    require(got.shape == want.shape and got.dtype == torch.float64, "fused_leaf output shape/dtype")
    require(bool(torch.isfinite(got).all()), "fused_leaf produced non-finite values")
    abs_err = float((got - want).abs().max()) if got.numel() else 0.0
    scale = float(want.abs().max()) if got.numel() else 1.0
    return abs_err, abs_err / (scale or 1.0)


def fused_leaf_bound(args):
    """Least time the card could take for this call, from this input: the
    larger of bytes/bandwidth (each distinct prefix row that a slot with a
    non-empty leaf range needs — an empty range differences a row with
    itself, exactly 0 — plus per-atom state, the two temporal tables and the
    output, each once) and operations/peak f64 (per live slot, window and
    value: the difference, the q_s·q_t product, the multiply and the add)."""
    lcum, lo, hi, side, qs, qtl, qtr = args
    G, R, WK = lcum.shape
    Q, ks = qs.shape[1], qs.shape[2]
    W, kt = qtl.shape
    live = hi > lo
    g = torch.arange(G, device=lcum.device)[:, None] * R
    rows = torch.cat([(g + hi * 2 + side)[live], (g + lo * 2 + side)[live]])
    distinct = int(torch.unique(rows).numel())
    n_live = int(live.sum())
    nbytes = distinct * WK * 8 + G * Q * (ks * 8 + 12) + 2 * W * kt * 8 + G * W * Q * 8
    flops = n_live * WK * 4
    t_b, t_f = nbytes / PEAK_BYTES_PER_S, flops / PEAK_F64_FLOPS
    return dict(bound_ms=max(t_b, t_f) * 1e3, bound_by="bytes" if t_b >= t_f else "operations",
                bytes=nbytes, flops=flops, live_slots=n_live, rows_distinct=distinct)


def phase_leaf_kernels(device):
    """fused_leaf vs its plain version: the reference's sweep (nleaf 4/8/16,
    (k_s, k_t) in {(2,2), (3,2), (2,3)}, Q 7/33/65), one case with the
    gaussian kernels' k_s = k_t = 11 and W > 8 windows a block, and one at
    the main path's shape (nleaf 256, ~4 000 edge groups, Q 512, W 5)."""
    big_g = 4000 if device != "cpu" else 40  # the rehearsal keeps the CPU small
    cases = [
        (4, 3, 7, 1, 2, 2), (8, 3, 33, 2, 3, 2), (16, 3, 65, 2, 2, 3),
        (32, 5, 130, 9, 11, 11),
        (256, big_g, 512, 5, 2, 2),
    ]
    worst_abs = worst_rel = 0.0
    for nleaf, G, Q, W, ks, kt in cases:
        abs_err, rel = compare_fused_leaf(leaf_case(nleaf, G, Q, W, ks, kt, device))
        say("kernels", kernel="fused_leaf", case=f"nleaf{nleaf}:G{G}:Q{Q}:W{W}:ks{ks}:kt{kt}",
            max_abs_err=abs_err, max_rel_err=rel)
        require(rel <= KERNEL_TOL, f"fused_leaf disagrees with its plain version: {rel}")
        worst_abs, worst_rel = max(worst_abs, abs_err), max(worst_rel, rel)
    return worst_abs, worst_rel


# ---------------------------------------------------------------- main path
def sps_sample(m, ts, n_edges, seed, ee=None):
    """The port's SPS oracle on a random sample of query edges, taken until
    it holds ``SPS_LIXELS`` lixels: (lixel ids, F_sps [W, n]) — the
    index-free evaluation of the same KDE over ``ee`` (default: the model's
    own event view)."""
    from repro_torch.core.plan import build_edge_geometry
    from repro_torch.core.shortest_path import bounded_dijkstra
    from repro_torch.core.sps import sps_eval_edge

    net, ctx = m.net, m.ctx
    ee = m.ee if ee is None else ee
    rng = np.random.default_rng(seed)
    radius = ctx.b_s + float(net.edge_len.max()) + 1.0
    ids, vals = [], []
    for a in rng.permutation(net.n_edges)[:n_edges]:
        rows = bounded_dijkstra(net, [net.edge_src[a], net.edge_dst[a]], radius, adj=m._adj)
        geom = build_edge_geometry(net, m.lix, ee, int(a), ctx.b_s, rows)
        n = geom.x.shape[0]
        if n == 0:
            continue
        ids.append(np.arange(geom.lix_base, geom.lix_base + n))
        vals.append(np.stack([sps_eval_edge(geom, ee, ctx, t) for t in ts]))
        if sum(len(i) for i in ids) >= SPS_LIXELS:
            break
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
    t1 = time.perf_counter()
    ids, F_sps = sps_sample(m, ts, SPS_EDGES, args.seed + 7)
    sps_s = time.perf_counter() - t1
    require(len(ids) >= 64, f"SPS sample too small: {len(ids)} lixels")
    err_sps = float(np.abs(F[:, ids] - F_sps).max()) / fmax
    require(err_sps <= SPS_TOL, f"rfs vs sps: {err_sps}")
    say("main", card=card, fused_vs_packed=err_packed, rfs_vs_sps=err_sps, sps_lixels=len(ids),
        sps_s=round(sps_s, 3), packed_cold_s=round(packed_cold_s, 4),
        packed_warm_s=round(packed_warm_s, 4))
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


# ------------------------------------------------------------- DRFS path
DRFS_FRACS = (0.2, 0.5, 0.8, 0.95, 0.5)  # window centres (span fractions), one duplicated


def phase_drfs(args, device, card):
    """The streaming index at full width: build from the first 90 % of the
    events (by time), then in order — both modes cold and warm, pin
    ``snap0``, two inserts of 5 % each (both modes after each),
    ``query(at=snap0)``, ``compact()`` (both modes). Every answer is held
    against the plain-torch ``packed`` engine swapped in on the same model,
    exact answers also against the SPS oracle over the current event set."""
    from repro_torch.core import TNKDE
    from repro_torch.core.events import Events, group_events_by_edge
    from repro_torch.core.rfs import FlatDynamicEngine
    from repro_torch.data.spatial import make_dataset
    from repro_torch.kernels import ops

    def sync():
        if device != "cpu":
            torch.cuda.synchronize()

    t0 = time.perf_counter()
    net, ev, _ = make_dataset("berkeley", scale=args.scale, seed=args.seed)
    order = np.argsort(ev.time, kind="stable")

    def part(lo, hi):
        sel = order[lo:hi]
        return Events(ev.edge_id[sel], ev.pos[sel], ev.time[sel])

    n_base, n_batch = int(0.9 * ev.n), int(0.05 * ev.n)
    t_min = float(ev.time.min())
    span = float(ev.time.max()) - t_min
    ts = [t_min + f * span for f in DRFS_FRACS]
    m = TNKDE(net, part(0, n_base), g=50.0, b_s=800.0, b_t=0.2 * span, solution="drfs",
              engine="torch", executor="fused", drfs_depth=8, auto_seal=False,
              horizon_s=0.9 * span, device=device)
    sync()
    require(m.engine_desc == "torch/fused", m.engine_desc)
    say("drfs", card=card, dataset="berkeley", scale=args.scale, edges=net.n_edges,
        base_events=n_base, batch_events=n_batch, lixels=m.n_lixels, depth=m.index.depth,
        index_bytes=m.index.index_bytes, build_s=round(time.perf_counter() - t0, 3))
    packed = {}  # the plain-torch engine, built once, reused across epochs
    secs = {}

    def run(exact, step, *, at=None):
        """One query in one mode; checks launches, shape, duplicates."""
        m.drfs_exact_leaf = exact
        kern, other = (ops.fused_walk, ops.fused_leaf) if exact else (ops.fused_leaf, ops.fused_walk)
        t1 = time.perf_counter()
        plan = m._host_plan(at if at is not None else m.snapshot())
        plan_s = time.perf_counter() - t1
        l0, o0, f0 = kern.launches, other.launches, m._fe.counters["fused_launches"]
        c0 = dict(m.index.counters)
        t1 = time.perf_counter()
        F = m.query(ts, at=at)
        sync()
        q_s = time.perf_counter() - t1
        nb = plan.n_blocks
        if device != "cpu":
            require(kern.launches - l0 == nb and other.launches == o0,
                    f"{step}: launches {kern.launches - l0}/{other.launches - o0} for {nb} blocks")
        require(m._fe.counters["fused_launches"] - f0 == nb, f"{step}: fused_launches != blocks")
        require(F.shape == (len(ts), m.n_lixels) and F.dtype == np.float64, f"{step}: shape/dtype")
        require(np.isfinite(F).all(), f"{step}: NaN/inf in the heatmap")
        require(float(np.abs(F).max()) > 0.0, f"{step}: the heatmap is all zeros")
        require(np.array_equal(F[1], F[4]), f"{step}: duplicate window centres differ")
        secs[step] = q_s
        say("drfs", step=step, mode="exact" if exact else "quantized", epoch=list(plan.key[0]),
            atoms=plan.n_atoms, blocks=nb, launches=kern.launches - l0, plan_s=round(plan_s, 3),
            flush_s=round(q_s, 4), pending=m.index.n_pending,
            pending_pairs=m.index.counters["pending"] - c0["pending"],
            partial_pairs=m.index.counters["partial"] - c0["partial"])
        return F

    def vs_packed(F, exact, step):
        """The same query through FlatDynamicEngine(executor='packed')."""
        if "fe" not in packed:
            packed["fe"] = FlatDynamicEngine(m.index, executor="packed", device=device)
        fused_fe, cursor = m._fe, dict(m._counter_cursor)
        m._fe, m._counter_cursor = packed["fe"], {}
        m.drfs_exact_leaf = exact
        t1 = time.perf_counter()
        F_p = m.query(ts)
        sync()
        m._fe, m._counter_cursor = fused_fe, cursor
        err = float(np.abs(F - F_p).max()) / float(np.abs(F_p).max())
        require(err <= PACKED_TOL, f"{step}: fused vs packed {err}")
        say("drfs", step=step, mode="exact" if exact else "quantized", fused_vs_packed=err,
            packed_s=round(time.perf_counter() - t1, 4))
        return err

    def vs_sps(F, step):
        """Exact mode against the index-free oracle over the surviving events
        (``m.ee`` holds only counts after an insert)."""
        t1 = time.perf_counter()
        e_, p_, t_ = m.index.snapshot().event_set()
        ee = group_events_by_edge(net, Events(e_, p_, t_))
        ids, F_sps = sps_sample(m, ts, SPS_EDGES, args.seed + 11, ee=ee)
        require(len(ids) >= 64, f"SPS sample too small: {len(ids)} lixels")
        err = float(np.abs(F[:, ids] - F_sps).max()) / float(np.abs(F).max())
        require(err <= SPS_TOL, f"{step}: drfs exact vs sps {err}")
        say("drfs", step=step, exact_vs_sps=err, sps_lixels=len(ids), events=len(t_),
            sps_s=round(time.perf_counter() - t1, 3))
        return err

    errs = dict(packed=0.0, sps=0.0)

    def check(Fq, Fx, step):
        errs["packed"] = max(errs["packed"], vs_packed(Fq, False, step), vs_packed(Fx, True, step))
        errs["sps"] = max(errs["sps"], vs_sps(Fx, step))

    # ---- the main path: counts set to 0 here, read at the end of the phase
    ops.fused_walk.launches = ops.fused_leaf.launches = 0
    Fq = run(False, "quantized-cold")
    require(np.array_equal(run(False, "quantized-warm"), Fq), "quantized: warm != cold")
    Fx = run(True, "exact-cold")
    require(np.array_equal(run(True, "exact-warm"), Fx), "exact: warm != cold")
    check(Fq, Fx, "base")
    snap0, F_snap0 = m.snapshot(), Fx
    for b in range(2):
        t1 = time.perf_counter()
        m.insert(part(n_base + b * n_batch, n_base + (b + 1) * n_batch))
        say("drfs", step=f"insert{b + 1}", events=n_batch, pending=m.index.n_pending,
            epoch=list(m.epoch), insert_s=round(time.perf_counter() - t1, 3))
        require(m.index.n_pending == (b + 1) * n_batch, "insert did not stay pending")
        Fq, Fx = run(False, f"quantized-insert{b + 1}"), run(True, f"exact-insert{b + 1}")
        check(Fq, Fx, f"insert{b + 1}")
    F_at = run(True, "exact-at-snap0", at=snap0)
    require(np.array_equal(F_at, F_snap0), "query(at=snap0) differs from the pre-insert answer")
    t1 = time.perf_counter()
    out = m.compact()
    sync()
    compact_s = time.perf_counter() - t1
    require(out["evicted"] > 0 and out["sealed"] > 0, f"compact() did nothing: {out}")
    say("drfs", step="compact", card=card, evicted=out["evicted"], sealed=out["sealed"],
        epoch=list(m.epoch), device_bytes=m._fe.device_bytes, compact_s=round(compact_s, 3))
    Fq, Fx = run(False, "quantized-compacted"), run(True, "exact-compacted")
    check(Fq, Fx, "compacted")
    launches = dict(fused_leaf=ops.fused_leaf.launches, fused_walk=ops.fused_walk.launches)
    if device != "cpu":
        require(min(launches.values()) > 0, f"the DRFS path never launched a kernel: {launches}")
    say("drfs", card=card, launches=json.dumps(launches), fused_vs_packed=errs["packed"],
        exact_vs_sps=errs["sps"], device_bytes=m._fe.device_bytes,
        warm_quantized_s=round(secs["quantized-warm"], 4), warm_exact_s=round(secs["exact-warm"], 4))
    if args.profile:
        for exact, tag in ((False, "quantized"), (True, "exact")):
            m.drfs_exact_leaf = exact
            profile_warm(m, ts, f"{args.profile}.drfs-{tag}")
    return m, ts, launches, secs


def phase_drfs_shapes(m, ts, device, card):
    """Both DRFS kernels at the shapes the main path gave them: every atom
    block of the last epoch's plan, in both modes, against the plain
    version; the largest block of each kernel is timed."""
    from repro_torch.core.rfs import _dyn_group, dyn_kernel_call
    from repro_torch.kernels import ops
    from repro_torch.kernels.fused_walk import fused_leaf_ref, fused_walk_ref

    fe = m._fe
    snap = m.snapshot()
    sealed, pend = fe._get_sealed(snap), fe._get_pending(snap)
    forest = fe._forest(sealed, pend)
    wb = fe.window_batch(m.ctx, ts)
    hq = snap.depth
    packs = fe._atom_packs(m._host_plan(snap))
    flush = None
    if device != "cpu":
        flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=device)  # 256 MB > L2
    result = {}
    for exact, name, ref in ((False, "fused_leaf", fused_leaf_ref), (True, "fused_walk", fused_walk_ref)):
        tables = fe.window_tables(wb, tuple(ts), snap, sealed, hq, exact)
        worst_abs = worst_rel = 0.0
        biggest, big_n = None, -1
        for entry in packs:
            grouped = _dyn_group(tables, entry["edges"], hq=hq, exact=exact, E=m.net.n_edges)
            _, kargs, kw = dyn_kernel_call(forest, grouped, entry, wb, hq=hq, exact=exact)
            got = getattr(ops, name)(*kargs, **kw)
            if device != "cpu":
                torch.cuda.synchronize()
            want = ref(*kargs, **kw)
            require(bool(torch.isfinite(got).all()), f"{name}: non-finite values")
            abs_err = float((got - want).abs().max())
            rel = abs_err / (float(want.abs().max()) or 1.0)
            require(rel <= KERNEL_TOL, f"{name} vs plain on a DRFS block: {rel}")
            worst_abs, worst_rel = max(worst_abs, abs_err), max(worst_rel, rel)
            if kargs[1].numel() > big_n:
                biggest, big_n = (kargs, kw), kargs[1].numel()
            del grouped, got, want
        kargs, kw = biggest
        G, Q = kargs[1].shape
        shape = dict(G=G, R=kargs[0].shape[1], Q=Q, W=len(ts), k_s=kargs[4].shape[2],
                     k_t=int(m.ctx.k_t), hq=hq)
        bound = fused_walk_bound(kargs, kw["offs"]) if exact else fused_leaf_bound(kargs)
        timing = dict(ms=None, plain_ms=None)
        if device != "cpu":
            fn = getattr(ops, name)
            timing["ms"] = time_ms(lambda: fn(*kargs, **kw), flush=flush)
            timing["plain_ms"] = time_ms(lambda: ref(*kargs, **kw), flush=flush)
        say("drfs-shapes", card=card, kernel=name, mode="exact" if exact else "quantized",
            blocks=len(packs), max_abs_err=worst_abs, max_rel_err=worst_rel,
            timed_shape=json.dumps(shape), ms=timing["ms"], plain_ms=timing["plain_ms"],
            bound_ms=bound["bound_ms"], bound_by=bound["bound_by"],
            **{k: v for k, v in bound.items() if k not in ("bound_ms", "bound_by")})
        result[name] = (worst_abs, worst_rel, shape, bound, timing)
        del biggest, kargs, tables
    return result


def build_kernels():
    """Compile every kernel source, one nvcc each, all started together."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels.fused_walk import fused_leaf_library, fused_walk_library

    builders = dict(fused_walk=fused_walk_library, fused_leaf=fused_leaf_library)
    t1 = time.perf_counter()
    with ThreadPoolExecutor(len(builders)) as pool:  # nvcc runs outside the GIL
        futures = [pool.submit(b, verbose=True) for b in builders.values()]
        for f in futures:
            f.result()  # prints ptxas -v; a failed build raises here
    say("build", kernels=",".join(builders), seconds=round(time.perf_counter() - t1, 2))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=float, default=1.0, help="berkeley replica scale (Table 3 = 1.0)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", metavar="PATH", default=None,
                    help="also write torch.profiler tables of warm queries: the RFS one to PATH, "
                         "the DRFS ones to PATH.drfs-quantized / PATH.drfs-exact")
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
        build_kernels()

    t1 = time.perf_counter()
    abs1, rel1 = phase_kernels(device)
    labs, lrel = phase_leaf_kernels(device)
    say("kernels", seconds=round(time.perf_counter() - t1, 1))
    t1 = time.perf_counter()
    m, ts, launches, secs = phase_main(args, device, card)
    abs2, rel2, shape, bound, timing = phase_main_shapes(m, ts, device, card)
    del m
    say("main", seconds=round(time.perf_counter() - t1, 1))
    t1 = time.perf_counter()
    dm, dts, dlaunches, dsecs = phase_drfs(args, device, card)
    say("drfs", seconds=round(time.perf_counter() - t1, 1))
    t1 = time.perf_counter()
    dshapes = phase_drfs_shapes(dm, dts, device, card)
    say("drfs-shapes", seconds=round(time.perf_counter() - t1, 1))

    # each path's launches were read right after that path's queries: the
    # launches made since, to compare a kernel with its plain version, do
    # not count
    if device != "cpu":
        require(launches > 0, "the main path never launched fused_walk")

    def entry(name, path, n, err_abs, err_rel, shp, bnd, tm, replaces, **extra):
        return dict(
            name=name, route="cuda", path=path,
            source=f"src/repro_torch/kernels/csrc/{name}.cu", replaces=replaces,
            launches=n, max_abs_err=err_abs, max_rel_err=err_rel,
            ms=tm["ms"], plain_ms=tm["plain_ms"], bound_ms=bnd["bound_ms"], bound_by=bnd["bound_by"],
            library_ms=None,  # no single PyTorch call computes either function
            timed_shape=shp, card=card, **extra,
        )

    la, lr, lshape, lbound, ltiming = dshapes["fused_leaf"]
    wa, wr, wshape, wbound, wtiming = dshapes["fused_walk"]
    kernels = [
        entry("fused_walk", "rfs", launches, max(abs1, abs2), max(rel1, rel2), shape, bound,
              timing, "src/repro/kernels/fused_walk.py:86",
              main_path=dict(scale=args.scale, cold_s=secs["cold_s"], warm_s=secs["warm_s"])),
        entry("fused_walk", "drfs-exact", dlaunches["fused_walk"], max(abs1, wa), max(rel1, wr),
              wshape, wbound, wtiming, "src/repro/kernels/fused_walk.py:86",
              main_path=dict(scale=args.scale, warm_s=dsecs["exact-warm"])),
        entry("fused_leaf", "drfs-quantized", dlaunches["fused_leaf"], max(labs, la), max(lrel, lr),
              lshape, lbound, ltiming, "src/repro/kernels/fused_walk.py:177",
              main_path=dict(scale=args.scale, warm_s=dsecs["quantized-warm"])),
    ]
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
