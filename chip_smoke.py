#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # needs one CUDA device and nvcc

Builds the hand-written kernels from the sources in this checkout (one
``nvcc`` per source, all started together), holds each against its plain
PyTorch version on the card, then drives the port's paths at full width
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
  in exact mode, the SPS oracle over the surviving events;
* ``[kernel]`` the per-bucket-search tier, ``executor='kernel'``: static RFS
  through ``tree_query`` (after ``[main]``'s model is freed; held against
  ``[main]``'s answer), then the streaming index (first 90 %, one insert of
  5 %) in both modes through ``dyn_leaf_query`` (quantized) and
  ``dyn_node_walk`` (exact), each answer held against the ``fused``
  executor at the same snapshot and, in exact mode, the SPS oracle.

Each path's launch counts are set to 0 just before it runs and read just
after; ``[*-shapes]`` then holds every block the path gave a kernel against
its plain version and times the largest.

Any failed check raises (non-zero exit). Without a CUDA device it exits
non-zero and prints no result.

Output, in order: the card's name and power limit as ``nvidia-smi`` gives
them; one line per phase and step (with its time); one JSON line
``{"kernels": [...]}`` with one entry per (kernel, path): launches on that
path, error against the plain version, time, the plain version's time and
the roofline bound at the largest block of that path; and as the last line
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

KERNEL_TOL = 1e-13  # f64, kernel vs its plain version; only association and FMA differ
KERNELS = ("fused_walk", "fused_leaf", "tree_query", "dyn_leaf_query", "dyn_node_walk")
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
        from repro_torch.kernels.dyn_query import tree_offs

        offs = tree_offs(n)
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


def plain_version(name):
    """The plain PyTorch version of ``ops.<name>``."""
    from repro_torch.kernels import dyn_query, fused_walk, tree_query

    return dict(fused_walk=fused_walk.fused_walk_ref, fused_leaf=fused_walk.fused_leaf_ref,
                tree_query=tree_query.tree_query_ref,
                dyn_leaf_query=dyn_query.dyn_leaf_query_ref,
                dyn_node_walk=dyn_query.dyn_node_walk_ref)[name]


def compare(name, args, **kw):
    """(max_abs_err, max_rel_err) of ops.<name> against its plain version,
    relative to max|plain|; synchronises so a fault surfaces here."""
    from repro_torch.kernels import ops

    got = getattr(ops, name)(*args, **kw)
    if got.is_cuda:
        torch.cuda.synchronize()
    want = plain_version(name)(*args, **kw)
    require(got.shape == want.shape and got.dtype == torch.float64, f"{name} output shape/dtype")
    require(bool(torch.isfinite(got).all()), f"{name} produced non-finite values")
    abs_err = float((got - want).abs().max()) if got.numel() else 0.0
    scale = float(want.abs().max()) if got.numel() else 1.0
    return abs_err, abs_err / (scale or 1.0)


def reset_launches():
    from repro_torch.kernels import ops

    for name in KERNELS:
        getattr(ops, name).launches = 0


def read_launches():
    from repro_torch.kernels import ops

    return {name: getattr(ops, name).launches for name in KERNELS}


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
        abs_err, rel = compare("fused_walk", args, offs=offs)
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
        abs_err, rel = compare("fused_leaf", leaf_case(nleaf, G, Q, W, ks, kt, device))
        say("kernels", kernel="fused_leaf", case=f"nleaf{nleaf}:G{G}:Q{Q}:W{W}:ks{ks}:kt{kt}",
            max_abs_err=abs_err, max_rel_err=rel)
        require(rel <= KERNEL_TOL, f"fused_leaf disagrees with its plain version: {rel}")
        worst_abs, worst_rel = max(worst_abs, abs_err), max(worst_rel, rel)
    return worst_abs, worst_rel


def tree_case(n_events, G, Q, Wh, K4, device, empty_group=None):
    """Seeded random inputs for tree_query, built as the reference's kernel
    tests build them: per group a time-major merge tree over ``n_events``
    events (level ℓ buckets 2^ℓ consecutive time ranks, position-sorted
    inside with +inf padding at the end, inclusive prefix moments), rank
    intervals, position bounds (every fifth slot a padding slot that selects
    nothing) and query vectors. ``empty_group`` holds no events."""
    from repro_torch.core.aggregation import next_pow2, segmented_cumsum

    rng = np.random.default_rng(n_events * 31 + Q)
    npad = next_pow2(n_events)
    lvl = npad.bit_length()
    pos = np.full((G, lvl, npad), np.inf)
    cum = np.zeros((G, lvl, npad, K4))
    ranks = np.arange(npad)
    for g in range(G):
        n = 0 if g == empty_group else n_events
        pp = np.full(npad, np.inf)
        pp[:n] = rng.uniform(0, 100, n)
        ff = np.zeros((npad, K4))
        ff[:n] = rng.normal(size=(n, K4))
        for lev in range(lvl):
            order = np.lexsort((pp, ranks >> lev))
            pos[g, lev] = pp[order]
            cum[g, lev] = segmented_cumsum(ff[order], np.arange(0, npad + 1, 1 << lev))
    r_lo = rng.integers(0, n_events, (G, Wh, Q))
    r_hi = np.maximum(rng.integers(0, n_events + 1, (G, Wh, Q)), r_lo)
    ph, pl1, pl2 = rng.uniform(0, 110, (G, Q)), rng.uniform(-10, 100, (G, Q)), rng.uniform(-10, 60, (G, Q))
    ph[:, ::5], pl1[:, ::5], pl2[:, ::5] = -np.inf, np.inf, np.inf
    l1r = rng.random((G, Q)) < 0.5
    qv = rng.normal(size=(G, Wh, Q, K4))
    t = lambda x, dt: torch.as_tensor(x, device=device).to(dt).contiguous()  # noqa: E731
    f, i = torch.float64, torch.int32
    return (t(pos, f), t(cum, f), t(r_lo, i), t(r_hi, i), t(ph, f), t(pl1, f), t(l1r, i), t(pl2, f),
            t(qv, f))


def tree_query_bound(args):
    """Least time the card could take for this call, from this input: the
    larger of bytes/bandwidth and operations/peak f64. Bytes: each distinct
    prefix row a non-empty bucket interval needs, the query row of every
    (slot, half-window) with such a bucket, rank intervals, position bounds
    and the output, each once (the position entries the searches probe are
    left out: a lower bound). Operations: per non-empty bucket, the
    difference, product and sum of every prefix value (3·K4)."""
    from repro_torch.kernels.tree_query import tree_buckets

    pos, cum, r_lo, r_hi, ph, pl1, l1r, pl2, qv = args
    G, LVL, NPAD = pos.shape
    K4 = cum.shape[-1]
    live = torch.zeros(r_lo.numel(), dtype=torch.bool, device=pos.device)
    rows, emitted, busy = [], 0, 0
    for lev, lane, g, seg_lo, i_lo, i_hi in tree_buckets(pos, r_lo, r_hi, ph, pl1, l1r, pl2):
        emitted += int(lane.numel())
        on = i_hi > i_lo
        busy += int(on.sum())
        live[lane[on]] = True
        base = (g * LVL + lev) * NPAD - 1
        rows += [(base + i_hi)[on], (base + i_lo)[on & (i_lo > seg_lo)]]
    distinct = int(torch.unique(torch.cat(rows)).numel()) if rows else 0
    n_live = int(live.sum())
    nbytes = ((distinct + n_live) * K4 * 8 + r_lo.numel() * (4 + 4 + 8)
              + G * r_lo.shape[2] * (3 * 8 + 4))
    flops = busy * 3 * K4
    t_b, t_f = nbytes / PEAK_BYTES_PER_S, flops / PEAK_F64_FLOPS
    return dict(bound_ms=max(t_b, t_f) * 1e3, bound_by="bytes" if t_b >= t_f else "operations",
                bytes=nbytes, flops=flops, buckets_emitted=emitted, buckets_nonempty=busy,
                rows_distinct=distinct, live_lanes=n_live)


def dyn_leaf_query_bound(args):
    """Least time the card could take for this call, from this input: the
    larger of bytes/bandwidth (each distinct prefix row a slot with a
    non-empty leaf range needs, the two query rows of every such (slot,
    window), per-slot state and the output, each once) and operations/peak
    f64 (per live slot, window and prefix value: difference, product, sum)."""
    tab, lo, hi, side, qv_l, qv_r = args
    G, R, WK = tab.shape
    W, Q, K = qv_l.shape[1], qv_l.shape[2], qv_l.shape[3]
    live = hi > lo
    g = torch.arange(G, device=tab.device)[:, None] * R
    rows = torch.cat([(g + hi * 2 + side)[live], (g + lo * 2 + side)[live]])
    distinct = int(torch.unique(rows).numel())
    n_live = int(live.sum())
    nbytes = distinct * WK * 8 + n_live * W * 2 * K * 8 + G * Q * 12 + G * W * Q * 8
    flops = n_live * WK * 3
    t_b, t_f = nbytes / PEAK_BYTES_PER_S, flops / PEAK_F64_FLOPS
    return dict(bound_ms=max(t_b, t_f) * 1e3, bound_by="bytes" if t_b >= t_f else "operations",
                bytes=nbytes, flops=flops, live_slots=n_live, rows_distinct=distinct)


def phase_kernel_kernels(device):
    """The three kernels of executor='kernel' against their plain versions
    on seeded sweeps: tree_query at npad 8/32/512 with ragged Q, W in {1, 5}
    (2 or 10 half-windows), one group of all-+inf padding and the 4·k_s·k_t
    = 484 query width of the gaussian kernels; dyn_leaf_query over the
    reference's sweep, K = 121 (gaussian) and the main path's shape;
    dyn_node_walk at hq 2/3/4 and 8. Returns the worst (abs, rel) error per
    kernel."""
    small = device == "cpu"  # the rehearsal keeps the CPU small
    worst = {}

    def check(name, case, args, **kw):
        abs_err, rel = compare(name, args, **kw)
        say("kernel-kernels", kernel=name, case=case, max_abs_err=abs_err, max_rel_err=rel)
        require(rel <= KERNEL_TOL, f"{name} disagrees with its plain version: {rel}")
        a, r = worst.get(name, (0.0, 0.0))
        worst[name] = (max(a, abs_err), max(r, rel))

    for n_events, G, Q, Wh, K4, empty in [
        (7, 3, 33, 2, 16, None), (30, 5, 130, 10, 16, 2), (21, 3, 65, 10, 484, None),
        (500, 4 if small else 64, 200 if small else 1000, 10, 16, None),
    ]:
        check("tree_query", f"npad{1 << (n_events - 1).bit_length()}:G{G}:Q{Q}:Wh{Wh}:K4{K4}",
              tree_case(n_events, G, Q, Wh, K4, device, empty))
    big_g = 40 if small else 4000
    for nleaf, G, Q, W, ks, kt in [
        (4, 3, 7, 1, 2, 1), (8, 3, 33, 3, 2, 2), (16, 3, 65, 2, 3, 1),
        (32, 5, 130, 9, 11, 11), (256, big_g, 512, 5, 2, 2),
    ]:
        tab, lo, hi, side, qs, qtl, qtr = leaf_case(nleaf, G, Q, W, ks, kt, device)
        rng = np.random.default_rng(nleaf + Q)
        qv = [torch.as_tensor(rng.normal(size=(G, W, Q, ks * kt)), device=device) for _ in range(2)]
        check("dyn_leaf_query", f"nleaf{nleaf}:G{G}:Q{Q}:W{W}:K{ks * kt}",
              (tab, lo, hi, side, *qv))
    for hq, G, Q, W, ks in [(2, 3, 7, 1, 2), (3, 3, 33, 2, 3), (4, 3, 65, 2, 2),
                            (8, 40 if small else 2000, 512, 5, 2)]:
        args, _ = layout_case(f"tree{hq}", G, Q, W, ks, device)
        check("dyn_node_walk", f"tree{hq}:G{G}:Q{Q}:W{W}:ks{ks}", args, hq=hq)
    return worst


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
        if m._fe.device.type == "cuda":
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
    reset_launches()
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
    counts = read_launches()
    launches = counts.pop("fused_walk")
    warm_searches = m.stats.n_rank_searches - s0
    require(not any(counts.values()), f"[main] launched another kernel: {counts}")

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
    return m, ts, F, launches, dict(cold_s=cold_s, warm_s=warm_s)


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
        abs_err, rel = compare("fused_walk", kargs, offs=entry["offs"])  # syncs after the kernel
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


# ------------------------------------------------ kernel tier, static RFS
def phase_rfs_kernel(args, device, card, ts, F_main):
    """``TNKDE(solution='rfs', executor='kernel')`` at full width, cold then
    warm, once ``[main]``'s model is freed: one ``tree_query`` launch per
    kernel entry per query and nothing else launched, warm == cold and
    duplicate centres bitwise, the answer within PACKED_TOL of ``[main]``'s
    (the fused executor, itself held against packed and SPS)."""
    from repro_torch.core import TNKDE
    from repro_torch.data.spatial import make_dataset

    def sync():
        if device != "cpu":
            torch.cuda.synchronize()

    t0 = time.perf_counter()
    net, ev, _ = make_dataset("berkeley", scale=args.scale, seed=args.seed)
    span = float(ev.time.max() - ev.time.min())
    if device != "cpu":
        torch.cuda.reset_peak_memory_stats()
    m = TNKDE(net, ev, g=50.0, b_s=800.0, b_t=0.2 * span, solution="rfs",
              engine="torch", executor="kernel", device=device)
    require(m.engine_desc == "torch/kernel", m.engine_desc)
    say("kernel", path="rfs", edges=net.n_edges, events=ev.n, lixels=m.n_lixels,
        build_s=round(time.perf_counter() - t0, 3))

    # ---- the path: counts set to 0 here, read right after the warm query
    reset_launches()
    t1 = time.perf_counter()
    F_cold = m.query(ts)
    sync()
    cold_s = time.perf_counter() - t1
    cold_counts = read_launches()
    s0 = m.stats.n_rank_searches
    t1 = time.perf_counter()
    F = m.query(ts)
    sync()
    warm_s = time.perf_counter() - t1
    counts = read_launches()
    launches = counts.pop("tree_query")
    require(not any(counts.values()), f"[kernel] rfs launched another kernel: {counts}")

    entries = m._fe._pack_cache.get(((m.epoch, m.ls), "kernel"))
    n = len(entries)
    require(n > 0, "the plan has no kernel entries")
    if device != "cpu":
        require(cold_counts["tree_query"] == n and launches == 2 * n,
                f"tree_query launches {cold_counts['tree_query']}/{launches} for {n} entries")
    require(m._fe.counters["fused_launches"] == 0, "the kernel executor counted fused launches")
    require(m.stats.n_rank_searches == s0, "warm query searched again")
    require(F.shape == F_main.shape and F.dtype == np.float64, "heatmap shape/dtype")
    require(np.isfinite(F).all(), "NaN/inf in the heatmap")
    require(np.array_equal(F, F_cold), "kernel: warm query differs from the cold one")
    require(np.array_equal(F[1], F[4]), "kernel: duplicate window centres are not bitwise identical")
    fmax = float(np.abs(F_main).max())
    err = float(np.abs(F - F_main).max()) / fmax
    require(err <= PACKED_TOL, f"kernel vs fused: {err}")
    peak = torch.cuda.max_memory_allocated() if device != "cpu" else None
    if args.profile:
        profile_warm(m, ts, f"{args.profile}.kernel-rfs")
    table_bytes = sum(e["pos"].numel() * 8 + e["cum"].numel() * 8 for e in entries)
    say("kernel", path="rfs", card=card, engine=m.engine_desc, atoms=m._host_plan().n_atoms,
        entries=n, padded_slots=sum(e["side"].numel() for e in entries), launches=launches,
        kernel_vs_fused=err, device_bytes=m._fe.device_bytes, entry_table_bytes=table_bytes,
        max_memory_allocated=peak, cold_s=round(cold_s, 4), warm_s=round(warm_s, 4))
    return m, launches, dict(cold_s=cold_s, warm_s=warm_s, err=err)


def phase_rfs_kernel_shapes(m, ts, device, card):
    """tree_query at the shapes the path gave it: every kernel entry is held
    against the plain version; the largest (by slots × half-windows) is
    timed, with its bound."""
    from repro_torch.core.rfs import tree_query_args
    from repro_torch.kernels import ops
    from repro_torch.kernels.tree_query import tree_query_ref

    fe = m._fe
    entries = fe._pack_cache.get(((m.epoch, m.ls), "kernel"))
    wb = fe.window_batch(m.ctx, ts)
    ranks = fe.window_tables(wb, tuple(ts))
    worst_abs = worst_rel = 0.0
    big, big_n = None, -1
    t1 = time.perf_counter()
    for i, entry in enumerate(entries):
        kargs = tree_query_args(ranks, entry, wb)
        abs_err, rel = compare("tree_query", kargs)
        require(rel <= KERNEL_TOL, f"tree_query vs plain at entry {i}: {rel}")
        worst_abs, worst_rel = max(worst_abs, abs_err), max(worst_rel, rel)
        if kargs[2].numel() > big_n:
            big, big_n = i, kargs[2].numel()
        del kargs
    compare_s = time.perf_counter() - t1
    kargs = tree_query_args(ranks, entries[big], wb)
    G, LVL, NPAD = kargs[0].shape
    shape = dict(G=G, LVL=LVL, NPAD=NPAD, Wh=kargs[2].shape[1], Q=kargs[2].shape[2],
                 K4=kargs[1].shape[-1])
    bound = tree_query_bound(kargs)
    timing = dict(ms=None, plain_ms=None)
    if device != "cpu":
        flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=device)  # 256 MB > L2
        timing["ms"] = time_ms(lambda: ops.tree_query(*kargs), flush=flush)
        timing["plain_ms"] = time_ms(lambda: tree_query_ref(*kargs), flush=flush)
    say("kernel-shapes", path="rfs", card=card, kernel="tree_query", entries=len(entries),
        max_abs_err=worst_abs, max_rel_err=worst_rel, compare_all_entries_s=round(compare_s, 3),
        timed_shape=json.dumps(shape), ms=timing["ms"], plain_ms=timing["plain_ms"],
        **bound)
    return worst_abs, worst_rel, shape, bound, timing


# ------------------------------------------------------------- DRFS path
DRFS_FRACS = (0.2, 0.5, 0.8, 0.95, 0.5)  # window centres (span fractions), one duplicated


# the kernel each DRFS executor launches per block: (quantized, exact)
DRFS_KERNELS = dict(fused=("fused_leaf", "fused_walk"), kernel=("dyn_leaf_query", "dyn_node_walk"))


def phase_drfs(args, device, card, *, executor="fused", versus="packed", inserts=2,
               compact=True, tag="drfs"):
    """The streaming index at full width: build from the first 90 % of the
    events (by time), then in order — both modes cold and warm, pin
    ``snap0``, ``inserts`` inserts of 5 % each (both modes after each) and,
    with ``compact``, ``query(at=snap0)`` and ``compact()`` (both modes).
    Every answer is held against the ``versus`` engine swapped in on the
    same model at the same snapshot, exact answers also against the SPS
    oracle over the current event set. The launch counts are set to 0 before
    the first query and each query's own launches are summed: the
    comparisons in between launch other kernels, which are not counted."""
    from repro_torch.core import TNKDE
    from repro_torch.core.events import Events, group_events_by_edge
    from repro_torch.core.rfs import FlatDynamicEngine
    from repro_torch.data.spatial import make_dataset

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
    if device != "cpu":
        torch.cuda.reset_peak_memory_stats()
    m = TNKDE(net, part(0, n_base), g=50.0, b_s=800.0, b_t=0.2 * span, solution="drfs",
              engine="torch", executor=executor, drfs_depth=8, auto_seal=False,
              horizon_s=0.9 * span, device=device)
    sync()
    require(m.engine_desc == f"torch/{executor}", m.engine_desc)
    say(tag, card=card, dataset="berkeley", scale=args.scale, edges=net.n_edges,
        base_events=n_base, batch_events=n_batch, lixels=m.n_lixels, depth=m.index.depth,
        index_bytes=m.index.index_bytes, build_s=round(time.perf_counter() - t0, 3))
    other_fe = {}  # the comparison engine, built once, reused across epochs
    secs = {}
    launches = dict.fromkeys(KERNELS, 0)

    def run(exact, step, *, at=None):
        """One query in one mode; checks launches, shape, duplicates."""
        m.drfs_exact_leaf = exact
        kern = DRFS_KERNELS[executor][int(exact)]
        t1 = time.perf_counter()
        plan = m._host_plan(at if at is not None else m.snapshot())
        plan_s = time.perf_counter() - t1
        l0, f0 = read_launches(), m._fe.counters["fused_launches"]
        c0 = dict(m.index.counters)
        t1 = time.perf_counter()
        F = m.query(ts, at=at)
        sync()
        q_s = time.perf_counter() - t1
        grew = {k: v - l0[k] for k, v in read_launches().items()}
        for k, v in grew.items():
            launches[k] += v
        nb = plan.n_blocks
        if device != "cpu":
            require(grew[kern] == nb and sum(grew.values()) == nb,
                    f"{step}: launches {grew} for {nb} blocks of {kern}")
        require(m._fe.counters["fused_launches"] - f0 == (nb if executor == "fused" else 0),
                f"{step}: fused_launches")
        require(F.shape == (len(ts), m.n_lixels) and F.dtype == np.float64, f"{step}: shape/dtype")
        require(np.isfinite(F).all(), f"{step}: NaN/inf in the heatmap")
        require(float(np.abs(F).max()) > 0.0, f"{step}: the heatmap is all zeros")
        require(np.array_equal(F[1], F[4]), f"{step}: duplicate window centres differ")
        secs[step] = q_s
        say(tag, step=step, mode="exact" if exact else "quantized", epoch=list(plan.key[0]),
            atoms=plan.n_atoms, blocks=nb, launches=grew[kern], plan_s=round(plan_s, 3),
            flush_s=round(q_s, 4), pending=m.index.n_pending,
            pending_pairs=m.index.counters["pending"] - c0["pending"],
            partial_pairs=m.index.counters["partial"] - c0["partial"])
        return F

    def vs_other(F, exact, step):
        """The same query through FlatDynamicEngine(executor=versus)."""
        if "fe" not in other_fe:
            other_fe["fe"] = FlatDynamicEngine(m.index, executor=versus, device=device)
        own_fe, cursor = m._fe, dict(m._counter_cursor)
        m._fe, m._counter_cursor = other_fe["fe"], {}
        m.drfs_exact_leaf = exact
        t1 = time.perf_counter()
        F_o = m.query(ts)
        sync()
        m._fe, m._counter_cursor = own_fe, cursor
        err = float(np.abs(F - F_o).max()) / float(np.abs(F_o).max())
        require(err <= PACKED_TOL, f"{step}: {executor} vs {versus} {err}")
        say(tag, step=step, mode="exact" if exact else "quantized",
            **{f"{executor}_vs_{versus}": err, f"{versus}_s": round(time.perf_counter() - t1, 4)})
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
        say(tag, step=step, exact_vs_sps=err, sps_lixels=len(ids), events=len(t_),
            sps_s=round(time.perf_counter() - t1, 3))
        return err

    errs = dict(versus=0.0, sps=0.0)

    def check(Fq, Fx, step):
        errs["versus"] = max(errs["versus"], vs_other(Fq, False, step), vs_other(Fx, True, step))
        errs["sps"] = max(errs["sps"], vs_sps(Fx, step))

    # ---- the path: counts set to 0 here; each query's own launches summed
    reset_launches()
    Fq = run(False, "quantized-cold")
    require(np.array_equal(run(False, "quantized-warm"), Fq), "quantized: warm != cold")
    Fx = run(True, "exact-cold")
    require(np.array_equal(run(True, "exact-warm"), Fx), "exact: warm != cold")
    check(Fq, Fx, "base")
    if args.profile:  # warm queries of the base epoch, no pending events
        for exact, mode in ((False, "quantized"), (True, "exact")):
            m.drfs_exact_leaf = exact
            profile_warm(m, ts, f"{args.profile}.{tag}-{mode}")
    snap0, F_snap0 = m.snapshot(), Fx
    for b in range(inserts):
        t1 = time.perf_counter()
        m.insert(part(n_base + b * n_batch, n_base + (b + 1) * n_batch))
        say(tag, step=f"insert{b + 1}", events=n_batch, pending=m.index.n_pending,
            epoch=list(m.epoch), insert_s=round(time.perf_counter() - t1, 3))
        require(m.index.n_pending == (b + 1) * n_batch, "insert did not stay pending")
        Fq, Fx = run(False, f"quantized-insert{b + 1}"), run(True, f"exact-insert{b + 1}")
        check(Fq, Fx, f"insert{b + 1}")
    if compact:
        F_at = run(True, "exact-at-snap0", at=snap0)
        require(np.array_equal(F_at, F_snap0), "query(at=snap0) differs from the pre-insert answer")
        t1 = time.perf_counter()
        out = m.compact()
        sync()
        compact_s = time.perf_counter() - t1
        require(out["evicted"] > 0 and out["sealed"] > 0, f"compact() did nothing: {out}")
        say(tag, step="compact", card=card, evicted=out["evicted"], sealed=out["sealed"],
            epoch=list(m.epoch), device_bytes=m._fe.device_bytes, compact_s=round(compact_s, 3))
        Fq, Fx = run(False, "quantized-compacted"), run(True, "exact-compacted")
        check(Fq, Fx, "compacted")
    mine = {k: launches[k] for k in DRFS_KERNELS[executor]}
    require(sum(launches.values()) == sum(mine.values()), f"{tag}: other kernels launched: {launches}")
    if device != "cpu":
        require(min(mine.values()) > 0, f"the {tag} path never launched a kernel: {mine}")
    peak = torch.cuda.max_memory_allocated() if device != "cpu" else None
    say(tag, card=card, launches=json.dumps(mine), **{f"{executor}_vs_{versus}": errs["versus"]},
        exact_vs_sps=errs["sps"], device_bytes=m._fe.device_bytes, max_memory_allocated=peak,
        warm_quantized_s=round(secs["quantized-warm"], 4), warm_exact_s=round(secs["exact-warm"], 4))
    return m, ts, mine, secs


def phase_drfs_shapes(m, ts, device, card, *, executor="fused", tag="drfs-shapes"):
    """Both DRFS kernels of the executor at the shapes the path gave them:
    every atom block of the last epoch's plan, in both modes, against the
    plain version; the largest block of each kernel is timed."""
    from repro_torch.core.rfs import _dyn_group, dyn_kernel_call
    from repro_torch.kernels import ops
    from repro_torch.kernels.dyn_query import tree_offs

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
    for exact, name in enumerate(DRFS_KERNELS[executor]):
        tables = fe.window_tables(wb, tuple(ts), snap, sealed, hq, bool(exact))
        worst_abs = worst_rel = 0.0
        biggest, big_n = None, -1
        for entry in packs:
            grouped = _dyn_group(tables, entry["edges"], hq=hq, exact=bool(exact), E=m.net.n_edges)
            got_name, kargs, kw = dyn_kernel_call(forest, grouped, entry, wb, hq=hq,
                                                  exact=bool(exact), executor=executor)
            require(got_name == name, f"{executor} block called {got_name}, not {name}")
            abs_err, rel = compare(name, kargs, **kw)
            require(rel <= KERNEL_TOL, f"{name} vs plain on a DRFS block: {rel}")
            worst_abs, worst_rel = max(worst_abs, abs_err), max(worst_rel, rel)
            if kargs[1].numel() > big_n:
                biggest, big_n = (kargs, kw), kargs[1].numel()
            del grouped, kargs
        kargs, kw = biggest
        G, Q = kargs[1].shape
        shape = dict(G=G, R=kargs[0].shape[1], Q=Q, W=len(ts), k_s=int(m.ctx.k_s),
                     k_t=int(m.ctx.k_t), hq=hq)
        if not exact:
            bound = fused_leaf_bound(kargs) if name == "fused_leaf" else dyn_leaf_query_bound(kargs)
        else:
            bound = fused_walk_bound(kargs, kw.get("offs", tree_offs(hq)))
        timing = dict(ms=None, plain_ms=None)
        if device != "cpu":
            fn, ref = getattr(ops, name), plain_version(name)
            timing["ms"] = time_ms(lambda: fn(*kargs, **kw), flush=flush)
            timing["plain_ms"] = time_ms(lambda: ref(*kargs, **kw), flush=flush)
        say(tag, card=card, kernel=name, mode="exact" if exact else "quantized",
            blocks=len(packs), max_abs_err=worst_abs, max_rel_err=worst_rel,
            timed_shape=json.dumps(shape), ms=timing["ms"], plain_ms=timing["plain_ms"],
            **bound)
        result[name] = (worst_abs, worst_rel, shape, bound, timing)
        del biggest, kargs, tables
    return result


def build_kernels():
    """Compile every kernel source, one nvcc each, all started together."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels.dyn_query import dyn_leaf_query_library
    from repro_torch.kernels.fused_walk import fused_leaf_library, fused_walk_library
    from repro_torch.kernels.tree_query import tree_query_library

    builders = dict(fused_walk=fused_walk_library, fused_leaf=fused_leaf_library,
                    tree_query=tree_query_library, dyn_leaf_query=dyn_leaf_query_library)
    t1 = time.perf_counter()
    with ThreadPoolExecutor(len(builders)) as pool:  # nvcc runs outside the GIL
        futures = [pool.submit(b, verbose=True) for b in builders.values()]
        for f in futures:
            f.result()  # prints ptxas -v; a failed build raises here
    say("build", kernels=",".join(builders), seconds=round(time.perf_counter() - t1, 2))


def free(device):
    """Return the cached blocks of freed models to the card."""
    import gc

    gc.collect()
    if device != "cpu":
        torch.cuda.empty_cache()


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=float, default=1.0, help="berkeley replica scale (Table 3 = 1.0)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", metavar="PATH", default=None,
                    help="also write torch.profiler tables of warm queries: the RFS ones to PATH "
                         "and PATH.kernel-rfs, the DRFS ones (base epoch) to "
                         "PATH.drfs-quantized / PATH.drfs-exact and "
                         "PATH.kernel-drfs-quantized / PATH.kernel-drfs-exact")
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
    kworst = phase_kernel_kernels(device)
    say("kernels", seconds=round(time.perf_counter() - t1, 1))
    t1 = time.perf_counter()
    m, ts, F_main, launches, secs = phase_main(args, device, card)
    abs2, rel2, shape, bound, timing = phase_main_shapes(m, ts, device, card)
    del m
    free(device)
    say("main", seconds=round(time.perf_counter() - t1, 1))
    t1 = time.perf_counter()
    km, tq_launches, tq_secs = phase_rfs_kernel(args, device, card, ts, F_main)
    tq_shapes = phase_rfs_kernel_shapes(km, ts, device, card)
    del km
    free(device)
    say("kernel", path="rfs", seconds=round(time.perf_counter() - t1, 1))
    t1 = time.perf_counter()
    dm, dts, dlaunches, dsecs = phase_drfs(args, device, card)
    say("drfs", seconds=round(time.perf_counter() - t1, 1))
    t1 = time.perf_counter()
    dshapes = phase_drfs_shapes(dm, dts, device, card)
    del dm
    free(device)
    say("drfs-shapes", seconds=round(time.perf_counter() - t1, 1))
    t1 = time.perf_counter()
    kdm, kdts, kdlaunches, kdsecs = phase_drfs(args, device, card, executor="kernel",
                                               versus="fused", inserts=1, compact=False,
                                               tag="kernel-drfs")
    kdshapes = phase_drfs_shapes(kdm, kdts, device, card, executor="kernel",
                                 tag="kernel-drfs-shapes")
    del kdm
    free(device)
    say("kernel", path="drfs", seconds=round(time.perf_counter() - t1, 1))

    # each path's launches were read right after that path's queries: the
    # launches made since, to compare a kernel with its plain version, do
    # not count
    if device != "cpu":
        require(launches > 0, "the main path never launched fused_walk")
        require(tq_launches > 0, "the rfs kernel path never launched tree_query")

    def entry(name, path, n, err_abs, err_rel, shp, bnd, tm, replaces, source=None, **extra):
        return dict(
            name=name, route="cuda", path=path,
            source=f"src/repro_torch/kernels/csrc/{source or name}.cu", replaces=replaces,
            launches=n, max_abs_err=err_abs, max_rel_err=err_rel,
            ms=tm["ms"], plain_ms=tm["plain_ms"], bound_ms=bnd["bound_ms"], bound_by=bnd["bound_by"],
            library_ms=None,  # no single PyTorch call computes any of these functions
            timed_shape=shp, card=card, **extra,
        )

    la, lr, lshape, lbound, ltiming = dshapes["fused_leaf"]
    wa, wr, wshape, wbound, wtiming = dshapes["fused_walk"]
    ta, tr, tshape, tbound, ttiming = tq_shapes
    qa, qr, qshape, qbound, qtiming = kdshapes["dyn_leaf_query"]
    na, nr, nshape, nbound, ntiming = kdshapes["dyn_node_walk"]
    kw_ = {k: kworst[k] for k in ("tree_query", "dyn_leaf_query", "dyn_node_walk")}
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
        entry("tree_query", "rfs-kernel", tq_launches, max(kw_["tree_query"][0], ta),
              max(kw_["tree_query"][1], tr), tshape, tbound, ttiming,
              "src/repro/kernels/tree_query.py:104",
              main_path=dict(scale=args.scale, cold_s=tq_secs["cold_s"], warm_s=tq_secs["warm_s"])),
        entry("dyn_leaf_query", "drfs-kernel-quantized", kdlaunches["dyn_leaf_query"],
              max(kw_["dyn_leaf_query"][0], qa), max(kw_["dyn_leaf_query"][1], qr), qshape,
              qbound, qtiming, "src/repro/kernels/dyn_query.py:59",
              main_path=dict(scale=args.scale, warm_s=kdsecs["quantized-warm"])),
        entry("dyn_node_walk", "drfs-kernel-exact", kdlaunches["dyn_node_walk"],
              max(kw_["dyn_node_walk"][0], na), max(kw_["dyn_node_walk"][1], nr), nshape,
              nbound, ntiming, "src/repro/kernels/dyn_query.py:148", source="fused_walk",
              main_path=dict(scale=args.scale, warm_s=kdsecs["exact-warm"])),
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
