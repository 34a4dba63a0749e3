#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # needs one CUDA device and nvcc

Builds the hand-written kernels from the sources in this checkout (one
``nvcc`` per source, all started together; each kernel's registers and
spills from ``ptxas -v`` on a ``[build]`` line; the count of ``HGMMA``
instructions — wgmma — in the SASS of every bf16 ``flash_attention``
instantiation, which must not be 0; the adds, minima, compares and selects
in the SASS of every ``minplus`` instantiation, none of which may spill),
holds each against its plain PyTorch
version on the card, then drives the port's paths at full width over the
Table-3 berkeley replica:

* ``[main]`` a static RFS query, ``TNKDE(solution='rfs', engine='torch',
  executor='fused').query(ts)``, checked against the plain-torch ``packed``
  executor and the index-free SPS oracle;
* ``[drfs]`` the streaming index, ``TNKDE(solution='drfs', engine='torch',
  executor='fused', drfs_depth=8, auto_seal=False, horizon_s=0.9·span)``
  built from the first 90 % of the events: queries in both modes
  (quantized: ``fused_leaf``; exact: ``fused_walk`` on the complete tree;
  both on the window tables in place),
  a pinned snapshot, two inserts of 5 % each, ``query(at=snapshot)`` and
  ``compact()``, each answer checked against the ``packed`` executor and,
  in exact mode, the SPS oracle over the surviving events;
* ``[kernel]`` the per-bucket-search tier, ``executor='kernel'``: static RFS
  through ``tree_query`` (after ``[main]``'s model is freed; held against
  ``[main]``'s answer), then the streaming index (first 90 %, one insert of
  5 %) in both modes through ``dyn_leaf_query_flat`` (quantized:
  ``fused_leaf.cu`` on the leaf table in place, counted as
  ``dyn_leaf_query``) and ``dyn_node_walk_flat`` (exact), each answer held
  against the ``fused`` executor at the same snapshot (quantized: bitwise)
  and, in exact mode, the SPS oracle;
* ``[main-codec]`` ``[main]``'s query with the window table stored by a table
  codec, float32 then bfloat16 (``FlatForestEngine.from_host_tables(...,
  codec=)`` over ``[main]``'s index): the f32 / bf16 instantiation of
  ``fused_walk`` only, no fallback, within ``CODEC_TOL`` of ``[main]``'s f64
  answer, warm ``bytes_moved`` ≤ ``BYTES_GATE`` × the f64 packed executor's;
  ``[drfs-codec]`` the same requirements on ``[drfs]``'s base epoch, f32 in
  both modes and bf16 in exact mode, on the fused and kernel executors;
* ``[minplus]`` device shortest paths: ``minplus_bellman_ford`` from every
  vertex of the berkeley network (dense f64 adjacency, radius b_s = 800) for
  as many rounds as the deepest bounded-Dijkstra tree has hops — one
  ``minplus_matmul`` launch per round — held against scipy's bounded
  Dijkstra (``endpoint_distance_rows``), with the kernel's grid: blocks,
  blocks per SM (``minplus_occupancy``) and waves;
* ``[serve]`` the serve tier, ``repro_torch.serve.TNKDEServer`` with two
  profiles on ``[drfs]``'s parameters (quantized: ``fused_leaf``; exact:
  ``fused_walk``) and the server's defaults (flushes of up to 16 centres),
  ``warmup()``, then a ``make_request_mix`` stream over the held-back 10 %
  (its first 48 queries, an insert of 1 % after 24): every answer bitwise
  equal to a standalone ``TNKDE`` replaying the server's flush at the pinned
  snapshot (cold and warm), exact also against SPS, no engine fault,
  degradation or library loaded after warmup, no dispatch that waits for
  the card, and the kernels launched once per atom block of every flush;
  ``[serve-durable]``
  restores the quantized profile from the write-ahead log and checkpoint a
  crash left and serves the rest bitwise; ``[serve-router]`` two replicas
  behind ``ReplicaRouter`` with background compaction on and one replica
  killed mid-run (berkeley x0.1), every answer exact after failover; each
  phase holds ``fused_leaf`` against its plain version at the shapes of its
  own last flush;
* ``[lm]`` LM serving of qwen2.5-3b at full width with seeded weights:
  bf16 prefill of 4 × 2 048 tokens with ``attn_impl='kernel'`` (one
  ``flash_attention`` launch per layer) and 32 greedy decode steps; then in
  float32 the kernel against ``attn_impl='dense'`` and prefill + 128
  teacher-forced decode steps against ``forward``;
* ``[lm-moe]``, ``[lm-rwkv]``, ``[lm-hybrid]``, ``[lm-encdec]``,
  ``[lm-mrope]`` the other LM families at their published widths with
  seeded weights: olmoe-1b-7b (16 layers, 4 × 2 048 tokens, top-8 of 64
  experts with capacity drops), rwkv6-3b (32 layers, 4 × 2 048; the WKV
  recurrence is plain torch), recurrentgemma-9b (38 layers with its 2-layer
  tail, 2 × 2 048 = the window, the decode steps wrapping the ring buffer),
  whisper-tiny (batch 8, 1 536 encoder frames, 384 decoder tokens, decode on
  the cross cache) and qwen2-vl-72b cut to 4 layers (embeddings of a 32 × 32
  patch image then text, M-RoPE streams that differ): bf16 prefill cold and
  warm with ``attn_impl='kernel'`` (``flash_attention`` launched exactly once
  per attention layer, and no other kernel), 32 greedy decode steps, the
  seconds and peak memory; then float32 checks at a cut depth (prefill +
  decode against forward; the kernel against ``'dense'`` where the family
  runs it; whisper's kernel on all 8 layers' activations against float64).
  ``flash_attention`` is held against its plain version and timed against
  SDPA at each of these paths' shapes first;
* ``[train-check]`` and ``[train]`` training (no hand-written kernel: the
  reference's Pallas kernel has no backward, and training attends with
  ``'auto'``): float32 at full width cut to 2 layers, 1 × 512 tokens — the
  loss and every gradient leaf against the same step in float64, remat
  ``'full'`` against ``'none'``, the int8 cross-pod mean of two members'
  gradients within scale/2 of their exact mean and one hierarchical step on
  a 2-member pod of this card; then qwen2.5-3b at full width trained
  ``TRAIN_STEPS`` steps through ``launch.train.run_training`` (bf16
  parameters, float32 AdamW, remat ``'full'``, 2 × 2 048 tokens a step):
  each step's seconds, tokens/s, loss, ce, grad norm and lr, the model-FLOP
  rate, the peak memory, no launch of any hand-written kernel; then the
  cost of the stacked-gradient route the trainer avoids;
* ``[dryrun]`` the dry-run (``launch.dryrun.main(['--all', '--mesh',
  'both'])``: every (arch x shape) cell accounted on meta tensors on the
  reference's two logical production meshes, all ``ok``, and the roofline
  tables against the H100's peaks), then its one-card check: qwen2.5-3b at
  ``[train]``'s shape on a 1 x 1 mesh — parameter, gradient and AdamW bytes
  equal to the live tensors', step FLOPs within DRYRUN_FLOPS_TOL of
  ``FlopCounterMode`` on a real step, bytes_per_device within
  DRYRUN_BYTES_TOL of ``[train]``'s peak — and ``[lm]``'s prefill and
  decode step against their peaks, each beside its roofline bound;
* ``[train-dp]`` training over several processes
  (``sharding.process.ProcessMesh``, one process a rank): (a)
  ``run_training`` on a world of 1 under NCCL at ``[train]``'s full width,
  steps and batch, its losses within 1e-6 of ``[train]``'s; then one
  spawned group of 2 ranks on this card under gloo (NCCL takes one rank a
  device; gloo's collectives go through host memory):
  (c) the int8 pod step at ``[train-check]``'s 2-layer cut bitwise the
  one-card ``hier_step``, (d) a checkpoint of the ranks' blocks restored on
  the 2 ranks and on this process bitwise, (b) qwen2.5-3b at full width
  (cut, ``cut=``, only if the pair does not fit by the printed reckoning)
  on ``('data',)`` = 2, its step's loss and grad norm against ``[train]``'s
  first within TRAIN_GRAD_TOL, the bytes staged and the step seconds; (e)
  one row of 512 tokens at that cut on ``('data', 'model')`` = (1, 2), a
  batch that does not divide by the world (both ranks run it whole), its
  loss and grad norm within 1e-6 / 1e-5 of the one-process step's;
* ``[dryrun-kde]`` ``ShardedForestEngine.lower_flush`` (the account of the
  sharded flush) on both production meshes for the reference's
  ``kde_cell`` world and the berkeley world, then the berkeley account at
  16 slabs on this card held against a real cold and warm query:
  ``segment_add`` launches and each shard's device bytes equal to the
  account's, the answer within PACKED_TOL of ``[main]``'s.

Each path's launch counts are set to 0 just before it runs and read just
after; ``[*-shapes]`` then holds every block the path gave a kernel against
its plain version and times the largest (the in-place walk in both of its
forms, edge block staged in shared memory and read through L1/L2, timed in
turns: ``ms_staged``, ``ms_unstaged``; ``ms`` is the form ``ops.walk_staged``
keeps). ``[flat-kernels]`` sweeps the in-place walk and leaf kernels over
seeded flat tables first, in every table dtype each is instantiated for.

Any failed check raises (non-zero exit). Without a CUDA device it exits
non-zero and prints no result.

Output, in order: the card's name and power limit as ``nvidia-smi`` gives
them; one line per phase and step (with its time); one JSON line
``{"kernels": [...]}`` with one entry per (kernel, path, table dtype): launches on that
path, error against the plain version, time, the plain version's time and
the roofline bound at the largest block of that path, and for
``flash_attention`` the time of ``scaled_dot_product_attention`` on the same
inputs (``library_ms``, timed only, never on the path; the two are timed in
turns in one call: kernel, SDPA, SDPA, kernel); and as the last line
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
PEAK_BF16_TC_FLOPS = 989e12  # dense bf16 tensor-core peak: the yardstick of attention
PEAK_F32_FLOPS = 67e12  # float32 outside the tensor cores, where the f32 flash kernel computes
# An add, a compare or a min is ONE lane-operation, where the FLOP rates above
# count a fused multiply-add as two: 64 f64 (128 f32) lane-operations per SM
# and clock, 132 SMs x 64 x 1.98 GHz = 16.7e12 f64 per second — half the rate.
PEAK_F64_LANE_OPS = PEAK_F64_FLOPS / 2
PEAK_F32_LANE_OPS = PEAK_F32_FLOPS / 2
# the SASS opcodes [build] counts in each minplus instantiation
MINPLUS_SASS = ("DADD", "DMNMX", "DSETP", "FADD", "FMNMX", "FSETP", "FSEL", "SEL", "LOP3",
                "MOV", "IMAD", "LDS", "LDGSTS", "BAR")

KERNEL_TOL = 1e-13  # f64, kernel vs its plain version; only association and FMA differ
KERNELS = ("fused_walk", "fused_leaf", "tree_query", "dyn_leaf_query", "dyn_node_walk",
           "minplus_matmul", "flash_attention", "segment_add", "fold_node_tables")
# segment_add launches per path (each read with that path's own counts, right
# after it ran): every TN-KDE flush ends in the fixed-order scatter
SEGMENT_LAUNCHES = {}
# fold_node_tables launches per path, read the same way: one a fresh window
# batch of the packed RFS executors (one a shard when sharded), none on a hit
FOLD_LAUNCHES = {}
FOLD_W = 24  # [fold-shapes]: berkeley's fresh queries fold 24 centres
# segment_add's time at [main]'s largest pack and [drfs]'s largest block in its
# earlier design (one thread per (lixel, window), loading its rows from device
# memory one after the other; NVIDIA H100 80GB HBM3, 700.00 W), printed beside
# this run's
SEGMENT_EARLIER_MS = {"main-segment": 0.051776, "drfs-segment": 0.078960}
SHARDS = (2, 4)  # [sharded]: S slabs on the one card
SHARDED_DRFS_SCALE = 0.1  # [sharded] DRFS and serve: berkeley x0.1 (exact mode's scans x S)
PACKED_TOL = 1e-12  # fused vs packed executor, relative to max|F|
# a table codec's answer vs the f64 answer, relative to max|F|: the narrow
# tables store each value rounded to float32 (~6e-8 of it) or bfloat16 (~4e-3);
# the arithmetic on them stays float64. The reference's own codec answers
# read up to 5.3e-7 (f32) and 3.4e-3 (bf16) of max|F| against its f64 ones.
CODEC_TOL = {"f32": 2e-6, "bf16": 1e-2}
CODEC_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
BYTES_GATE = 0.55  # codec warm bytes_moved vs the f64 packed executor's (the reference's gate)
SPS_TOL = 1e-10  # index vs index-free oracle, relative to max|F|
SPS_EDGES = 32  # most query edges in the SPS sample
SPS_LIXELS = 96  # the sample stops once it holds this many lixels (>= 64 checked)
MINPLUS_RADIUS = 800.0  # b_s of the TN-KDE queries above: the SPS precomputation's bound
SP_TOL = 1e-12  # Bellman-Ford vs Dijkstra, relative per entry: equal-length paths may
#                 sum their edges in another order
# flash_attention vs its plain version, relative to max|out|: in f32 the two differ
# only in the order of the sums (online softmax against one softmax), ~1e-6; in bf16
# the output is rounded once to bf16 (one ulp is 2^-8 ≈ 3.9e-3 of a value), so two
# f32 results a hair apart may round one ulp apart
FLASH_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
# [lm] float32 checks. Per layer, on all 36 layers' real activations: the
# kernel's error against the same attention in float64 may be at most
# LAYER_ACCURACY times that of its plain f32 version (+1e-6 of max|out|) — the
# reference's init scales (fan-in of wq/wk = the head count) give attention
# logits of magnitude ~1e3 at full width, where any f32 order of sums moves
# the output by ~1e-4 of max|out|, so a fixed tolerance would measure the
# weights, not the kernel; the kernel sums its 2 048 keys one chunk after
# another, hence a factor of a few. End to end through the public entry
# points, on the first LM_CHECK_LAYERS layers at full width, relative to
# max|logit|: ~1e-4 of f32 attention error per layer, amplified by the next
# layer, stays far below LM_TOL, while a wrong cache slot, rope position or
# mask moves the logits by O(1). At 36 layers the random model amplifies any
# change of arithmetic to O(1) (phase_lm prints it), hence the cut. At the cut
# a sound run read (a) 2.8e-5 and (b) 2.9e-3 on an H100: (a) reads the last
# token of 2 sequences, (b) 2 × 128 positions, where the forward alone, kernel
# against dense, already differs by 4.9e-3. q and k rounded to bf16, or TF32
# matmuls, read 0.20-0.60 (lm_cut_readings prints both each run).
LAYER_ACCURACY = 4.0
LM_TOL = 1e-2
LM_CHECK_LAYERS = 2  # depth of the [lm] f32 end-to-end checks (full width)


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
    from repro_torch.kernels import (dyn_query, flash_attention, fused_walk, minplus,
                                     segment_add, tree_query)

    return dict(fused_walk=fused_walk.fused_walk_ref, fused_leaf=fused_walk.fused_leaf_ref,
                fused_walk_flat=fused_walk.fused_walk_flat_ref,
                dyn_node_walk_flat=fused_walk.fused_walk_flat_ref,
                fused_leaf_flat=fused_walk.fused_leaf_flat_ref,
                tree_query=tree_query.tree_query_ref,
                dyn_leaf_query=dyn_query.dyn_leaf_query_ref,
                dyn_leaf_query_flat=fused_walk.fused_leaf_flat_ref,
                dyn_node_walk=dyn_query.dyn_node_walk_ref,
                minplus_matmul=minplus.minplus_matmul_ref,
                flash_attention=flash_attention.flash_attention_ref,
                segment_add=segment_add.segment_add_ref)[name]


def compare(name, args, fn=None, **kw):
    """(max_abs_err, max_rel_err) of ops.<name> (or ``fn``) against its plain
    version, relative to max|plain|; synchronises so a fault surfaces here."""
    from repro_torch.kernels import ops

    got = (fn or getattr(ops, name))(*args, **kw)
    if got.is_cuda:
        torch.cuda.synchronize()
    want = plain_version(name)(*args, **kw)
    require(got.shape == want.shape and got.dtype == torch.float64, f"{name} output shape/dtype")
    require(bool(torch.isfinite(got).all()), f"{name} produced non-finite values")
    abs_err = float((got - want).abs().max()) if got.numel() else 0.0
    scale = float(want.abs().max()) if got.numel() else 1.0
    return abs_err, abs_err / (scale or 1.0)


def reset_launches():
    """Every wrapper's launch count, and its per-table-dtype counts, to 0."""
    from repro_torch.kernels import ops

    for name in KERNELS:
        fn = getattr(ops, name)
        fn.launches = 0
        if hasattr(fn, "launches_by_dtype"):
            fn.launches_by_dtype = dict.fromkeys(ops.TABLE_DTYPES, 0)


def read_launches():
    from repro_torch.kernels import ops

    return {name: getattr(ops, name).launches for name in KERNELS}


def take_segment(counts, path):
    """Pop segment_add's count from a path's counts (read right after the
    path ran) and record it under ``path`` for the kernels line."""
    n = counts.pop("segment_add")
    SEGMENT_LAUNCHES[path] = SEGMENT_LAUNCHES.get(path, 0) + n
    return n


def take_fold(counts, path):
    """Pop fold_node_tables' count from a path's counts and record it under
    ``path`` for the kernels line, as take_segment does for the scatter."""
    n = counts.pop("fold_node_tables")
    FOLD_LAUNCHES[path] = FOLD_LAUNCHES.get(path, 0) + n
    return n


def read_launches_by_dtype():
    """{kernel: {table dtype: launches}} of the wrappers that count them."""
    from repro_torch.kernels import ops

    return {name: dict(getattr(ops, name).launches_by_dtype) for name in KERNELS
            if hasattr(getattr(ops, name), "launches_by_dtype")}


def time_samples(fn, *, reps=10, flush=None, calls=1):
    """``reps`` CUDA-event times of fn() in ms, after two warm-up calls;
    ``flush`` (a large tensor) is overwritten before every sample so the
    inputs are not L2-resident. With ``calls`` > 1 a sample is the mean over
    that many back-to-back calls: the host's time to launch one call then
    overlaps the card's work on the previous one instead of being counted."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b) / calls)
    return out


def time_ms(fn, *, reps=10, flush=None):
    """Median CUDA-event time of fn() in ms (see time_samples)."""
    return float(np.median(time_samples(fn, reps=reps, flush=flush)))


def walk_work(index, r_lo, r_hi, side):
    """What THIS input makes the in-place walk do: (rows emitted, distinct
    flat table rows)."""
    nlev = int(index.span).bit_length()
    base = index.lvl_base[:nlev][:, index.edges][..., None]  # [nlev, G, 1]
    l, r = r_lo.to(torch.int64), r_hi.to(torch.int64)
    emitted, rows = 0, []
    for lev in range(nlev):
        for left in (True, False):
            emit = (l < r) & (((l if left else r) & 1) == 1)
            row = ((base[lev] + (l if left else r - 1)) * 2 + side)[emit]
            emitted += int(emit.sum())
            rows.append(row)
            if left:
                l = torch.where(emit, l + 1, l)
            else:
                r = torch.where(emit, r - 1, r)
        l, r = l >> 1, r >> 1
    distinct = int(torch.unique(torch.cat(rows)).numel()) if rows else 0
    return emitted, distinct


def fused_walk_bound(args):
    """Least time the card could take for this in-place walk, from this
    input: the larger of bytes/bandwidth (each distinct flat row the climb
    needs, at the table's itemsize; r_lo/r_hi of every slot, which say whether it is live; side and
    the coefficients of the live slots only, since a padding slot's answer
    is 0 whatever they hold; each group's lvl_base column and edge, read
    once; the output written once) and operations/peak f64 (one add per
    gathered value, 3 per (live atom, window, feature) in the contraction)."""
    table, index, r_lo, r_hi, side, qs = args
    WC = table.shape[1]
    G, Q, ks = qs.shape
    W = WC // (2 * ks)
    nlev = int(index.span).bit_length()
    emitted, distinct = walk_work(index, r_lo, r_hi, side)
    n_live = int((r_lo < r_hi).sum())
    nbytes = (distinct * WC * table.element_size() + G * Q * 8 + n_live * (ks * 8 + 4)
              + G * W * Q * 8 + G * (nlev + 1) * 8)
    flops = emitted * WC + n_live * W * 3 * ks
    t_b, t_f = nbytes / PEAK_BYTES_PER_S, flops / PEAK_F64_FLOPS
    return dict(bound_ms=max(t_b, t_f) * 1e3, bound_by="bytes" if t_b >= t_f else "operations",
                bytes=nbytes, flops=flops, live_slots=n_live, rows_emitted=emitted,
                rows_distinct=distinct)


def walk_forms(kernel, kargs, device):
    """The in-place walk at one shape in both forms — the edge block staged
    in shared memory, and read through L1/L2 — each held against the plain
    version, then (on the card) timed in turns with L2 flushed (unstaged,
    staged, staged, unstaged: 5 samples each time) beside the plain
    version. ``ms`` is the form ``ops.walk_staged`` keeps."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.fused_walk import fused_walk_flat_ref

    isz = kargs[0].element_size()
    forms = {"unstaged": False}
    if ops.walk_stageable(kargs[1].span, kargs[0].shape[1], isz):
        forms["staged"] = True
    worst = (0.0, 0.0)
    for form, st in forms.items():
        # the CPU rehearsal has no kernel: it walks the same comparison on
        # the wrapper, which takes the plain version there
        fn = (lambda *x, st=st: ops._walk_flat(kernel, *x, staged=st)[0]) if device != "cpu" \
            else ops.fused_walk_flat
        a, r = compare("fused_walk_flat", kargs, fn=fn)
        require(r <= KERNEL_TOL, f"{kernel} {form} vs plain: {r}")
        worst = max(worst[0], a), max(worst[1], r)
    kept = "staged" if ops.walk_staged(kargs[1].span, kargs[0].shape[1], isz) else "unstaged"
    timing = dict(ms=None, plain_ms=None, kept=kept, **{f"ms_{f}": None for f in forms})
    if device != "cpu":
        flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=device)  # 256 MB > L2
        samples = {f: [] for f in forms}
        for form in sorted(forms, reverse=True) + sorted(forms):
            samples[form] += time_samples(
                lambda: ops._walk_flat(kernel, *kargs, staged=forms[form]), reps=5, flush=flush)
        for form in forms:
            timing[f"ms_{form}"] = float(np.median(samples[form]))
        timing["ms"] = timing[f"ms_{kept}"]
        timing["plain_ms"] = time_ms(lambda: fused_walk_flat_ref(*kargs), flush=flush)
    return worst, timing


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
    """Least time the card could take for this in-place leaf phase, from
    this input: the larger of bytes/bandwidth (each distinct flat prefix row,
    at the table's itemsize, that a slot whose two rows differ needs — equal rows difference to
    exactly 0 —; lo/hi of every slot, which say whether it is live; side and
    q_s of the live slots only; each group's edge, the two temporal tables
    and the output, each once) and operations/peak f64 (per live slot,
    window and value: the difference, the q_s·q_t product, the multiply and
    the add)."""
    lcum, index, lo, hi, side, qs, qtl, qtr = args
    WK = lcum.shape[1]
    G, Q, ks = qs.shape
    W, kt = qtl.shape
    R = (int(index.span) + 1) * 2
    base = index.edges[:, None] * R
    i_hi = base + (hi.to(torch.int64) * 2 + side).clamp(0, R - 1)
    i_lo = base + (lo.to(torch.int64) * 2 + side).clamp(0, R - 1)
    live = i_hi != i_lo
    distinct = int(torch.unique(torch.cat([i_hi[live], i_lo[live]])).numel())
    n_live = int(live.sum())
    nbytes = (distinct * WK * lcum.element_size() + G * Q * 8 + n_live * (ks * 8 + 4)
              + 2 * W * kt * 8 + G * W * Q * 8 + G * 8)
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


def flat_walk_case(layout, E, G, Q, W, ks, device, dtype=torch.float64):
    """Seeded inputs for the in-place walk: a level-major flat table of E
    edges of one npad ('rfs<npad>': the packed forest's node order, level ℓ
    of every edge before level ℓ+1; 'tree<hq>': the complete tree's,
    torch_engine.dyn_node_base), stored as ``dtype`` (a table codec's fold
    dtype), G groups on edges drawn with repeats, every fifth slot padding
    (empty interval, qs = 0)."""
    from repro_torch.core.torch_engine import dyn_node_base
    from repro_torch.kernels import ops

    n = int(layout.lstrip("rfstre"))
    npad = n if layout.startswith("rfs") else 1 << n
    nlev = npad.bit_length()
    if layout.startswith("rfs"):
        e = torch.arange(E, dtype=torch.int64)
        lvl_base = torch.stack([E * (2 * npad - 2 * (npad >> lev)) + e * (npad >> lev)
                                for lev in range(nlev)])
    else:
        lvl_base = dyn_node_base(E, n)
    rng = np.random.default_rng(npad * 1000 + E * 10 + Q)
    table = rng.normal(size=(2 * E * (2 * npad - 1), W * 2 * ks))
    edges = rng.integers(0, E, G)
    r_lo = rng.integers(0, npad + 1, (G, Q))
    r_hi = np.maximum(rng.integers(0, npad + 1, (G, Q)), r_lo)
    r_hi[:, ::5] = r_lo[:, ::5]
    side = rng.integers(0, 2, (G, Q))
    qs = rng.normal(size=(G, Q, ks))
    qs[:, ::5] = 0.0
    t = lambda x, dt: torch.as_tensor(x, device=device).to(dt).contiguous()  # noqa: E731
    index = ops.walk_index(t(lvl_base, torch.int64), t(edges, torch.int64), npad,
                           lvl_base_host=lvl_base.numpy(), edges_host=edges)
    return (t(table, dtype), index, t(r_lo, torch.int32), t(r_hi, torch.int32),
            t(side, torch.int32), t(qs, torch.float64))


def flat_leaf_case(nleaf, E, G, Q, W, ks, kt, device, dtype=torch.float64):
    """Seeded inputs for the in-place leaf phase: dyn_window_tables' layout
    (per edge (nleaf+1)·2 prefix rows) for E edges, stored as ``dtype`` (a
    table codec's moment dtype), G groups on edges drawn with repeats, every
    fifth slot an empty leaf range."""
    from repro_torch.kernels import ops

    rng = np.random.default_rng(nleaf * 1000 + E * 10 + Q)
    R = (nleaf + 1) * 2
    lcum = np.cumsum(rng.normal(size=(E, R, W * 2 * ks * kt)), axis=1).reshape(E * R, -1)
    edges = rng.integers(0, E, G)
    lo = rng.integers(0, nleaf + 1, (G, Q))
    hi = np.maximum(rng.integers(0, nleaf + 1, (G, Q)), lo)
    hi[:, ::5] = lo[:, ::5]
    side = rng.integers(0, 2, (G, Q))
    qs = rng.normal(size=(G, Q, ks))
    qtl, qtr = rng.normal(size=(W, kt)), rng.normal(size=(W, kt))
    t = lambda x, dt: torch.as_tensor(x, device=device).to(dt).contiguous()  # noqa: E731
    return (t(lcum, dtype), ops.leaf_index(t(edges, torch.int64), nleaf, edges_host=edges),
            t(lo, torch.int32), t(hi, torch.int32), t(side, torch.int32), t(qs, torch.float64),
            t(qtl, torch.float64), t(qtr, torch.float64))


def phase_flat_kernels(device):
    """The in-place kernels against their plain versions, for every table
    dtype each is instantiated for: fused_walk_flat (float64, float32,
    bfloat16) on the RFS layouts npad 4-512 and the trees hq 2-8, in both
    forms (staged where the edge block fits a block's shared memory, and
    through L1/L2; ragged Q, W > 8 windows, the gaussian k_s; bfloat16 nodes
    of 8 bytes, which the staged copy moves in 8-byte pieces), and
    fused_leaf_flat (float64, float32) over nleaf 4-256 (K = 121 included).
    Both sides compute in float64 from the same stored values. Returns the
    worst (abs, rel) per (kernel, table dtype)."""
    from repro_torch.kernels import ops

    small = device == "cpu"  # the rehearsal keeps the CPU small
    worst = {}

    def check(name, dtype, case, args, fn=None):
        abs_err, rel = compare(name, args, fn=fn)
        dt = str(dtype).removeprefix("torch.")
        say("flat-kernels", kernel=name, table_dtype=dt, case=case, max_abs_err=abs_err,
            max_rel_err=rel)
        require(rel <= KERNEL_TOL, f"{name} {dt} disagrees with its plain version: {rel}")
        a, r = worst.get((name, dt), (0.0, 0.0))
        worst[name, dt] = (max(a, abs_err), max(r, rel))

    walk_cases = [
        ("rfs4", 5, 3, 7, 1, 2), ("rfs8", 5, 4, 33, 2, 3), ("rfs16", 6, 5, 65, 3, 2),
        ("rfs32", 40, 60 if small else 1600, 512, 5, 2), ("rfs64", 5, 5, 130, 9, 11),
        ("rfs512", 6, 8 if small else 64, 1000, 5, 2),
        ("tree2", 5, 3, 7, 1, 2), ("tree3", 5, 4, 33, 2, 3), ("tree4", 6, 5, 65, 2, 2),
        ("tree8", 40, 20 if small else 400, 512, 5, 2),
    ]
    # bfloat16 nodes of W·2k_s = 2 or 6 values: 8 (mod 16) bytes
    odd_bf16 = [("rfs16", 5, 4, 33, 1, 1), ("rfs64", 5, 4, 65, 3, 1), ("tree4", 5, 4, 33, 1, 1)]
    for dtype in (torch.float64, torch.float32, torch.bfloat16):
        forms = set()
        for layout, E, G, Q, W, ks in walk_cases + (odd_bf16 if dtype == torch.bfloat16 else []):
            args = flat_walk_case(layout, E, G, Q, W, ks, device, dtype)
            case = f"{layout}:E{E}:G{G}:Q{Q}:W{W}:ks{ks}"
            check("fused_walk_flat", dtype, case, args)
            if device == "cpu":
                continue
            for st in (False, True):
                if st and not ops.walk_stageable(args[1].span, args[0].shape[1],
                                                 args[0].element_size()):
                    continue
                forms.add(st)
                check("fused_walk_flat", dtype, f"{case}:{'staged' if st else 'unstaged'}", args,
                      fn=lambda *x, st=st: ops._walk_flat("fused_walk", *x, staged=st)[0])
        require(device == "cpu" or forms == {True, False},
                f"the in-place walk sweep misses a form for {dtype}")
    for dtype in (torch.float64, torch.float32):
        for nleaf, E, G, Q, W, ks, kt in [
            (4, 5, 3, 7, 1, 2, 1), (8, 5, 4, 33, 3, 2, 2), (16, 6, 5, 65, 2, 3, 1),
            (32, 5, 5, 130, 9, 11, 11), (256, 40, 40 if small else 4000, 512, 5, 2, 2),
        ]:
            check("fused_leaf_flat", dtype, f"nleaf{nleaf}:E{E}:G{G}:Q{Q}:W{W}:ks{ks}:kt{kt}",
                  flat_leaf_case(nleaf, E, G, Q, W, ks, kt, device, dtype))
    return worst


def tree_case(n_events, G, Q, Wh, ks, kt, device, empty_group=None):
    """Seeded random inputs for tree_query, built as the reference's kernel
    tests build them: per group a time-major merge tree over ``n_events``
    events (level ℓ buckets 2^ℓ consecutive time ranks, position-sorted
    inside with +inf padding at the end, inclusive prefix moments of width
    4·k_s·k_t), concatenated into one flat forest (``base = g·LVL·NPAD``);
    per-edge rank intervals, position bounds (every fifth slot a padding
    slot that selects nothing, qs zero), sides, q_s, q_t and the half of
    each half-window. ``empty_group`` holds no events. Returns (args, kw)."""
    from repro_torch.core.aggregation import next_pow2, segmented_cumsum

    K4 = 4 * ks * kt
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
    r_lo = rng.integers(0, n_events, (G, Wh))
    r_hi = np.maximum(rng.integers(0, n_events + 1, (G, Wh)), r_lo)
    ph, pl1, pl2 = rng.uniform(0, 110, (G, Q)), rng.uniform(-10, 100, (G, Q)), rng.uniform(-10, 60, (G, Q))
    qs = rng.normal(size=(G, Q, ks))
    ph[:, ::5], pl1[:, ::5], pl2[:, ::5], qs[:, ::5] = -np.inf, np.inf, np.inf, 0.0
    l1r = rng.random((G, Q)) < 0.5
    side = rng.integers(0, 2, (G, Q))
    qt = rng.normal(size=(Wh, kt))
    half = np.arange(Wh) % 2
    t = lambda x, dt: torch.as_tensor(x, device=device).to(dt).contiguous()  # noqa: E731
    f, i = torch.float64, torch.int32
    return (t(pos.reshape(-1), f), t(cum.reshape(-1, K4), f),
            t(np.arange(G) * lvl * npad, torch.int64), t(r_lo, i), t(r_hi, i), t(ph, f),
            t(pl1, f), t(l1r, i), t(pl2, f), t(qs, f), t(qt, f), t(side, i), t(half, i)), \
        dict(npad=int(npad))


def tree_query_bound(args, kw):
    """Least time the card could take for this call, from this input: the
    larger of bytes/bandwidth and operations/peak f64, for the function as
    the kernel computes it. Bytes: the K = k_s·k_t combo columns of each
    distinct (prefix row, combo) a non-empty bucket interval needs, each
    distinct position entry the three searches of an emitted bucket probe,
    the per-edge rank intervals and ``base``, the slots' bounds, flags and
    ``qs``, ``qt``, ``half`` and the output, each once. Operations: per
    non-empty bucket, the difference, product and sum of each combo column
    (3·K). ``bound_ms_qvec_form`` is the count for the earlier form of the
    function (a materialised 4K-wide query row per live lane,
    [G, Wh, Q] rank intervals, all 4K prefix columns), kept so that its
    bound can still be read; it is not this kernel's bound."""
    from repro_torch.kernels import tree_query as tq

    pos_flat, cum_flat, first_row, r_lo2, r_hi2, ph, pl1, l1r, pl2, qs, qt, side, half = args
    pos, r_lo, r_hi = tq.tree_query_views(pos_flat, first_row, r_lo2, r_hi2, ph.shape[1],
                                          npad=kw["npad"])
    G, LVL, NPAD = pos.shape
    Wh, Q, ks, kt = r_lo.shape[1], r_lo.shape[2], qs.shape[2], qt.shape[1]
    K4, K = cum_flat.shape[-1], ks * kt
    live = torch.zeros(r_lo.numel(), dtype=torch.bool, device=pos.device)
    rows, combos, probes, emitted, busy = [], [], [], 0, 0
    search = tq._search

    def probing(row, g, lo, hi, val, right, steps):
        """tq._search, replayed to collect the storage index in ``pos`` of
        every entry a live lane reads."""
        want = search(row, g, lo, hi, val, right, steps)
        lo, hi = lo.clone(), hi.clone()
        at = row.storage_offset() + g * row.stride(0)
        for _ in range(steps):
            on = lo < hi
            m = (lo + hi) >> 1
            probes.append((at + m * row.stride(1))[on])
            v = row[g, m.clamp(0, row.shape[1] - 1)]
            go = torch.where(right, v <= val, v < val) & on
            lo, hi = torch.where(go, m + 1, lo), torch.where(go | ~on, hi, m)
        require(torch.equal(lo, want), "tree_query_bound: the replayed search differs")
        return want

    tq._search = probing
    try:
        for lev, lane, g, seg_lo, i_lo, i_hi in tq.tree_buckets(pos, r_lo, r_hi, ph, pl1, l1r,
                                                                pl2):
            emitted += int(lane.numel())
            on = i_hi > i_lo
            busy += int(on.sum())
            live[lane[on]] = True
            row0 = (g * LVL + lev) * NPAD - 1
            c = side[g, lane % Q].to(torch.int64) * 2 + half[(lane // Q) % Wh]
            for i, keep in ((i_hi, on), (i_lo, on & (i_lo > seg_lo))):
                rows.append((row0 + i)[keep])
                combos.append(((row0 + i) * 4 + c)[keep])
    finally:
        tq._search = search
    distinct = int(torch.unique(torch.cat(rows)).numel()) if rows else 0
    distinct_combo = int(torch.unique(torch.cat(combos)).numel()) if combos else 0
    probed = int(torch.unique(torch.cat(probes)).numel()) if probes else 0
    n_live = int(live.sum())
    nbytes = (distinct_combo * K * 8 + probed * 8 + G * (8 + Wh * 8) + Wh * (4 + kt * 8)
              + G * Q * (3 * 8 + 4 + 4 + ks * 8) + G * Q * Wh * 8)
    flops = busy * 3 * K
    t_b, t_f = nbytes / PEAK_BYTES_PER_S, flops / PEAK_F64_FLOPS
    # the earlier form's count, as it was before the query vector moved in
    old_bytes = ((distinct + n_live) * K4 * 8 + probed * 8 + r_lo.numel() * (4 + 4 + 8)
                 + G * Q * (3 * 8 + 4))
    old_ms = max(old_bytes / PEAK_BYTES_PER_S, busy * 3 * K4 / PEAK_F64_FLOPS) * 1e3
    return dict(bound_ms=max(t_b, t_f) * 1e3, bound_by="bytes" if t_b >= t_f else "operations",
                bytes=nbytes, flops=flops, buckets_emitted=emitted, buckets_nonempty=busy,
                rows_distinct=distinct, row_combos_distinct=distinct_combo,
                positions_probed=probed, live_lanes=n_live, bound_ms_qvec_form=old_ms,
                bytes_qvec_form=old_bytes)


def phase_kernel_kernels(device):
    """The three kernels of executor='kernel' against their plain versions
    on seeded sweeps: tree_query at npad 8/32/512 with ragged Q, W in {1, 5}
    (2 or 10 half-windows), one group of all-+inf padding and the 4·k_s·k_t
    = 484 query width of the gaussian kernels; dyn_leaf_query (the
    reference's grouped contract, materialised query vectors) and
    dyn_leaf_query_flat (the flush's call: fused_leaf.cu on the same rows
    viewed flat, one edge a group) over the reference's sweep, K = 121
    (gaussian) and the main path's shape;
    dyn_node_walk at hq 2/3/4 and 8. Returns the worst (abs, rel) error per
    kernel."""
    from repro_torch.kernels import ops

    small = device == "cpu"  # the rehearsal keeps the CPU small
    worst = {}

    def check(name, case, args, **kw):
        abs_err, rel = compare(name, args, **kw)
        say("kernel-kernels", kernel=name, case=case, max_abs_err=abs_err, max_rel_err=rel)
        require(rel <= KERNEL_TOL, f"{name} disagrees with its plain version: {rel}")
        a, r = worst.get(name, (0.0, 0.0))
        worst[name] = (max(a, abs_err), max(r, rel))

    staged = set()
    for n_events, G, Q, Wh, ks, kt, empty in [
        (7, 3, 33, 2, 2, 2, None), (30, 5, 130, 10, 2, 2, 2), (21, 3, 65, 10, 11, 11, None),
        (500, 4 if small else 64, 200 if small else 1000, 10, 2, 2, None),
    ]:
        targs, tkw = tree_case(n_events, G, Q, Wh, ks, kt, device, empty)
        on = ops.tree_staged(tkw["npad"], 4 * ks * kt)
        staged.add(on)
        check("tree_query", f"npad{tkw['npad']}:G{G}:Q{Q}:Wh{Wh}:K4{4 * ks * kt}:"
              f"{'staged' if on else 'unstaged'}", targs, **tkw)
    require(staged == {True, False}, "the tree_query sweep misses a branch of the kernel")
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
        index = ops.leaf_index(torch.arange(G, device=device), nleaf, edges_host=np.arange(G))
        check("dyn_leaf_query_flat", f"nleaf{nleaf}:G{G}:Q{Q}:W{W}:ks{ks}:kt{kt}",
              (tab.reshape(G * tab.shape[1], -1), index, lo, hi, side, qs, qtl, qtr))
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


def profile_call(fn, path, title, device):
    """Kernel-time table of one call of ``fn`` (torch.profiler) written to
    ``path``, headed by ``title`` and the call's wall time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        fn()
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t1
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write(f"{title} under the profiler: {wall:.4f} s\n")
        f.write(prof.key_averages().table(sort_by="cuda_time_total", row_limit=40))
    say("profile", written=path, wall_s_profiled=round(wall, 4))


def profile_warm(m, ts, path):
    """Kernel-time table of one warm query written to ``path``."""
    profile_call(lambda: m.query(ts), path, f"warm query, engine {m.engine_desc}",
                 m._fe.device)


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
    seg = take_segment(counts, "rfs")
    fold = take_fold(counts, "rfs")
    warm_searches = m.stats.n_rank_searches - s0
    require(not any(counts.values()), f"[main] launched another kernel: {counts}")
    if device != "cpu":
        require(seg == launches, f"[main] segment_add launches {seg} for {launches} walks")
        require(fold == 1, f"[main] fold_node_tables launched {fold} times for one fresh ts")

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
    host = build_packed_host_tables(m.index)  # [main-codec] builds its engines on it too
    m._fe = FlatForestEngine.from_host_tables(m.index, host, executor="packed", device=device)
    m._counter_cursor = {}
    t1 = time.perf_counter()
    F_packed = m.query(ts)
    sync()
    packed_cold_s = time.perf_counter() - t1
    b0 = m._fe.counters["bytes_moved"]
    t1 = time.perf_counter()
    m.query(ts)
    sync()
    packed_warm_s = time.perf_counter() - t1
    packed_warm_bytes = m._fe.counters["bytes_moved"] - b0
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
        packed_warm_s=round(packed_warm_s, 4), packed_warm_bytes_moved=packed_warm_bytes)
    return m, ts, F, launches, dict(cold_s=cold_s, warm_s=warm_s, host=host,
                                    packed_warm_bytes=packed_warm_bytes)


def phase_main_shapes(m, ts, device, card, *, form_npads=(64, 128), tag="main-shapes"):
    """The kernel at the shapes the main path gave it, on the window table in
    place (in the engine's table codec): every atom pack of the plan is
    compared with the plain version; the largest is timed in both forms
    (walk_forms), and so is the largest pack of each npad in
    ``form_npads``."""
    from repro_torch.kernels import ops

    fe = m._fe
    packs = fe._pack_cache.get(((m.epoch, m.ls), "fused"))
    tabs = fe.window_tables(fe.window_batch(m.ctx, ts), tuple(ts))
    table = tabs.reshape(tabs.shape[0], -1)
    worst_abs = worst_rel = 0.0
    biggest, big_n = None, -1
    t1 = time.perf_counter()
    for entry in packs:
        kargs = (table, entry["index"], entry["r_lo"], entry["r_hi"], entry["side"], entry["qs"])
        abs_err, rel = compare("fused_walk_flat", kargs)  # syncs after the kernel
        require(rel <= KERNEL_TOL, f"fused_walk vs plain at npad={entry['npad']}: {rel}")
        worst_abs, worst_rel = max(worst_abs, abs_err), max(worst_rel, rel)
        n = entry["r_lo"].numel()
        if n > big_n:
            biggest, big_n = kargs, n
    t_kernel = time.perf_counter() - t1
    kargs = biggest
    G, Q = kargs[2].shape
    npad = int(kargs[1].span)
    isz = table.element_size()
    shape = dict(G=G, npad=npad, rows=table.shape[0], Q=Q, W=len(ts), k_s=kargs[5].shape[2],
                 table_dtype=str(table.dtype).removeprefix("torch."),
                 staged=ops.walk_staged(npad, table.shape[1], isz))
    bound = fused_walk_bound(kargs)
    (fa, fr), timing = walk_forms("fused_walk", kargs, device)
    worst_abs, worst_rel = max(worst_abs, fa), max(worst_rel, fr)
    say(tag, card=card, packs=len(packs), max_abs_err=worst_abs, max_rel_err=worst_rel,
        walk_and_compare_all_packs_s=round(t_kernel, 4), timed_shape=json.dumps(shape),
        **timing, **{k: v for k, v in bound.items() if k not in ("bound_ms", "bound_by")})
    # the two forms at other RFS block sizes: for f64 npad 64 (~40 KB) and
    # 128 (~80 KB), both staged by default; for the narrow tables the npads
    # whose blocks a narrow table brings under WALK_STAGE_MAX bytes, which
    # walk_staged leaves unstaged (it counts the block's f64 bytes)
    for npad in form_npads:
        sized = [e for e in packs if int(e["index"].span) == npad]
        if not sized:
            continue
        e = max(sized, key=lambda e: e["r_lo"].numel())
        kargs = (table, e["index"], e["r_lo"], e["r_hi"], e["side"], e["qs"])
        _, t = walk_forms("fused_walk", kargs, device)
        say(tag, card=card, forms_at_npad=npad, G=kargs[2].shape[0], Q=kargs[2].shape[1],
            stage_bytes=ops.walk_stage_bytes(npad, table.shape[1], isz), **t,
            bound_ms=fused_walk_bound(kargs)["bound_ms"])
    return worst_abs, worst_rel, shape, bound, timing


# -------------------------------------------------- table codec, static RFS
def table_bytes(t):
    return int(t.numel()) * t.element_size()


def phase_main_codec(m, ts, F64, main, device, card):
    """``[main]``'s query with the window tables stored by a table codec:
    for 'f32' and then 'bf16', a fused engine over ``[main]``'s index and
    host tables (``FlatForestEngine.from_host_tables(..., codec=)``) swapped
    into the model, a cold and a warm query with the launch counts set to 0
    just before and read just after. Requires no fallback, the narrow dtype
    in the cached window table, launches of that dtype's instantiation only
    (one per pack per query), the answer within CODEC_TOL of ``[main]``'s f64
    one, warm ``bytes_moved`` ≤ BYTES_GATE × the f64 packed executor's; then
    every pack against the plain version and the largest timed
    (``[main-codec-shapes]``). Returns per codec the launches, seconds and
    the shapes' (abs, rel, shape, bound, timing)."""
    from repro_torch.core.rfs import FlatForestEngine

    def sync():
        if device != "cpu":
            torch.cuda.synchronize()

    fused_fe, out = m._fe, {}
    fmax = float(np.abs(F64).max())
    # npads whose edge block a narrow table brings under WALK_STAGE_MAX bytes
    form_npads = dict(f32=(256,), bf16=(256, 512))
    for codec, dtype in CODEC_DTYPES.items():
        dt = str(dtype).removeprefix("torch.")
        fe = FlatForestEngine.from_host_tables(m.index, main["host"], executor="fused",
                                               device=device, codec=codec)
        require(fe.codec.name == codec and fe.codec.fallback_reason is None,
                f"[main-codec] {codec} fell back: {fe.codec.fallback_reason}")
        m._fe, m._counter_cursor = fe, {}
        # ---- the path: counts set to 0 here, read right after the warm query
        reset_launches()
        t1 = time.perf_counter()
        F_cold = m.query(ts)
        sync()
        cold_s = time.perf_counter() - t1
        b0 = fe.counters["bytes_moved"]
        t1 = time.perf_counter()
        F = m.query(ts)
        sync()
        warm_s = time.perf_counter() - t1
        counts, by_dtype = read_launches(), read_launches_by_dtype()
        warm_bytes = fe.counters["bytes_moved"] - b0
        launches = counts.pop("fused_walk")
        seg = take_segment(counts, f"rfs-codec-{codec}")
        fold = take_fold(counts, f"rfs-codec-{codec}")
        n_packs = len(fe._pack_cache.get(((m.epoch, m.ls), "fused")))
        require(not any(counts.values()), f"[main-codec] launched another kernel: {counts}")
        require(device == "cpu" or seg == launches, f"[main-codec] segment_add launches {seg}")
        if device != "cpu":
            require(by_dtype["fold_node_tables"][dt] == fold == 1,
                    f"[main-codec] {codec}: fold_node_tables launches "
                    f"{by_dtype['fold_node_tables']} for one fresh ts")
            require(by_dtype["fused_walk"][dt] == launches == 2 * n_packs,
                    f"[main-codec] {codec}: fused_walk launches {by_dtype['fused_walk']} "
                    f"for {n_packs} packs")
        tab = fe._tab_cache.get((tuple(ts), "fused", codec))
        require(tab is not None and tab.dtype == dtype, f"[main-codec] window table is not {dt}")
        require(np.array_equal(F, F_cold), f"[main-codec] {codec}: warm query differs from cold")
        require(np.array_equal(F[1], F[4]), f"[main-codec] {codec}: duplicate centres differ")
        err = float(np.abs(F - F64).max()) / fmax
        require(0.0 < err <= CODEC_TOL[codec], f"[main-codec] {codec} vs f64: {err}")
        ratio = warm_bytes / main["packed_warm_bytes"]
        require(0.0 < ratio <= BYTES_GATE, f"[main-codec] {codec} warm bytes_moved ratio {ratio}")
        say("main-codec", card=card, codec=codec, table_dtype=dt, launches=launches,
            codec_vs_f64=err, tol=CODEC_TOL[codec], warm_bytes_moved=warm_bytes,
            bytes_vs_packed_f64=ratio, window_table_bytes=table_bytes(tab),
            device_bytes=fe.device_bytes, cold_s=round(cold_s, 4), warm_s=round(warm_s, 4))
        shapes = phase_main_shapes(m, ts, device, card, form_npads=form_npads[codec],
                                   tag="main-codec-shapes")
        out[codec] = dict(launches=launches, secs=dict(cold_s=cold_s, warm_s=warm_s),
                          shapes=shapes, err=err)
        m._fe, m._counter_cursor = fused_fe, {}
        del fe, tab
        free(device)
    return out


# ------------------------------------------------ kernel tier, static RFS
def phase_rfs_kernel(args, device, card, ts, F_main):
    """``TNKDE(solution='rfs', executor='kernel')`` at full width, cold then
    warm, once ``[main]``'s model is freed: one ``tree_query`` launch per
    kernel entry per query and nothing else launched, warm == cold and
    duplicate centres bitwise, the answer within PACKED_TOL of ``[main]``'s
    (the fused executor, itself held against packed and SPS)."""
    from repro_torch.core import TNKDE
    from repro_torch.core.rfs import _device_nbytes
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
    seg = take_segment(counts, "rfs-kernel")
    require(not any(counts.values()), f"[kernel] rfs launched another kernel: {counts}")
    require(device == "cpu" or seg == launches, f"[kernel] segment_add launches {seg}")

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
    # what the entries hold: the bounds and slot state (the tables stay in the forest)
    entry_bytes = sum(_device_nbytes(e) for e in entries)
    say("kernel", path="rfs", card=card, engine=m.engine_desc, atoms=m._host_plan().n_atoms,
        entries=n, padded_slots=sum(e["side"].numel() for e in entries), launches=launches,
        kernel_vs_fused=err, device_bytes=m._fe.device_bytes, entry_bytes=entry_bytes,
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
        kargs, kw = tree_query_args(fe._flat, ranks, entry, wb)
        abs_err, rel = compare("tree_query", kargs, **kw)
        require(rel <= KERNEL_TOL, f"tree_query vs plain at entry {i}: {rel}")
        worst_abs, worst_rel = max(worst_abs, abs_err), max(worst_rel, rel)
        n = kargs[5].numel() * kargs[3].shape[1]  # slots × half-windows
        if n > big_n:
            big, big_n = i, n
        del kargs
    compare_s = time.perf_counter() - t1
    kargs, kw = tree_query_args(fe._flat, ranks, entries[big], wb)
    npad, k4 = kw["npad"], kargs[1].shape[-1]
    shape = dict(G=kargs[2].shape[0], LVL=npad.bit_length(), NPAD=npad, Wh=kargs[3].shape[1],
                 Q=kargs[5].shape[1], K4=k4, staged=ops.tree_staged(npad, k4))
    bound = tree_query_bound(kargs, kw)
    timing = dict(ms=None, plain_ms=None)
    if device != "cpu":
        flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=device)  # 256 MB > L2
        timing["ms"] = time_ms(lambda: ops.tree_query(*kargs, **kw), flush=flush)
        timing["plain_ms"] = time_ms(lambda: tree_query_ref(*kargs, **kw), flush=flush)
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
        if device != "cpu":  # and the scatter once or twice a block (tree, scans)
            require(grew[kern] == nb and sum(grew.values()) - grew["segment_add"] == nb
                    and nb <= grew["segment_add"] <= 2 * nb,
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
        if (executor, versus) == ("kernel", "fused"):  # the same kernels on the same tables
            require(err == 0.0, f"{step}: kernel vs fused executor not bitwise equal: {err}")
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
    seg = take_segment(launches, tag)
    require(sum(launches.values()) == sum(mine.values()), f"{tag}: other kernels launched: {launches}")
    if device != "cpu":
        require(min(mine.values()) > 0 and seg > 0,
                f"the {tag} path never launched a kernel: {mine}, segment_add {seg}")
    peak = torch.cuda.max_memory_allocated() if device != "cpu" else None
    say(tag, card=card, launches=json.dumps(mine), **{f"{executor}_vs_{versus}": errs["versus"]},
        exact_vs_sps=errs["sps"], device_bytes=m._fe.device_bytes, max_memory_allocated=peak,
        warm_quantized_s=round(secs["quantized-warm"], 4), warm_exact_s=round(secs["exact-warm"], 4))
    return m, ts, mine, secs


# the ops wrapper each DRFS flush calls, by the kernel (launch count) it runs
DRFS_CALLS = dict(fused_leaf="fused_leaf_flat", fused_walk="fused_walk_flat",
                  dyn_leaf_query="dyn_leaf_query_flat", dyn_node_walk="dyn_node_walk_flat")


def phase_drfs_shapes(m, ts, device, card, *, executor="fused", tag="drfs-shapes",
                      modes=(False, True)):
    """Both DRFS kernels of the executor at the shapes the path gave them:
    every atom block of the last epoch's plan, in each of ``modes`` (exact
    or not), with the arguments the flush builds (the window table in place,
    in the engine's table codec), against the plain version; the largest
    block of each kernel is timed (the walk in both forms), with L2
    flushed."""
    from repro_torch.core.rfs import dyn_kernel_call
    from repro_torch.kernels import ops

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
        if bool(exact) not in modes:
            continue
        tables = fe.window_tables(wb, tuple(ts), snap, sealed, hq, bool(exact))
        worst_abs = worst_rel = 0.0
        biggest, big_n = None, -1
        for entry in packs:
            tab, index = fe.tree_table(tables, entry, hq=hq, exact=bool(exact))
            got_name, kargs, kw = dyn_kernel_call(forest, tab, entry, wb, hq=hq, exact=bool(exact),
                                                  executor=executor, index=index)
            require(got_name == DRFS_CALLS[name], f"{executor} block called {got_name}, not {name}")
            abs_err, rel = compare(got_name, kargs, **kw)
            require(rel <= KERNEL_TOL, f"{name} vs plain on a DRFS block: {rel}")
            worst_abs, worst_rel = max(worst_abs, abs_err), max(worst_rel, rel)
            n = entry["side"].numel()
            if n > big_n:
                biggest, big_n = (got_name, kargs, kw, tuple(entry["side"].shape)), n
            del tab, kargs
        got_name, kargs, kw, (G, Q) = biggest
        shape = dict(G=G, Q=Q, table=list(kargs[0].shape),
                     table_dtype=str(kargs[0].dtype).removeprefix("torch."), W=len(ts),
                     k_s=int(m.ctx.k_s), k_t=int(m.ctx.k_t), hq=hq)
        timing = dict(ms=None, plain_ms=None)
        if exact:
            bound = fused_walk_bound(kargs)
            (fa, fr), timing = walk_forms(name, kargs, device)
            worst_abs, worst_rel = max(worst_abs, fa), max(worst_rel, fr)
        else:
            bound = fused_leaf_bound(kargs)  # both executors run fused_leaf.cu here
            if device != "cpu":
                fn, ref = getattr(ops, got_name), plain_version(got_name)
                timing["ms"] = time_ms(lambda: fn(*kargs, **kw), flush=flush)
                timing["plain_ms"] = time_ms(lambda: ref(*kargs, **kw), flush=flush)
        say(tag, card=card, kernel=name, mode="exact" if exact else "quantized",
            blocks=len(packs), max_abs_err=worst_abs, max_rel_err=worst_rel,
            timed_shape=json.dumps(shape), **timing, **bound)
        result[name] = (worst_abs, worst_rel, shape, bound, timing)
        del biggest, kargs, tables
    return result


# --------------------------------------------------- table codec, DRFS
def phase_drfs_codec(args, device, card):
    """The streaming index at ``[drfs]``'s configuration (the first 90 % of
    the events, ``drfs_depth=8``, ``auto_seal=False``, the same horizon),
    base epoch only, no inserts: the f64 fused answers in both modes, then
    for each executor ('fused', 'kernel') an engine with ``codec='f32'``
    (quantized and exact) and one with ``'bf16'`` (exact: the bf16 preset's
    leaf moments are float32, as under 'f32') swapped into the model, a cold
    and a warm query per mode with the launch counts set to 0 just before
    and read just after. The requirements of ``[main-codec]``, against the
    f64 answers at the same snapshot; the warm ``bytes_moved`` against the
    f64 engine's, which counts the same gathers at the same row bytes as
    the f64 packed executor. Then every block against the plain version and
    the largest timed (``[drfs-codec-shapes]``). Returns {(kernel, table
    dtype): dict(launches, secs, err, shapes)}."""
    from repro_torch.core import TNKDE
    from repro_torch.core.events import Events
    from repro_torch.core.rfs import FlatDynamicEngine
    from repro_torch.data.spatial import make_dataset

    def sync():
        if device != "cpu":
            torch.cuda.synchronize()

    t0 = time.perf_counter()
    net, ev, _ = make_dataset("berkeley", scale=args.scale, seed=args.seed)
    sel = np.argsort(ev.time, kind="stable")[: int(0.9 * ev.n)]
    t_min = float(ev.time.min())
    span = float(ev.time.max()) - t_min
    ts = [t_min + f * span for f in DRFS_FRACS]
    if device != "cpu":
        torch.cuda.reset_peak_memory_stats()
    m = TNKDE(net, Events(ev.edge_id[sel], ev.pos[sel], ev.time[sel]), g=50.0, b_s=800.0,
              b_t=0.2 * span, solution="drfs", engine="torch", executor="fused", drfs_depth=8,
              auto_seal=False, horizon_s=0.9 * span, device=device)
    f64_fe = m._fe
    F64, bytes64 = {}, {}
    for exact in (False, True):
        m.drfs_exact_leaf = exact
        F64[exact] = m.query(ts)
        b0 = f64_fe.counters["bytes_moved"]
        require(np.array_equal(m.query(ts), F64[exact]), "[drfs-codec] f64: warm != cold")
        bytes64[exact] = f64_fe.counters["bytes_moved"] - b0
    snap = m.snapshot()
    hq = snap.depth
    n_blocks = m._host_plan(snap).n_blocks
    say("drfs-codec", card=card, base_events=len(sel), epoch=list(m.epoch), blocks=n_blocks,
        f64_device_bytes=f64_fe.device_bytes, setup_s=round(time.perf_counter() - t0, 3))
    out = {}
    for executor in ("fused", "kernel"):
        for codec, modes in (("f32", (False, True)), ("bf16", (True,))):
            fe = FlatDynamicEngine(m.index, executor=executor, device=device, codec=codec)
            require(fe.codec.name == codec and fe.codec.fallback_reason is None,
                    f"[drfs-codec] {codec} fell back: {fe.codec.fallback_reason}")
            m._fe, m._counter_cursor = fe, {}
            for exact in modes:
                m.drfs_exact_leaf = exact
                kern = DRFS_KERNELS[executor][int(exact)]
                dtype = CODEC_DTYPES[codec] if exact else torch.float32  # the moment dtype
                dt = str(dtype).removeprefix("torch.")
                mode = "exact" if exact else "quantized"
                # ---- the path: counts set to 0 here, read right after the warm query
                reset_launches()
                t1 = time.perf_counter()
                F_cold = m.query(ts)
                sync()
                cold_s = time.perf_counter() - t1
                b0 = fe.counters["bytes_moved"]
                t1 = time.perf_counter()
                F = m.query(ts)
                sync()
                warm_s = time.perf_counter() - t1
                counts, by_dtype = read_launches(), read_launches_by_dtype()
                warm_bytes = fe.counters["bytes_moved"] - b0
                launches = counts.pop(kern)
                seg = take_segment(counts, f"drfs-codec-{executor}-{mode}-{codec}")
                require(not any(counts.values()), f"[drfs-codec] launched another kernel: {counts}")
                require(device == "cpu" or seg >= launches, f"[drfs-codec] segment_add {seg}")
                if device != "cpu":
                    require(by_dtype[kern][dt] == launches == 2 * n_blocks,
                            f"[drfs-codec] {executor} {codec} {mode}: {kern} launches "
                            f"{by_dtype[kern]} for {n_blocks} blocks")
                (tab,) = fe._tab_cache[(tuple(ts), snap.revision, snap.depth, hq, exact, codec)]
                require(tab.dtype == dtype, f"[drfs-codec] {mode} window table is {tab.dtype}")
                require(np.array_equal(F, F_cold), f"[drfs-codec] {codec} {mode}: warm != cold")
                require(np.array_equal(F[1], F[4]), f"[drfs-codec] {codec} {mode}: duplicate "
                        "window centres differ")
                err = float(np.abs(F - F64[exact]).max()) / float(np.abs(F64[exact]).max())
                require(0.0 < err <= CODEC_TOL[codec], f"[drfs-codec] {codec} {mode} vs f64: {err}")
                ratio = warm_bytes / bytes64[exact]
                require(0.0 < ratio <= BYTES_GATE,
                        f"[drfs-codec] {codec} {mode} warm bytes_moved ratio {ratio}")
                say("drfs-codec", card=card, executor=executor, codec=codec, mode=mode,
                    table_dtype=dt, kernel=kern, launches=launches, codec_vs_f64=err,
                    tol=CODEC_TOL[codec], warm_bytes_moved=warm_bytes, bytes_vs_f64=ratio,
                    window_table_bytes=table_bytes(tab), device_bytes=fe.device_bytes,
                    cold_s=round(cold_s, 4), warm_s=round(warm_s, 4))
                out[kern, dt] = dict(launches=launches, err=err, codec=codec,
                                     secs=dict(cold_s=cold_s, warm_s=warm_s))
                del tab
            shapes = phase_drfs_shapes(m, ts, device, card, executor=executor,
                                       tag="drfs-codec-shapes", modes=modes)
            for kern, res in shapes.items():
                out[kern, res[2]["table_dtype"]]["shapes"] = res
            m._fe, m._counter_cursor = f64_fe, {}
            del fe
            free(device)
    peak = torch.cuda.max_memory_allocated() if device != "cpu" else None
    say("drfs-codec", card=card, max_memory_allocated=peak,
        seconds=round(time.perf_counter() - t0, 1))
    return out


# ------------------------------------------------------------ serve tier
# The serve phases run the server's defaults (window_cap 16: a flush
# coalesces up to 16 distinct centres; 32 slots). Their counts are cut to
# their time budget (120 s on the card for the three). At berkeley x1.0 a
# model takes ~6 s to build, each epoch ~6 s of host planning per model and
# ~3 s for its first flush (the epoch's atom packs), a quantized flush
# 0.02-0.1 s on a sealed epoch and ~0.5 s with 1 % of the events pending
# (~1.7 s with 5 %), an exact flush ~1-2.5 s whatever its width, and a
# compaction ~10 s per model (tools/serve_costs.py; PERF.md §5). So the
# phases serve the first two epochs of the mix (an insert of 1 % between),
# the exact profile takes every SERVE_EXACT_EVERY-th query of the first
# epoch, and [serve]/[serve-durable] compact nothing: background compaction
# between batches runs in [serve-router] (berkeley x0.1), the single
# server's and the router's own.
SERVE_REQUESTS = 48  # queries served: the first two epochs of the mix
SERVE_EVERY = 24  # the mix inserts the next 1 % of the events after every 24 queries
SERVE_MIX_INSERTS = 10  # the mix spreads the held-back 10 % over 10 inserts
SERVE_WINDOWS = 3  # each query asks for 1..3 window centres
SERVE_EXACT_EVERY = 8  # the exact profile takes queries 0, 8, 16 (first epoch); quantized all
SERVE_CRASH = SERVE_EVERY + 1  # [serve-durable]'s server stops after the insert
SERVE_KILL = 12  # [serve-router] kills replica 1 once this many queries are admitted
SERVE_ROUTER_SCALE = 0.1  # [serve-router]'s berkeley scale: x1.0 does not fit the budget
SERVE_PROFILES = dict(quantized=False, exact=True)  # profile -> drfs_exact_leaf


def serve_world(args, scale=None):
    """``[drfs]``'s world and profile: berkeley, the first 90 % of the events
    (by time) as the base index, the held-back 10 % as the stream of the
    serve mix (``make_request_mix``: queries of 1..3 centres inside
    [t_min + 0.2 span, t_min + 0.8 span], an insert of the next tenth of the
    stream after every SERVE_EVERY), of which the first SERVE_REQUESTS
    queries and the inserts between them are served."""
    from repro_torch.core.events import Events
    from repro_torch.data.spatial import make_dataset
    from repro_torch.serve import QueryItem, make_request_mix

    net, ev, _ = make_dataset("berkeley", scale=args.scale if scale is None else scale,
                              seed=args.seed)
    order = np.argsort(ev.time, kind="stable")
    n_base = int(0.9 * ev.n)

    def part(sel):
        return Events(ev.edge_id[sel], ev.pos[sel], ev.time[sel])

    t_min = float(ev.time.min())
    span = float(ev.time.max()) - t_min
    prof = dict(g=50.0, b_s=800.0, b_t=0.2 * span, solution="drfs", engine="torch",
                executor="fused", drfs_depth=8, auto_seal=False, horizon_s=0.9 * span)
    mix = make_request_mix(part(order[n_base:]), t_min + 0.2 * span, t_min + 0.8 * span,
                           n_requests=SERVE_EVERY * SERVE_MIX_INSERTS, stream_every=SERVE_EVERY,
                           max_windows=SERVE_WINDOWS, seed=args.seed + 17)
    mix = mix[:SERVE_REQUESTS + (SERVE_REQUESTS - 1) // SERVE_EVERY]
    require(isinstance(mix[-1], QueryItem), "the served mix ends on an insert")
    return net, part(order[:n_base]), prof, mix


def serve_profiles(prof, names=tuple(SERVE_PROFILES)):
    from repro_torch.serve import ProfileConfig

    return {n: ProfileConfig(drfs_exact_leaf=SERVE_PROFILES[n], **prof) for n in names}


def serve_route(profiles):
    """The profiles query ``q`` (its index among the mix's queries) goes to:
    all for one profile; with the exact profile, every SERVE_EXACT_EVERY-th
    query of the first epoch to it as well."""
    def route(q):
        return [n for n in profiles
                if n != "exact" or (q % SERVE_EXACT_EVERY == 0 and q < SERVE_EVERY)]
    return route


def serve_drive(server, mix, items, route, *, on_submit=None, on_insert=None, on_item=None):
    """Drive ``mix[i] for i in items`` through ``server`` (a TNKDEServer or a
    ReplicaRouter): each query goes to the profiles ``route`` names (tag
    ``(profile, i)``), full flushes are pumped as they fill, and before an
    insert every admitted request is answered — so each epoch's host plan is
    built over exactly that epoch's events. ``on_item(i)`` runs after item
    i. Returns ({tag: Response}, {tag: seconds from admission to answer})."""
    from repro_torch.serve import InsertItem

    out, t_sub, lat = {}, {}, {}

    def handle(rs):
        t = time.perf_counter()
        for r in rs:
            require(r.tag not in out, f"two responses for {r.tag}")
            out[r.tag], lat[r.tag] = r, t - t_sub[r.tag]

    def drain():
        while server.n_queued:
            handle(server.pump(force=True))

    for i in items:
        item = mix[i]
        if isinstance(item, InsertItem):
            drain()
            server.insert(item.events)
            if on_insert is not None:
                on_insert(item.events)
        else:
            q = sum(1 for it in mix[:i] if not isinstance(it, InsertItem))
            for name in route(q):
                t_sub[(name, i)] = time.perf_counter()
                server.submit(item.ts, profile=name, tag=(name, i))
                if on_submit is not None:
                    on_submit(name, i)
                if server.has_ready_batch:
                    handle(server.pump(force=False))
        if on_item is not None:
            on_item(i)
    drain()
    return out, lat


def serve_sync_guard(model, counter):
    """Run ``model.dispatch`` under ``torch.cuda.set_sync_debug_mode('warn')``
    and count the warnings: a dispatch that waits for the card (``.item()``,
    ``.cpu()``, ``nonzero``, a blocking copy, ``bool()`` of a device tensor)
    would stall the double-buffered pipeline."""
    import warnings

    inner = model.dispatch

    def dispatch(ts, **kw):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                return inner(ts, **kw)
            finally:
                torch.cuda.set_sync_debug_mode("default")
                hits = [str(w.message) for w in caught
                        if "called a synchronizing CUDA operation" in str(w.message)]
                counter["dispatches"] += 1
                counter["syncs"] += len(hits)
                if hits and "first" not in counter:
                    counter["first"] = hits[0][:200]

    model.dispatch = dispatch


def serve_record(models, flushes, blocks=None):
    """Record ``(profile, pinned epoch, centres)`` of every engine pass of
    ``models`` ({profile: TNKDE}) in ``flushes``; with ``blocks``, add the
    pass's atom blocks (one kernel launch each) to ``blocks[profile]``."""
    for name, m in models.items():
        def dispatch(ts, *, at=None, _m=m, _name=name, _inner=m.dispatch):
            pq = _inner(ts, at=at)
            if blocks is not None:
                blocks[_name] += _m._host_plan(at).n_blocks
            flushes.append((_name, at.epoch, tuple(ts)))
            return pq

        m.dispatch = dispatch


def serve_replay(flushes, query, pins):
    """``{(profile, epoch, centre): row}``: every recorded pass evaluated
    again by ``query(profile, centres, snapshot)`` at ``pins[(profile,
    epoch)]``, with the same centres in the same order."""
    rows = {}
    for name, epoch, ts in flushes:
        F = query(name, list(ts), pins[(name, epoch)])
        for j, c in enumerate(ts):
            rows.setdefault((name, epoch, c), F[j])
    return rows


def serve_check(tag, resp, mix, rows, epochs=None):
    """Every response ok and each of its rows bitwise equal to the replayed
    pass that computed it, at its pinned epoch (with ``epochs``: the epoch
    ``[serve]`` pinned for the same request)."""
    for k, r in sorted(resp.items()):
        require(r.ok, f"[{tag}] {k} failed: {r.error}")
        e = tuple(r.stats.epoch)
        if epochs is not None:
            require(e == tuple(epochs[k]), f"[{tag}] {k} pinned {e}, [serve] {epochs[k]}")
        want = np.stack([rows[(k[0], e, float(c))] for c in mix[k[1]].ts])
        require(np.array_equal(r.heat, want), f"[{tag}] {k} differs from the reference: "
                f"{float(np.abs(r.heat - want).max())}")
    return len(resp)


def serve_widths(flushes):
    """{profile: [W of each engine pass, in order]} — how many distinct
    centres each flush coalesced."""
    out = {}
    for name, _, ts in flushes:
        out.setdefault(name, []).append(len(ts))
    return out


def phase_serve(args, device, card, tmp):
    """The serve tier at full width: ``TNKDEServer`` with two profiles on
    ``[drfs]``'s parameters — quantized (``fused_leaf``) and exact
    (``fused_walk``) — and the server's defaults (window_cap 16, 32 slots)
    over the base index, ``warmup()``, a checkpoint and a
    ``WriteAheadLog`` under ``tmp``, then the serve mix: SERVE_EVERY queries
    coalesced into flushes of up to 16 centres, an insert of 5 %, SERVE_EVERY
    more; after SERVE_CRASH items the log directory is copied as a crash
    would leave it (``[serve-durable]`` restores that copy) and the server
    runs on as the uninterrupted run. Compaction is off here (x1.0 costs
    ~10 s per model; ``[serve-router]`` runs it).

    Every answer is held bitwise against a standalone ``TNKDE`` on the
    profiles' parameters, fed the same inserts and queried at the response's
    pinned snapshot in the response's mode (one model answers both, as in
    ``[drfs]``: ``drfs_exact_leaf`` is read per query) with the centres of
    the server's flush that computed it, cold then warm (bitwise equal); the
    exact profile also against the SPS oracle over that snapshot's events.
    The standalone model takes the server's host plans of the same epochs
    (one per epoch: the plan does not depend on the mode; ~6 s each at
    x1.0), so what it checks is the device path and the serve tier. The
    flush's centres, not the request's own; ``width_bits`` (a centre of a
    wider flush answered alone against the flush) must be 0.0: every flush
    ends in the fixed-order scatter (``ops.segment_add``), whose sums do not
    depend on the flush's width."""
    import shutil

    from repro_torch.core import TNKDE, WriteAheadLog
    from repro_torch.core.events import Events, group_events_by_edge
    from repro_torch.serve import TNKDEServer, jit_entries

    t0 = time.perf_counter()
    net, base, prof, mix = serve_world(args)
    profiles = serve_profiles(prof)
    route = serve_route(profiles)
    srv = TNKDEServer(net, base, profiles, device=device, auto_compact=False)
    standalone = TNKDE(net, base, device=device, **profiles["quantized"].to_kwargs())

    def oracle_query(name, ts, at):
        standalone.drfs_exact_leaf = SERVE_PROFILES[name]
        return standalone.query(ts, at=at)

    for n, m in srv.models.items():
        require(m.engine_desc == "torch/fused", f"[serve] {n}: {m.engine_desc}")
    require(srv.degrade_after is None or device == "cpu",
            f"[serve] the ladder is on: degrade_after={srv.degrade_after}")
    build_s = time.perf_counter() - t0
    warm_s = {}
    for name in profiles:
        t1 = time.perf_counter()
        w = srv.warmup(profiles=[name])
        if device != "cpu":
            torch.cuda.synchronize()
        warm_s[name] = round(time.perf_counter() - t1, 3)
    lib0 = jit_entries()
    t1 = time.perf_counter()
    srv.attach_wal(WriteAheadLog(os.path.join(tmp, "wal")))
    step = srv.checkpoint(os.path.join(tmp, "ckpt"))
    ckpt_s = time.perf_counter() - t1
    n_q = sum(1 for it in mix if hasattr(it, "ts"))
    say("serve", card=card, profiles=",".join(profiles), base_events=base.n,
        stream_events=sum(it.events.n for it in mix if hasattr(it, "events")), queries=n_q,
        exact_every=SERVE_EXACT_EVERY, inserts=len(mix) - n_q, window_cap=srv.window_cap,
        slots=srv.continuous.scheduler.n_slots, auto_compact=srv.auto_compact,
        degrade_after=srv.degrade_after, window_classes=json.dumps(w["window_classes"]),
        libraries_after_warmup=lib0, build_s=round(build_s, 3), warmup_s=json.dumps(warm_s),
        checkpoint_step=step, checkpoint_s=round(ckpt_s, 3))
    syncs = dict(dispatches=0, syncs=0)
    if device != "cpu":
        for m in srv.models.values():
            serve_sync_guard(m, syncs)
    pins, srv_pins = {}, {}  # (profile, epoch) -> the standalone's / the server's snapshot

    def on_submit(name, i):
        e = srv.models[name].epoch
        require(standalone.epoch == e, "standalone epoch ladder")
        pins.setdefault((name, e), standalone.snapshot())
        srv_pins.setdefault((name, e), srv.models[name].snapshot())

    def on_item(i):
        if i == SERVE_CRASH - 1:  # what a crash here leaves on disk
            shutil.copytree(os.path.join(tmp, "wal"), os.path.join(tmp, "crash-wal"))

    blocks = dict.fromkeys(profiles, 0)
    flushes = []  # (profile, pinned epoch, centres) of every engine pass
    serve_record(srv.models, flushes, blocks)
    reset_launches()
    t1 = time.perf_counter()
    resp, lat = serve_drive(srv, mix, range(len(mix)), route, on_submit=on_submit,
                            on_insert=standalone.insert, on_item=on_item)
    if device != "cpu":
        torch.cuda.synchronize()
    serve_s = time.perf_counter() - t1
    launches = read_launches()
    seg = take_segment(dict(launches), "serve")
    lib1 = jit_entries()
    for m in srv.models.values():
        del m.dispatch  # the class's dispatch again: no recording from here on
    st = srv.stats
    require(st.n_engine_faults == 0 and st.n_degradations == 0 and st.n_errors == 0,
            f"[serve] faults {st.n_engine_faults}, degradations {st.n_degradations}, "
            f"errors {st.n_errors}")
    for n, m in srv.models.items():
        require(m.engine_desc == "torch/fused", f"[serve] {n} left the fused executor: "
                f"{m.engine_desc}")
    require(lib1 == lib0, f"[serve] loaded {lib1 - lib0} CUDA libraries after warmup()")
    widths = serve_widths(flushes)
    require(max(widths["quantized"]) > 1, f"[serve] no flush coalesced centres: {widths}")
    if device != "cpu":
        require(launches["fused_leaf"] == blocks["quantized"] > 0
                and launches["fused_walk"] == blocks["exact"] > 0
                and sum(launches.values()) - seg == blocks["quantized"] + blocks["exact"]
                and seg >= blocks["quantized"] + blocks["exact"],
                f"[serve] launches {launches} for blocks {blocks}")
        require(syncs["syncs"] == 0,
                f"[serve] dispatch synchronised with the card {syncs['syncs']} times in "
                f"{syncs['dispatches']} dispatches: {syncs.get('first')}")
    # ---- held against the standalone model (its launches not counted)
    t1 = time.perf_counter()
    qm = srv.models["quantized"]
    for key in sorted({(e, False) for _, e in pins}):
        require(qm._plan_cache.get(key) is not None, f"[serve] no server plan for {key}")
        standalone._plan_cache.put(key, qm._plan_cache.get(key))
    rows = serve_replay(flushes, oracle_query, pins)
    n_checked = serve_check("serve", resp, mix, rows)
    width_bits = None
    for name, epoch in sorted(pins):
        ts = [f[2] for f in flushes if f[:2] == (name, epoch)][-1]
        if epoch == max(e for n, e in pins if n == name):
            # cold == warm at the profile's last epoch (the quantized one has
            # pending events), on the card's scatter order (ROADMAP Queue C
            # item 1)
            require(np.array_equal(oracle_query(name, list(ts), pins[(name, epoch)]),
                                   np.stack([rows[(name, epoch, c)] for c in ts])),
                    f"[serve] {name} at {epoch}: warm query differs from cold")
        if width_bits is None and name == "quantized" and len(ts) > 1:
            F1 = oracle_query(name, [ts[0]], pins[(name, epoch)])  # the same centre alone
            width_bits = float(np.abs(F1[0] - rows[(name, epoch, ts[0])]).max())
    # the fixed-order scatter: a centre answered alone is bitwise the same
    # centre in a wider flush (ROADMAP Queue C item 1, closed)
    require(width_bits == 0.0, f"[serve] a centre alone differs from its flush by {width_bits}")
    tag = max(k for k in resp if k[0] == "exact")  # the last exact answer vs SPS
    e_, p_, t_ = pins[("exact", tuple(resp[tag].stats.epoch))].event_set()
    ee = group_events_by_edge(net, Events(e_, p_, t_))
    ids, F_sps = sps_sample(standalone, list(mix[tag[1]].ts), SPS_EDGES, args.seed + 13, ee=ee)
    require(len(ids) >= 64, f"SPS sample too small: {len(ids)} lixels")
    F = resp[tag].heat
    worst_sps = float(np.abs(F[:, ids] - F_sps).max()) / float(np.abs(F).max())
    require(worst_sps <= SPS_TOL, f"[serve] exact vs sps {worst_sps}")
    check_s = time.perf_counter() - t1
    lat_ms = np.array(list(lat.values())) * 1e3
    say("serve", card=card, requests=st.n_requests, flushes=st.n_flushes,
        engine_flushes=len(flushes), flush_widths=json.dumps(widths), batches=st.n_batches,
        occupancy=round(st.batch_occupancy, 4), windows_requested=st.n_windows_requested,
        windows_evaluated=st.n_windows_evaluated, rows_computed=st.n_rows_computed,
        epochs=json.dumps(sorted({e for _, e in pins})),
        run_p50_ms=round(float(np.percentile(lat_ms, 50)), 3),
        run_p95_ms=round(float(np.percentile(lat_ms, 95)), 3), serve_s=round(serve_s, 3),
        launches=json.dumps({k: launches[k] for k in ("fused_leaf", "fused_walk")}),
        blocks=json.dumps(blocks), libraries_added=lib1 - lib0,
        dispatch_syncs=syncs["syncs"] if device != "cpu" else None,
        standalone_equal=f"bitwise_{n_checked}", width_bits=width_bits,
        exact_vs_sps=worst_sps, check_s=round(check_s, 3))
    del standalone
    free(device)
    # ---- both kernels at the shapes the serve flushes gave them: the last
    # pass of each profile (its window table is still cached)
    shapes = {}
    for name, exact in SERVE_PROFILES.items():
        ts = [f[2] for f in flushes if f[0] == name][-1]
        shapes.update(phase_drfs_shapes(srv.models[name], list(ts), device, card,
                                        tag="serve-shapes", modes=(exact,)))
    epochs = {k: r.stats.epoch for k, r in resp.items() if k[0] == "quantized"}
    qpins = {k: p for k, p in srv_pins.items() if k[0] == "quantized"}
    srv._wal.close()
    del srv
    free(device)
    say("serve", seconds=round(time.perf_counter() - t0, 1))
    # the quantized model of the uninterrupted run, with its pinned snapshots,
    # is the reference of [serve-durable]
    return (qm, qpins, epochs), launches, shapes


def phase_serve_durable(args, device, card, ref, tmp):
    """Crash recovery of the quantized profile: the write-ahead log as
    ``[serve]``'s server left it after SERVE_CRASH items of the mix (nothing
    closed: the log is fsync'd per record) and its checkpoint; a fresh
    server over the same base events runs ``restore(ckpt, wal=...)`` and
    serves the rest of the mix. The recovered epoch, every answer's pinned
    epoch and every answer must equal the uninterrupted ``[serve]`` run's:
    its quantized model (``ref``), queried at its own pinned snapshot with
    the centres of the flush that computed the answer, bitwise. The kernel
    is then held against its plain version at the shapes of this run's
    last flush."""
    from repro_torch.core import WriteAheadLog
    from repro_torch.serve import TNKDEServer

    qm, qpins, epochs = ref
    t0 = time.perf_counter()
    net, base, prof, mix = serve_world(args)
    profiles = serve_profiles(prof, ("quantized",))
    fresh = TNKDEServer(net, base, profiles, device=device, auto_compact=False)
    build_s = time.perf_counter() - t0
    rep = fresh.restore(os.path.join(tmp, "ckpt"), wal=WriteAheadLog(os.path.join(tmp, "crash-wal")))
    crash = [k for k in epochs if k[1] >= SERVE_CRASH]
    require(fresh.models["quantized"].epoch == tuple(epochs[min(crash)]),
            f"recovered epoch {fresh.models['quantized'].epoch} != {epochs[min(crash)]}")
    require(rep.restored_step is not None and rep.n_records >= 1, f"recovery: {rep.as_dict()}")
    flushes = []
    serve_record(fresh.models, flushes)
    reset_launches()
    got, _ = serve_drive(fresh, mix, range(SERVE_CRASH, len(mix)), serve_route(profiles))
    if device != "cpu":
        torch.cuda.synchronize()
    launches = read_launches()
    seg = take_segment(launches, "serve-durable")
    require(set(got) == set(crash), f"[serve-durable] answered {sorted(got)}")
    require(fresh.stats.n_engine_faults == 0 and fresh.stats.n_degradations == 0,
            "[serve-durable] faults or degradations")
    if device != "cpu":
        require(launches["fused_leaf"] > 0 and sum(launches.values()) == launches["fused_leaf"]
                and seg >= launches["fused_leaf"],
                f"[serve-durable] launches {launches}, segment_add {seg}")
    fm = fresh.models["quantized"]
    shapes = phase_drfs_shapes(fm, list(flushes[-1][2]), device, card,
                               tag="serve-durable-shapes", modes=(False,))
    epoch = fm.epoch
    del fresh, fm
    free(device)
    rows = serve_replay(flushes, lambda name, ts, at: qm.query(ts, at=at), qpins)
    n = serve_check("serve-durable", got, mix, rows, epochs)
    say("serve-durable", card=card, restored_step=rep.restored_step,
        crash_after_items=SERVE_CRASH, epoch=list(epoch), build_s=round(build_s, 3),
        restore_seconds=round(rep.restore_seconds, 3), replay_seconds=round(rep.replay_seconds, 3),
        records=rep.n_records, events=rep.n_events, truncated_bytes=rep.n_truncated_bytes,
        answers_bitwise=n, flush_widths=json.dumps(serve_widths(flushes)),
        launches=launches["fused_leaf"], seconds=round(time.perf_counter() - t0, 1))
    return launches["fused_leaf"], shapes["fused_leaf"]


def phase_serve_router(args, device, card):
    """``ReplicaRouter`` with two replicas of the quantized profile on the
    card, at berkeley x``SERVE_ROUTER_SCALE`` (x1.0 does not fit the time
    budget), with background compaction on (the router's own, between
    batches): ``ft.faults.kill_replica`` takes replica 1 down once
    SERVE_KILL queries are admitted. Every answer — the failed-over ones
    included — must equal a single ``TNKDEServer`` (its own background
    compaction on) on the same world and mix, queried at its snapshot of the
    answer's pinned epoch with the centres of the flush that computed the
    answer, bitwise (two replicas give one answer: the card's scatter
    order, ROADMAP Queue C item 1), with at least one failover, at least one
    compaction on each side and the killed replica quarantined. The kernel
    is then held against its plain version at the shapes of the router's
    last flush."""
    from repro_torch.ft.faults import kill_replica
    from repro_torch.serve import ReplicaRouter, TNKDEServer

    t0 = time.perf_counter()
    scale = SERVE_ROUTER_SCALE * args.scale
    net, base, prof, mix = serve_world(args, scale=scale)
    profiles = serve_profiles(prof, ("quantized",))
    route = serve_route(profiles)
    single = TNKDEServer(net, base, profiles, device=device)
    sm = single.models["quantized"]
    pins = {}  # every epoch the single server's model passes through

    def pin(*_):
        pins.setdefault(("quantized", sm.epoch), sm.snapshot())

    inner = sm.compact

    def compact(t_now=None):
        out = inner(t_now)
        pin()
        return out

    sm.compact = compact
    want, _ = serve_drive(single, mix, range(len(mix)), route, on_submit=pin, on_insert=pin)
    del sm.compact
    require(all(r.ok for r in want.values()), "[serve-router] the single server failed")
    require(single.stats.n_compactions >= 1, "[serve-router] the single server never compacted")
    # the ladder is off on the card: the killed replica must be failed over
    # and quarantined, and any degradation fails the run
    router = ReplicaRouter(net, base, profiles, replicas=2, device=device)
    build_s = time.perf_counter() - t0
    flushes = []
    for s_ in router.servers:
        serve_record(s_.models, flushes)
    admitted = []

    def on_submit(name, i):
        admitted.append(i)
        if len(admitted) == SERVE_KILL:
            kill_replica(router.servers[1])

    reset_launches()
    got, lat = serve_drive(router, mix, range(len(mix)), route, on_submit=on_submit)
    if device != "cpu":
        torch.cuda.synchronize()
    launches = read_launches()
    seg = take_segment(launches, "serve-router")
    require(set(got) == set(want), f"[serve-router] answered {sorted(got)}")
    n = serve_check("serve-router", got, mix,
                    serve_replay(flushes, lambda name, ts, at: sm.query(ts, at=at), pins))
    sj = router.stats_json()
    require(router.n_failovers >= 1, f"[serve-router] no failover: {sj['ft_events']}")
    require(sj["n_degradations"] == 0, "[serve-router] a replica degraded")
    compactions = router.servers[0].stats.n_compactions  # the router's, on the live replica
    require(compactions >= 1, "[serve-router] the router never compacted")
    require(sj["health"][1] == "quarantined" and sj["health"][0] == "healthy",
            f"[serve-router] health {sj['health']}")
    if device != "cpu":
        require(launches["fused_leaf"] > 0 and sum(launches.values()) == launches["fused_leaf"]
                and seg >= launches["fused_leaf"],
                f"[serve-router] launches {launches}, segment_add {seg}")
    rm = router.servers[0].models["quantized"]
    require(rm.epoch == sm.epoch, f"[serve-router] replica at {rm.epoch}, single at {sm.epoch}")
    shapes = phase_drfs_shapes(rm, list(flushes[-1][2]), device, card,
                               tag="serve-router-shapes", modes=(False,))
    lat_ms = np.array(list(lat.values())) * 1e3
    say("serve-router", card=card, replicas=2, killed=1, scale=scale,
        cut=f"berkeley_x{scale}_(x1.0_over_the_120_s_budget)",
        edges=net.n_edges, base_events=base.n, health=json.dumps(sj["health"]),
        failovers=router.n_failovers, quarantines=router.n_quarantines,
        compactions=compactions, single_compactions=single.stats.n_compactions,
        epochs=json.dumps(sorted({e for _, e in pins})),
        engine_faults=sj["n_engine_faults"], answers_bitwise=n, launches=launches["fused_leaf"],
        flush_widths=json.dumps(serve_widths(flushes)), build_s=round(build_s, 3),
        run_p50_ms=round(float(np.percentile(lat_ms, 50)), 3),
        run_p95_ms=round(float(np.percentile(lat_ms, 95)), 3),
        seconds=round(time.perf_counter() - t0, 1))
    del router, single, sm, rm, pins
    free(device)
    return launches["fused_leaf"], shapes["fused_leaf"]


def minplus_case(M, K, N, dtype, device, seed):
    """Seeded distances in [0, 10) with +inf entries: a whole row of a, a
    whole column of b and scattered single entries of both."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 10, (M, K))
    b = rng.uniform(0, 10, (K, N))
    a[rng.integers(0, M, max(1, M // 7)), rng.integers(0, K, max(1, M // 7))] = np.inf
    b[rng.integers(0, K, max(1, N // 7)), rng.integers(0, N, max(1, N // 7))] = np.inf
    a[rng.integers(0, M), :] = np.inf
    b[:, rng.integers(0, N)] = np.inf
    t = lambda x: torch.as_tensor(x, device=device).to(dtype).contiguous()  # noqa: E731
    return t(a), t(b)


def minplus_bound(M, K, N, itemsize):
    """Least time of one (min, +) product: the larger of bytes/bandwidth (a,
    b read once, out written once) and operations/lane rate (an add and a
    min per (i, j, k), each one lane-operation of the f64 or f32 pipe).
    ``bound_ms_fma_rate`` is the count PR 14-16 used — the same operations
    against the FLOP rate, which counts an FMA as two and so halves the
    floor —, kept for reading old numbers only."""
    nbytes = (M * K + K * N + M * N) * itemsize
    ops_ = 2 * M * N * K
    rate = PEAK_F64_LANE_OPS if itemsize == 8 else PEAK_F32_LANE_OPS
    t_b, t_f = nbytes / PEAK_BYTES_PER_S, ops_ / rate
    old = max(t_b, ops_ / (2 * rate)) * 1e3
    return dict(bound_ms=max(t_b, t_f) * 1e3, bound_by="bytes" if t_b >= t_f else "operations",
                bytes=nbytes, ops=ops_, bound_ms_fma_rate=old)


def phase_minplus_kernels(device):
    """minplus_matmul vs its plain version, bitwise (torch.equal), float32
    and float64: one tile (``minplus.TILE``: 80 x 64, BK 16) and a tile ±1
    in M and N, K below BK, ragged K, M and N, in both of the kernel's
    staging forms (16-byte copies where K and N allow, one copy per element
    elsewhere; each form must be met in each type), and the [minplus]
    path's berkeley shape."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.minplus import TILE, minplus_vec

    big = 1576 if device != "cpu" else 100  # the rehearsal keeps the CPU small
    tm, tn, tk = TILE
    n = 0
    for dtype in (torch.float32, torch.float64):
        forms = set()
        for M, K, N in [(1, 1, 1), (65, 33, 17), (129, 257, 63), (tm - 1, tk - 1, tn + 1),
                        (tm, tk, tn), (tm + 1, tk + 1, tn - 1), (tm - 1, 4, tn + 4),
                        (tm + 1, 6, 2 * tn + 2), (2 * tm - 1, 20, 2 * tn - 4),
                        (2 * tm + 1, 16, 2 * tn + 1), (big, big, big)]:
            a, b = minplus_case(M, K, N, dtype, device, M * 7 + N)
            vec = minplus_vec(a, b)
            forms.add(vec)
            got = ops.minplus_matmul(a, b)
            if got.is_cuda:
                torch.cuda.synchronize()
            want = plain_version("minplus_matmul")(a, b)
            require(got.dtype == dtype and got.shape == want.shape, "minplus_matmul shape/dtype")
            require(torch.equal(got, want), f"minplus_matmul {M}x{K}x{N} {dtype}: not bitwise "
                    f"equal to its plain version")
            say("minplus-kernels", case=f"{M}x{K}x{N}:{str(dtype)[6:]}", vec=vec,
                bitwise_equal=True, inf_outputs=int(torch.isinf(want).sum()))
            n += 1
        require(forms == {True, False}, f"the {dtype} sweep misses a staging form: {forms}")
    return n


def hop_depth(predecessors: np.ndarray) -> np.ndarray:
    """Hop counts of shortest-path trees from their predecessor matrix
    (``scipy.sparse.csgraph.dijkstra(..., return_predecessors=True)``:
    ``[S, V]``, negative where there is no predecessor). 0 at each source and
    at every vertex the search did not reach. The largest entry is a number
    of Bellman-Ford rounds that reproduces every distance the search found."""
    pred = np.asarray(predecessors)
    rows = np.arange(pred.shape[0])[:, None]
    has = pred >= 0
    parent = np.where(has, pred, 0)
    depth = np.where(has, -1, 0)
    while (depth < 0).any():  # one tree level per pass
        up = depth[rows, parent]
        ready = (depth < 0) & (up >= 0)
        if not ready.any():
            raise ValueError("predecessor matrix has a cycle")
        depth[ready] = up[ready] + 1
    return depth


def phase_minplus(args, device, card):
    """All-pairs bounded distances of the berkeley network on the device:
    ``minplus_bellman_ford`` from every vertex, ``rounds`` = the deepest hop
    count of scipy's bounded-Dijkstra trees within the radius (so every
    distance Dijkstra finds is reached), held against
    ``endpoint_distance_rows`` (the SPS precomputation on the host)."""
    import scipy.sparse.csgraph as csgraph

    from repro_torch.core import shortest_path as sp
    from repro_torch.data.spatial import make_dataset
    from repro_torch.kernels import ops
    from repro_torch.kernels.minplus import TILE as MINPLUS_TILE
    from repro_torch.kernels.minplus import minplus_occupancy, minplus_vec

    net, _, _ = make_dataset("berkeley", scale=args.scale, seed=args.seed)
    V = net.n_vertices
    csr = sp.adjacency_csr(net)
    t1 = time.perf_counter()
    want = sp.endpoint_distance_rows(net, MINPLUS_RADIUS, adj=csr)
    scipy_s = time.perf_counter() - t1
    _, pred = csgraph.dijkstra(csr, directed=False, indices=np.arange(V), limit=MINPLUS_RADIUS,
                               return_predecessors=True)
    rounds = int(hop_depth(pred).max())
    adj = torch.as_tensor(net.dense_adjacency(), device=device)
    init = torch.full((V, V), float("inf"), dtype=torch.float64, device=device)
    init.fill_diagonal_(0.0)

    def sync():
        if device != "cpu":
            torch.cuda.synchronize()

    sync()
    # ---- the path: counts set to 0 here, read right after the call
    reset_launches()
    t1 = time.perf_counter()
    D = sp.minplus_bellman_ford(adj, init, rounds)
    sync()
    call_s = time.perf_counter() - t1
    counts = read_launches()
    launches = counts.pop("minplus_matmul")
    require(not any(counts.values()), f"[minplus] launched another kernel: {counts}")
    if device != "cpu":
        require(launches == rounds, f"minplus_matmul launches {launches} for {rounds} rounds")
    got = D.cpu().numpy()
    within = np.isfinite(want)
    err = np.abs(got[within] - want[within])
    rel = float((err / np.maximum(want[within], np.finfo(np.float64).tiny)).max())
    require(rel <= SP_TOL, f"[minplus] vs bounded Dijkstra: {rel}")
    require(bool((got[~within] > MINPLUS_RADIUS).all()),
            "[minplus] an entry Dijkstra leaves beyond the radius came out within it")
    shape = dict(M=V, K=V, N=V, dtype="float64")
    bound = minplus_bound(V, V, V, 8)
    timing = dict(ms=None, plain_ms=None)
    tm, tn, _ = MINPLUS_TILE
    waves = dict(blocks=-(-V // tm) * -(-V // tn), vec=minplus_vec(D, adj))
    if device != "cpu":
        occ = minplus_occupancy(torch.float64, waves["vec"], torch.cuda.current_device())
        require((occ["tile_m"], occ["tile_n"], occ["tile_k"]) == MINPLUS_TILE,
                f"minplus.TILE {MINPLUS_TILE} is not the compiled tile: {occ}")
        waves.update(blocks_per_sm=occ["blocks_per_sm"], sms=occ["sms"],
                     waves=waves["blocks"] / (occ["blocks_per_sm"] * occ["sms"]))
        buf = torch.empty_like(D)
        timing["ms"] = time_ms(lambda: ops.minplus_matmul(D, adj, out=buf))
        timing["plain_ms"] = time_ms(lambda: plain_version("minplus_matmul")(D, adj, out=buf),
                                     reps=3)
    say("minplus", card=card, vertices=V, edges=net.n_edges, radius=MINPLUS_RADIUS,
        rounds=rounds, launches=launches, entries_within_radius=int(within.sum()),
        vs_dijkstra_rel=rel, max_abs_err=float(err.max()), call_s=round(call_s, 4),
        scipy_host_s=round(scipy_s, 4), round_kernel_ms=timing["ms"],
        plain_ms=timing["plain_ms"], **bound, **waves)
    return launches, float(err.max()), rel, shape, bound, timing, waves


# ----------------------------------------------------------- LM serving path
LM_SHAPE = (4, 16, 2, 2048, 128)  # qwen2.5-3b prefill: B, H, Hkv, S, head_dim


def flash_case(B, H, Hkv, S, D, dtype, device, seed, layout="bhsd"):
    """Seeded standard-normal q, k, v; ``layout='bshd'`` makes them as the
    LM path does: [B, S, heads, D] tensors viewed as [B, heads, S, D]."""
    rng = np.random.default_rng(seed)
    out = []
    for heads in (H, Hkv, Hkv):
        shape = (B, S, heads, D) if layout == "bshd" else (B, heads, S, D)
        x = torch.as_tensor(rng.standard_normal(shape, dtype=np.float32), device=device)
        x = x.to(dtype)
        out.append(x.transpose(1, 2) if layout == "bshd" else x)
    return tuple(out)


def flash_bound(B, H, Hkv, S, D, itemsize, causal=True):
    """Least time of one attention call: the larger of bytes/bandwidth (q,
    k, v read once, out written once) and 4·B·H·S²·D FLOPs (halved when
    causal) over the bf16 dense tensor-core peak, where the bf16 kernel
    computes. The same FLOPs over the f32 CUDA-core peak (the f32 kernel's)
    ride beside it."""
    nbytes = (2 * B * H * S * D + 2 * B * Hkv * S * D) * itemsize
    flops = 4 * B * H * S * S * D // (2 if causal else 1)
    t_b, t_f = nbytes / PEAK_BYTES_PER_S, flops / PEAK_BF16_TC_FLOPS
    return dict(bound_ms=max(t_b, t_f) * 1e3, bound_by="bytes" if t_b >= t_f else "operations",
                bytes=nbytes, flops=flops, f32_cuda_core_bound_ms=flops / PEAK_F32_FLOPS * 1e3)


def phase_flash_kernels(device):
    """flash_attention vs its plain version: causal and not, rep = H/Hkv in
    {1, 2, 8}, S in {64, 128, 384, 2 048}; f32 at D in {16, 64, 128} (and
    the bf16 D = 32 and D = 256 extra cases), bf16 at every D in HEAD_DIMS;
    bf16 at the ragged S 1, 37 and 100 (D 128 and 256, both layouts); and
    the [lm] prefill's shape in its layout ([B, S, H, D] viewed as
    [B, H, S, D]), which is then timed against the plain version and, in
    turns in this call (kernel, SDPA, SDPA, kernel), against
    scaled_dot_product_attention: over runs of 10 back-to-back calls (``ms``,
    ``library_ms``) and one call a sample (``*_single_call``). Returns the
    worst (abs, rel) error, that shape, its bound and its times."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import HEAD_DIMS

    small = device == "cpu"  # the rehearsal keeps the CPU small
    seqs = (64, 128) if small else (64, 128, 384, 2048)
    cases = [(1, 2 * rep, 2, S, D, causal, dtype, "bhsd")
             for dtype, dims in ((torch.float32, (16, 64, 128)), (torch.bfloat16, HEAD_DIMS))
             for causal in (True, False) for rep in (1, 2, 8) for D in dims for S in seqs]
    cases += [(2, 4, 2, 128, 32, True, torch.bfloat16, "bhsd"),
              (1, 8, 1, 256, 256, True, torch.bfloat16, "bhsd")]
    # ragged S (not a multiple of the tile): partly out-of-bounds TMA boxes,
    # masked rows and keys
    cases += [(1, 4, 2, S, D, causal, torch.bfloat16, layout)
              for S in (1, 37, 100) for D in (128, 256) for causal in (True, False)
              for layout in ("bhsd", "bshd")]
    if not small:
        cases.append((*LM_SHAPE, True, torch.bfloat16, "bshd"))
    worst_abs = worst_rel = 0.0
    worst_dt = {}
    for i, (B, H, Hkv, S, D, causal, dtype, layout) in enumerate(cases):
        q, k, v = flash_case(B, H, Hkv, S, D, dtype, device, i, layout)
        got = ops.flash_attention(q, k, v, causal=causal)
        if got.is_cuda:
            torch.cuda.synchronize()
        want = plain_version("flash_attention")(q, k, v, causal=causal)
        require(got.shape == want.shape and got.dtype == dtype, "flash_attention shape/dtype")
        require(bool(torch.isfinite(got).all()), "flash_attention produced non-finite values")
        abs_err = float((got.float() - want.float()).abs().max())
        rel = abs_err / float(want.float().abs().max())
        if layout == "bshd" or S == 2048 or D > 128 or S % 64 or i % 8 == 0:
            say("flash-kernels", case=f"B{B}:H{H}:Hkv{Hkv}:S{S}:D{D}:{str(dtype)[6:]}:"
                f"{'causal' if causal else 'full'}:{layout}", max_abs_err=abs_err,
                max_rel_err=rel)
        require(rel <= FLASH_TOL[dtype], f"flash_attention disagrees with its plain version "
                f"at {(B, H, Hkv, S, D, causal, dtype)}: {rel}")
        worst_abs, worst_rel = max(worst_abs, abs_err), max(worst_rel, rel)
        key = f"{str(dtype)[6:]}:D{D}"
        worst_dt[key] = max(worst_dt.get(key, 0.0), rel)
    say("flash-kernels", cases=len(cases), max_abs_err=worst_abs, max_rel_err=worst_rel,
        worst_rel_by_dtype_and_D=json.dumps(worst_dt),
        tol=json.dumps({str(k)[6:]: v for k, v in FLASH_TOL.items()}))
    _, _, shape, bound, timing = flash_timed(*LM_SHAPE, True, device)
    return worst_abs, worst_rel, shape, bound, timing


def flash_timed(B, H, Hkv, S, D, causal, device, seed=99):
    """The bf16 kernel at one path's shape, in the path's layout ([B, S, H,
    D] viewed as [B, H, S, D]): held against its plain version (FLASH_TOL),
    then timed against the plain version and, in turns in this call (kernel,
    SDPA, SDPA, kernel), against scaled_dot_product_attention: over runs of
    10 back-to-back calls (``ms``, ``library_ms``) and one call a sample
    (``*_single_call``). Returns (abs, rel, shape, bound, timing); the
    rehearsal takes no times, at one sequence of at most 128 tokens."""
    from repro_torch.kernels import ops

    if device == "cpu":
        B, S = 1, min(S, 128)
    q, k, v = flash_case(B, H, Hkv, S, D, torch.bfloat16, device, seed, "bshd")
    got = ops.flash_attention(q, k, v, causal=causal)
    if got.is_cuda:
        torch.cuda.synchronize()
    want = plain_version("flash_attention")(q, k, v, causal=causal)
    require(bool(torch.isfinite(got).all()), "flash_attention produced non-finite values")
    abs_err = float((got.float() - want.float()).abs().max())
    rel = abs_err / float(want.float().abs().max())
    require(rel <= FLASH_TOL[torch.bfloat16], f"flash_attention disagrees with its plain "
            f"version at {(B, H, Hkv, S, D, causal)}: {rel}")
    shape = dict(B=B, H=H, Hkv=Hkv, S=S, D=D, dtype="bfloat16", causal=causal, layout="bshd")
    bound = flash_bound(B, H, Hkv, S, D, 2, causal)
    timing = dict(ms=None, plain_ms=None, library_ms=None)
    if device != "cpu":
        sdpa = torch.nn.functional.scaled_dot_product_attention
        kern = lambda: ops.flash_attention(q, k, v, causal=causal)  # noqa: E731
        # the yardstick only, never on the path: one PyTorch call, same function
        lib = lambda: sdpa(q, k, v, is_causal=causal, enable_gqa=True)  # noqa: E731
        # 10 back-to-back calls a sample: the card's time, the host's launch
        # work overlapped. One call a sample: that plus the host's work the
        # card waits for when it is idle (for the kernel, the wrapper's checks
        # and three TMA maps), which every launch on an idle card pays
        for calls, tag in ((10, ""), (1, "_single_call")):
            turns = [time_samples(f, reps=20, calls=calls) for f in (kern, lib, lib, kern)]
            timing["ms" + tag] = float(np.median(turns[0] + turns[3]))
            timing["library_ms" + tag] = float(np.median(turns[1] + turns[2]))
            timing["turns_ms" + tag] = [float(np.median(t)) for t in turns]
        timing["plain_ms"] = time_ms(lambda: plain_version("flash_attention")(q, k, v,
                                                                             causal=causal))
    say("flash-kernels", timed_shape=json.dumps(shape), max_abs_err=abs_err, max_rel_err=rel,
        **timing, **bound)
    return abs_err, rel, shape, bound, timing


def _leaves(tree):
    for v in (tree.values() if isinstance(tree, dict) else tree):
        yield from (_leaves(v) if isinstance(v, (dict, list)) else (v,))


def phase_lm(args, device, card):
    """qwen2.5-3b at full width (not reduced; seeded weights on the card).
    bf16: 4 prompts of 2 048 tokens prefilled with attn_impl='kernel' (cold,
    then warm), one flash_attention launch per layer each, then 32 greedy
    decode steps from the padded cache. float32 (TF32 off), 2 sequences of
    2 048 tokens: the kernel against dense attention on each of the 36
    layers' real activations (lm_layerwise); then, on the first
    LM_CHECK_LAYERS layers at full width, (a) last-token prefill logits,
    'kernel' vs 'dense', and (b) prefill of 1 920 tokens + 128
    teacher-forced decode steps vs one forward over all 2 048 with
    'kernel'. The rehearsal runs the reduced miniature."""
    import dataclasses

    from repro_torch.configs import get_config, reduce_for_smoke
    from repro_torch.kernels import ops
    from repro_torch.models.registry import get_model
    from repro_torch.models.transformer import layer_params

    small = device == "cpu"
    cfg = get_config("qwen2.5-3b")
    if small:
        cfg = dataclasses.replace(reduce_for_smoke(cfg), param_dtype="bfloat16",
                                  compute_dtype="bfloat16")
    B, S, n_dec = (2, 128, 4) if small else (4, 2048, 32)
    rng = np.random.default_rng(args.seed)

    def sync():
        if not small:
            torch.cuda.synchronize()

    # ---- bf16 serving, the path: counts set to 0 before the first prefill,
    # read after the last decode step
    if not small:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = get_model(cfg)
    params = model.init(args.seed, device=device)
    sync()
    say("lm", card=card, arch=cfg.arch_id, layers=cfg.n_layers, d_model=cfg.d_model,
        heads=cfg.n_heads, kv_heads=cfg.n_kv, head_dim=cfg.hd, d_ff=cfg.d_ff, vocab=cfg.vocab,
        params=sum(t.numel() for t in _leaves(params)), dtype=cfg.param_dtype,
        init_s=round(time.perf_counter() - t0, 3))
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (B, S)), device=device)
    reset_launches()
    secs = {}
    for step in ("cold", "warm"):
        n0 = ops.flash_attention.launches
        t1 = time.perf_counter()
        logits, cache = model.prefill(params, {"tokens": toks}, attn_impl="kernel")
        sync()
        secs[f"prefill_{step}_s"] = time.perf_counter() - t1
        grew = ops.flash_attention.launches - n0
        if not small:
            require(grew == cfg.n_layers, f"prefill launched flash_attention {grew} times, "
                    f"not once per layer ({cfg.n_layers})")
    require(tuple(logits.shape) == (B, cfg.vocab) and bool(torch.isfinite(logits).all()),
            "[lm] prefill logits: shape or non-finite values")
    cache = {k: torch.nn.functional.pad(c, (0, 0, 0, 0, 0, n_dec)) for k, c in cache.items()}
    tok = torch.argmax(logits, -1)
    finite = torch.isfinite(logits).all()
    decoded = []
    t1 = time.perf_counter()
    for i in range(n_dec):
        logits, cache = model.decode_step(params, tok, cache, S + i)
        finite &= torch.isfinite(logits).all()
        tok = torch.argmax(logits, -1)
        decoded.append(tok)
    sync()
    secs["decode_s_per_step"] = (time.perf_counter() - t1) / n_dec
    counts = read_launches()
    if args.profile:  # after the counts are read: these launches are not the path's
        profile_call(lambda: model.prefill(params, {"tokens": toks}, attn_impl="kernel"),
                     f"{args.profile}.lm-prefill", f"warm prefill, {B} x {S} tokens", device)
        profile_call(lambda: model.decode_step(params, tok, cache, S + n_dec - 1),
                     f"{args.profile}.lm-decode", f"one decode step, batch {B}", device)
    launches = counts.pop("flash_attention")
    require(not any(counts.values()), f"[lm] launched another kernel: {counts}")
    if not small:
        require(launches == 2 * cfg.n_layers, f"[lm] flash_attention launches {launches}")
    require(bool(finite), "[lm] non-finite decode logits")
    peak = torch.cuda.max_memory_allocated() if not small else None
    say("lm", card=card, batch=B, prompt=S, decode_steps=n_dec, launches=launches,
        **{k: round(v, 4) for k, v in secs.items()}, max_memory_allocated=peak,
        last_logits_row0=[round(float(x), 4) for x in logits[0, :4]],
        last_logits_absmax=float(logits.float().abs().max()),
        decoded_row0=[int(t[0]) for t in decoded[:8]])
    del cache, logits
    free(device)
    peaks = lm_account_readings(model, params, toks, S, n_dec, small)
    say("lm", card=card, step="account-readings", **peaks)
    del params, model
    free(device)

    # ---- float32 at full width (TF32 off)
    cfg32 = dataclasses.replace(cfg, param_dtype="float32", compute_dtype="float32")
    t0 = time.perf_counter()
    params = get_model(cfg32).init(args.seed + 1, device=device)
    B2, P, T = (2, 96, 32) if small else (2, 1920, 128)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (B2, P + T)), device=device)
    layer, e2e = lm_layerwise(params, cfg32, toks)
    # (a), (b) end to end through the public entry points, depth cut to
    # LM_CHECK_LAYERS (the first layers of the same weights): at 36 layers
    # the random-weight model amplifies any difference of arithmetic past
    # every tolerance (e2e above)
    cfg_cut = dataclasses.replace(cfg32, n_layers=min(LM_CHECK_LAYERS, cfg.n_layers))
    cut = dict(params, layers=layer_params(params["layers"], slice(0, cfg_cut.n_layers)))
    model = get_model(cfg_cut)
    err_a = lm_kernel_vs_dense(model, cut, toks)
    require(err_a <= LM_TOL, f"[lm] f32 prefill, kernel vs dense: {err_a}")
    err_b = lm_decode_vs_forward(model, cut, toks, P, T)
    require(err_b <= LM_TOL, f"[lm] f32 prefill + decode vs forward: {err_b}")
    readings = lm_cut_readings(model, cut, cfg_cut, toks, P, T)
    say("lm", card=card, step="float32", batch=B2, tokens=P + T,
        layers_checked=cfg.n_layers, **{f"layerwise_{k}": v for k, v in layer.items()},
        **{f"e2e_{k}_layers{cfg.n_layers}": v for k, v in e2e.items()},
        check_layers=cfg_cut.n_layers, kernel_vs_dense_rel=err_a, prefill=P, decode_steps=T,
        prefill_decode_vs_forward_rel=err_b, tol=LM_TOL,
        seconds=round(time.perf_counter() - t0, 3))
    say("lm", card=card, step="float32-readings", check_layers=cfg_cut.n_layers, tol=LM_TOL,
        **readings)
    # the controls are held on the card only: on the CPU the TF32 switch does nothing
    for name in ("control_bf16_qk", "control_tf32") if not small else ():
        require(max(readings[f"{name}_kernel_vs_dense_rel"],
                    readings[f"{name}_decode_vs_forward_rel"]) > LM_TOL,
                f"[lm] the limit {LM_TOL} does not tell {name} from a sound run")
    del params, cut, model
    free(device)
    return launches, secs, dict(layerwise=layer, kernel_vs_dense=err_a, decode_vs_forward=err_b,
                                peak=peak, account_readings=peaks)


def lm_account_readings(model, params, toks, S, n_dec, small):
    """What ``[dryrun]``'s one-card check holds its [lm] accounts against,
    read after the path's counts and peak, with only the parameters live:
    the peak of one bf16 prefill (``attn_impl='kernel'``, cold cache) and of
    one decode step on the padded ``S + n_dec`` cache, and the FLOPs
    ``FlopCounterMode`` counts in a prefill with ``'dense'`` attention (the
    kernel's FLOPs are no aten op) and in that decode step."""
    from torch.utils.flop_counter import FlopCounterMode

    def peak_of(fn):
        if not small:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        out = fn()
        if not small:
            torch.cuda.synchronize()
        return out, (torch.cuda.max_memory_allocated() if not small else None)

    (logits, cache), peak_prefill = peak_of(
        lambda: model.prefill(params, {"tokens": toks}, attn_impl="kernel"))
    cache = {k: torch.nn.functional.pad(c, (0, 0, 0, 0, 0, n_dec)) for k, c in cache.items()}
    tok = torch.argmax(logits, -1)
    del logits
    _, peak_decode = peak_of(lambda: model.decode_step(params, tok, cache, S))
    with FlopCounterMode(display=False) as fc:
        model.decode_step(params, tok, cache, S)
    decode_flops = fc.get_total_flops()
    del cache
    with FlopCounterMode(display=False) as fc:
        model.prefill(params, {"tokens": toks}, attn_impl="dense")
    return dict(peak_prefill=peak_prefill, peak_decode=peak_decode,
                prefill_flops_dense=fc.get_total_flops(), decode_flops=decode_flops,
                cache_rows=S + n_dec)


def lm_kernel_vs_dense(model, params, toks):
    """(a): last-token prefill logits, 'kernel' against 'dense', relative to
    max|logit|."""
    lk, _ = model.prefill(params, {"tokens": toks}, attn_impl="kernel")
    ld, _ = model.prefill(params, {"tokens": toks}, attn_impl="dense")
    require(bool(torch.isfinite(lk).all()), "[lm] f32 kernel logits not finite")
    return float((lk - ld).abs().max()) / float(ld.abs().max())


def lm_decode_vs_forward(model, params, toks, P, T, impl="kernel"):
    """(b): prefill of P tokens with 'kernel', then T teacher-forced decode
    steps (the token at P + i written at P + i; the cache padded for them by
    ``launch.serve.pad_cache``), against one forward over all P + T tokens
    with ``impl`` at those positions, relative to max|logit|."""
    from repro_torch.launch.serve import pad_cache

    _, cache = model.prefill(params, {"tokens": toks[:, :P]}, attn_impl="kernel")
    cache = pad_cache(model.cfg, cache, P, T)
    dec = []
    for i in range(T):
        li, cache = model.decode_step(params, toks[:, P + i], cache, P + i)
        dec.append(li)
    ref = model.forward(params, {"tokens": toks}, attn_impl=impl)[0][:, P:]
    return float((torch.stack(dec, 1) - ref).abs().max()) / float(ref.abs().max())


def lm_cut_readings(model, params, cfg, toks, P, T):
    """What the [lm] limit is read against, at the cut depth. The model's
    own sensitivity: last-token logits under a 1e-7 relative change of the
    embeddings ('dense'). Where (b)'s difference comes from: per layer (the
    dense trunk's activations), decode_attention at every decoded position
    against the same attention in float64 on decode's own one-token q/k/v
    (out-projected, relative to max|out|), beside the kernel's error on the
    full-sequence rows; how far decode's one-row projections of q and k lie
    from the full sequence's at the same positions; (b) with 'dense' in
    place of the kernel in the forward; the forward's logits at (b)'s
    positions, 'kernel' against 'dense', and 'kernel' against itself with q
    moved by seeded relative noise of decode's size before the kernel. Two
    controls a sound run must not resemble: (a) and (b) with q and k rounded
    to bf16 before the kernel, and with TF32 matmuls."""
    from repro_torch.kernels import ops
    from repro_torch.models.attention import attention, decode_attention, qkv
    from repro_torch.models.common import rms_norm, rotary
    from repro_torch.models.mlp import mlp
    from repro_torch.models.transformer import layer_params

    out = {}
    ld, _ = model.prefill(params, {"tokens": toks}, attn_impl="dense")
    lp_, _ = model.prefill(dict(params, embed=params["embed"] * (1 + 1e-7)), {"tokens": toks},
                           attn_impl="dense")
    out["perturbed_embed_rel"] = float((lp_ - ld).abs().max()) / float(ld.abs().max())
    del ld, lp_
    out["decode_vs_forward_dense_rel"] = lm_decode_vs_forward(model, params, toks, P, T,
                                                              impl="dense")

    def forward_rows():  # the forward's logits at (b)'s positions, relative to them
        return model.forward(params, {"tokens": toks}, attn_impl="kernel")[0][:, P:]

    fk = forward_rows()
    fd = model.forward(params, {"tokens": toks}, attn_impl="dense")[0][:, P:]
    out["forward_kernel_vs_dense_rel"] = float((fk - fd).abs().max()) / float(fd.abs().max())
    del fd
    S = toks.shape[1]
    cos, sin = rotary(torch.arange(S, device=toks.device), cfg.hd, cfg.rope_theta)
    x = params["embed"][toks]
    for i in range(cfg.n_layers):
        lp = layer_params(params["layers"], i)
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        q, k, v = qkv(lp["attn"], h, cfg, (cos[None, :, None, :], sin[None, :, None, :]))
        wo = lp["attn"]["wo"].double().flatten(0, 1)
        full = ops.flash_attention(*(t.transpose(1, 2) for t in (q, k, v)), causal=True)
        exact = attention_f64(*(t.transpose(1, 2) for t in (q, k, v)))
        proj = lambda o: o[:, :, P:].transpose(1, 2).flatten(-2).double() @ wo  # noqa: E731
        top = float(proj(exact).abs().max())
        e_kernel = float((proj(full) - proj(exact)).abs().max()) / top
        e_dec = dq = dk = 0.0
        for t in range(P, S):
            rope_t = (cos[None, t:t + 1, None, :], sin[None, t:t + 1, None, :])
            ck, cv = k.clone(), v.clone()
            o_dec, _ = decode_attention(lp["attn"], h[:, t:t + 1], cfg, rope_t, ck, cv, t)
            q1, k1, _ = qkv(lp["attn"], h[:, t:t + 1], cfg, rope_t)  # as decode computed them
            e1 = attention_f64(q1.transpose(1, 2), ck[:, :t + 1].transpose(1, 2),
                               cv[:, :t + 1].transpose(1, 2), last_row=True)
            want = e1.transpose(1, 2).flatten(-2) @ wo
            e_dec = max(e_dec, float((o_dec.double() - want).abs().max()) / top)
            dq = max(dq, float((q1[:, 0] - q[:, t]).abs().max()) / float(q.abs().max()))
            dk = max(dk, float((k1[:, 0] - k[:, t]).abs().max()) / float(k.abs().max()))
        out.update({f"layer{i}_decode_vs_f64": e_dec, f"layer{i}_kernel_vs_f64": e_kernel,
                    f"layer{i}_decode_q_vs_full": dq, f"layer{i}_decode_k_vs_full": dk})
        del q, k, v, full, exact
        a, _ = attention(lp["attn"], h, cfg, (cos[None, :, None, :], sin[None, :, None, :]),
                         impl="dense")
        x = x + a
        x = x + mlp(lp["mlp"], rms_norm(x, lp["ln2"], cfg.norm_eps), cfg)
    del x, h, a

    kernel = ops.flash_attention

    def bf16_qk(q, k, v, **kw):
        return kernel(q.bfloat16().float(), k.bfloat16().float(), v, **kw)

    delta = max(out[f"layer{i}_decode_q_vs_full"] for i in range(cfg.n_layers))
    gen = torch.Generator(device=toks.device).manual_seed(0)

    def noisy_q(q, k, v, **kw):
        noise = torch.randn(q.shape, generator=gen, device=q.device, dtype=q.dtype)
        return kernel(q * (1 + delta * noise), k, v, **kw)

    # while a stand-in is ops.flash_attention, the kernel counts its launches there
    bf16_qk.launches = noisy_q.launches = 0
    try:  # q moved as far as decode's q lies from the forward's
        ops.flash_attention = noisy_q
        noisy = forward_rows()
    finally:
        ops.flash_attention = kernel
    out["q_noise_forward_rel"] = float((noisy - fk).abs().max()) / float(fk.abs().max())
    del noisy
    tf32 = torch.backends.cuda.matmul.allow_tf32
    for name in ("control_bf16_qk", "control_tf32"):
        try:
            if name == "control_bf16_qk":
                ops.flash_attention = bf16_qk
            else:
                torch.backends.cuda.matmul.allow_tf32 = True
            out[f"{name}_kernel_vs_dense_rel"] = lm_kernel_vs_dense(model, params, toks)
            out[f"{name}_decode_vs_forward_rel"] = lm_decode_vs_forward(model, params, toks, P, T)
        finally:
            ops.flash_attention = kernel
            torch.backends.cuda.matmul.allow_tf32 = tf32
    del fk
    return out


def attention_f64(q, k, v, last_row=False, causal=True):
    """Attention in float64 on [B, H, S, D] inputs (K/V heads expanded by
    index), causal unless asked otherwise: the exact yardstick of the
    per-layer check. With ``last_row`` the one query row ``q [B, H, 1, D]``
    sits at the last key."""
    B, H, S, D = q.shape
    rep = H // k.shape[1]
    kk, vv = (t.double().repeat_interleave(rep, dim=1) for t in (k, v))
    s = torch.matmul(q.double(), kk.transpose(-1, -2)) * D ** -0.5
    if causal and not last_row:
        s = s.masked_fill(~torch.ones((S, S), dtype=torch.bool, device=q.device).tril(),
                          float("-inf"))
    return torch.matmul(torch.softmax(s, dim=-1), vv)


def lm_layerwise(params, cfg, toks):
    """The kernel on every layer's real activations: a dense prefill trunk,
    layer by layer; at each layer the attention function of that layer's
    q, k, v (f32) through the kernel and through its plain f32 version, both
    against the same function in float64. Returns the worst per-layer
    ratio (kernel error / plain error, each relative to max|out|) with the
    worst errors, and — to show why the end-to-end checks cut depth — how
    far the last-token logits of the whole stack move (relative to
    max|logit|) between 'kernel' and 'dense', and under a 1e-7 relative
    perturbation of the embeddings with 'dense'."""
    from repro_torch.kernels import ops
    from repro_torch.models.attention import attention, qkv
    from repro_torch.models.common import rms_norm, rotary
    from repro_torch.models.mlp import mlp
    from repro_torch.models.registry import get_model
    from repro_torch.models.transformer import layer_params

    require(not cfg.embed_scale and cfg.family == "dense", "lm_layerwise: plain dense embedding")
    S = toks.shape[1]
    cos, sin = rotary(torch.arange(S, device=toks.device), cfg.hd, cfg.rope_theta)
    rope = (cos[None, :, None, :], sin[None, :, None, :])
    x = params["embed"][toks]
    worst = dict(ratio=0.0, kernel_vs_f64=0.0, plain_vs_f64=0.0, kernel_vs_plain=0.0)
    for i in range(cfg.n_layers):
        lp = layer_params(params["layers"], i)
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        q, k, v = (t.transpose(1, 2) for t in qkv(lp["attn"], h, cfg, rope))
        exact = attention_f64(q, k, v)
        scale = float(exact.abs().max())
        o_k = ops.flash_attention(q, k, v, causal=True)
        o_p = plain_version("flash_attention")(q, k, v, causal=True)
        e_k = float((o_k.double() - exact).abs().max()) / scale
        e_p = float((o_p.double() - exact).abs().max()) / scale
        require(e_k <= LAYER_ACCURACY * e_p + 1e-6,
                f"[lm] layer {i}: kernel {e_k} vs plain {e_p} from the f64 attention")
        for key, val in (("ratio", e_k / max(e_p, 1e-30)), ("kernel_vs_f64", e_k),
                         ("plain_vs_f64", e_p),
                         ("kernel_vs_plain", float((o_k - o_p).abs().max()) / scale)):
            worst[key] = max(worst[key], val)
        del q, k, v, exact, o_k, o_p
        a, _ = attention(lp["attn"], h, cfg, rope, impl="dense")
        x = x + a
        x = x + mlp(lp["mlp"], rms_norm(x, lp["ln2"], cfg.norm_eps), cfg)
    del x, h, a
    model = get_model(cfg)
    ld, _ = model.prefill(params, {"tokens": toks}, attn_impl="dense")
    lk, _ = model.prefill(params, {"tokens": toks}, attn_impl="kernel")
    lp_, _ = model.prefill(dict(params, embed=params["embed"] * (1 + 1e-7)), {"tokens": toks},
                           attn_impl="dense")
    top = float(ld.abs().max())
    return worst, dict(kernel_vs_dense_rel=float((lk - ld).abs().max()) / top,
                       perturbed_embed_rel=float((lp_ - ld).abs().max()) / top)


# ---------------------------------------------------- the other LM families
# [lm-moe], [lm-rwkv], [lm-hybrid], [lm-encdec], [lm-mrope]: each family at
# its published width with seeded weights, served in bf16 (a cold and a warm
# prefill with attn_impl='kernel', then LM_FAMILY_DECODE greedy steps), then
# checked in float32 (TF32 off) at the depth each phase names.
LM_FAMILY_DECODE = 32
# the flash kernel at each new path's own shape, [B, S, H, D] viewed as
# [B, H, S, D]: B, H, Hkv, S, D, causal
FAMILY_FLASH_SHAPES = {
    "lm-moe": (4, 16, 16, 2048, 128, True),  # olmoe-1b-7b prefill: MHA, rep 1
    "lm-encdec-encoder": (8, 6, 6, 1536, 64, False),  # whisper-tiny encoder: full
    "lm-encdec-decoder": (8, 6, 6, 384, 64, True),  # whisper-tiny decoder: causal
    "lm-mrope": (2, 64, 8, 2048, 128, True),  # qwen2-vl-72b prefill: 64/8 heads
}
MROPE_LAYERS = 4  # qwen2-vl-72b at full width is 1.76 GB a layer in bf16: 80 do not fit
MROPE_GRID = 32  # [lm-mrope]: a 32 x 32 patch image, then text
WHISPER_FRAMES = 1536  # the first multiple of 128 above Whisper's 1 500 (the kernel tiles S)
WHISPER_TOKENS = 384  # decoder tokens, within Whisper's 448 positions
HYBRID_CHECK_LAYERS = 5  # one (rec, rec, attn) period and recurrentgemma-9b's 2-layer tail
# [lm-encdec] f32 end to end at 1 encoder + 1 decoder layer: with the
# reference's init scales (attention logits up to ~400) the full 4 + 4 model
# moved its logits by 0.82 of max|logit| under a 1e-7 change of the frames
# on an H100 (the phase prints it each run), so it is cut as [lm] cuts
# qwen2.5-3b; the kernel is checked on all 8 layers' real activations
# (encdec_layerwise)
WHISPER_CHECK_LAYERS = 1
HYBRID_CHECK_STEPS = 64  # [lm-hybrid] f32 decode steps past the full window


def sync(device):
    if device != "cpu":
        torch.cuda.synchronize()


def timed(fn, device):
    """(fn(), seconds) with the card synchronised on both sides."""
    sync(device)
    t1 = time.perf_counter()
    out = fn()
    sync(device)
    return out, time.perf_counter() - t1


def family_config(arch, device, **overrides):
    """The published config, or its reduced miniature in bf16 for the
    rehearsal, with ``overrides``."""
    import dataclasses

    from repro_torch.configs import get_config, reduce_for_smoke

    cfg = get_config(arch)
    if device == "cpu":
        cfg = dataclasses.replace(reduce_for_smoke(cfg), param_dtype="bfloat16",
                                  compute_dtype="bfloat16")
    return dataclasses.replace(cfg, **overrides)


def f32_config(cfg, **overrides):
    import dataclasses

    return dataclasses.replace(cfg, param_dtype="float32", compute_dtype="float32", **overrides)


def seeded(shape, seed, device, dtype=torch.float32, scale=1.0):
    gen = torch.Generator(device=device).manual_seed(seed)
    return (torch.randn(shape, generator=gen, device=device) * scale).to(dtype)


def lm_family_bf16(args, device, card, tag, cfg, batch, per_prefill):
    """bf16 serving of ``cfg``: seeded weights on the device; a cold and a
    warm ``prefill(batch, attn_impl='kernel')``, each launching
    flash_attention exactly ``per_prefill`` times; LM_FAMILY_DECODE greedy
    decode steps from the cache ``launch.serve.pad_cache`` made room in. The
    counts are set to 0 before the first prefill and read after the last
    step: flash_attention is the only kernel. Prints the seconds and peak
    memory; returns (model, params, launches, secs, peak)."""
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import pad_cache
    from repro_torch.models.registry import get_model

    card_run = device != "cpu"
    if card_run:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = get_model(cfg)
    params = model.init(args.seed, device=device)
    sync(device)
    say(tag, card=card, arch=cfg.arch_id, family=cfg.family, layers=cfg.n_layers,
        d_model=cfg.d_model, heads=cfg.n_heads, kv_heads=cfg.n_kv, head_dim=cfg.hd,
        d_ff=cfg.d_ff, vocab=cfg.vocab, params=sum(t.numel() for t in _leaves(params)),
        dtype=cfg.param_dtype, init_s=round(time.perf_counter() - t0, 3))
    B, S = next(iter(batch.values())).shape[:2]
    reset_launches()
    secs = {}
    for step in ("cold", "warm"):
        n0 = ops.flash_attention.launches
        (logits, cache), secs[f"prefill_{step}_s"] = timed(
            lambda: model.prefill(params, batch, attn_impl="kernel"), device)
        grew = ops.flash_attention.launches - n0
        require(not card_run or grew == per_prefill, f"[{tag}] prefill launched "
                f"flash_attention {grew} times, not {per_prefill}")
    require(tuple(logits.shape) == (B, cfg.vocab) and bool(torch.isfinite(logits).all()),
            f"[{tag}] prefill logits: shape or non-finite values")
    cache = pad_cache(cfg, cache, S, LM_FAMILY_DECODE)
    tok = torch.argmax(logits, -1)
    finite = torch.isfinite(logits).all()
    decoded = []
    t1 = time.perf_counter()
    for i in range(LM_FAMILY_DECODE):
        logits, cache = model.decode_step(params, tok, cache, S + i)
        finite &= torch.isfinite(logits).all()
        tok = torch.argmax(logits, -1)
        decoded.append(tok)
    sync(device)
    secs["decode_s_per_step"] = (time.perf_counter() - t1) / LM_FAMILY_DECODE
    counts = read_launches()
    launches = counts.pop("flash_attention")
    require(not any(counts.values()), f"[{tag}] launched another kernel: {counts}")
    require(not card_run or launches == 2 * per_prefill,
            f"[{tag}] flash_attention launches {launches}, not {2 * per_prefill}")
    require(bool(finite), f"[{tag}] non-finite decode logits")
    if args.profile:  # after the counts are read: these launches are not the path's
        profile_call(lambda: model.prefill(params, batch, attn_impl="kernel"),
                     f"{args.profile}.{tag}-prefill", f"warm prefill, {B} x {S}", device)
        profile_call(lambda: model.decode_step(params, tok, cache, S + LM_FAMILY_DECODE - 1),
                     f"{args.profile}.{tag}-decode", f"one decode step, batch {B}", device)
    peak = torch.cuda.max_memory_allocated() if card_run else None
    say(tag, card=card, batch=B, prompt=S, decode_steps=LM_FAMILY_DECODE, launches=launches,
        **{k: round(v, 4) for k, v in secs.items()}, max_memory_allocated=peak,
        last_logits_absmax=float(logits.float().abs().max()),
        decoded_row0=[int(t[0]) for t in decoded[:8]])
    del cache, logits
    return model, params, launches, secs, peak


def lm_f32_checks(tag, card, model, params, toks, P, T, *, kernel=True, embeds=None):
    """The float32 checks of one family at the cut depth, relative to
    max|logit|: (a) last-token prefill logits, 'kernel' against 'dense'
    (on ``embeds`` = {embeds, mrope_pos} where given, else the tokens),
    where the family runs the kernel; (b) prefill of P tokens + T
    teacher-forced decode steps against one forward over P + T tokens."""
    out = {}
    if kernel:
        if embeds is None:
            out["kernel_vs_dense_rel"] = lm_kernel_vs_dense(model, params, toks)
        else:
            lk, _ = model.prefill(params, embeds, attn_impl="kernel")
            ld, _ = model.prefill(params, embeds, attn_impl="dense")
            require(bool(torch.isfinite(lk).all()), f"[{tag}] f32 kernel logits not finite")
            out["kernel_vs_dense_rel"] = float((lk - ld).abs().max()) / float(ld.abs().max())
    out["prefill_decode_vs_forward_rel"] = lm_decode_vs_forward(
        model, params, toks, P, T, impl="kernel" if kernel else "dense")
    for k, v in out.items():
        require(v <= LM_TOL, f"[{tag}] f32 {k}: {v} > {LM_TOL}")
    say(tag, card=card, step="float32", layers=model.cfg.n_layers, batch=toks.shape[0],
        prefill=P, decode_steps=T, **out, tol=LM_TOL)
    return out


def phase_lm_moe(args, device, card):
    """olmoe-1b-7b at its full 16 layers, 4 × 2 048 tokens (capacity C =
    320 per row and expert at the default factor 1.25); float32 at 2
    layers with capacity factor 16, the reference's no-drop setting."""
    from repro_torch.models import moe
    from repro_torch.models.registry import get_model

    cfg = family_config("olmoe-1b-7b", device)
    small = device == "cpu"
    B, S = (2, 128) if small else (4, 2048)
    toks = torch.as_tensor(np.random.default_rng(args.seed).integers(0, cfg.vocab, (B, S)),
                           device=device)
    model, params, launches, secs, peak = lm_family_bf16(
        args, device, card, "lm-moe", cfg, {"tokens": toks}, cfg.n_layers)
    C = moe.capacity(cfg, S)
    say("lm-moe", capacity=C, experts=cfg.n_experts, top_k=cfg.moe_top_k,
        dispatch_buffer_bytes=B * cfg.n_experts * (C + 1) * cfg.d_model * 2)
    del model, params
    free(device)
    cfg32 = f32_config(cfg, n_layers=min(LM_CHECK_LAYERS, cfg.n_layers), capacity_factor=16.0)
    model = get_model(cfg32)
    params = model.init(args.seed + 1, device=device)
    P, T = (96, 32) if small else (1920, 128)
    toks = torch.as_tensor(np.random.default_rng(args.seed + 1).integers(
        0, cfg.vocab, (2, P + T)), device=device)
    checks = lm_f32_checks("lm-moe", card, model, params, toks, P, T)
    del model, params
    free(device)
    return dict(launches=launches, secs=secs, peak=peak, checks=checks, arch=cfg.arch_id)


def phase_lm_rwkv(args, device, card):
    """rwkv6-3b at its full 32 layers, 4 × 2 048 tokens (no kernel: the WKV
    recurrence is plain torch, as the reference's is plain jnp); the time
    mix of one layer (projections + the WKV loop over the tokens) timed
    alone and set against the warm prefill; float32 at 2 layers."""
    from repro_torch.models import rwkv
    from repro_torch.models.registry import get_model
    from repro_torch.models.transformer import layer_params

    cfg = family_config("rwkv6-3b", device)
    small = device == "cpu"
    B, S = (2, 128) if small else (4, 2048)
    toks = torch.as_tensor(np.random.default_rng(args.seed).integers(0, cfg.vocab, (B, S)),
                           device=device)
    model, params, launches, secs, peak = lm_family_bf16(
        args, device, card, "lm-rwkv", cfg, {"tokens": toks}, 0)
    x = seeded((B, S, cfg.d_model), args.seed, device, torch.bfloat16)
    st = rwkv.init_state(cfg, B, torch.bfloat16, device=device)
    lp = layer_params(params["layers"], 0)
    tm = lambda: rwkv.time_mix(lp["tm"], x, cfg, (st["tm_x"], st["tm_S"]))  # noqa: E731
    tm()
    _, tm_s = timed(tm, device)
    secs["time_mix_s_per_layer"] = tm_s
    say("lm-rwkv", step="time-mix", time_mix_s_per_layer=round(tm_s, 4),
        time_mix_share_of_warm_prefill=round(tm_s * cfg.n_layers / secs["prefill_warm_s"], 4))
    del model, params, x
    free(device)
    cfg32 = f32_config(cfg, n_layers=min(LM_CHECK_LAYERS, cfg.n_layers))
    model = get_model(cfg32)
    params = model.init(args.seed + 1, device=device)
    P, T = (96, 32) if small else (1920, 128)
    toks = torch.as_tensor(np.random.default_rng(args.seed + 1).integers(
        0, cfg.vocab, (2, P + T)), device=device)
    checks = lm_f32_checks("lm-rwkv", card, model, params, toks, P, T, kernel=False)
    del model, params
    free(device)
    return dict(launches=launches, secs=secs, peak=peak, checks=checks, arch=cfg.arch_id)


def phase_lm_hybrid(args, device, card):
    """recurrentgemma-9b at its full 38 layers (12 periods of (rec, rec,
    attn) and the 2-layer tail), 2 × 2 048 tokens = the window: the decode
    steps wrap the ring buffer. No kernel (the pattern blocks take 'dense'
    up to 4 096 tokens, as the reference's do). One RG-LRU block timed
    alone and set against the warm prefill. float32 at 5 layers (a period
    and the tail): prefill of the full window + 64 decode steps past it
    against the forward."""
    from repro_torch.models import rglru
    from repro_torch.models.registry import get_model
    from repro_torch.models.transformer import layer_params

    cfg = family_config("recurrentgemma-9b", device)
    small = device == "cpu"
    B, S = 2, cfg.local_window
    toks = torch.as_tensor(np.random.default_rng(args.seed).integers(0, cfg.vocab, (B, S)),
                           device=device)
    model, params, launches, secs, peak = lm_family_bf16(
        args, device, card, "lm-hybrid", cfg, {"tokens": toks}, 0)
    pat = cfg.block_pattern
    n_rec = sum(pat[i % len(pat)] == "rec" for i in range(cfg.n_layers))
    x = seeded((B, S, cfg.d_model), args.seed, device, torch.bfloat16)
    lp = layer_params(params["pattern"][0], 0)["rec"]
    st = rglru.init_rglru_state(cfg, B, torch.bfloat16, device=device)
    rec = lambda: rglru.rglru_block(lp, x, cfg, st)  # noqa: E731
    rec()
    _, rec_s = timed(rec, device)
    secs["rglru_s_per_layer"] = rec_s
    say("lm-hybrid", step="rg-lru", tail_layers=len(params["tail"]), rec_layers=n_rec,
        rglru_s_per_layer=round(rec_s, 4),
        rglru_share_of_warm_prefill=round(rec_s * n_rec / secs["prefill_warm_s"], 4))
    del model, params, x
    free(device)
    cfg32 = f32_config(cfg, n_layers=HYBRID_CHECK_LAYERS)
    model = get_model(cfg32)
    params = model.init(args.seed + 1, device=device)
    P, T = S, (8 if small else HYBRID_CHECK_STEPS)
    toks = torch.as_tensor(np.random.default_rng(args.seed + 1).integers(
        0, cfg.vocab, (2, P + T)), device=device)
    checks = lm_f32_checks("lm-hybrid", card, model, params, toks, P, T, kernel=False)
    del model, params
    free(device)
    return dict(launches=launches, secs=secs, peak=peak, checks=checks, arch=cfg.arch_id)


def mrope_streams(B, grid, n_text, device):
    """Qwen2-VL position streams [B, 3, grid² + n_text]: a grid × grid patch
    image (t = 0, h = row, w = column), then text from the largest image
    position + 1 on all three streams."""
    r, c = np.divmod(np.arange(grid * grid), grid)
    img = np.stack([np.zeros_like(r), r, c])
    txt = np.broadcast_to(grid + np.arange(n_text), (3, n_text))
    pos = np.broadcast_to(np.concatenate([img, txt], 1), (B, 3, grid * grid + n_text))
    return torch.as_tensor(pos.copy(), device=device)


def phase_lm_mrope(args, device, card):
    """qwen2-vl-72b at full width, depth cut to MROPE_LAYERS: embeddings of
    2 × 2 048 tokens (a 32 × 32 patch image, then text) with M-RoPE streams
    that differ; decode steps at text positions. float32 at 2 layers: (a)
    on the image + text embeddings, (b) on text tokens."""
    from repro_torch.models.registry import get_model

    small = device == "cpu"
    cfg = family_config("qwen2-vl-72b", device, n_layers=2 if small else MROPE_LAYERS)
    B, S, grid = (2, 128, 8) if small else (2, 2048, MROPE_GRID)
    embeds = seeded((B, S, cfg.d_model), args.seed, device, torch.bfloat16, 0.02)
    pos = mrope_streams(B, grid, S - grid * grid, device)
    model, params, launches, secs, peak = lm_family_bf16(
        args, device, card, "lm-mrope", cfg, {"embeds": embeds, "mrope_pos": pos}, cfg.n_layers)
    del model, params, embeds
    free(device)
    cfg32 = f32_config(cfg, n_layers=min(LM_CHECK_LAYERS, cfg.n_layers))
    model = get_model(cfg32)
    params = model.init(args.seed + 1, device=device)
    P, T = (96, 32) if small else (1920, 128)
    toks = torch.as_tensor(np.random.default_rng(args.seed + 1).integers(
        0, cfg.vocab, (2, P + T)), device=device)
    emb = {"embeds": seeded((2, S, cfg.d_model), args.seed + 1, device, scale=0.02),
           "mrope_pos": pos[:2]}
    checks = lm_f32_checks("lm-mrope", card, model, params, toks, P, T, embeds=emb)
    del model, params, emb
    free(device)
    return dict(launches=launches, secs=secs, peak=peak, checks=checks, arch=cfg.arch_id)


TRAIN_STEPS = 6  # [train]: steps of full-width qwen2.5-3b through run_training
TRAIN_BATCH, TRAIN_SEQ = 2, 2048
TRAIN_LR, TRAIN_WARMUP = 3e-4, 2
# [train-check]: qwen2.5-3b at full width cut to 2 layers (at 36 the random
# weights amplify any change of arithmetic, as [lm] finds: their gradients
# grow ~5x a layer back to the embedding, [train] step=grad-scale), float32
# against the same step in float64, 1 x 512 tokens. The loss within
# TRAIN_LOSS_TOL relative; each gradient leaf within TRAIN_GRAD_TOL of its
# max|g|. Float32 itself reads 7.0e-3 there on an H100 (the embedding; the
# first layer's wq 6.3e-3: attention logits ~1e3 amplify the rounding of
# the softmax's backward), so the limit is set by a control, as LM_TOL is:
# the same step with TF32 matrix products (a 10-bit mantissa) reads 3.09 and
# must read above it. 'full' against 'none' remat to the same limits (read
# 0.0 on the card, where the recomputed layer adds in the same order)
TRAIN_CHECK_LAYERS, TRAIN_CHECK_SEQ = 2, 512
TRAIN_LOSS_TOL, TRAIN_GRAD_TOL = 1e-5, 2e-2


def train_grads(model, params, batch):
    """(loss, {path: gradient}) of ``model.loss_fn`` the way the train step
    takes them: one leaf per layer (``train_step.layer_views``)."""
    from repro_torch.train.optimizer import tree_leaves
    from repro_torch.train.train_step import layer_views

    views = layer_views(params, lambda t: t.detach().requires_grad_())
    loss, _ = model.loss_fn(views, batch)
    leaves = tree_leaves(views)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
    return loss.detach(), grads


def leaf_paths(tree, pre=""):
    """Leaf paths in ``train.optimizer.tree_leaves`` order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in leaf_paths(tree[k], f"{pre}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree) for p in leaf_paths(v, f"{pre}/{i}")]
    return [pre]


def grads_vs(got, want, paths):
    """{path: max|got - want| / max|want|} (float64), the worst first."""
    out = {}
    for name, g, w in zip(paths, got, want):
        scale = float(w.abs().max())
        if scale:
            out[name] = float((g.double() - w.double()).abs().max()) / scale
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def phase_train(args, device, card):
    """qwen2.5-3b at full width (36 layers, d 2 048, 16/2 heads, d_ff
    11 008, vocab 151 936, tied; seeded weights) trained TRAIN_STEPS steps
    through ``launch.train.run_training(device='cuda')``: bf16 parameters,
    float32 AdamW state, remat 'full', attn_impl 'auto' (dense at 2 048
    tokens), TokenPipeline batches of TRAIN_BATCH x TRAIN_SEQ, lr 3e-4 with
    2 warmup steps, no checkpoint directory. The step seconds are read off
    the trainer's log lines (one per step, each after the step's loss came
    back to the host): the first from the call, so it holds the init of the
    parameters and the AdamW state. The counts of every hand-written
    kernel are set to 0 before and read after: training launches none.
    Then the cost of the gradient route the trainer avoids: the backward of
    36 ``stack[i]`` reads of the full-width layer stacks into the stacks'
    gradient, against per-layer leaves. The rehearsal runs the reduced
    miniature."""
    import dataclasses

    from repro_torch.launch.train import run_training

    small = device == "cpu"
    cfg = dataclasses.replace(family_config("qwen2.5-3b", device), remat="full")
    B, S = (2, 128) if small else (TRAIN_BATCH, TRAIN_SEQ)
    if not small:
        torch.cuda.reset_peak_memory_stats()
    reset_launches()
    stamps, lines = [], []

    def log(line):
        stamps.append(time.perf_counter())
        lines.append(line)
        print(line, flush=True)

    t0 = time.perf_counter()
    params, opt, losses = run_training(cfg, steps=TRAIN_STEPS, global_batch=B, seq_len=S,
                                       lr=TRAIN_LR, warmup=TRAIN_WARMUP, seed=args.seed,
                                       log_every=1, log_fn=log, device=device)
    counts = read_launches()
    require(not any(counts.values()), f"[train] launched a hand-written kernel: {counts}")
    require(int(opt.step) == TRAIN_STEPS and len(losses) == TRAIN_STEPS,
            f"[train] {int(opt.step)} optimizer steps, {len(losses)} losses")
    vals = [dict(zip(("loss", "ce", "gnorm", "lr"),
                     (float(x) for x in line.split()[4:11:2]))) for line in lines]
    require(all(np.isfinite(v).all() for v in (losses, [list(d.values()) for d in vals])),
            f"[train] non-finite loss, ce, grad norm or lr: {vals}")
    require(all(bool(torch.isfinite(t).all()) for t in _leaves(params)),
            "[train] non-finite parameters after the steps")
    step_s = [stamps[0] - t0] + [b - a for a, b in zip(stamps, stamps[1:])]
    warm = step_s[1:]
    tokens = B * S
    flops = cfg.flops_per_token_train() * tokens
    warm_s = sum(warm) / len(warm)
    peak = torch.cuda.max_memory_allocated() if not small else None
    for i, (sec, v) in enumerate(zip(step_s, vals)):
        say("train", card=card, step=i, seconds=round(sec, 4), tokens_per_s=round(tokens / sec, 1),
            **v, **({"includes": "init"} if i == 0 else {}))
    out = dict(arch=cfg.arch_id, layers=cfg.n_layers, batch=B, seq=S, steps=TRAIN_STEPS,
               params=sum(t.numel() for t in _leaves(params)), first_step_incl_init_s=step_s[0],
               warm_step_s=warm_s, warm_steps_s=warm, tokens_per_s=tokens / warm_s,
               model_flops_per_step=flops, model_flops_per_s=flops / warm_s,
               model_flops_share_of_bf16_peak=flops / warm_s / PEAK_BF16_TC_FLOPS,
               losses=losses, grad_norms=[v["gnorm"] for v in vals],
               max_memory_allocated=peak, launches=counts)
    say("train", card=card, **{k: v for k, v in out.items()
                               if k not in ("losses", "grad_norms", "launches")})
    out["state_nbytes"] = train_state_nbytes(cfg, params, opt, B, S, args.seed, device)
    say("train", card=card, step="state-and-flops", **out["state_nbytes"])
    del params, opt
    free(device)
    out["grad_scale"] = grad_scale(cfg, device, args.seed)
    say("train", card=card, step="grad-scale", **out["grad_scale"])
    if not small:
        out["select_grad"] = select_grad_cost(cfg, device)
        say("train", card=card, step="select-gradient", **out["select_grad"])
    return out


def train_state_nbytes(cfg, params, opt, B, S, seed, device):
    """What ``[dryrun]``'s one-card check holds its account against, read
    after ``[train]``'s steps and peak: the bytes of the live parameters and
    AdamW state, and of one step's gradients (per-layer leaves, as the step
    takes them) with the FLOPs ``FlopCounterMode`` counts in that step."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.data.synthetic import TokenPipeline
    from repro_torch.models.registry import get_model

    nbytes = lambda leaves: sum(t.numel() * t.element_size() for t in leaves)  # noqa: E731
    batch = TokenPipeline(cfg.vocab, S, B, seed=seed).batch(0, device)
    with FlopCounterMode(display=False) as fc:
        _, grads = train_grads(get_model(cfg), params, batch)
    out = dict(params=nbytes(_leaves(params)), opt=nbytes(_leaves(tuple(opt))),
               grads=nbytes(grads), step_flops=fc.get_total_flops())
    del grads
    return out


def grad_scale(cfg, device, seed):
    """How large the gradients of ``cfg`` are at its seeded init: one step's
    (1 x 512 tokens, the trainer's per-layer leaves) float32 sum of squares
    as the reference's clip takes it (``inf`` once it overflows), the global
    norm accumulated in float64 as the port's, the largest |g|, and the norm
    of the ``mlp.w_up`` gradient at five depths."""
    from repro_torch.data.synthetic import TokenPipeline
    from repro_torch.models.registry import get_model
    from repro_torch.train.train_step import layer_views

    model = get_model(cfg)
    params = model.init(seed, device=device)
    paths = leaf_paths(layer_views(params))
    batch = TokenPipeline(cfg.vocab, 64 if device == "cpu" else 512, 1, seed=seed).batch(0, device)
    _, grads = train_grads(model, params, batch)
    f64 = lambda g: float(torch.linalg.vector_norm(g, dtype=torch.float64))  # noqa: E731
    L = cfg.n_layers
    depths = sorted({0, L // 4, L // 2, 3 * L // 4, L - 1})
    out = dict(f32_sum_of_squares=float(sum(torch.sum(torch.square(g.float())) for g in grads)),
               f64_global_norm=sum(f64(g) ** 2 for g in grads) ** 0.5,
               max_abs_grad=max(float(g.abs().max()) for g in grads),
               w_up_grad_norm_by_depth={
                   i: f64(grads[paths.index(f"/layers/{i}/mlp/w_up")]) for i in depths})
    del params, grads
    free(device)
    return out


def select_grad_cost(cfg, device):
    """Seconds of the backward that reading layer i of a stack requiring
    grad costs (one ``select`` backward per layer, each a zero tensor the
    size of the stack added into its gradient), over the full-width layer
    stacks of ``cfg``, against ``torch.unbind`` (one stack of the per-layer
    gradients) — the trainer's per-layer leaves cost neither. Random bf16
    per-layer gradients; one timed backward each, after one untimed."""
    from repro_torch.models.registry import get_model

    stacks = [t for t in _leaves(get_model(cfg).init(0, device=device)["layers"])]
    grads = [torch.randn(t.shape, device=device).to(t.dtype) for t in stacks]
    out = {}
    for name, split in (("select", lambda x: [x[i] for i in range(x.shape[0])]),
                        ("unbind", torch.unbind)):
        for timed_run in (False, True):
            xs = [t.detach().requires_grad_() for t in stacks]
            outs, gs = [], []
            for x, g in zip(xs, grads):
                outs += list(split(x))
                gs += list(g.unbind(0))
            sync(device)
            t1 = time.perf_counter()
            torch.autograd.backward(outs, gs)
            sync(device)
            if timed_run:
                out[f"{name}_backward_s"] = time.perf_counter() - t1
            require(all(torch.equal(x.grad, g) for x, g in zip(xs, grads)),
                    f"[train] {name} backward: wrong stacked gradient")
            del xs, outs, gs
    out["stack_bytes"] = sum(t.numel() * t.element_size() for t in stacks)
    del stacks, grads
    free(device)
    return out


def phase_train_check(args, device, card):
    """float32 checks of the training step at full width, 2 layers, 1 x 512
    tokens (TF32 off): loss and every gradient leaf against the same step in
    float64; remat 'full' against 'none'; one hierarchical step on a 2-member
    pod on this device, and its int8 mean of the members' gradients within
    scale/2 per element of their exact mean."""
    import dataclasses

    from repro_torch.core.distributed import ShardMesh
    from repro_torch.data.synthetic import TokenPipeline
    from repro_torch.models.registry import get_model
    from repro_torch.train.grad_compression import compressed_tree_allreduce, init_residuals
    from repro_torch.train.optimizer import adamw_init, tree_leaves, tree_map
    from repro_torch.train.train_step import make_train_step

    small = device == "cpu"
    cfg = f32_config(family_config("qwen2.5-3b", device), n_layers=TRAIN_CHECK_LAYERS,
                     remat="full")
    S = 64 if small else TRAIN_CHECK_SEQ
    t0 = time.perf_counter()
    model = get_model(cfg)
    params = model.init(args.seed + 2, device=device)
    from repro_torch.train.train_step import layer_views

    paths = leaf_paths(layer_views(params))
    batch = TokenPipeline(cfg.vocab, S, 2, seed=args.seed).batch(0, device)
    one = {k: v[:1] for k, v in batch.items()}
    loss, g32 = train_grads(model, params, one)
    cfg64 = dataclasses.replace(cfg, param_dtype="float64", compute_dtype="float64")
    p64 = tree_map(lambda t: t.double(), params)
    loss64, g64 = train_grads(get_model(cfg64), p64, one)
    del p64
    loss_rel = abs(float(loss) - float(loss64)) / abs(float(loss64))
    by_leaf = grads_vs(g32, g64, paths)
    loss_none, g_none = train_grads(get_model(dataclasses.replace(cfg, remat="none")), params,
                                    one)
    remat_loss_rel = abs(float(loss_none) - float(loss)) / abs(float(loss))
    remat_by_leaf = grads_vs(g_none, g32, paths)
    del g_none
    # the control: TF32 matrix products (a 10-bit mantissa) against float64
    # must read above the limit, or the limit does not tell a change of
    # arithmetic from float32's own rounding (as [lm]'s controls)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        loss_tf32, g_tf32 = train_grads(model, params, one)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    control_by_leaf = grads_vs(g_tf32, g64, paths)
    control_loss_rel = abs(float(loss_tf32) - float(loss64)) / abs(float(loss64))
    del g_tf32, g64, g32
    grad_rel, remat_grad_rel = max(by_leaf.values()), max(remat_by_leaf.values())
    control_grad_rel = max(control_by_leaf.values())
    top = lambda d: {k: float(f"{v:.3e}") for k, v in list(d.items())[:6]}  # noqa: E731
    say("train-check", card=card, step="by-leaf", f32_vs_f64=top(by_leaf),
        remat_none_vs_full=top(remat_by_leaf), control_tf32_vs_f64=top(control_by_leaf),
        control_tf32_loss_rel=control_loss_rel)
    require(loss_rel <= TRAIN_LOSS_TOL and grad_rel <= TRAIN_GRAD_TOL,
            f"[train-check] f32 vs f64: loss {loss_rel}, gradients {grad_rel}")
    require(remat_loss_rel <= TRAIN_LOSS_TOL and remat_grad_rel <= TRAIN_GRAD_TOL,
            f"[train-check] remat 'none' vs 'full': loss {remat_loss_rel}, gradients "
            f"{remat_grad_rel}")
    if not small:  # on the CPU the TF32 switch does nothing
        require(control_grad_rel > TRAIN_GRAD_TOL,
                f"[train-check] the limit {TRAIN_GRAD_TOL} does not tell TF32 products "
                f"({control_grad_rel}) from float32's")
    # the pod: the members' gradients (batch halves) reduced by the int8
    # error-feedback mean the hierarchical step runs, then the step itself
    mesh = ShardMesh.on_one_device(2, device, axis="pod")
    members = [train_grads(model, params, {k: v[i:i + 1] for k, v in batch.items()})[1]
               for i in range(2)]
    mean, _ = compressed_tree_allreduce(members, [[torch.zeros_like(g, dtype=torch.float32)
                                                   for g in m] for m in members],
                                        mesh.shard_devices(["pod"]))
    worst = 0.0  # |int8 mean - exact mean| in units of the leaf's scale / 2
    for m, a, b in zip(mean, *members):
        scale = float(torch.maximum(a.abs().max(), b.abs().max())) / 127.0 + 1e-12
        worst = max(worst, float((m - (a.double() + b.double()) / 2).abs().max()) / (scale / 2))
    require(worst <= 1.0 + 1e-4, f"[train-check] int8 mean off the exact mean by {worst} x "
            "scale/2")
    del members, mean
    step = make_train_step(model.loss_fn, cfg, mesh=mesh, lr=TRAIN_LR, warmup=TRAIN_WARMUP,
                           pod_compression=True)
    before = float(params["layers"]["mlp"]["w_up"].double().sum())
    params, opt, res, met = step(params, adamw_init(params), [init_residuals(params)] * 2,
                                 batch)
    require(int(opt.step) == 1 and all(bool(torch.isfinite(v)) for v in met.values()),
            f"[train-check] hierarchical step: {met}")
    require(float(params["layers"]["mlp"]["w_up"].double().sum()) != before,
            "[train-check] hierarchical step left the parameters as they were")
    out = dict(layers=cfg.n_layers, tokens=S, loss=float(loss), f32_vs_f64_loss_rel=loss_rel,
               f32_vs_f64_grad_rel=grad_rel, remat_none_vs_full_loss_rel=remat_loss_rel,
               remat_none_vs_full_grad_rel=remat_grad_rel, control_tf32_grad_rel=control_grad_rel,
               control_tf32_loss_rel=control_loss_rel, int8_mean_err_half_scales=worst,
               hier_loss=float(met["loss"]), hier_grad_norm=float(met["grad_norm"]),
               tol_loss=TRAIN_LOSS_TOL, tol_grad=TRAIN_GRAD_TOL,
               seconds=round(time.perf_counter() - t0, 3))
    say("train-check", card=card, **out)
    del params, opt, res, model
    free(device)
    return out


# [train-dp]: the train step over several processes (sharding.process). Part
# (a) runs in this process, (b)-(d) in one spawned group of 2 ranks on this
# card under gloo (NCCL takes one rank a device), whose collectives go
# through host memory and loopback TCP.
TRAIN_DP_WORLD = 2
TRAIN_DP_STEPS = 1  # (b): the step held against [train]'s first (~22 s on the card)
TRAIN_DP_TIMEOUT = 420.0  # s the spawned group may take before it is stopped
TRAIN_DP_CONTEXT_BYTES = 2 << 30  # a CUDA context and allocator slack per process (reckoned)
TRAIN_DP_ROWS_LOSS_TOL, TRAIN_DP_ROWS_NORM_TOL = 1e-6, 1e-5  # (e) against one process


def _rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


def _digest(t, index):
    """blake2b of the bytes of ``t[index]`` (a tensor's block, on the host)."""
    import hashlib

    block = t[index].detach().to("cpu").contiguous()
    if block.dtype == torch.bfloat16:
        block = block.view(torch.int16)
    return hashlib.blake2b(block.numpy().tobytes(), digest_size=16).hexdigest()


def train_dp_reckon(cfg, layers, B, world, train):
    """Bytes one rank of ``world`` needs to train ``cfg`` cut to ``layers``
    on ``B`` global rows: its blocks of the bf16 parameters and their
    gradients, of the float32 master weights and moments (logical_sharding on
    ``('data',)`` = world), the gathered embedding and its gradient, and the
    activations of its rows as [train]'s peak gives them per row."""
    import dataclasses

    from repro_torch.core.distributed import ShardMesh
    from repro_torch.models.registry import abstract_params
    from repro_torch.sharding.rules import PROFILES, logical_sharding
    from repro_torch.train.optimizer import tree_leaves

    meta = ShardMesh(["meta"] * world, axis_names=("data",))
    params, axes = abstract_params(dataclasses.replace(cfg, n_layers=layers))
    state = 0
    for p, ax in zip(tree_leaves(params), _axes_leaves(axes)):
        blk = logical_sharding(tuple(p.shape), ax, meta, PROFILES["train"], p.dtype)
        state += 2 * blk.shard_nbytes + 3 * blk.shard_nbytes * 4 // p.element_size()
    st = train["state_nbytes"]
    per_row = (train["max_memory_allocated"] - st["params"] - st["opt"] - st["grads"]) / B
    embed = params["embed"].numel() * params["embed"].element_size()
    return int(state + 2 * embed + per_row * B / world)


def _axes_leaves(axes):
    if isinstance(axes, dict):
        return [a for k in sorted(axes) for a in _axes_leaves(axes[k])]
    if isinstance(axes, list):
        return [a for v in axes for a in _axes_leaves(v)]
    return [axes]


def stepped_init(model, seed, device):
    """``model.init`` with every leaf in the parameter dtype, as a step
    leaves them (a bf16 model's norms start in float32)."""
    from repro_torch.models.common import dtype_of
    from repro_torch.train.optimizer import tree_map

    pdt = dtype_of(model.cfg.param_dtype)
    return tree_map(lambda t: t.to(pdt), model.init(seed, device=device))


def train_dp_ranks(rank, world, address, spec):
    """One rank of [train-dp]'s group (``spawn_ranks``): (c) the pod step
    on ``('pod',)`` = world at [train-check]'s cut, held bitwise against the
    one-card ``hier_step`` run here too; (d) one data-parallel step at the
    same cut in bf16 on ``('data',)`` = world, checkpointed (blocks digested
    for the parent's restore, and restored here on this world, bitwise); (b)
    ``spec['steps']`` steps of [train]'s model, cut to ``spec['layers']``,
    on ``('data',)`` = world; (e) one step at [train-check]'s cut on
    ``('data', 'model')`` = (1, world) of one row, which every rank runs
    whole (``train_step.row_axes``)."""
    import dataclasses

    from repro_torch.ckpt.checkpoint import _flatten, restore_checkpoint, save_checkpoint
    from repro_torch.core.distributed import ShardMesh
    from repro_torch.data.synthetic import TokenPipeline
    from repro_torch.models.registry import get_model
    from repro_torch.sharding.process import (ProcessMesh, init_group, state_blocks,
                                              take_blocks, tree_nbytes)
    from repro_torch.sharding.rules import PROFILES
    from repro_torch.train.grad_compression import init_residuals
    from repro_torch.train.optimizer import adamw_init
    from repro_torch.train.train_step import make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))  # the host's cores, shared
    device, seed = spec["device"], spec["seed"]
    dev = init_group(address=address, rank=rank, world=world, backend="gloo", device=device,
                     timeout_s=spec["timeout"])
    pod = ProcessMesh((world,), ("pod",), device=dev)
    data = ProcessMesh((world,), ("data",), device=dev)
    data_model = ProcessMesh((1, world), ("data", "model"), device=dev)
    rules = PROFILES["train"]
    out = {}

    # (c) the pod step at [train-check]'s cut, against the one-card hier_step
    cfg = f32_config(family_config("qwen2.5-3b", device), n_layers=TRAIN_CHECK_LAYERS,
                     remat="full")
    model = get_model(cfg)
    batch = TokenPipeline(cfg.vocab, spec["check_seq"], world, seed=seed).batch(0, dev)
    step = make_train_step(model.loss_fn, cfg, mesh=pod, rules=rules, lr=TRAIN_LR,
                           warmup=TRAIN_WARMUP, pod_compression=True)
    params = take_blocks(model.init(seed + 2, device=dev), step.blocks)
    params, opt, res, met = step(params, adamw_init(params), init_residuals(params), batch)
    del opt
    one = ShardMesh.on_one_device(world, dev, axis="pod")
    step1 = make_train_step(model.loss_fn, cfg, mesh=one, lr=TRAIN_LR, warmup=TRAIN_WARMUP,
                            pod_compression=True)
    p1 = model.init(seed + 2, device=dev)
    p1, o1, r1, met1 = step1(p1, adamw_init(p1), [init_residuals(p1)] * world, batch)
    differ = [k for (k, a), (_, b) in zip(_flatten(params), _flatten(p1)) if not torch.equal(a, b)]
    differ += [f"residual{k}" for (k, a), (_, b) in zip(_flatten(res), _flatten(r1[rank]))
               if not torch.equal(a, b)]
    out["c"] = dict(differ=differ, loss=float(met["loss"]), one_card_loss=float(met1["loss"]),
                    grad_norm=float(met["grad_norm"]), host_staged_bytes=pod.host_staged_bytes)
    del params, res, p1, o1, r1, step, step1
    free(device)

    # (e) one row of the check's tokens on ('data', 'model') = (1, world): a
    # global batch that does not divide by the world, held by the parent
    # against the one-process step
    batch = TokenPipeline(cfg.vocab, spec["check_seq"], 1, seed=seed).batch(0, dev)
    step = make_train_step(model.loss_fn, cfg, mesh=data_model, rules=rules, lr=TRAIN_LR,
                           warmup=TRAIN_WARMUP)
    params = take_blocks(model.init(seed + 3, device=dev), step.blocks)
    sync(device)
    t1 = time.perf_counter()
    params, opt, met = step(params, adamw_init(params), batch)
    loss, norm = float(met["loss"]), float(met["grad_norm"])
    out["e"] = dict(loss=loss, grad_norm=norm, seconds=time.perf_counter() - t1,
                    host_staged_bytes=data_model.host_staged_bytes)
    del params, opt, step
    free(device)

    # (d) a checkpoint of world blocks, restored here and (by the parent) on one process
    cfg = dataclasses.replace(family_config("qwen2.5-3b", device), n_layers=TRAIN_CHECK_LAYERS,
                              remat="full")
    model = get_model(cfg)
    step = make_train_step(model.loss_fn, cfg, mesh=data, rules=rules, lr=TRAIN_LR,
                           warmup=TRAIN_WARMUP)
    params = take_blocks(model.init(seed, device=dev), step.blocks)
    params, opt, _ = step(params, adamw_init(params), batch)
    state, blocks = {"params": params, "opt": opt}, state_blocks(step.blocks)
    t1 = time.perf_counter()
    save_checkpoint(spec["ckpt"], 1, state, shardings=blocks)
    save_s = time.perf_counter() - t1
    index = {k: b.index() for k, b in _flatten(blocks)}
    digests = {k: _digest(v, tuple(slice(None) for _ in index[k])) for k, v in _flatten(state)}
    skel = take_blocks(stepped_init(model, seed + 9, dev), step.blocks)
    back, at, _ = restore_checkpoint(spec["ckpt"], {"params": skel, "opt": adamw_init(skel)},
                                     shardings=blocks)
    same = all(torch.equal(a, b) for (_, a), (_, b) in zip(_flatten(back), _flatten(state)))
    out["d"] = dict(index=index, digests=digests, restored_bitwise=same, at=at,
                    save_s=save_s, state_bytes=tree_nbytes(state))
    del params, opt, state, skel, back, step
    free(device)

    # (b) [train]'s model on ('data',) = world: its first step against [train]'s
    cfg = dataclasses.replace(family_config("qwen2.5-3b", device), remat="full",
                              n_layers=spec["layers"])
    model = get_model(cfg)
    step = make_train_step(model.loss_fn, cfg, mesh=data, rules=rules, lr=TRAIN_LR,
                           warmup=TRAIN_WARMUP)
    staged0 = data.host_staged_bytes
    params = take_blocks(model.init(seed, device=dev), step.blocks)
    free(device)
    opt = adamw_init(params)
    pipe = TokenPipeline(cfg.vocab, spec["seq"], spec["batch"], seed=seed)
    steps = []
    if device != "cpu":
        torch.cuda.reset_peak_memory_stats()
    for t in range(spec["steps"]):
        b = pipe.batch(t, dev)
        sync(device)
        t1 = time.perf_counter()
        params, opt, m = step(params, opt, b)
        loss, norm = float(m["loss"]), float(m["grad_norm"])
        steps.append(dict(seconds=time.perf_counter() - t1, loss=loss, grad_norm=norm))
    out["b"] = dict(steps=steps, state_bytes=tree_nbytes(params) + tree_nbytes(tuple(opt)[1:]),
                    host_staged_bytes=data.host_staged_bytes - staged0,
                    peak=torch.cuda.max_memory_allocated() if device != "cpu" else None)
    return out


def phase_train_dp(args, device, card, train, tmp):
    """The port's train step over several processes, one per rank
    (``sharding.process.ProcessMesh``): (a) ``run_training`` on a world of 1
    under NCCL at [train]'s full width, steps and batch, its losses against
    [train]'s; then one spawned group of TRAIN_DP_WORLD ranks on this card
    under gloo: (c) the pod step at [train-check]'s cut bitwise against the
    one-card ``hier_step``; (d) a checkpoint of the group's blocks, restored
    on the group and on this process (one process, whole leaves) bitwise;
    (b) [train]'s model on ``('data',)`` = 2 — at full width if the pair
    fits the card by the reckoning printed, else cut (``cut=``) — its first
    step's loss and grad norm against [train]'s within TRAIN_GRAD_TOL, the
    bytes gloo moved through host memory and the step seconds; (e) one row
    of [train-check]'s cut on ``('data', 'model')`` = (1, 2), a batch that
    does not divide by the world, against the one-process step here (loss
    within 1e-6, grad norm within 1e-5, the same loss on both ranks).
    Training launches no hand-written kernel."""
    import dataclasses

    import torch.distributed as dist

    from repro_torch.ckpt.checkpoint import _flatten, restore_checkpoint
    from repro_torch.data.synthetic import TokenPipeline
    from repro_torch.launch.train import run_training
    from repro_torch.models.registry import get_model
    from repro_torch.sharding.process import ProcessMesh, free_address, init_group, spawn_ranks
    from repro_torch.train.optimizer import adamw_init
    from repro_torch.train.train_step import make_train_step

    small = device == "cpu"
    t0 = time.perf_counter()
    cfg = dataclasses.replace(family_config("qwen2.5-3b", device), remat="full")
    B, S = (2, 128) if small else (TRAIN_BATCH, TRAIN_SEQ)

    # (a) a world of 1 under NCCL (gloo on the CPU): [train]'s run
    init_group(address=free_address(), rank=0, world=1, backend="gloo" if small else "nccl",
               device=device)
    try:
        mesh = ProcessMesh((1, 1), ("data", "model"), device=device)
        reset_launches()
        t1 = time.perf_counter()
        _, opt, losses = run_training(cfg, steps=TRAIN_STEPS, global_batch=B, seq_len=S,
                                      lr=TRAIN_LR, warmup=TRAIN_WARMUP, seed=args.seed,
                                      mesh=mesh, log_fn=lambda line: None)
        a_s = time.perf_counter() - t1
        counts = read_launches()
    finally:
        dist.destroy_process_group()
    del opt
    free(device)
    a_rel = max(_rel(a, b) for a, b in zip(losses, train["losses"]))
    say("train-dp", card=card, part="a", world=1, backend="gloo" if small else "nccl",
        layers=cfg.n_layers, steps=TRAIN_STEPS, losses=losses, vs_train_max_rel=a_rel,
        seconds=round(a_s, 3))
    require(not any(counts.values()), f"[train-dp] launched a hand-written kernel: {counts}")
    require(a_rel <= 1e-6, f"[train-dp] (a) world 1 losses {losses} against [train]'s "
            f"{train['losses']}: {a_rel}")

    # (b)'s depth: the pair at full width if it fits beside this process
    free_bytes = torch.cuda.mem_get_info()[0] if not small else None
    layers = cfg.n_layers
    need = lambda n: TRAIN_DP_WORLD * (train_dp_reckon(cfg, n, B, TRAIN_DP_WORLD, train)  # noqa
                                       + TRAIN_DP_CONTEXT_BYTES)
    if not small:
        while need(layers) > free_bytes and layers > 1:
            layers -= 1
    want = dict(loss=train["losses"][0], grad_norm=train["grad_norms"][0])
    if layers != cfg.n_layers:  # the one-process step at the cut depth
        _, _, cut_losses = run_training(dataclasses.replace(cfg, n_layers=layers), steps=1,
                                        global_batch=B, seq_len=S, lr=TRAIN_LR,
                                        warmup=TRAIN_WARMUP, seed=args.seed, device=device,
                                        log_every=1, log_fn=lambda line: want.update(
                                            grad_norm=float(line.split()[8])))
        want["loss"] = cut_losses[0]
        free(device)
    say("train-dp", card=card, part="reckon", world=TRAIN_DP_WORLD, layers=layers,
        reckon_bytes=need(layers) if not small else None, free_bytes=free_bytes)

    ckpt = os.path.join(tmp, "train-dp-ckpt")
    spec = dict(device=device, seed=args.seed, timeout=TRAIN_DP_TIMEOUT / 2, ckpt=ckpt,
                check_seq=64 if small else TRAIN_CHECK_SEQ, layers=layers, batch=B, seq=S,
                steps=TRAIN_DP_STEPS)
    t1 = time.perf_counter()
    ranks = spawn_ranks(train_dp_ranks, TRAIN_DP_WORLD, (spec,), timeout_s=TRAIN_DP_TIMEOUT)
    group_s = time.perf_counter() - t1

    # (c)
    for r, out in enumerate(ranks):
        c = out["c"]
        say("train-dp", card=card, part="c", rank=r, layers=TRAIN_CHECK_LAYERS,
            bitwise=not c["differ"], loss=c["loss"], one_card_loss=c["one_card_loss"],
            grad_norm=c["grad_norm"], host_staged_bytes=c["host_staged_bytes"])
        require(not c["differ"], f"[train-dp] (c) rank {r}: the pod step differs from the "
                f"one-card hier_step in {c['differ'][:8]}")

    # (d): restore the group's checkpoint whole in this process
    dcfg = dataclasses.replace(cfg, n_layers=TRAIN_CHECK_LAYERS)
    skel = stepped_init(get_model(dcfg), args.seed + 9, device)
    t1 = time.perf_counter()
    whole, at, _ = restore_checkpoint(ckpt, {"params": skel, "opt": adamw_init(skel)},
                                      in_place=True)
    restore_s = time.perf_counter() - t1
    bad = [(r, k) for r, out in enumerate(ranks) for k, v in _flatten(whole)
           if _digest(v, out["d"]["index"][k]) != out["d"]["digests"][k]]
    d = ranks[0]["d"]
    say("train-dp", card=card, part="d", world=TRAIN_DP_WORLD, layers=TRAIN_CHECK_LAYERS,
        restored_on_world=[out["d"]["restored_bitwise"] for out in ranks],
        restored_on_one_process=not bad, at=at, state_bytes_per_rank=d["state_bytes"],
        save_s=round(d["save_s"], 3), restore_one_process_s=round(restore_s, 3))
    require(all(out["d"]["restored_bitwise"] for out in ranks) and not bad and at == 1,
            f"[train-dp] (d) checkpoint of {TRAIN_DP_WORLD} ranks restored: "
            f"{[out['d']['restored_bitwise'] for out in ranks]}, one process differs in "
            f"{bad[:8]}")
    del whole, skel
    free(device)

    # (e): the one-process step on the row every rank ran whole
    ecfg = f32_config(family_config("qwen2.5-3b", device), n_layers=TRAIN_CHECK_LAYERS,
                      remat="full")
    emodel = get_model(ecfg)
    seq = 64 if small else TRAIN_CHECK_SEQ
    batch = TokenPipeline(ecfg.vocab, seq, 1, seed=args.seed).batch(0, device)
    params = emodel.init(args.seed + 3, device=device)
    t1 = time.perf_counter()
    _, _, met = make_train_step(emodel.loss_fn, ecfg, lr=TRAIN_LR, warmup=TRAIN_WARMUP)(
        params, adamw_init(params), batch)
    e_want = dict(loss=float(met["loss"]), grad_norm=float(met["grad_norm"]))
    one_s = time.perf_counter() - t1
    del params, met
    free(device)
    e = [out["e"] for out in ranks]
    e_loss = max(_rel(o["loss"], e_want["loss"]) for o in e)
    e_norm = max(_rel(o["grad_norm"], e_want["grad_norm"]) for o in e)
    for r, o in enumerate(e):
        say("train-dp", card=card, part="e", rank=r, mesh="data1 x model2", rows=1, seq=seq,
            layers=TRAIN_CHECK_LAYERS, loss=o["loss"], grad_norm=o["grad_norm"],
            step_seconds=round(o["seconds"], 4), host_staged_bytes=o["host_staged_bytes"])
    say("train-dp", card=card, part="e", one_process=e_want, vs_one_process_loss_rel=e_loss,
        vs_one_process_grad_norm_rel=e_norm, tol_loss=TRAIN_DP_ROWS_LOSS_TOL,
        tol_grad_norm=TRAIN_DP_ROWS_NORM_TOL, one_process_seconds=round(one_s, 4))
    require(all(o["loss"] == e[0]["loss"] for o in e),
            f"[train-dp] (e) the ranks report different losses: {[o['loss'] for o in e]}")
    require(e_loss <= TRAIN_DP_ROWS_LOSS_TOL and e_norm <= TRAIN_DP_ROWS_NORM_TOL,
            f"[train-dp] (e) one row on {TRAIN_DP_WORLD} ranks against one process: loss "
            f"{e_loss}, grad norm {e_norm}")
    require(all(np.isfinite([o["loss"], o["grad_norm"]]).all() for o in e),
            "[train-dp] (e) non-finite loss or grad norm")

    # (b)
    b = [out["b"] for out in ranks]
    first = b[0]["steps"][0]
    loss_rel, norm_rel = _rel(first["loss"], want["loss"]), _rel(first["grad_norm"],
                                                                 want["grad_norm"])
    for r, out in enumerate(b):
        say("train-dp", card=card, part="b", rank=r, world=TRAIN_DP_WORLD, backend="gloo",
            layers=layers, **({"cut": layers} if layers != cfg.n_layers else {}),
            batch=B, seq=S, step_seconds=[round(s["seconds"], 4) for s in out["steps"]],
            losses=[s["loss"] for s in out["steps"]],
            grad_norms=[s["grad_norm"] for s in out["steps"]],
            state_bytes=out["state_bytes"], host_staged_bytes=out["host_staged_bytes"],
            peak=out["peak"])
    say("train-dp", card=card, part="b", vs_one_process_loss_rel=loss_rel,
        vs_one_process_grad_norm_rel=norm_rel, one_process=want, tol=TRAIN_GRAD_TOL)
    require(all(_rel(o["steps"][0]["loss"], first["loss"]) == 0.0 for o in b),
            "[train-dp] (b) the ranks report different losses")
    require(loss_rel <= TRAIN_GRAD_TOL and norm_rel <= TRAIN_GRAD_TOL,
            f"[train-dp] (b) world {TRAIN_DP_WORLD} against one process: loss {loss_rel}, "
            f"grad norm {norm_rel}")
    require(all(np.isfinite([s["loss"], s["grad_norm"]]).all() for o in b for s in o["steps"]),
            "[train-dp] (b) non-finite loss or grad norm")
    say("train-dp", card=card, seconds=round(time.perf_counter() - t0, 3),
        group_seconds=round(group_s, 3))


def encdec_layerwise(params, cfg, frames, toks):
    """The kernel on every encoder and decoder layer's real activations (a
    dense float32 trunk, as lm_layerwise does for [lm]): each layer's
    self-attention (non-causal in the encoder, causal in the decoder)
    through the kernel and its plain f32 version, both against float64; the
    kernel's error may be at most LAYER_ACCURACY times the plain version's
    (+1e-6 of max|out|). Returns the worst readings, and how far the whole
    model's logits move ('kernel' against 'dense', and 'dense' under a 1e-7
    relative change of the frames): the reason for the end-to-end cut."""
    from repro_torch.kernels import ops
    from repro_torch.models import encdec
    from repro_torch.models.attention import attention, qkv
    from repro_torch.models.mlp import mlp
    from repro_torch.models.registry import get_model
    from repro_torch.models.transformer import layer_params

    worst = dict(ratio=0.0, kernel_vs_f64=0.0, plain_vs_f64=0.0)

    def check(lp, h, causal, where):
        q, k, v = (t.transpose(1, 2) for t in qkv(lp["attn"], h, cfg, None))
        exact = attention_f64(q, k, v, causal=causal)
        scale = float(exact.abs().max())
        e_k = float((ops.flash_attention(q, k, v, causal=causal).double() - exact).abs().max())
        e_p = float((plain_version("flash_attention")(q, k, v, causal=causal).double()
                     - exact).abs().max())
        e_k, e_p = e_k / scale, e_p / scale
        require(e_k <= LAYER_ACCURACY * e_p + 1e-6,
                f"[lm-encdec] {where}: kernel {e_k} vs plain {e_p} from the f64 attention")
        for key, val in (("ratio", e_k / max(e_p, 1e-30)), ("kernel_vs_f64", e_k),
                         ("plain_vs_f64", e_p)):
            worst[key] = max(worst[key], val)
        return attention(lp["attn"], h, cfg, None, causal=causal, impl="dense")[0]

    eps = cfg.norm_eps
    x = frames + encdec._sinusoid(frames.shape[1], cfg.d_model, frames.dtype, frames.device)
    for i in range(cfg.n_enc_layers):
        lp = layer_params(params["enc"], i)
        x = x + check(lp, encdec._ln(x, lp["ln1"], eps), False, f"encoder layer {i}")
        x = x + mlp(lp["mlp"], encdec._ln(x, lp["ln2"], eps), cfg)
    enc = encdec._ln(x, params["enc_ln"], eps)
    x = params["embed"][toks] + params["dec_pos"][:toks.shape[1]]
    for i in range(cfg.n_layers):
        lp = layer_params(params["dec"], i)
        x = x + check(lp, encdec._ln(x, lp["ln1"], eps), True, f"decoder layer {i}")
        xa = lp["xattn"]
        k, v = encdec._proj(enc, xa["wk"]), encdec._proj(enc, xa["wv"])
        x = x + encdec._cross_attention(xa, encdec._ln(x, lp["ln_x"], eps), k, v, cfg)
        x = x + mlp(lp["mlp"], encdec._ln(x, lp["ln2"], eps), cfg)
    del x, enc
    model = get_model(cfg)
    batch = {"frames": frames, "tokens": toks}
    ld, _ = model.forward(params, batch, attn_impl="dense")
    lk, _ = model.forward(params, batch, attn_impl="kernel")
    lp_, _ = model.forward(params, dict(batch, frames=frames * (1 + 1e-7)), attn_impl="dense")
    top = float(ld.abs().max())
    return worst, dict(kernel_vs_dense_rel=float((lk - ld).abs().max()) / top,
                       perturbed_frames_rel=float((lp_ - ld).abs().max()) / top)


def phase_lm_encdec(args, device, card):
    """whisper-tiny (4 + 4 layers, d 384), batch 8: encode 1 536 frames
    (non-causal flash_attention, 4 launches) and decode_train 384 tokens
    (causal, 4 launches), cold and warm, then LM_FAMILY_DECODE greedy decode
    steps from position 0 on the cross cache (prefill_cross). float32: the
    kernel on all 8 layers' real activations against float64
    (encdec_layerwise), then at WHISPER_CHECK_LAYERS + WHISPER_CHECK_LAYERS
    layers (a) the logits, 'kernel' against 'dense', and (b) 384
    teacher-forced decode steps against decode_train."""
    from repro_torch.kernels import ops
    from repro_torch.models import encdec
    from repro_torch.models.registry import get_model
    from repro_torch.models.transformer import layer_params

    cfg = family_config("whisper-tiny", device)
    card_run = device != "cpu"
    B, F, S = (2, 128, 64) if not card_run else (8, WHISPER_FRAMES, WHISPER_TOKENS)
    frames = seeded((B, F, cfg.d_model), args.seed, device, torch.bfloat16)
    toks = torch.as_tensor(np.random.default_rng(args.seed).integers(0, cfg.vocab, (B, S)),
                           device=device)
    if card_run:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = get_model(cfg)
    params = model.init(args.seed, device=device)
    sync(device)
    say("lm-encdec", card=card, arch=cfg.arch_id, enc_layers=cfg.n_enc_layers,
        dec_layers=cfg.n_layers, d_model=cfg.d_model, heads=cfg.n_heads, head_dim=cfg.hd,
        vocab=cfg.vocab, params=sum(t.numel() for t in _leaves(params)),
        dtype=cfg.param_dtype, init_s=round(time.perf_counter() - t0, 3))
    reset_launches()
    secs, n_enc, n_dec = {}, 0, 0
    for step in ("cold", "warm"):
        n0 = ops.flash_attention.launches
        enc, secs[f"encode_{step}_s"] = timed(
            lambda: encdec.encode(params, cfg, frames, attn_impl="kernel"), device)
        n1 = ops.flash_attention.launches
        logits, secs[f"decode_train_{step}_s"] = timed(
            lambda: encdec.decode_train(params, cfg, toks, enc, attn_impl="kernel"), device)
        n2 = ops.flash_attention.launches
        require(not card_run or (n1 - n0, n2 - n1) == (cfg.n_enc_layers, cfg.n_layers),
                f"[lm-encdec] flash_attention launches {(n1 - n0, n2 - n1)} a run, not "
                f"{(cfg.n_enc_layers, cfg.n_layers)}")
        n_enc, n_dec = n_enc + n1 - n0, n_dec + n2 - n1
    require(tuple(logits.shape) == (B, S, cfg.vocab) and bool(torch.isfinite(logits).all()),
            "[lm-encdec] decoder logits: shape or non-finite values")
    cache = model.init_cache(B, LM_FAMILY_DECODE, dtype=torch.bfloat16, enc_seq=F, device=device)
    cache["xk"], cache["xv"] = encdec.prefill_cross(params, cfg, enc)
    tok, finite, decoded = toks[:, 0], torch.isfinite(logits).all(), []
    t1 = time.perf_counter()
    for i in range(LM_FAMILY_DECODE):
        logits, cache = model.decode_step(params, tok, cache, i)
        finite &= torch.isfinite(logits).all()
        tok = torch.argmax(logits, -1)
        decoded.append(tok)
    sync(device)
    secs["decode_s_per_step"] = (time.perf_counter() - t1) / LM_FAMILY_DECODE
    counts = read_launches()
    launches = counts.pop("flash_attention")
    require(not any(counts.values()), f"[lm-encdec] launched another kernel: {counts}")
    require(launches == n_enc + n_dec, "[lm-encdec] flash_attention launched in decode")
    require(bool(finite), "[lm-encdec] non-finite decode logits")
    if args.profile:  # after the counts are read: these launches are not the path's
        profile_call(lambda: encdec.decode_train(params, cfg, toks, encdec.encode(
            params, cfg, frames, attn_impl="kernel"), attn_impl="kernel"),
            f"{args.profile}.lm-encdec-prefill", f"warm encode + decode_train, batch {B}", device)
        profile_call(lambda: model.decode_step(params, tok, cache, LM_FAMILY_DECODE - 1),
                     f"{args.profile}.lm-encdec-decode", f"one decode step, batch {B}", device)
    peak = torch.cuda.max_memory_allocated() if card_run else None
    say("lm-encdec", card=card, batch=B, frames=F, tokens=S, decode_steps=LM_FAMILY_DECODE,
        launches_encoder=n_enc, launches_decoder=n_dec,
        **{k: round(v, 4) for k, v in secs.items()}, max_memory_allocated=peak,
        last_logits_absmax=float(logits.float().abs().max()),
        decoded_row0=[int(t[0]) for t in decoded[:8]])
    del model, params, cache, enc, logits, frames
    free(device)

    # float32: the kernel on every layer at full depth, end to end at the cut
    cfg32 = f32_config(cfg)
    params = get_model(cfg32).init(args.seed + 1, device=device)
    frames = seeded((2, F, cfg.d_model), args.seed + 1, device)
    toks = toks[:2]
    layer, full_depth = encdec_layerwise(params, cfg32, frames, toks)
    cut = f32_config(cfg, n_layers=WHISPER_CHECK_LAYERS, n_enc_layers=WHISPER_CHECK_LAYERS)
    cparams = dict(params, enc=layer_params(params["enc"], slice(0, WHISPER_CHECK_LAYERS)),
                   dec=layer_params(params["dec"], slice(0, WHISPER_CHECK_LAYERS)))
    model = get_model(cut)
    batch = {"frames": frames, "tokens": toks}
    lk, _ = model.forward(cparams, batch, attn_impl="kernel")
    ld, _ = model.forward(cparams, batch, attn_impl="dense")
    require(bool(torch.isfinite(lk).all()), "[lm-encdec] f32 kernel logits not finite")
    top = float(ld.abs().max())
    checks = {"kernel_vs_dense_rel": float((lk - ld).abs().max()) / top}
    lp_, _ = model.forward(cparams, dict(batch, frames=frames * (1 + 1e-7)), attn_impl="dense")
    checks["perturbed_frames_rel"] = float((lp_ - ld).abs().max()) / top
    del ld, lp_
    enc = encdec.encode(cparams, cut, frames, attn_impl="kernel")
    cache = model.init_cache(2, S, dtype=torch.float32, enc_seq=F, device=device)
    cache["xk"], cache["xv"] = encdec.prefill_cross(cparams, cut, enc)
    dec = []
    for t in range(S):
        li, cache = model.decode_step(cparams, toks[:, t], cache, t)
        dec.append(li)
    checks["decode_vs_decode_train_rel"] = (float((torch.stack(dec, 1) - lk).abs().max())
                                            / float(lk.abs().max()))
    for k in ("kernel_vs_dense_rel", "decode_vs_decode_train_rel"):
        require(checks[k] <= LM_TOL, f"[lm-encdec] f32 {k}: {checks[k]} > {LM_TOL}")
    say("lm-encdec", card=card, step="float32", layers_checked=cfg.n_enc_layers + cfg.n_layers,
        **{f"layerwise_{k}": v for k, v in layer.items()},
        **{f"e2e_{k}_full_depth": v for k, v in full_depth.items()},
        check_layers=f"{WHISPER_CHECK_LAYERS}+{WHISPER_CHECK_LAYERS}", batch=2, frames=F,
        decode_steps=S, **checks, tol=LM_TOL)
    del model, params, cparams, cache, enc, lk, dec
    free(device)
    return dict(launches=launches, launches_encoder=n_enc, launches_decoder=n_dec, secs=secs,
                peak=peak, checks=checks, arch=cfg.arch_id)


# ------------------------------------------- the fixed-order scatter
def segment_case(L, n_src, W, halves, layout, device, seed):
    """Seeded inputs of ``ops.segment_add``: (heat [L, W], src [n_src, C],
    index) for one index ``layout``: 'dup' (every row real, many per lixel),
    'padded' (a grouped layout: some slots real), 'single' (one segment),
    'empty' (no rows), 'long' (one segment of 3 tiles and more, among short
    ones) and 'ramp' (segment lengths 1 .. 2·BLOCK_ROWS + 1 in shuffled atom
    order, on padded slots: every block-boundary case). L and n_src grow to
    what the layout needs."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.segment_add import BLOCK_ROWS

    rng = np.random.default_rng(seed)
    C = 2 * W if halves else W
    if layout == "dup":
        slots = np.arange(n_src)
        lixel = rng.integers(0, max(L // 3, 1), n_src)
    elif layout == "padded":
        slots = np.sort(rng.choice(n_src, n_src // 2, replace=False))
        lixel = rng.integers(0, L, len(slots))
    elif layout == "single":
        slots = rng.permutation(n_src)[: n_src // 3]
        lixel = np.full(len(slots), L // 2)
    elif layout == "long":
        n_long = 3 * BLOCK_ROWS + 37
        n_src = max(n_src, n_long + 400)
        lixel = np.concatenate([np.full(n_long, L // 2), rng.integers(0, L // 3, 300)])
        rng.shuffle(lixel)
        slots = rng.permutation(n_src)[: len(lixel)]
    elif layout == "ramp":
        lens = np.arange(1, 2 * BLOCK_ROWS + 2)
        L = max(L, 2 * len(lens) + 1)
        lixel = np.repeat(rng.permutation(len(lens)) * 2, lens)
        rng.shuffle(lixel)
        n_src = max(n_src, len(lixel) + 997)
        slots = np.sort(rng.choice(n_src, len(lixel), replace=False))
    else:
        slots = lixel = np.zeros(0, np.int64)
    heat = torch.as_tensor(rng.normal(size=(L, W)), device=device)
    src = torch.as_tensor(rng.normal(size=(n_src, C)) * 10.0 ** rng.integers(-6, 6, (n_src, 1)),
                          device=device)
    return heat, src, ops.segment_index(lixel, slots, device=device)


def segment_bitwise(heat, src, index, halves):
    """ops.segment_add against its plain version on copies of ``heat``:
    (max_abs_err, max_rel_err), required 0.0 — the same additions in the
    same order, no FMA to contract."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.segment_add import segment_add_ref

    got = ops.segment_add(heat.clone(), src, index, halves=halves)
    if got.is_cuda:
        torch.cuda.synchronize()
    want = segment_add_ref(heat.clone(), src, index, halves=halves)
    require(torch.isfinite(got).all(), "segment_add produced non-finite values")
    err = float((got - want).abs().max()) if got.numel() else 0.0
    require(torch.equal(got, want), f"segment_add is not bitwise its plain version ({err})")
    return err, err


def phase_segment_kernels(device):
    """``[segment-kernels]``: ops.segment_add held bitwise against its plain
    version over odd widths (W = 1, 5, 16, and 2·TILE_COLS + 3: more columns
    than one tile holds, a ragged last column tile), half-window pairs, a
    contiguous and a transposed (strided) source, duplicates, padded slots,
    one segment, none, one longer than a block and a tile, and a ramp of
    segment lengths 1 .. 2·BLOCK_ROWS + 1."""
    from repro_torch.kernels.segment_add import BLOCK_ROWS, TILE_COLS

    n = 0
    widths = (1, 5, 16, 2 * TILE_COLS + 3)
    layouts = ("dup", "padded", "single", "empty", "long", "ramp")
    for W in widths:
        for halves in (False, True):
            for layout in layouts:
                heat, src, index = segment_case(301, 2000, W, halves, layout, device,
                                                W * 100 + halves * 10 + len(layout))
                if layout == "long":
                    require(index.max_len > BLOCK_ROWS, "[segment-kernels] no long segment")
                segment_bitwise(heat, src, index, halves)
                segment_bitwise(heat, src.T.contiguous().T, index, halves)
                n += 2
                del heat, src, index
    say("segment-kernels", cases=n, bitwise=True, widths=",".join(map(str, widths)),
        layouts=",".join(layouts), block_rows=BLOCK_ROWS, tile_cols=TILE_COLS)
    return n


def segment_bound(heat, src, index, halves):
    """Least time the card could take for one segment_add, from this input:
    the larger of bytes/bandwidth (each real row's W or 2W source values,
    its source-row index, the segment bounds and lixels, and each (lixel,
    window) heat value read and written once) and operations/peak f64 lane
    rate (one add per row and window, two with half-window pairs)."""
    W = heat.shape[1]
    M, U = index.n_rows, index.n_segs
    nbytes = M * W * (2 if halves else 1) * 8 + M * 8 + (2 * U + 1) * 8 + 2 * U * W * 8
    ops_n = M * W * (2 if halves else 1)
    t_b, t_o = nbytes / PEAK_BYTES_PER_S, ops_n / PEAK_F64_LANE_OPS
    return dict(bound_ms=max(t_b, t_o) * 1e3, bound_by="bytes" if t_b >= t_o else "operations",
                bytes=nbytes, adds=ops_n)


def segment_timing(heat, src, index, halves, device):
    """On the card: the kernel and its plain version, and ``index_put_``
    with ``accumulate=True`` — one PyTorch call of the same function, on the
    same rows gathered beforehand (the scatter the port used before) — timed
    in turns (kernel, library, library, kernel; 5 samples each) with L2
    flushed; and ``one_row_ms``, the kernel on a one-row index into the same
    heat and source (its launch and dependent loads, no chain to speak of)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.segment_add import segment_add_ref

    timing = dict(ms=None, plain_ms=None, library_ms=None, one_row_ms=None)
    if device == "cpu":
        return timing
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=device)  # 256 MB > L2
    lix = index.lixel.repeat_interleave(index.seg_ptr[1:] - index.seg_ptr[:-1])
    rows = src.index_select(0, index.rows)
    if halves:
        rows = rows[:, 0::2] + rows[:, 1::2]
    h = heat.clone()
    calls = dict(kernel=lambda: ops.segment_add(h, src, index, halves=halves),
                 library=lambda: h.index_put_((lix,), rows, accumulate=True))
    samples = {k: [] for k in calls}
    for k in ("kernel", "library", "library", "kernel"):
        samples[k] += time_samples(calls[k], reps=5, flush=flush)
    timing["ms"] = float(np.median(samples["kernel"]))
    timing["library_ms"] = float(np.median(samples["library"]))
    timing["plain_ms"] = time_ms(lambda: segment_add_ref(h, src, index, halves=halves),
                                 reps=3, flush=flush)
    one = ops.segment_index([0], [0], device=device)
    timing["one_row_ms"] = time_ms(lambda: ops.segment_add(h, src, one, halves=halves),
                                   reps=5, flush=flush)
    return timing


def phase_segment_shapes(m, ts, device, card, tag="main-segment"):
    """segment_add at the shapes ``[main]``'s flushes gave it: every atom
    pack's walk output (the fused kernel on the window table in place) onto
    a seeded heatmap, bitwise against the plain version; the pack with the
    most real rows is timed (``segment_timing``)."""
    from repro_torch.kernels import ops

    fe = m._fe
    packs = fe._pack_cache.get(((m.epoch, m.ls), "fused"))
    tabs = fe.window_tables(fe.window_batch(m.ctx, ts), tuple(ts))
    table = tabs.reshape(tabs.shape[0], -1)
    heat = torch.as_tensor(np.random.default_rng(5).normal(size=(m.n_lixels, len(ts))),
                           device=device)
    big, big_n = None, -1
    for e in packs:
        out = ops.fused_walk_flat(table, e["index"], e["r_lo"], e["r_hi"], e["side"], e["qs"])
        src = out.reshape(-1, len(ts))
        segment_bitwise(heat, src, e["seg"], False)
        if e["seg"].n_rows > big_n:
            big, big_n = (src, e["seg"]), e["seg"].n_rows
        else:
            del src, out
    src, index = big
    shape = dict(L=m.n_lixels, W=len(ts), src_rows=int(src.shape[0]), rows=index.n_rows,
                 lixels=index.n_segs, longest_segment=index.max_len, halves=False)
    bound = segment_bound(heat, src, index, False)
    timing = segment_timing(heat, src, index, False, device)
    say(tag, card=card, packs=len(packs), bitwise=True, timed_shape=json.dumps(shape),
        grid=index.n_blocks, earlier_design_ms=SEGMENT_EARLIER_MS.get(tag), **timing, **bound)
    return 0.0, 0.0, shape, bound, timing


def fold_bound(args, kw, out_itemsize=8):
    """Least time the card could take for one fold, from this input: the
    larger of bytes/bandwidth (the table written once at ``out_itemsize``
    bytes a value; every node's run start; the prefix bytes the fold needs,
    each read once: a row's 2K values of combos (0, 2) where it is a lo or
    mid boundary, of combos (1, 3) where it is a mid or hi one — counted from
    the searches the plain version makes on this input; the window batch)
    and operations/peak f64 lane rate (a subtract, multiply and add per
    (value, t))."""
    from repro_torch.kernels.fold_tables import seg_search, window_boundaries

    time_tab, cum_tab, starts, t_lo, t_hi, qt = args
    lvl_ptr, steps, k_t = kw["lvl_ptr"], kw["steps"], kw["k_t"]
    K = int(cum_tab.shape[2])
    R, W, ks = int(starts.shape[0]), int(t_lo.shape[0]) // 2, K // k_t
    t_b, right_b = window_boundaries(t_lo, t_hi)
    keys = []  # row * 2 + (0: combos (0, 2), 1: combos (1, 3))
    for lev in range(len(lvl_ptr) - 1):
        ns = starts[lvl_ptr[lev]:lvl_ptr[lev + 1]]
        for c0 in range(0, ns.shape[0], 1 << 16):
            s_lo = ns[c0:c0 + (1 << 16)]
            i = seg_search(time_tab, s_lo[None, None], (s_lo + (1 << lev))[None, None],
                           t_b[..., None], right_b[..., None], int(steps[lev]))
            for b, groups in ((0, (0,)), (1, (0, 1)), (2, (1,))):
                rows = (i[b] - 1)[i[b] > s_lo[None]]
                keys += [torch.unique(rows * 2 + g) for g in groups]
    n_keys = int(torch.unique(torch.cat(keys)).numel()) if keys else 0
    values = R * 2 * W * 2 * ks
    nbytes = values * out_itemsize + R * 8 + n_keys * 2 * K * 8 + 2 * W * (2 + k_t) * 8
    ops_n = values * k_t * 3
    t_b_, t_o = nbytes / PEAK_BYTES_PER_S, ops_n / PEAK_F64_LANE_OPS
    return dict(bound_ms=max(t_b_, t_o) * 1e3, bound_by="bytes" if t_b_ >= t_o else "operations",
                bytes=nbytes, table_bytes=values * out_itemsize, prefix_bytes=n_keys * 2 * K * 8,
                ops=ops_n)


def phase_fold_shapes(m, device, card, tag="fold-shapes"):
    """``[fold-shapes]``: ops.fold_node_tables at the main path's forest and
    FOLD_W fresh centres (berkeley's fresh queries) against its plain version
    on the same tables — float64 within KERNEL_TOL of max|F|, float32 and
    bfloat16 equal to the plain version's cast or one unit in the last place
    where the float64 tables differ — then, on the card, the float64 kernel
    timed with L2 flushed beside its bound (fold_bound) and the plain
    version's time."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.fold_tables import fold_node_tables_ref

    fe = m._fe
    pk = fe._packed
    t_min, span = float(m.ee.time.min()), float(m.ee.time.max() - m.ee.time.min())
    rng = np.random.default_rng(FOLD_W)
    ts = tuple(float(t) for t in t_min + span * rng.uniform(0.0, 1.0, FOLD_W))
    wb = fe.window_batch(m.ctx, ts)
    starts, lvl_ptr = pk["starts"], pk["lvl_ptr"]
    args = (pk["pf"].pm_time, pk["pf"].pm_cum, starts, wb.t_lo, wb.t_hi, wb.qt)
    kw = dict(lvl_ptr=lvl_ptr, steps=pk["steps_per_level"], k_t=int(m.ctx.k_t))
    want64 = fold_node_tables_ref(*args, **kw)
    got64 = ops.fold_node_tables(*args, **kw)
    if device != "cpu":
        torch.cuda.synchronize()
    scale = float(want64.abs().max())
    require(scale > 0.0 and bool(torch.isfinite(got64).all()), f"[{tag}] empty or non-finite")
    abs_err = float((got64 - want64).abs().max())
    require(abs_err <= KERNEL_TOL * scale, f"[{tag}] f64 vs plain: {abs_err / scale}")
    ulps = {}
    for dtype, view in ((torch.float32, torch.int32), (torch.bfloat16, torch.int16)):
        got, want = ops.fold_node_tables(*args, **kw, out_dtype=dtype), want64.to(dtype)
        d = (got.view(view).int() - want.view(view).int()).abs()
        require(bool(((d == 0) | ((d <= 1) & (got64 != want64))).all()),
                f"[{tag}] {dtype} differs from the plain version's cast")
        ulps[str(dtype).removeprefix("torch.")] = int(d.max())
        del got, want, d
    shape = dict(nodes=int(starts.shape[0]), levels=len(lvl_ptr) - 1, W=FOLD_W,
                 k_s=int(m.ctx.k_s), k_t=int(m.ctx.k_t), rows=int(got64.shape[0]))
    bound = fold_bound(args, kw)
    timing = dict(ms=None, plain_ms=None)
    if device != "cpu":
        flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=device)  # 256 MB > L2
        del got64, want64
        free(device)
        timing["ms"] = time_ms(lambda: ops.fold_node_tables(*args, **kw), flush=flush)
        timing["plain_ms"] = time_ms(lambda: fold_node_tables_ref(*args, **kw), reps=3,
                                     flush=flush)
        del flush
    say(tag, card=card, **shape, max_rel_err=abs_err / scale, narrow_max_ulps=json.dumps(ulps),
        ms=timing["ms"], plain_ms=timing["plain_ms"], bound_ms=bound["bound_ms"],
        bound_by=bound["bound_by"], bytes=bound["bytes"], prefix_bytes=bound["prefix_bytes"])
    return abs_err, abs_err / scale, shape, bound, timing


def phase_segment_shapes_drfs(m, ts, device, card, tag="drfs-segment"):
    """segment_add at the shapes ``[drfs]``'s flushes gave it: per atom block
    of the last plan, the tree phase's [G·Qp, W] slots (``gseg``) and the
    scan phase's half-window [M, 2W] rows (``seg``, a transposed source, as
    ``eval_atoms_dyn`` hands it over), on seeded values, bitwise against the
    plain version; the block with the most rows is timed in its tree form."""
    fe = m._fe
    packs = fe._atom_packs(m._host_plan(m.snapshot()))
    W = len(ts)
    rng = np.random.default_rng(6)
    heat = torch.as_tensor(rng.normal(size=(m.n_lixels, W)), device=device)
    big, big_n = None, -1
    for e in packs:
        G, Qp = e["side"].shape
        src = torch.as_tensor(rng.normal(size=(G * Qp, W)), device=device)
        segment_bitwise(heat, src, e["gseg"], False)
        vals = torch.as_tensor(rng.normal(size=(2 * W, e["m"])), device=device)
        segment_bitwise(heat, vals.T, e["seg"], True)
        if e["gseg"].n_rows > big_n:
            big, big_n = (src, e["gseg"]), e["gseg"].n_rows
    src, index = big
    shape = dict(L=m.n_lixels, W=W, src_rows=int(src.shape[0]), rows=index.n_rows,
                 lixels=index.n_segs, longest_segment=index.max_len, halves=False)
    bound = segment_bound(heat, src, index, False)
    timing = segment_timing(heat, src, index, False, device)
    say(tag, card=card, blocks=len(packs), bitwise=True, timed_shape=json.dumps(shape),
        grid=index.n_blocks, earlier_design_ms=SEGMENT_EARLIER_MS.get(tag), **timing, **bound)
    return 0.0, 0.0, shape, bound, timing


# ------------------------------------------- search / cascade executors
def phase_search(m, ts, F_main, device, card):
    """``[search]``: ``executor='search'`` and then ``'cascade'`` (plain
    torch over the time-major forest, no kernel of their own) on ``[main]``'s
    model, index and plan: an engine of each swapped in, a cold and a warm
    query with the launch counts set to 0 just before and read just after.
    Each answer within PACKED_TOL of ``[main]``'s, warm == cold and duplicate
    centres bitwise, no kernel launched but the scatter (once per pack)."""
    from repro_torch.core.rfs import FlatForestEngine

    def sync():
        if device != "cpu":
            torch.cuda.synchronize()

    fused_fe, out = m._fe, {}
    fmax = float(np.abs(F_main).max())
    for executor in ("search", "cascade"):
        t0 = time.perf_counter()
        fe = FlatForestEngine(m.index, executor=executor, device=device)
        require(fe.executor == executor, f"[search] asked {executor}, built {fe.executor}")
        m._fe, m._counter_cursor = fe, {}
        require(m.engine_desc == f"torch/{executor}", m.engine_desc)
        build_s = time.perf_counter() - t0
        if device != "cpu":
            torch.cuda.reset_peak_memory_stats()
        st0 = dict(fe.counters)
        reset_launches()
        t1 = time.perf_counter()
        F_cold = m.query(ts)
        sync()
        cold_s = time.perf_counter() - t1
        st1 = dict(fe.counters)
        t1 = time.perf_counter()
        F = m.query(ts)
        sync()
        warm_s = time.perf_counter() - t1
        counts = read_launches()
        seg = take_segment(counts, executor)
        n_packs = len(fe._pack_cache.get((m._host_plan().key, executor)))
        require(not any(counts.values()), f"[search] {executor} launched a kernel: {counts}")
        require(device == "cpu" or seg == 2 * n_packs,
                f"[search] {executor}: segment_add {seg} for {n_packs} packs")
        require(np.array_equal(F, F_cold), f"[search] {executor}: warm query differs from cold")
        require(np.array_equal(F[1], F[4]), f"[search] {executor}: duplicate centres differ")
        err = float(np.abs(F - F_main).max()) / fmax
        require(err <= PACKED_TOL, f"[search] {executor} vs [main]: {err}")
        cold = {k: st1[k] - st0[k] for k in ("rank_searches", "moment_gathers", "bytes_moved")}
        warm = {k: fe.counters[k] - st1[k] for k in cold}
        peak = torch.cuda.max_memory_allocated() if device != "cpu" else None
        say("search", card=card, executor=executor, engine=m.engine_desc, packs=n_packs,
            launches=json.dumps({**{k: v for k, v in counts.items() if v}, "segment_add": seg}),
            vs_main=err, counters_cold=json.dumps(cold), counters_warm=json.dumps(warm),
            device_bytes=fe.device_bytes, max_memory_allocated=peak,
            build_s=round(build_s, 3), cold_s=round(cold_s, 4), warm_s=round(warm_s, 4))
        out[executor] = dict(err=err, cold_s=cold_s, warm_s=warm_s, launches=seg)
        m._fe, m._counter_cursor = fused_fe, {}
        del fe
        free(device)
    return out


# ------------------------------------------------------ sharded engines
def phase_sharded(m, ts, F_main, host, device, card):
    """``[sharded]`` static RFS at ``[main]``'s scale: S slabs (SHARDS) on the
    one card, a ``ShardedForestEngine`` over ``[main]``'s index swapped into
    its model with the mesh (``engine_desc`` ``torch/packed@shards=S``), a
    cold and a warm query with the launch counts set to 0 just before and
    read just after. Each answer within PACKED_TOL of ``[main]``'s, warm ==
    cold and duplicate centres bitwise; ``bytes_per_shard`` over the
    single-device packed engine's ``device_bytes`` (after the same query)
    at most 1/S + 0.25; the heaviest shard's events at most twice the mean."""
    from repro_torch.core.distributed import ShardMesh, ShardedForestEngine
    from repro_torch.core.rfs import FlatForestEngine

    def sync():
        if device != "cpu":
            torch.cuda.synchronize()

    fused_fe = m._fe
    fmax = float(np.abs(F_main).max())
    single = FlatForestEngine.from_host_tables(m.index, host, executor="packed", device=device)
    m._fe, m._counter_cursor = single, {}
    m.query(ts)
    single_bytes = single.device_bytes
    m._fe, m._counter_cursor = fused_fe, {}
    del single
    free(device)
    out = {}
    for S in SHARDS:
        if device != "cpu":
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        mesh = ShardMesh.on_one_device(S, device=device)
        fe = ShardedForestEngine(m.index, mesh)
        sync()
        build_s = time.perf_counter() - t0
        m._fe, m.mesh, m._counter_cursor = fe, mesh, {}
        require(m.engine_desc == f"torch/packed@shards={S}", m.engine_desc)
        reset_launches()
        t1 = time.perf_counter()
        F_cold = m.query(ts)
        sync()
        cold_s = time.perf_counter() - t1
        t1 = time.perf_counter()
        F = m.query(ts)
        sync()
        warm_s = time.perf_counter() - t1
        counts = read_launches()
        seg = take_segment(counts, f"sharded-rfs-{S}")
        fold = take_fold(counts, f"sharded-rfs-{S}")
        require(not any(counts.values()), f"[sharded] launched another kernel: {counts}")
        require(device == "cpu" or seg > 0, "[sharded] the scatter never launched")
        require(device == "cpu" or fold == S, f"[sharded] S={S}: {fold} folds, one a shard")
        require(np.array_equal(F, F_cold), f"[sharded] S={S}: warm query differs from cold")
        require(np.array_equal(F[1], F[4]), f"[sharded] S={S}: duplicate centres differ")
        err = float(np.abs(F - F_main).max()) / fmax
        require(err <= PACKED_TOL, f"[sharded] S={S} vs [main]: {err}")
        frac = m.stats.bytes_per_shard / single_bytes
        require(0.0 < frac <= 1.0 / S + 0.25, f"[sharded] S={S}: bytes_per_shard frac {frac}")
        loads = fe.sf.events_per_shard.astype(np.float64)
        require(loads.max() <= 2.0 * loads.mean(), f"[sharded] S={S}: loads {loads}")
        peak = torch.cuda.max_memory_allocated() if device != "cpu" else None
        say("sharded", card=card, solution="rfs", shards=S, engine=m.engine_desc,
            vs_main=err, bytes_per_shard=m.stats.bytes_per_shard, single_bytes=single_bytes,
            bytes_frac=round(frac, 4), frac_gate=round(1.0 / S + 0.25, 4),
            events_per_shard=json.dumps(loads.astype(int).tolist()), segment_add=seg,
            fold_node_tables=fold, device_bytes=fe.device_bytes, max_memory_allocated=peak,
            build_s=round(build_s, 3),
            cold_s=round(cold_s, 4), warm_s=round(warm_s, 4))
        out[S] = dict(err=err, frac=frac, cold_s=cold_s, warm_s=warm_s, peak=peak)
        m._fe, m.mesh, m._counter_cursor = fused_fe, None, {}
        del fe
        free(device)
    return out


def phase_sharded_drfs(args, device, card):
    """``[sharded]`` streaming DRFS, cut to berkeley ``SHARDED_DRFS_SCALE``
    (exact mode's boundary-leaf scans run once per shard): per S in SHARDS a
    ``TNKDE(solution='drfs', mesh=...)`` on the first 90 % of the events,
    both modes at the base epoch, after an insert of 5 % (pending) and after
    ``seal()``, each answer held against the single-device packed engine
    swapped in on the same model and snapshot (≤ 1e-11), exact mode's last
    answer against the SPS oracle. Each sharded query's own launches are
    summed; the comparisons' are not counted."""
    from repro_torch.core import TNKDE
    from repro_torch.core.distributed import ShardMesh
    from repro_torch.core.events import Events, group_events_by_edge
    from repro_torch.core.rfs import FlatDynamicEngine
    from repro_torch.data.spatial import make_dataset

    scale = SHARDED_DRFS_SCALE * args.scale
    net, ev, _ = make_dataset("berkeley", scale=scale, seed=args.seed)
    order = np.argsort(ev.time, kind="stable")

    def part(lo, hi):
        sel = order[lo:hi]
        return Events(ev.edge_id[sel], ev.pos[sel], ev.time[sel])

    n_base, n_batch = int(0.9 * ev.n), int(0.05 * ev.n)
    t_min = float(ev.time.min())
    span = float(ev.time.max()) - t_min
    ts = [t_min + f * span for f in DRFS_FRACS]
    worst = 0.0
    for S in SHARDS:
        t0 = time.perf_counter()
        m = TNKDE(net, part(0, n_base), g=50.0, b_s=800.0, b_t=0.2 * span, solution="drfs",
                  mesh=ShardMesh.on_one_device(S, device=device), drfs_depth=8,
                  auto_seal=False, device=device)
        require(m.engine_desc == f"torch/packed@shards={S}", m.engine_desc)
        single = FlatDynamicEngine(m.index, executor="packed", device=device)
        build_s = time.perf_counter() - t0
        seg = 0
        times = {}
        reset_launches()
        for step in ("base", "insert", "seal"):
            if step == "insert":
                m.insert(part(n_base, n_base + n_batch))
            elif step == "seal":
                m.seal()
            for exact in (False, True):
                m.drfs_exact_leaf = exact
                snap = m.snapshot()
                l0 = read_launches()
                t1 = time.perf_counter()
                F = m.query(ts, at=snap)
                if device != "cpu":
                    torch.cuda.synchronize()
                times[f"{step}-{'exact' if exact else 'quantized'}_s"] = round(
                    time.perf_counter() - t1, 4)
                grew = {k: v - l0[k] for k, v in read_launches().items()}
                seg += take_segment(grew, f"sharded-drfs-{S}")
                require(not any(grew.values()), f"[sharded] drfs launched another kernel: {grew}")
                own, cursor = m._fe, dict(m._counter_cursor)
                m._fe, m._counter_cursor = single, {}
                F_1 = m.query(ts, at=snap)
                m._fe, m._counter_cursor = own, cursor
                require(np.isfinite(F).all() and np.abs(F).max() > 0, f"[sharded] {step}: F")
                require(np.array_equal(F[1], F[4]), f"[sharded] {step}: duplicate centres")
                err = float(np.abs(F - F_1).max()) / float(np.abs(F_1).max())
                require(err <= 1e-11, f"[sharded] drfs S={S} {step} exact={exact}: {err}")
                worst = max(worst, err)
        require(device == "cpu" or seg > 0, "[sharded] drfs: the scatter never launched")
        e_, p_, t_ = m.index.snapshot().event_set()  # m.ee holds counts after an insert
        ids, F_sps = sps_sample(m, ts, SPS_EDGES, args.seed + 19,
                                ee=group_events_by_edge(net, Events(e_, p_, t_)))
        err_sps = float(np.abs(F[:, ids] - F_sps).max()) / float(np.abs(F).max())
        require(len(ids) >= 64 and err_sps <= SPS_TOL, f"[sharded] drfs vs sps {err_sps}")
        say("sharded", card=card, solution="drfs", shards=S, scale=scale,
            scale_cut=f"berkeley x{scale} (exact mode's scans run once per shard)",
            edges=net.n_edges, base_events=n_base, batch_events=n_batch,
            vs_single_packed=worst, exact_vs_sps=err_sps, segment_add=seg,
            bytes_per_shard=m._fe.bytes_per_shard, single_device_bytes=single.device_bytes,
            build_s=round(build_s, 3),
            **times)
        del m, single
        free(device)
    return worst


def phase_sharded_serve(args, device, card):
    """``[sharded]`` serve: a ``TNKDEServer(mesh=...)`` (two slabs, one
    quantized DRFS profile, berkeley ``SHARDED_DRFS_SCALE``) answers a few
    requests — one admitted before an insert, two after — and every answer
    is held against an unsharded server's (≤ 1e-12)."""
    from repro_torch.core.distributed import ShardMesh
    from repro_torch.core.events import Events
    from repro_torch.data.spatial import make_dataset
    from repro_torch.serve import ProfileConfig, TNKDEServer

    scale = SHARDED_DRFS_SCALE * args.scale
    net, ev, _ = make_dataset("berkeley", scale=scale, seed=args.seed)
    order = np.argsort(ev.time, kind="stable")

    def part(lo, hi):
        sel = order[lo:hi]
        return Events(ev.edge_id[sel], ev.pos[sel], ev.time[sel])

    n_base = int(0.9 * ev.n)
    t_min = float(ev.time.min())
    span = float(ev.time.max()) - t_min
    cfg = {"default": ProfileConfig(g=50.0, b_s=800.0, b_t=0.2 * span, solution="drfs",
                                    drfs_depth=8)}
    reqs = [[t_min + 0.3 * span], [t_min + 0.5 * span, t_min + 0.7 * span],
            [t_min + 0.4 * span]]
    got = {}
    seg = 0
    for name, kw in (("sharded", dict(mesh=ShardMesh.on_one_device(2, device=device))),
                     ("single", {})):
        srv = TNKDEServer(net, part(0, n_base), profiles=cfg, device=device, **kw)
        reset_launches()
        srv.submit(reqs[0])
        srv.insert(part(n_base, n_base + int(0.02 * ev.n)))
        for r in reqs[1:]:
            srv.submit(r)
        got[name] = {r.id: r.heat for r in srv.pump(force=True)}
        if name == "sharded":
            desc = srv.models["default"].engine_desc
            counts = read_launches()
            seg = take_segment(counts, "sharded-serve")
            require(not any(counts.values()), f"[sharded] serve launched another kernel {counts}")
            require(device == "cpu" or seg > 0, "[sharded] serve: the scatter never launched")
        del srv
        free(device)
    require(desc == "torch/packed@shards=2", f"[sharded] serve engine {desc}")
    require(set(got["sharded"]) == set(got["single"]) and len(got["single"]) == len(reqs),
            f"[sharded] serve answered {sorted(got['sharded'])}")
    errs = [float(np.abs(got["sharded"][k] - b).max()) / float(np.abs(b).max())
            for k, b in got["single"].items()]
    require(max(errs) <= PACKED_TOL, f"[sharded] serve vs unsharded: {errs}")
    say("sharded", card=card, solution="drfs-serve", engine=desc, scale=scale, requests=len(reqs),
        vs_unsharded=max(errs), segment_add=seg)
    return max(errs)


# ------------------------------------------------ dry-run accounting
DRYRUN_CELLS = 64  # --all on both production meshes: 32 runnable cells x 2
DRYRUN_FLOPS_TOL = 0.01  # the account's step FLOPs against FlopCounterMode on the card
DRYRUN_BYTES_TOL = 0.15  # the account's bytes_per_device against max_memory_allocated
DRYRUN_JOBS = 4  # cells traced at once, one host process each (the machine has 8 cores)


def one_card_account(cfg, B, S, kind, attn_impl, device):
    """The dry-run's record of one step of ``cfg`` on a 1 x 1 ``ShardMesh``
    of this card, with its roofline row (one chip)."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.core.distributed import ShardMesh
    from repro_torch.launch import dryrun, roofline

    shape = ShapeSpec(f"{kind}_{B}x{S}", S, B, kind)
    mesh = ShardMesh([device], shape=(1, 1), axis_names=("data", "model"))
    rec = dryrun.lower_cell(cfg, shape, mesh, remat=cfg.remat, attn_impl=attn_impl)
    rec["ok"] = True
    return rec, roofline.roofline_row(rec, 1, shape=shape)


def account_check(tag, card, rec, row, *, flops, peak, seconds, state=None):
    """Hold one account against the card's readings: FLOPs within
    DRYRUN_FLOPS_TOL, bytes_per_device within DRYRUN_BYTES_TOL of the peak,
    and (``state``: {key: live bytes}) the state bytes exactly."""
    mem = rec["memory"]
    out = dict(account_flops=rec["cost"]["flops_global"], card_flops=flops,
               account_bytes_per_device=mem["bytes_per_device"], card_peak=peak,
               bound_s=max(row["t_compute_s"], row["t_memory_s"], row["t_collective_s"]),
               bound_by=row["dominant"], measured_s=seconds)
    if state is not None:
        for key, live in state.items():
            require(mem[key] == live, f"[dryrun] {tag}: account {key} {mem[key]} != live {live}")
            out[f"account_{key}"] = mem[key]
    if flops is not None:
        out["flops_rel"] = out["account_flops"] / flops - 1.0
        require(abs(out["flops_rel"]) <= DRYRUN_FLOPS_TOL,
                f"[dryrun] {tag}: FLOPs {out['account_flops']} vs the card's {flops}")
    if peak is not None:
        out["bytes_rel"] = mem["bytes_per_device"] / peak - 1.0
        require(abs(out["bytes_rel"]) <= DRYRUN_BYTES_TOL,
                f"[dryrun] {tag}: bytes_per_device {mem['bytes_per_device']} vs peak {peak}")
    say("dryrun", card=card, check=tag, **out,
        **{k: mem[k] for k in ("param_bytes", "grad_bytes", "opt_bytes", "cache_bytes",
                               "activation_bytes")})
    return out


def phase_dryrun(args, device, card, train, lm_secs, lm_checks):
    """``[dryrun]``: ``launch.dryrun.main(['--all', '--mesh', 'both'])`` on
    the host in DRYRUN_JOBS processes (meta tensors; it launches and
    allocates nothing on the card):
    every one of the DRYRUN_CELLS cells ``ok``, the roofline tables of both
    meshes printed. Then the one-card check: qwen2.5-3b accounted at
    ``[train]``'s shape (TRAIN_BATCH x TRAIN_SEQ, remat 'full', profile
    'train') on a 1 x 1 mesh — parameter, gradient and AdamW bytes equal to
    the live tensors' exactly, step FLOPs within DRYRUN_FLOPS_TOL of
    FlopCounterMode on one real step, bytes_per_device within
    DRYRUN_BYTES_TOL of ``[train]``'s peak, the roofline bound beside the
    measured step — and the same for ``[lm]``'s bf16 prefill (4 x 2 048,
    'kernel') and one decode step against their peaks (``[lm]``'s
    ``account-readings``). The rehearsal accounts the reduced miniatures."""
    import dataclasses
    import tempfile

    from repro_torch.launch import dryrun, roofline

    small = device == "cpu"
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="dryrun-") as tmp:
        tmp = getattr(args, "dryrun_out", None) or tmp
        rc = dryrun.main(["--all", "--mesh", "both", "--out", tmp, "--jobs",
                          str(DRYRUN_JOBS)])
        recs = [json.load(open(os.path.join(tmp, f))) for f in sorted(os.listdir(tmp))]
        secs = time.perf_counter() - t0
        require(rc == 0 and len(recs) == DRYRUN_CELLS and all(r["ok"] for r in recs),
                f"[dryrun] {sum(r['ok'] for r in recs)} of {len(recs)} cells ok (rc {rc})")
        tables = {}
        for mesh in ("pod1", "pod2"):
            rows, n_chips, _ = roofline.rows_of(tmp, mesh)
            tables[mesh] = roofline.render_table(rows, title=f"Roofline ({mesh}, {n_chips} "
                                                 "H100s; the reference's logical mesh)")
            print(tables[mesh], flush=True)
    say("dryrun", card=card, cells=len(recs), ok=sum(r["ok"] for r in recs),
        seconds=round(secs, 1), max_trace_s=round(max(r["trace_s"] for r in recs), 1))

    # ---- the one-card check against [train] and [lm]
    cfg = dataclasses.replace(family_config("qwen2.5-3b", device), remat="full")
    B, S = (2, 128) if small else (TRAIN_BATCH, TRAIN_SEQ)
    live = train["state_nbytes"]
    rec, row = one_card_account(cfg, B, S, "train", "auto", device)
    checks = {"train": account_check(
        "train", card, rec, row, flops=live["step_flops"], peak=train["max_memory_allocated"],
        seconds=train["warm_step_s"],
        state=dict(param_bytes=live["params"], grad_bytes=live["grads"],
                   opt_bytes=live["opt"]))}
    reads = lm_checks["account_readings"]
    B, S, n_dec = (2, 128, 4) if small else (4, 2048, 32)
    rec, row = one_card_account(cfg, B, S, "prefill", "kernel", device)
    checks["prefill"] = account_check("lm-prefill", card, rec, row,
                                      flops=reads["prefill_flops_dense"],
                                      peak=reads["peak_prefill"], seconds=lm_secs["prefill_warm_s"])
    rec, row = one_card_account(cfg, B, S + n_dec, "decode", "auto", device)
    checks["decode"] = account_check("lm-decode", card, rec, row, flops=reads["decode_flops"],
                                     peak=reads["peak_decode"],
                                     seconds=lm_secs["decode_s_per_step"])
    return dict(cells=len(recs), seconds=secs, checks=checks)


def phase_segment_shapes_sharded(fe, m, ts, device, card, tag):
    """segment_add at the shapes a sharded flush gave it: every shard's walk
    output of every atom block onto a seeded [L, W] delta (half-window rows,
    as ``ShardedForestEngine.flush_plan`` hands them over), bitwise against
    the plain version; the shard block with the most rows is timed."""
    from repro_torch.core.torch_engine import eval_atoms_packed

    tabs = fe.window_tables(fe.window_batch(m.ctx, ts), tuple(float(t) for t in ts))
    heat = torch.as_tensor(np.random.default_rng(7).normal(size=(m.n_lixels, len(ts))),
                           device=device)
    big, big_n, n = None, -1, 0
    for entry in fe._atom_packs(m._host_plan()):
        for s, sh in enumerate(entry["shards"]):
            if sh["seg"].n_rows == 0:
                continue
            vals = eval_atoms_packed(tabs[s], fe._nbl[s], sh["fa"], sh["r_lo"], sh["r_hi"],
                                     max_levels=fe.max_levels)
            segment_bitwise(heat, vals.T, sh["seg"], True)
            n += 1
            if sh["seg"].n_rows > big_n:
                big, big_n = (vals.T, sh["seg"]), sh["seg"].n_rows
    src, index = big
    shape = dict(L=m.n_lixels, W=len(ts), src_rows=int(src.shape[0]), rows=index.n_rows,
                 lixels=index.n_segs, longest_segment=index.max_len, halves=True)
    bound = segment_bound(heat, src, index, True)
    timing = segment_timing(heat, src, index, True, device)
    say(tag, card=card, shard_blocks=n, bitwise=True, timed_shape=json.dumps(shape),
        grid=index.n_blocks, **timing, **bound)
    return 0.0, 0.0, shape, bound, timing


KDE_DRYRUN_SHARDS = 16  # [dryrun-kde]: the berkeley account held against a real query


def phase_dryrun_kde(args, device, card, ts, F_main):
    """``[dryrun-kde]``: ``ShardedForestEngine.lower_flush`` on both
    production meshes (16 shards over ``data``, 32 over ``(pod, data)``; meta
    positions, nothing allocated) for the reference's ``kde_cell`` world
    (``launch.dryrun.kde_cell``, with the CUDA library the flush launches
    loaded and its argument and temporary bytes) and for the berkeley world
    ``[main]`` builds. Then the berkeley account at S = KDE_DRYRUN_SHARDS on this card
    (``ShardMesh.on_one_device``) taken before a cold and a warm query
    (counts set to 0 just before, read just after): ``segment_add``
    launches equal to the account's (one per block and shard with rows,
    per query), each shard's device bytes equal to its account, the answer
    within PACKED_TOL of ``[main]``'s."""
    from repro_torch.core import TNKDE
    from repro_torch.core.distributed import ShardedForestEngine, ShardMesh
    from repro_torch.core.rfs import _device_nbytes
    from repro_torch.data.spatial import make_dataset
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh

    def sync():
        if device != "cpu":
            torch.cuda.synchronize()

    out = {}
    for mp in (False, True):
        cell = dryrun.kde_cell(mp, compile_prog=device != "cpu")
        lo = cell.pop("lowered")
        require(cell["n_shards"] == (32 if mp else 16) and lo.launches > 0,
                f"[dryrun-kde] kde_cell: {cell}")
        say("dryrun-kde", card=card, world="kde_cell", **{k: (json.dumps(v) if isinstance(
            v, dict) else v) for k, v in cell.items()})
        out[f"kde_cell_{'pod2' if mp else 'pod1'}"] = cell
    t0 = time.perf_counter()
    net, ev, _ = make_dataset("berkeley", scale=args.scale, seed=args.seed)
    span = float(ev.time.max() - ev.time.min())
    S = KDE_DRYRUN_SHARDS
    mesh = ShardMesh.on_one_device(S, device=device)
    m = TNKDE(net, ev, g=50.0, b_s=800.0, b_t=0.2 * span, solution="rfs", mesh=mesh,
              device=device)
    require(m.engine_desc == f"torch/packed@shards={S}", m.engine_desc)
    plan = m._host_plan()
    build_s = time.perf_counter() - t0
    for mp in (False, True):
        axes = ("pod", "data") if mp else ("data",)
        fe = ShardedForestEngine(m.index, make_production_mesh(multi_pod=mp), axes)
        t1 = time.perf_counter()
        lo = fe.lower_flush(fe.window_batch(m.ctx, ts), plan, m.n_lixels)
        tag = f"berkeley_{'pod2' if mp else 'pod1'}"
        out[tag] = dict(n_shards=lo.n_shards, bytes_per_shard=lo.slab_bytes_per_shard,
                        flush_bytes_per_shard=lo.bytes_per_shard, launches=lo.launches,
                        lower_s=time.perf_counter() - t1)
        say("dryrun-kde", card=card, world="berkeley", scale=args.scale, mesh=tag, **out[tag])
        del fe
    fe = m._fe
    lo = fe.lower_flush(fe.window_batch(m.ctx, ts), plan, m.n_lixels)
    reset_launches()
    t1 = time.perf_counter()
    F_cold = m.query(ts)
    sync()
    cold_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    F = m.query(ts)
    sync()
    warm_s = time.perf_counter() - t1
    counts = read_launches()
    seg = take_segment(counts, "dryrun-kde")
    fold = take_fold(counts, "dryrun-kde")
    require(not any(counts.values()), f"[dryrun-kde] launched another kernel: {counts}")
    if device != "cpu":
        require(seg == 2 * lo.launches, f"[dryrun-kde] segment_add launched {seg} times, the "
                f"account says {lo.launches} a query")
        require(fold == S, f"[dryrun-kde] {fold} folds for one fresh ts on {S} shards")
    real = [_device_nbytes(fe._shard_parts(s)) for s in range(S)]
    want = [sh["bytes"] for sh in lo.shards]
    require(real == want, f"[dryrun-kde] per-shard bytes {real} != the account's {want}")
    require(np.array_equal(F, F_cold), "[dryrun-kde] warm query differs from the cold one")
    err = float(np.abs(F - F_main).max()) / float(np.abs(F_main).max())
    require(err <= PACKED_TOL, f"[dryrun-kde] S={S} vs [main]: {err}")
    out["berkeley_card"] = dict(shards=S, launches=seg, account_launches_per_query=lo.launches,
                                bytes_per_shard=max(real),
                                account_bytes_per_shard=lo.bytes_per_shard, vs_main=err,
                                build_s=build_s, cold_s=cold_s, warm_s=warm_s)
    say("dryrun-kde", card=card, world="berkeley", scale=args.scale, **out["berkeley_card"])
    shapes = phase_segment_shapes_sharded(fe, m, ts, device, card, "dryrun-kde-segment")
    del m, fe
    free(device)
    return out, shapes


def ptxas_report(log):
    """Per kernel function in an ``nvcc -Xptxas -v`` log: registers and
    spill bytes (stores, loads)."""
    import re

    out, fn = {}, None
    for line in (log or "").splitlines():
        hit = re.search(r"Compiling entry function '([^']+)'", line)
        if hit:
            fn = hit.group(1)
            out[fn] = dict(regs=None, spill_stores=None, spill_loads=None)
            continue
        hit = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if hit and fn:
            out[fn].update(spill_stores=int(hit.group(1)), spill_loads=int(hit.group(2)))
        hit = re.search(r"Used (\d+) registers", line)
        if hit and fn:
            out[fn]["regs"] = int(hit.group(1))
    return out


def sass_counts(lib_path, opcodes):
    """How many instructions of each opcode in ``opcodes`` (the mnemonic
    before any ``.`` modifier, predicated or not) ``cuobjdump -sass`` lists
    in each kernel function of a built library: {function: {opcode: n}}."""
    import re
    from pathlib import Path

    from repro_torch.kernels._build import find_nvcc

    tool = Path(find_nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(tool), "-sass", lib_path], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    out, fn = {}, None
    for line in text.splitlines():
        if "Function : " in line:
            fn = line.split("Function : ", 1)[1].strip()
            out[fn] = dict.fromkeys(opcodes, 0)
            continue
        hit = re.search(r"\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", line)
        if fn and hit and hit.group(1) in out[fn]:
            out[fn][hit.group(1)] += 1
    return out


def build_kernels():
    """Compile every kernel source, one nvcc each, all started together;
    print each kernel's registers and spills (ptxas -v), and show from the
    SASS that the bf16 flash_attention kernels run on the tensor cores
    (HGMMA, the wgmma instruction)."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels._build import build_log
    from repro_torch.kernels.dyn_query import dyn_leaf_query_library
    from repro_torch.kernels.flash_attention import flash_library
    from repro_torch.kernels.fold_tables import fold_tables_library
    from repro_torch.kernels.fused_walk import fused_leaf_library, fused_walk_library
    from repro_torch.kernels.minplus import minplus_library
    from repro_torch.kernels.segment_add import segment_add_library
    from repro_torch.kernels.tree_query import tree_query_library

    builders = dict(fused_walk=fused_walk_library, fused_leaf=fused_leaf_library,
                    tree_query=tree_query_library, dyn_leaf_query=dyn_leaf_query_library,
                    minplus=minplus_library, flash_attention=flash_library,
                    segment_add=segment_add_library, fold_tables=fold_tables_library)
    t1 = time.perf_counter()
    with ThreadPoolExecutor(len(builders)) as pool:  # nvcc runs outside the GIL
        futures = {name: pool.submit(b, verbose=True) for name, b in builders.items()}
        libs = {name: f.result() for name, f in futures.items()}  # a failed build raises here
    say("build", kernels=",".join(builders), seconds=round(time.perf_counter() - t1, 2))
    for name in builders:
        for fn, rep in ptxas_report(build_log(name)).items():
            say("build", source=name, kernel=fn, **rep)
    hgmma = {fn: n["HGMMA"] for fn, n in sass_counts(libs["flash_attention"]._name,
                                                     ("HGMMA",)).items()
             if "flash_bf16_kernel" in fn}
    say("build", source="flash_attention", sass_hgmma=json.dumps(hgmma))
    require(len(hgmma) == 5 and all(hgmma.values()),
            f"the bf16 flash_attention kernels do not run wgmma: {hgmma}")
    # the (min, +) inner instruction: an add, and a min (DMNMX / FMNMX) or a
    # compare and two selects; no instantiation may spill
    mp = ptxas_report(build_log("minplus"))
    require(len(mp) == 4 and all(r["spill_stores"] == 0 and r["spill_loads"] == 0
                                 for r in mp.values()),
            f"minplus_kernel spills or is missing an instantiation: {mp}")
    for fn, counts in sass_counts(libs["minplus"]._name, MINPLUS_SASS).items():
        if "minplus_kernel" in fn:
            say("build", source="minplus", kernel=fn, sass=json.dumps(counts))


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
                         "PATH.kernel-drfs-quantized / PATH.kernel-drfs-exact, and of the LM's "
                         "warm prefill and one decode step to PATH.lm-prefill / PATH.lm-decode")
    ap.add_argument("--dryrun-out", metavar="DIR", default=None,
                    help="keep [dryrun]'s cell files in DIR (default: a temporary directory, "
                         "removed)")
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
        # float32 matmuls in full float32 (the [lm] f32 checks); PyTorch's
        # defaults, set so that nothing else can change them
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
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
    flat_worst = phase_flat_kernels(device)
    kworst = phase_kernel_kernels(device)
    n_minplus_cases = phase_minplus_kernels(device)
    fl_abs, fl_rel, fl_shape, fl_bound, fl_timing = phase_flash_kernels(device)
    fam_flash = {path: flash_timed(*shape, device) for path, shape in FAMILY_FLASH_SHAPES.items()}
    n_seg_cases = phase_segment_kernels(device)
    say("kernels", seconds=round(time.perf_counter() - t1, 1))
    t1 = time.perf_counter()
    m, ts, F_main, launches, secs = phase_main(args, device, card)
    abs2, rel2, shape, bound, timing = phase_main_shapes(m, ts, device, card)
    seg_main = phase_segment_shapes(m, ts, device, card)
    fold_main = phase_fold_shapes(m, device, card)
    say("main", seconds=round(time.perf_counter() - t1, 1))
    t1 = time.perf_counter()
    search = phase_search(m, ts, F_main, device, card)
    say("search", seconds=round(time.perf_counter() - t1, 1))
    t1 = time.perf_counter()
    sharded = phase_sharded(m, ts, F_main, secs["host"], device, card)
    say("sharded", solution="rfs", seconds=round(time.perf_counter() - t1, 1))
    t1 = time.perf_counter()
    main_codec = phase_main_codec(m, ts, F_main, secs, device, card)
    del m, secs["host"]
    free(device)
    say("main-codec", seconds=round(time.perf_counter() - t1, 1))
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
    seg_drfs = phase_segment_shapes_drfs(dm, dts, device, card)
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
    t1 = time.perf_counter()
    drfs_codec = phase_drfs_codec(args, device, card)
    free(device)
    say("drfs-codec", seconds=round(time.perf_counter() - t1, 1))
    t1 = time.perf_counter()
    import tempfile

    with tempfile.TemporaryDirectory(prefix="serve-durable-") as tmp:
        s_ref, s_launches, s_shapes = phase_serve(args, device, card, tmp)
        dur_launches, dur_shapes = phase_serve_durable(args, device, card, s_ref, tmp)
    del s_ref
    free(device)
    rt_launches, rt_shapes = phase_serve_router(args, device, card)
    say("serve-tier", card=card, phases="serve,serve-durable,serve-router",
        seconds=round(time.perf_counter() - t1, 1))
    t1 = time.perf_counter()
    sharded_drfs = phase_sharded_drfs(args, device, card)
    sharded_serve = phase_sharded_serve(args, device, card)
    say("sharded", solution="drfs,serve", seconds=round(time.perf_counter() - t1, 1))
    t1 = time.perf_counter()
    mp_launches, mp_abs, mp_rel, mp_shape, mp_bound, mp_timing, mp_waves = phase_minplus(
        args, device, card)
    free(device)
    say("minplus", seconds=round(time.perf_counter() - t1, 1))
    t1 = time.perf_counter()
    lm_launches, lm_secs, lm_checks = phase_lm(args, device, card)
    say("lm", seconds=round(time.perf_counter() - t1, 1))
    families = {}
    for tag, phase in (("lm-moe", phase_lm_moe), ("lm-rwkv", phase_lm_rwkv),
                       ("lm-hybrid", phase_lm_hybrid), ("lm-encdec", phase_lm_encdec),
                       ("lm-mrope", phase_lm_mrope)):
        t1 = time.perf_counter()
        families[tag] = phase(args, device, card)
        say(tag, seconds=round(time.perf_counter() - t1, 1), peak=families[tag]["peak"])
    t1 = time.perf_counter()
    train_check = phase_train_check(args, device, card)
    train = phase_train(args, device, card)
    say("train", seconds=round(time.perf_counter() - t1, 1), peak=train["max_memory_allocated"])
    t1 = time.perf_counter()
    dry = phase_dryrun(args, device, card, train, lm_secs, lm_checks)
    say("dryrun", seconds=round(time.perf_counter() - t1, 1))
    t1 = time.perf_counter()
    dry_kde, seg_kde = phase_dryrun_kde(args, device, card, ts, F_main)
    say("dryrun-kde", seconds=round(time.perf_counter() - t1, 1))
    free(device)
    with tempfile.TemporaryDirectory(prefix="train-dp-") as tmp:
        phase_train_dp(args, device, card, train, tmp)
    fam_launches = {"lm-moe": families["lm-moe"]["launches"],
                    "lm-encdec-encoder": families["lm-encdec"]["launches_encoder"],
                    "lm-encdec-decoder": families["lm-encdec"]["launches_decoder"],
                    "lm-mrope": families["lm-mrope"]["launches"]}

    # each path's launches were read right after that path's queries: the
    # launches made since, to compare a kernel with its plain version, do
    # not count
    if device != "cpu":
        require(launches > 0, "the main path never launched fused_walk")
        require(tq_launches > 0, "the rfs kernel path never launched tree_query")
        require(mp_launches > 0, "the shortest-path path never launched minplus_matmul")
        require(lm_launches > 0, "the lm prefill path never launched flash_attention")
        require(all(n > 0 for n in fam_launches.values()),
                f"an LM family path never launched flash_attention: {fam_launches}")
        require(all(r["launches"] > 0 for r in main_codec.values()),
                "a [main-codec] path never launched its fused_walk instantiation")
        require(all(r["launches"] > 0 for r in drfs_codec.values()),
                "a [drfs-codec] path never launched its kernel instantiation")
        require(all(n > 0 for n in SEGMENT_LAUNCHES.values()),
                f"a TN-KDE path never launched segment_add: {SEGMENT_LAUNCHES}")
        require(all(n > 0 for n in FOLD_LAUNCHES.values()),
                f"a packed RFS path never launched fold_node_tables: {FOLD_LAUNCHES}")

    def entry(name, path, n, err_abs, err_rel, shp, bnd, tm, replaces, source=None,
              table_dtype="float64", **extra):
        # the walk's two forms, timed in turns at the same shape (walk_forms)
        forms = {k: tm[k] for k in ("kept", "ms_staged", "ms_unstaged") if k in tm}
        return dict(
            name=name, route="cuda", path=path, table_dtype=table_dtype,
            source=f"src/repro_torch/kernels/csrc/{source or name}.cu", replaces=replaces,
            launches=n, max_abs_err=err_abs, max_rel_err=err_rel,
            ms=tm["ms"], plain_ms=tm["plain_ms"], bound_ms=bnd["bound_ms"], bound_by=bnd["bound_by"],
            # timed only, never on a path: flash_attention against
            # scaled_dot_product_attention, segment_add against index_put_
            # (accumulate) on its rows gathered beforehand; no single PyTorch
            # call computes any of the others
            library_ms=tm.get("library_ms"),
            timed_shape=shp, card=card, **forms, **extra,
        )

    la, lr, lshape, lbound, ltiming = dshapes["fused_leaf"]
    wa, wr, wshape, wbound, wtiming = dshapes["fused_walk"]
    ta, tr, tshape, tbound, ttiming = tq_shapes
    qa, qr, qshape, qbound, qtiming = kdshapes["dyn_leaf_query"]
    na, nr, nshape, nbound, ntiming = kdshapes["dyn_node_walk"]
    # the flush's call (dyn_leaf_query_flat) is B4's row; the sweep of the
    # reference's grouped contract (csrc/dyn_leaf_query.cu, on no path) is
    # reported under its own key
    kw_ = {k: kworst[k] for k in ("tree_query", "dyn_node_walk")}
    kw_["dyn_leaf_query"] = kworst["dyn_leaf_query_flat"]
    ga, gr = kworst["dyn_leaf_query"]
    fwa, fwr = flat_worst["fused_walk_flat", "float64"]
    fla, flr = flat_worst["fused_leaf_flat", "float64"]
    kernels = [
        entry("fused_walk", "rfs", launches, max(abs1, abs2, fwa), max(rel1, rel2, fwr), shape,
              bound, timing, "src/repro/kernels/fused_walk.py:86",
              main_path=dict(scale=args.scale, cold_s=secs["cold_s"], warm_s=secs["warm_s"])),
        entry("fused_walk", "drfs-exact", dlaunches["fused_walk"], max(abs1, wa, fwa),
              max(rel1, wr, fwr), wshape, wbound, wtiming, "src/repro/kernels/fused_walk.py:86",
              main_path=dict(scale=args.scale, warm_s=dsecs["exact-warm"])),
        entry("fused_leaf", "drfs-quantized", dlaunches["fused_leaf"], max(labs, la, fla),
              max(lrel, lr, flr), lshape, lbound, ltiming, "src/repro/kernels/fused_walk.py:177",
              main_path=dict(scale=args.scale, warm_s=dsecs["quantized-warm"])),
        entry("tree_query", "rfs-kernel", tq_launches, max(kw_["tree_query"][0], ta),
              max(kw_["tree_query"][1], tr), tshape, tbound, ttiming,
              "src/repro/kernels/tree_query.py:104",
              main_path=dict(scale=args.scale, cold_s=tq_secs["cold_s"], warm_s=tq_secs["warm_s"])),
        entry("dyn_leaf_query", "drfs-kernel-quantized", kdlaunches["dyn_leaf_query"],
              max(kw_["dyn_leaf_query"][0], qa), max(kw_["dyn_leaf_query"][1], qr), qshape,
              qbound, qtiming, "src/repro/kernels/dyn_query.py:59", source="fused_leaf",
              grouped_contract_sweep=dict(source="src/repro_torch/kernels/csrc/dyn_leaf_query.cu",
                                          max_abs_err=ga, max_rel_err=gr),
              main_path=dict(scale=args.scale, warm_s=kdsecs["quantized-warm"])),
        entry("dyn_node_walk", "drfs-kernel-exact", kdlaunches["dyn_node_walk"],
              max(kw_["dyn_node_walk"][0], na), max(kw_["dyn_node_walk"][1], nr), nshape,
              nbound, ntiming, "src/repro/kernels/dyn_query.py:148", source="fused_walk",
              main_path=dict(scale=args.scale, warm_s=kdsecs["exact-warm"])),
        entry("minplus_matmul", "shortest-path", mp_launches, mp_abs, mp_rel, mp_shape, mp_bound,
              mp_timing, "src/repro/kernels/minplus.py:36", source="minplus",
              bitwise_cases=n_minplus_cases, bound_ms_fma_rate=mp_bound["bound_ms_fma_rate"],
              grid=mp_waves, main_path=dict(scale=args.scale)),
        entry("flash_attention", "lm-prefill", lm_launches, fl_abs, fl_rel, fl_shape, fl_bound,
              fl_timing, "src/repro/kernels/flash_attention.py:72",
              main_path=dict(arch="qwen2.5-3b", **lm_secs, **lm_checks)),
    ]
    # the other LM families: one flash_attention entry per path that runs it,
    # timed at that path's own shape (rwkv and the hybrid run no kernel)
    for path, (ea, er, eshape, ebound, etiming) in fam_flash.items():
        fam = families[path.removesuffix("-encoder").removesuffix("-decoder")]
        kernels.append(entry("flash_attention", path, fam_launches[path], ea, er, eshape, ebound,
                             etiming, "src/repro/kernels/flash_attention.py:72",
                             main_path=dict(arch=fam["arch"], **fam["secs"], **fam["checks"],
                                            peak=fam["peak"])))
    # one entry per (kernel, path, table dtype) a table codec ran: the error
    # is the worst of the path's blocks and of the in-place sweep of that dtype
    for codec, dtype in CODEC_DTYPES.items():
        dt = str(dtype).removeprefix("torch.")
        r = main_codec[codec]
        ca, cr, cshape, cbound, ctiming = r["shapes"]
        sa, sr = flat_worst["fused_walk_flat", dt]
        kernels.append(entry("fused_walk", f"rfs-codec-{codec}", r["launches"], max(ca, sa),
                             max(cr, sr), cshape, cbound, ctiming,
                             "src/repro/kernels/fused_walk.py:86", table_dtype=dt,
                             main_path=dict(scale=args.scale, codec=codec, codec_vs_f64=r["err"],
                                            **r["secs"])))
    drfs_paths = dict(fused_walk=("drfs-exact", "src/repro/kernels/fused_walk.py:86", None,
                                  "fused_walk_flat"),
                      fused_leaf=("drfs-quantized", "src/repro/kernels/fused_walk.py:177", None,
                                  "fused_leaf_flat"),
                      dyn_node_walk=("drfs-kernel-exact", "src/repro/kernels/dyn_query.py:148",
                                     "fused_walk", "fused_walk_flat"),
                      dyn_leaf_query=("drfs-kernel-quantized", "src/repro/kernels/dyn_query.py:59",
                                      "fused_leaf", "fused_leaf_flat"))
    for (kern, dt), r in drfs_codec.items():  # bf16 runs exact mode only
        path, replaces, source, sweep = drfs_paths[kern]
        codec = r["codec"]
        ca, cr, cshape, cbound, ctiming = r["shapes"]
        sa, sr = flat_worst[sweep, dt]
        kernels.append(entry(kern, f"{path}-codec-{codec}", r["launches"], max(ca, sa),
                             max(cr, sr), cshape, cbound, ctiming, replaces, source=source,
                             table_dtype=dt,
                             main_path=dict(scale=args.scale, codec=codec,
                                            codec_vs_f64=r["err"], **r["secs"])))
    # the serve tier runs the [drfs] kernels through TNKDEServer: each entry's
    # errors, times and bound come from its own phase's last flush
    sq, sx = s_shapes["fused_leaf"], s_shapes["fused_walk"]
    for path, n, scale, (ea, er, eshape, ebound, etiming) in (
            ("serve-quantized", s_launches["fused_leaf"], args.scale, sq),
            ("serve-durable", dur_launches, args.scale, dur_shapes),
            ("serve-router", rt_launches, SERVE_ROUTER_SCALE * args.scale, rt_shapes)):
        kernels.append(entry("fused_leaf", path, n, ea, er, eshape, ebound, etiming,
                             "src/repro/kernels/fused_walk.py:177",
                             main_path=dict(scale=scale, phase=path)))
    kernels.append(entry("fused_walk", "serve-exact", s_launches["fused_walk"],
                         sx[0], sx[1], sx[2], sx[3], sx[4],
                         "src/repro/kernels/fused_walk.py:86",
                         main_path=dict(scale=args.scale, phase="serve-exact")))
    # the fixed-order scatter ends every TN-KDE flush: its [main] entry counts
    # that path's launches and lists every path's (launches_by_path); its
    # [drfs] entry is timed at that path's largest block
    seg_replaces = ("none: added by the port, no TPU counterpart (the reference scatters "
                    "with heat.at[lixel].add in its jitted flushes, src/repro/core/rfs.py:562)")
    for path, n, (ea, er, eshape, ebound, etiming), extra in (
            ("rfs", SEGMENT_LAUNCHES["rfs"], seg_main,
             dict(launches_by_path=dict(SEGMENT_LAUNCHES), bitwise_cases=n_seg_cases,
                  search=search, sharded_rfs={str(k): v for k, v in sharded.items()},
                  sharded_drfs_vs_single=sharded_drfs, sharded_serve_vs_single=sharded_serve)),
            ("drfs", SEGMENT_LAUNCHES["drfs"], seg_drfs, {}),
            ("dryrun-kde", SEGMENT_LAUNCHES["dryrun-kde"], seg_kde,
             dict(dryrun_kde=dry_kde, dryrun=dict(cells=dry["cells"],
                                                  seconds=dry["seconds"],
                                                  checks=dry["checks"])))):
        kernels.append(entry("segment_add", path, n, ea, er, eshape, ebound, etiming,
                             seg_replaces, main_path=dict(scale=args.scale), **extra))
    # the window-table fold of the packed RFS executors, timed at berkeley's
    # W = 24; its entry lists every path's launches
    kernels.append(entry("fold_node_tables", "rfs", FOLD_LAUNCHES["rfs"], *fold_main,
                         "none: added by the port, no TPU counterpart (the reference folds with "
                         "jitted jnp, src/repro/core/jax_engine.py:581)", source="fold_tables",
                         launches_by_path=dict(FOLD_LAUNCHES), main_path=dict(scale=args.scale)))
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
